"""Arithmetic the per-layer metrics' readers share.  A reader returns
None where its run holds nothing to read, and the harness then leaves the
metric out of the result line."""

from __future__ import annotations

import statistics
from pathlib import Path
from typing import Callable, Optional

__all__ = ["idle_share_pct", "mfu_pct", "device_ms_per_call", "names_matcher",
           "host_median_ms"]


def idle_share_pct(run) -> Optional[float]:
    """The device's idle share of the profiled span, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.idle_share


def mfu_pct(run, least_seconds_per_call: float) -> Optional[float]:
    """The least time of a call's model work over the wall time of a call
    of the measured window (unprofiled), in %."""
    w = run.window
    if run.trace is None or w.calls == 0 or w.failed or least_seconds_per_call is None:
        return None
    return 100.0 * least_seconds_per_call / (w.elapsed / w.calls)


def names_matcher(path: Path) -> Callable[[str], bool]:
    """A matcher of kernel names from a file of substrings, one a line."""
    with open(path) as f:
        parts = [line.strip() for line in f if line.strip() and not line.startswith("#")]
    return lambda name: any(p in name for p in parts)


def device_ms_per_call(run, match: Callable[[str], bool]) -> Optional[float]:
    """Device ms a profiled call in the operations ``match`` accepts; None
    where the profiler saw none of them."""
    if run.trace is None or run.trace.calls == 0:
        return None
    if not any(match(name) for name, _, _ in run.trace.device_ops):
        return None
    return run.trace.device_seconds(match) * 1e3 / run.trace.calls


def host_median_ms(run, key: str) -> Optional[float]:
    """The median of a host-clock sample the driver took around its own
    call, over the measured window's calls."""
    values = run.driver.samples.get(key, [])[:run.window.calls]
    return statistics.median(values) if values else None
