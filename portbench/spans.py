"""Arithmetic of the per-layer metrics that read the program's own spans.

The program opens host ranges named ``refid.*`` at its layer boundaries
(``refid_tpu_torch/core/timer.py::span``).  They are not user annotations,
so the profiler keeps them on the host timeline only, on the device
activities' clock, among the host operations of the harness's thread that
``Trace.host_ops`` holds.  A reader returns None where the trace holds no
``refid.`` span (a program that opens none), so the metric is left out of
the result line rather than read as 0, and None where the span it reads is
absent.

An idle gap of the device is attributed to the innermost ``refid.`` span
open at the gap's middle, the rule of ``Trace.idle_gaps`` restricted to
the program's spans; a gap lies inside a span when that span is its
innermost one or encloses it.  Per call means over ``Trace.calls`` (a
window, an image).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.trace import union_seconds

__all__ = ["PREFIX", "program_spans", "open_spans", "idle_ms_per_call", "span_ms_per_call",
           "span_mean_us"]

PREFIX = "refid."


def program_spans(trace) -> List[Tuple[str, float, float]]:
    """The ``refid.`` spans among the trace's host operations."""
    return [op for op in trace.host_ops if op[0].startswith(PREFIX)]


def _spans(run, name: str) -> Optional[List[Tuple[str, float, float]]]:
    """The program's spans of a traced run, or None where the run holds no
    call, no program span or none named ``name``."""
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    if not any(n == name for n, _, _ in spans):
        return None
    return spans


def open_spans(trace) -> List[Tuple[float, Tuple[str, ...]]]:
    """For each idle gap of the device, in time order: its seconds and the
    names of the program's spans open at its middle, outermost first (the
    last is the innermost)."""
    spans = sorted(program_spans(trace), key=lambda e: (e[1], -e[2]))
    out, active, j = [], [], 0
    for a, b in trace.gaps():
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] >= mid]
        out.append((b - a, tuple(n for n, _, _ in active)))
    return out


def idle_ms_per_call(run, inside: str, outside: Optional[str] = None) -> Optional[float]:
    """Device idle ms a call while the host is inside the span ``inside``
    and, where ``outside`` is given, not inside ``outside``."""
    if _spans(run, inside) is None:
        return None
    idle = sum(s for s, names in open_spans(run.trace)
               if inside in names and (outside is None or outside not in names))
    return idle * 1e3 / run.trace.calls


def span_ms_per_call(run, name: str) -> Optional[float]:
    """Host ms a call inside the spans named ``name`` (their union, within
    the profiled span)."""
    spans = _spans(run, name)
    if spans is None:
        return None
    t = run.trace
    return union_seconds([(a, b) for n, a, b in spans if n == name], t.lo, t.hi) * 1e3 / t.calls


def span_mean_us(run, name: str) -> Optional[float]:
    """The mean duration of a span named ``name``, in us."""
    spans = _spans(run, name)
    if spans is None:
        return None
    durations = [b - a for n, a, b in spans if n == name]
    return 1e6 * sum(durations) / len(durations)
