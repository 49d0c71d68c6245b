"""Timers with process-wide stats (mirrors ``refid_tpu/core/timer.py``;
upstream ``basicsr/utils/timer_util.py``).

``Timer`` measures host wall-clock time; ``DeviceTimer`` also waits for the
card's queued work (``torch.cuda.synchronize``) when the block starts and
when it ends, so the time covers the device work the block queued (the JAX
package's timer blocks on dispatch instead).  Without an initialised CUDA
context it is a ``Timer``.

``span(name)`` opens a range on the profiler's host timeline: it records
only while a ``torch.profiler`` session is on, on the same clock as the
device activities, and costs one C call otherwise.  Unlike
``record_function`` it is not a user annotation, so it leaves no copy of
itself on the device timeline."""

from __future__ import annotations

import atexit
import time
from collections import defaultdict
from typing import Dict

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Timer", "DeviceTimer", "span", "timer_stats", "print_timer_stats",
           "enable_atexit_dump"]

_cumulative: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


class Timer:
    """``with Timer(name):`` adds the block's seconds to ``name``'s total;
    ``print_every`` prints the mean every that many blocks."""

    def __init__(self, name: str = "timer", print_every: int = 0):
        self.name = name
        self.print_every = print_every

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.start
        _cumulative[self.name] += dt
        _counts[self.name] += 1
        if self.print_every and _counts[self.name] % self.print_every == 0:
            avg = _cumulative[self.name] / _counts[self.name]
            print(f"[{self.name}] avg {avg*1000:.2f} ms over "
                  f"{_counts[self.name]} calls")
        return False


class DeviceTimer(Timer):
    """Waits for the card's outstanding work before starting and before
    stopping the clock."""

    def __enter__(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return super().__enter__()

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return super().__exit__(*exc)


def span(name: str) -> _RecordFunctionFast:
    """``with span(name):`` records the block as a host range named
    ``name`` while a profiler session is on.  A new range each use: one
    instance is never shared between threads."""
    return _RecordFunctionFast(name)


def timer_stats() -> Dict[str, Dict[str, float]]:
    return {name: {"total_s": _cumulative[name], "count": _counts[name],
                   "avg_ms": 1000 * _cumulative[name] / max(_counts[name], 1)}
            for name in _cumulative}


def print_timer_stats():
    for name, s in sorted(timer_stats().items()):
        print(f"[{name}] total {s['total_s']:.2f}s count {s['count']} "
              f"avg {s['avg_ms']:.2f}ms")


def enable_atexit_dump():
    atexit.register(print_timer_stats)
