"""Reduce a ``torch.profiler`` session to what the per-layer metrics read.

Device time is the union of the device operations' intervals (kernels,
copies, fills), so operations that overlap on several streams count once,
and it is taken inside the same profiled span whose wall time it is held
against: the idle share ``1 - busy / wall`` lies in [0, 1] by construction.
Idle gaps are named by the innermost host operation of the harness's
thread that was running at the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

__all__ = ["Interval", "Trace", "merge", "union_seconds", "from_profiler", "TOP"]

TOP = 10
Interval = Tuple[float, float]          # seconds on the profiler's clock


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if end < start:
            raise ValueError(f"interval ends before it starts: {(start, end)}")
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def union_seconds(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


@dataclass
class Trace:
    """One profiled span: its bounds, the device operations and the host
    operations of the harness's thread (name, start, end; seconds)."""
    lo: float
    hi: float
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    calls: int = 0

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds([(a, b) for _, a, b in self.device_ops], self.lo, self.hi)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, match) -> float:
        """Union of the device operations whose name ``match(name)`` accepts."""
        return union_seconds([(a, b) for n, a, b in self.device_ops if match(n)],
                             self.lo, self.hi)

    def top_device_ops(self, top: int = TOP) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device_ops:
            by_name[name] += max(0.0, min(b, self.hi) - max(a, self.lo))
        return [[n[:200], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def gaps(self) -> List[Interval]:
        """The device's idle intervals inside the span."""
        out, cursor = [], self.lo
        for a, b in merge([(a, b) for _, a, b in self.device_ops]):
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if cursor < self.hi:
            out.append((cursor, self.hi))
        return out

    def idle_gaps(self, top: int = TOP) -> List[list]:
        """Idle seconds by the innermost host operation running at each
        gap's middle ("no host op" where none was)."""
        host = sorted(self.host_ops, key=lambda e: (e[1], -e[2]))
        by_name: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[str, float, float]] = []     # open host ops, nested
        j = 0
        for a, b in self.gaps():                       # in time order
            mid = 0.5 * (a + b)
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by_name[stack[-1][0] if stack else "no host op"] += b - a
        return [[n[:200], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def from_profiler(prof, span_name: str, calls: int) -> Trace:
    """The :class:`Trace` of the host span ``span_name`` (a
    ``record_function`` that encloses the profiled calls and their final
    synchronisation) in a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, span, thread = [], [], None, None
    events = prof.events()
    for e in events:
        if e.device_type == DeviceType.CPU and e.name == span_name:
            span, thread = e, e.thread
    if span is None:
        raise RuntimeError(f"the profiler recorded no span {span_name!r}")
    for e in events:
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("portbench."):     # not a user annotation
                device.append((e.name, a, b))
        elif e.thread == thread:
            host.append((e.name, a, b))
    lo, hi = span.time_range.start * 1e-6, span.time_range.end * 1e-6
    return Trace(lo, hi, device, host, calls)
