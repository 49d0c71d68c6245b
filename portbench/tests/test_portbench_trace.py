"""The idle share's arithmetic: the union of device intervals counts an
overlap once, and the share of the same span is never negative."""

from __future__ import annotations

import random

import pytest

from portbench.trace import Trace, merge, union_seconds


def test_overlap_counts_once():
    ops = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 2.5, 2.7), ("d", 6.0, 7.0)]
    trace = Trace(0.0, 10.0, ops)
    assert trace.busy_s == pytest.approx(4.0)          # [1, 4] and [6, 7]
    assert trace.idle_share == pytest.approx(0.6)
    assert trace.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]


def test_clipped_to_the_span():
    assert union_seconds([(-5.0, 2.0), (9.0, 20.0)], 0.0, 10.0) == pytest.approx(3.0)
    assert merge([(3, 4), (1, 2), (2, 3)]) == [(1, 4)]


def test_share_is_never_negative():
    rng = random.Random(7)
    for _ in range(200):
        ops = []
        for _ in range(rng.randint(1, 40)):
            a = rng.uniform(-1.0, 11.0)
            ops.append(("k", a, a + rng.uniform(0.0, 3.0)))
        trace = Trace(0.0, 10.0, ops)
        summed = sum(min(b, 10.0) - max(a, 0.0) for _, a, b in ops if b > 0 and a < 10)
        assert 0.0 <= trace.idle_share <= 1.0
        assert trace.busy_s <= summed + 1e-9           # a sum counts overlaps twice


def test_idle_gaps_named_by_the_innermost_host_op():
    trace = Trace(0.0, 10.0, [("k", 1.0, 3.0), ("k", 6.0, 7.0)],
                  [("call", 0.0, 10.0), ("sync", 4.5, 5.5), ("python", 8.0, 9.5)])
    assert dict(trace.idle_gaps()) == pytest.approx({"python": 3.0, "sync": 3.0, "call": 1.0})
    assert trace.top_device_ops() == [["k", 3.0]]
