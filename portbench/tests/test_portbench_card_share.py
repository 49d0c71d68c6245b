"""The reader ``voxel_norm_card_share.deblur`` on synthetic traces: the share
of the demo's normalisations (spans ``refid.events.voxel_norm``) that hold a
span ``refid.events.voxel_norm_card``; None where the trace holds no
normalisation, so the metric is left out on a program that opens none."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import ROOT, load_module
from portbench.trace import Trace

NAME = "voxel_norm_card_share.deblur"


def _read(trace):
    return load_module(ROOT / "metrics" / f"{NAME}.py").read(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("on_card,share", [((0, 1, 2), 100.0), ((1,), 100.0 / 3), ((), 0.0)])
def test_card_share_of_the_normalisations(on_card, share):
    """Three images; the card span opens inside the normalisations of
    ``on_card`` (none: every normalisation fell back to the host, which
    reads 0, not None).  A card span outside every normalisation holds none
    of them."""
    host = [("portbench.voxel", 0.0, 9.0)]
    if on_card:
        host.append(("refid.events.voxel_norm_card", 9.2, 9.4))
    for i in range(3):
        host += [("refid.events.k2", 3 * i, 3 * i + 1),
                 ("refid.events.voxel_norm", 3 * i + 1, 3 * i + 2)]
        if i in on_card:
            host.append(("refid.events.voxel_norm_card", 3 * i + 1.1, 3 * i + 1.9))
    trace = Trace(0.0, 10.0, [("k", 0.5, 1.0)], sorted(host, key=lambda e: e[1]), 3)
    assert _read(trace) == pytest.approx(share)


@pytest.mark.parametrize("host,calls", [
    ([("refid.vfi.request", 0.0, 9.0), ("refid.vfi.network", 3.0, 8.0)], 2),
    ([("portbench.pipeline", 0.0, 4.0), ("aten::conv2d", 1.0, 2.0)], 1),
    ([("refid.events.voxel_norm", 1.0, 2.0)], 0),
])
def test_none_without_normalisations(host, calls):
    """A VFI trace, a trace with no program span and a run with no call."""
    assert _read(Trace(0.0, 10.0, [("k", 1.0, 2.0)], host, calls)) is None


def test_none_without_a_trace():
    assert _read(None) is None
