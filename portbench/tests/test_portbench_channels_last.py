"""The reader ``channels_last_share.vfi`` on synthetic traces: the share of
the VFI network calls (spans ``refid.vfi.network``) that hold a span
``refid.vfi.channels_last``; 0 where every call ran NCHW, None where the
trace holds no network call, so the metric is left out on a program that
opens none."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import ROOT, load_module
from portbench.trace import Trace

NAME = "channels_last_share.vfi"


def _read(trace):
    return load_module(ROOT / "metrics" / f"{NAME}.py").read(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("held,share", [((0, 1, 2), 100.0), ((1,), 100.0 / 3), ((), 0.0)])
def test_share_of_the_network_calls(held, share):
    """Three windows; the channels_last span opens inside the network calls
    of ``held`` (none: the int8 path, which reads 0, not None).  A span
    outside every network call holds none of them."""
    host = [("portbench.pipeline", 0.0, 9.0)]
    if held:
        host.append(("refid.vfi.channels_last", 9.2, 9.4))
    for i in range(3):
        host += [("refid.vfi.request", 3 * i, 3 * i + 2.5),
                 ("refid.vfi.pack", 3 * i + 0.5, 3 * i + 1),
                 ("refid.vfi.network", 3 * i + 1, 3 * i + 2)]
        if i in held:
            host.append(("refid.vfi.channels_last", 3 * i + 1.1, 3 * i + 1.9))
    trace = Trace(0.0, 10.0, [("k", 0.5, 1.0)], sorted(host, key=lambda e: e[1]), 3)
    assert _read(trace) == pytest.approx(share)


@pytest.mark.parametrize("host,calls", [
    ([("refid.task.upload", 0.0, 1.0), ("refid.task.network", 1.0, 8.0)], 2),
    ([("portbench.pipeline", 0.0, 4.0), ("aten::conv2d", 1.0, 2.0)], 1),
    ([("refid.vfi.network", 1.0, 2.0), ("refid.vfi.channels_last", 1.1, 1.9)], 0),
])
def test_none_without_network_calls(host, calls):
    """A deblur trace, a trace with no program span and a run with no call."""
    assert _read(Trace(0.0, 10.0, [("k", 1.0, 2.0)], host, calls)) is None


def test_none_without_a_trace():
    assert _read(None) is None
