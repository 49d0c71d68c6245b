"""The readers of the program's spans on synthetic traces: an idle gap goes
to the innermost ``refid.`` span open at its middle (other host operations
are passed over), a reading is per call, and a trace with no program span
gives None, so the metric is left out on a program that opens none."""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

from portbench.harness import ROOT, load_module
from portbench.spans import open_spans
from portbench.trace import Trace

READERS = ["edge_idle_ms.vfi", "network_idle_ms.vfi", "int8_site_us.vfi", "k2_ms.deblur",
           "voxel_norm_ms.deblur", "upload_ms.deblur", "network_idle_ms.deblur"]


def _read(name, trace):
    return load_module(ROOT / "metrics" / f"{name}.py").read(SimpleNamespace(trace=trace))


def _vfi(calls=2):
    """Gaps (0, .5) and (1, 2) at the request's edge, (3.5, 4.6) inside a site
    inside the network, (6, 6.8) in the network under an aten op, (9.5, 10)
    after the request."""
    device = [("k", 0.5, 1.0), ("k", 2.0, 3.5), ("k", 4.6, 6.0), ("k", 6.8, 9.5)]
    host = [("portbench.pipeline", 0.0, 10.0), ("refid.vfi.request", 0.0, 9.0),
            ("refid.vfi.pad", 0.3, 1.8), ("refid.vfi.network", 3.0, 8.0),
            ("refid.int8.site", 4.0, 5.0), ("aten::conv2d", 4.1, 4.9),
            ("refid.int8.site", 5.0, 5.002), ("aten::add", 6.0, 7.0)]
    return Trace(0.0, 10.0, device, host, calls)


def test_gaps_go_to_the_innermost_program_span():
    got = open_spans(_vfi())
    assert [names[-1] if names else None for _, names in got] == [
        "refid.vfi.request", "refid.vfi.pad", "refid.int8.site", "refid.vfi.network", None]
    assert got[2][1] == ("refid.vfi.request", "refid.vfi.network", "refid.int8.site")


@pytest.mark.parametrize("calls", [1, 2, 4])
def test_vfi_readers_per_window(calls):
    trace = _vfi(calls)
    assert _read("edge_idle_ms.vfi", trace) == pytest.approx(1.5e3 / calls)
    assert _read("network_idle_ms.vfi", trace) == pytest.approx(1.9e3 / calls)
    assert _read("int8_site_us.vfi", trace) == pytest.approx(1e6 * 1.002 / 2)
    for name in ("k2_ms.deblur", "voxel_norm_ms.deblur", "upload_ms.deblur",
                 "network_idle_ms.deblur"):
        assert _read(name, trace) is None                  # spans this trace lacks


@pytest.mark.parametrize("calls", [1, 3])
def test_deblur_readers_per_image(calls):
    device = [("Memcpy HtoD", 1.0, 1.5), ("k", 3.2, 3.6), ("k", 3.8, 5.0)]
    host = [("portbench.voxel", 0.0, 3.0), ("refid.events.k2", 0.5, 2.0),
            ("refid.events.voxel_norm", 2.0, 3.0), ("portbench.network", 3.0, 6.0),
            ("refid.task.upload", 3.0, 3.5), ("refid.task.network", 3.5, 5.5),
            ("refid.events.k2", 6.5, 7.0)]
    trace = Trace(0.0, 8.0, device, host, calls)
    assert _read("k2_ms.deblur", trace) == pytest.approx(2.0e3 / calls)
    assert _read("voxel_norm_ms.deblur", trace) == pytest.approx(1.0e3 / calls)
    assert _read("upload_ms.deblur", trace) == pytest.approx(0.5e3 / calls)
    # gaps (3.6, 3.8) in the network; (5, 8) has its middle after the span
    assert _read("network_idle_ms.deblur", trace) == pytest.approx(0.2e3 / calls)


def test_none_without_program_spans():
    device = [("k", 1.0, 2.0)]
    host = [("portbench.pipeline", 0.0, 4.0), ("aten::conv2d", 1.0, 2.0)]
    for trace in (Trace(0.0, 4.0, device, host, 2), Trace(0.0, 4.0, device, [], 2),
                  _vfi(calls=0), None):
        assert all(_read(name, trace) is None for name in READERS)


def test_edge_and_network_idle_within_the_idle_time():
    rng = random.Random(3)
    for _ in range(100):
        device, host, t = [], [("portbench.pipeline", 0.0, 30.0)], 0.0
        for _ in range(3):                             # three requests
            a = t + rng.uniform(0.0, 1.0)
            net = a + rng.uniform(0.5, 2.0)
            b = net + rng.uniform(2.0, 5.0)
            host += [("refid.vfi.request", a, b + 0.3), ("refid.vfi.network", net, b)]
            host += [("refid.int8.site", s, s + 0.05)
                     for s in sorted(rng.uniform(net, b - 0.05) for _ in range(5))]
            t = b + 0.5
        for _ in range(40):
            s = rng.uniform(0.0, t)
            device.append(("k", s, s + rng.uniform(0.0, 0.6)))
        trace = Trace(0.0, t, device, host, 3)
        edge, network = _read("edge_idle_ms.vfi", trace), _read("network_idle_ms.vfi", trace)
        assert edge >= 0 and network >= 0
        assert edge + network <= trace.idle_share * trace.window_s * 1e3 / 3 + 1e-9
