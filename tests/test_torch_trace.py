"""The port's profiler spans (``core/timer.py::span``) on the CPU: where
they open, how they nest, that they are program ranges (FUNCTION scope,
not user annotations, so the profiler keeps no device copy of them), and
that recording them changes no output.

The toy pipeline is tests/test_torch_quant.py's configuration (img_chn 8, 2
encoders, base 8, 1 residual block, 32x32, m=2, n=1) with the modules'
own seeded init; the toy task is EVHINet at wf 8."""

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import ProfilerActivity, profile

from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.core.timer import span
from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
from refid_tpu_torch.models import FinalBidirectionAttenfusion
from refid_tpu_torch.tasks import build_task

torch.set_num_threads(1)

H = W = 32
M, N = 2, 1
TOY = dict(img_chn=8, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
STAGES = ["refid.vfi.pad", "refid.vfi.voxelize", "refid.vfi.pack", "refid.vfi.network"]
NET = {"type": "SingleMultiConnectEVHINet", "in_chn": 3, "ev_chn": 6, "wf": 8, "depth": 3}


def _events(rng, n, h=H, w=W):
    return np.stack([np.sort(rng.rand(n)), rng.randint(0, w, n), rng.randint(0, h, n),
                     rng.randint(0, 2, n)], 1).astype(np.float32)


def _request(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32),
            _events(rng, 800))


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(17)
    return FinalBidirectionAttenfusion(RefidConfig(**TOY)).eval()


def _profiled(fn):
    """``fn()`` under a CPU profiler: its result and the ``refid.`` events
    as (name, start, end, event), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end, e) for e in prof.events()
                    if e.name.startswith("refid.")), key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(spans, outer):
    """The spans strictly nested in the span ``outer``."""
    _, a, b, e = outer
    return [s for s in spans if s[3] is not e and a <= s[1] and s[2] <= b]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _layers(spans):
    """The spans of the layers above the conv layer: all but ``refid.conv``
    (one a biased conv) and ``refid.conv.epilogue``."""
    return [s for s in spans if not s[0].startswith("refid.conv")]


def test_a_request_opens_its_stages_in_order(model):
    """The stages one after another; the float pipeline's model call, in
    channels_last, is also the span ``refid.vfi.channels_last``, inside the
    network's."""
    pipe = BlurVFIPipeline(model, model.cfg, m=M, n=N, device="cpu")
    _, spans = _profiled(lambda: pipe(*_request(1)))
    (request,) = _named(spans, "refid.vfi.request")
    (network,) = _named(spans, "refid.vfi.network")
    in_network = _layers(_inside(spans, network))
    assert [s[0] for s in in_network] == ["refid.vfi.channels_last"]
    convs = _named(spans, "refid.conv")
    assert convs and convs == _inside(spans, in_network[0])    # every conv in the model call
    inside = [s for s in _layers(_inside(spans, request)) if s[3] is not in_network[0][3]]
    assert [s[0] for s in inside] == STAGES
    assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))      # one after another


def test_a_static_int8_request_opens_a_span_per_site(model):
    pipe = BlurVFIPipeline(model, model.cfg, m=M, n=N, int8="static", device="cpu")
    pipe.calibrate(*_request(2))
    states = []
    make = pipe.served._quant_state
    pipe.served._quant_state = lambda: states.append(make()) or states[-1]
    _, spans = _profiled(lambda: pipe(*_request(3)))
    (network,) = _named(spans, "refid.vfi.network")
    sites = _named(spans, "refid.int8.site")
    assert states[0].sites == len(pipe.served.scales) > 0
    assert len(sites) == states[0].sites
    assert sites == _named(_inside(spans, network), "refid.int8.site")


def test_the_demo_calls_open_their_spans():
    events = _events(np.random.RandomState(4), 500, 24, 40)
    grid, spans = _profiled(lambda: events_to_voxel_grid(events, 6, 40, 24, "HWC", device="cpu"))
    assert [s[0] for s in spans] == ["refid.events.k2"]
    _, spans = _profiled(lambda: voxel_norm_np(grid))
    assert [s[0] for s in spans] == ["refid.events.voxel_norm"]


def test_predict_tensor_opens_upload_and_network(tmp_path):
    task = build_task({"name": "toy_single", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "network_g": dict(NET),
                       "path": {"visualization": str(tmp_path / "vis")}, "val": {}},
                      device="cpu")
    rng = np.random.RandomState(5)
    lq = rng.rand(1, 32, 48, 3).astype(np.float32)
    vox = rng.randn(1, 32, 48, 6).astype(np.float32)
    out, spans = _profiled(lambda: task.predict_tensor(lq, vox))
    layers = _layers(spans)
    assert [s[0] for s in layers] == ["refid.task.upload", "refid.task.network"]
    assert layers[0][2] <= layers[1][1]
    convs = _named(spans, "refid.conv")
    assert convs and convs == _inside(spans, layers[1])        # every conv in the network
    torch.testing.assert_close(out, task.predict_tensor(lq, vox), rtol=0, atol=0)


@pytest.mark.parametrize("int8", [False, "static"])
def test_spans_are_program_ranges_and_change_no_output(model, int8):
    pipe = BlurVFIPipeline(model, model.cfg, m=M, n=N, int8=int8, device="cpu")
    if int8:
        pipe.calibrate(*_request(2))
    request = _request(6)
    plain = pipe(*request)
    traced, spans = _profiled(lambda: pipe(*request))
    assert spans
    assert all(e.scope == int(RecordScope.FUNCTION) and not e.is_user_annotation
               for *_, e in spans)
    assert torch.equal(plain, traced)


def _three_spans():
    for _ in range(3):
        with span("refid.test"):
            pass


def test_span_records_only_under_the_profiler():
    _three_spans()                                  # no session: nothing kept, no error
    _, spans = _profiled(_three_spans)
    assert [s[0] for s in spans] == ["refid.test"] * 3
