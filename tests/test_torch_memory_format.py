"""The memory format the serving pipelines run the VFI network in (CPU,
f32, toy shapes): a float pipeline without a spatial plan serves in
channels_last, from the packed input through every conv, the zero
recurrent states of step 0 included, to the stacked output; the int8 modes
keep NCHW, whatever format an earlier pipeline left the module's weights
in."""

import numpy as np
import pytest
import torch
import torch.nn as nn

from refid_tpu_torch import BlurVFIPipeline, RefidConfig, SharpVFIPipeline
from refid_tpu_torch.models import FinalBidirectionAttenfusion
from refid_tpu_torch.serve import quant
from tests.test_torch_helpers import served_nchw

torch.set_num_threads(1)

H, W = 16, 24
M, N = 2, 1
# the blur packing's 2 frames and 2 (m - 1) bins; the sharp packing's 26
CFGS = {kind: RefidConfig(img_chn=c, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
        for kind, c in (("blur", 2 * M + 4), ("sharp", 26))}
CL = torch.channels_last


def _request(seed, n_events=600):
    rng = np.random.RandomState(seed)
    ev = np.stack([np.sort(rng.rand(n_events)), rng.randint(0, W, n_events),
                   rng.randint(0, H, n_events), rng.choice([-1., 1.], n_events)],
                  1).astype(np.float32)
    return rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32), ev


def _model(kind="blur", seed=3):
    """The toy network with every parameter drawn (EGACA's zero-initialised
    ``beta`` and ``gamma`` included, so its branch counts)."""
    torch.manual_seed(seed)
    model = FinalBidirectionAttenfusion(CFGS[kind])
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.1)
    return model


def _pipeline(kind, model, **kw):
    if kind == "blur":
        return BlurVFIPipeline(model, model.cfg, m=M, n=N, device="cpu", **kw)
    return SharpVFIPipeline(model, model.cfg, n=3, device="cpu", **kw)


class _ConvInputs:
    """Forward hooks on every conv and transposed conv: the name, shape and
    format of each input, call by call."""

    def __init__(self, model):
        self.calls = []
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]

    def _hook(self, name):
        def hook(module, inputs, output):
            x = inputs[0]
            self.calls.append((name, tuple(x.shape), x.is_contiguous(memory_format=CL),
                               x.is_contiguous()))
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


@pytest.mark.parametrize("kind,t", [("blur", 2 * M + N), ("sharp", 3)])
def test_float_pipeline_serves_every_conv_channels_last(kind, t):
    model = _model(kind)
    pipe = _pipeline(kind, model)
    assert pipe.channels_last
    assert all(p.is_contiguous(memory_format=CL) for p in model.parameters() if p.dim() == 4)
    hooks = _ConvInputs(model)
    out = pipe(*_request(1))
    hooks.remove()
    # the event head runs once a step in each direction, from step 0 on
    assert sum(name == "head.conv2d" for name, *_ in hooks.calls) == 2 * t
    wide = [c for c in hooks.calls if c[1][-1] * c[1][-2] > 1]
    assert wide and [c for c in wide if not c[2]] == []
    assert out.shape == (t, H, W, 3) and out.is_contiguous()


def test_zero_states_follow_the_input_format():
    """Step 0's trunks concatenate the stage output with a zero state; both
    are channels_last, so the trunk's first conv is too (a zero state made
    NCHW turns the cat NCHW)."""
    model = _model().to(memory_format=CL)
    x = torch.rand(1, 8, H, W).contiguous(memory_format=CL)
    for like in (x, x.contiguous()):
        enc, dec = model._zero_states(1, H, W, like)
        for z in enc + dec:
            assert z.is_contiguous(memory_format=CL) != z.is_contiguous()
            assert z.is_contiguous(memory_format=CL) == (like is x) and not z.any()


def test_model_output_in_the_input_format():
    """The frames stack as ``(b, t, h, w, c)`` in memory from channels_last
    inputs and as ``(b, t, c, h, w)`` from NCHW ones, with equal values up
    to the convs' summation order."""
    model = _model().eval()
    g = torch.Generator().manual_seed(5)
    x = torch.rand(1, model.cfg.img_chn, H, W, generator=g)
    ev = torch.randn(1, 3, 2, H, W, generator=g)
    with torch.no_grad():
        want = model(x, ev)
        model.to(memory_format=CL)
        got = model(x.contiguous(memory_format=CL),
                    ev.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3))
    assert want.is_contiguous()
    assert got.shape == want.shape and got.permute(0, 1, 3, 4, 2).is_contiguous()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["blur", "sharp"])
def test_channels_last_pipeline_equals_nchw(kind):
    model = _model(kind)
    request = _request(2)
    got = _pipeline(kind, model)(*request)
    want = served_nchw(_pipeline(kind, model))(*request)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("mode", [True, "static"])
def test_int8_pipelines_stay_nchw_on_the_plain_c8_path(mode, monkeypatch):
    """The network gets NCHW inputs and weights, and its int8 sites run the
    plain version of C8 (which reads ``(n, h, w, c)`` int8 that Q8 packs
    from its NCHW input)."""
    model = _model()
    _pipeline("blur", model)                 # a float pipeline converts the module first
    pipe = _pipeline("blur", model, int8=mode)
    assert not pipe.channels_last
    assert all(p.is_contiguous() for p in model.parameters())
    if mode == "static":
        pipe.calibrate(*_request(4))
    inputs, packed = [], []
    conv_int8_packed = quant.conv_int8_packed

    def plain_c8(xq, *args, **kw):
        packed.append(xq.device.type)
        return conv_int8_packed(xq, *args, **kw)

    monkeypatch.setattr(quant, "conv_int8_packed", plain_c8)
    handle = model.register_forward_pre_hook(
        lambda module, args: inputs.append([a.is_contiguous() for a in args[:2]]))
    hooks = _ConvInputs(model)
    out = pipe(*_request(1))
    hooks.remove()
    handle.remove()
    assert inputs == [[True, True]]
    assert [c[3] for c in hooks.calls if c[0] == "head_img.conv2d"] == [True]
    assert packed and set(packed) == {"cpu"}
    assert out.shape == (2 * M + N, H, W, 3)


@pytest.mark.parametrize("mode", [True, "static"])
def test_int8_result_does_not_depend_on_an_earlier_float_pipeline(mode):
    """A module converted to channels_last by a float pipeline, then served
    by an int8 pipeline, gives the int8 result of a module never
    converted."""
    request = _request(6)
    outs = []
    for converted in (False, True):
        model = _model()
        if converted:
            _pipeline("blur", model)(*request)
        pipe = _pipeline("blur", model, int8=mode)
        if mode == "static":
            pipe.calibrate(*_request(7))
        outs.append(pipe(*request))
    assert torch.equal(outs[0], outs[1])
