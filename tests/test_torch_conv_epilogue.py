"""The conv layer's entry point (``ops/conv_epilogue.py::biased_conv``) and
the epilogue kernel (``csrc/conv_epilogue.cu``).

On the CPU, and wherever gradients are recorded, the entry point runs the
ops the modules ran before it existed (the conv with its bias, then
PyTorch's activation), bit for bit: the blocks are held against those ops
written out.  With the entry point's rule and kernel replaced by CPU
stand-ins, the spans ``refid.conv`` / ``refid.conv.epilogue`` nest as the
reader ``conv_epilogue_share.vfi`` reads them.

The card tests (``gpu`` marker: a CUDA kernel has no CPU mode, so they skip
without a CUDA device) hold the kernel against the eager chain
(:func:`epilogue_reference`) bit for bit, over layouts, dtypes, channel
counts, planes and activations, and whole served calls (a bf16 and an int8
static VFI window, an EVHINet and an EFNet image) against the same calls
with the entry point held on the eager path.  On the GPU machine:
``python -m pytest tests/test_torch_conv_epilogue.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.harness import ROOT, load_module
from portbench.trace import from_profiler
from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.models import FinalBidirectionAttenfusion
from refid_tpu_torch.models.evhinet import HINConvBlock
from refid_tpu_torch.models.layers import (
    ConvLayer, ConvResidualBlocks, ImageEncoderConvBlock, ResidualBlock, ResidualBlockNoBN,
    SELayer, conv_transpose_up,
)
from refid_tpu_torch.models.recurrent import RecurrentEncoderStage, UpsampleConvLayer
from refid_tpu_torch.ops import conv_epilogue as ce
from refid_tpu_torch.parallel.spatial import HaloConv2d

torch.set_num_threads(1)

ACTS = [None, "relu", 0.2, 0.1, (0.2, 0.2)]
ACT_IDS = ["none", "relu", "leaky0.2", "leaky0.1", "leaky0.2x2"]


def _eager(y, act):
    """The activations as the modules applied them before the entry point."""
    if act == "relu":
        return F.relu(y)
    for slope in () if act is None else (act,) if isinstance(act, float) else act:
        y = F.leaky_relu(y, slope)
    return y


def _x(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _filled(module, seed=1):
    """``module`` with every parameter drawn (zero-initialised biases too)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    return module.eval()


# ---- the CPU: the entry point falls back ----

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
def test_conv_falls_back_to_todays_ops(act, grad):
    conv = _filled(HaloConv2d(8, 16, 3, 1, 1))
    up = _filled(conv_transpose_up(8, 4))
    x = _x(1, 8, 10, 12)
    before = ce.LAUNCHES
    with torch.set_grad_enabled(grad):
        assert not ce.engages(conv, x) and not ce.engages(up, x)
        got, got_up = conv(x, act=act), up(x, act=act)
        want = _eager(F.conv2d(x, conv.weight, conv.bias, 1, 1), act)
        want_up = _eager(F.conv_transpose2d(x, up.weight, up.bias, 2), act)
    assert torch.equal(got, want) and torch.equal(got_up, want_up)
    assert ce.LAUNCHES == before
    if grad:
        got.sum().backward()
        assert conv.weight.grad is not None and conv.bias.grad is not None


def _blocks():
    """(name, module, input, the block's forward as it was written before
    the entry point)."""
    x8, x16 = _x(1, 8, 12, 16, seed=2), _x(1, 16, 12, 16, seed=3)

    def c(conv, x):
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding, 1, conv.groups)

    def hin(m, x):
        out = c(m.conv_1, x)
        if m.norm is not None:
            half = m.norm.weight.shape[0]
            h1 = out[:, :half]
            mu = h1.mean((2, 3), keepdim=True)
            var = (h1 - mu).square().mean((2, 3), keepdim=True)
            h1 = ((h1 - mu) * torch.rsqrt(var + 1e-5) * m.norm.weight.view(1, -1, 1, 1)
                  + m.norm.bias.view(1, -1, 1, 1))
            out = torch.cat([h1, out[:, half:]], 1)
        out = F.leaky_relu(out, 0.2)
        out = F.leaky_relu(c(m.conv_2, out), 0.2)
        return out + c(m.identity, x)

    return [
        ("conv_layer", ConvLayer(8, 16, 3, 1, 1, 0.2), x8,
         lambda m, x: F.leaky_relu(c(m.conv2d, x), 0.2)),
        ("conv_layer_plain", ConvLayer(8, 16, 3, 1, 1, None), x8, lambda m, x: c(m.conv2d, x)),
        ("image_encoder", ImageEncoderConvBlock(8, 16), x8,
         lambda m, x: c(m.down, F.leaky_relu(c(m.conv_2, F.leaky_relu(c(m.conv_1, x), 0.2)),
                                             0.2) + c(m.identity, x))),
        ("residual", ResidualBlock(16), x16,
         lambda m, x: F.relu(c(m.conv2, F.relu(c(m.conv1, x))) + x)),
        ("residual_nobn", ResidualBlockNoBN(16), x16,
         lambda m, x: x + c(m.conv2, F.relu(c(m.conv1, x)))),
        ("conv_residual", ConvResidualBlocks(8, 16, 2), x8,
         lambda m, x: m.main[2][1](m.main[2][0](F.leaky_relu(c(m.main[0], x), 0.1)))),
        ("se", SELayer(16, 8, 16), x16,
         lambda m, x: torch.sigmoid(c(m[3], F.relu(c(m[1], F.adaptive_avg_pool2d(x, 1)))))),
        ("stage_first_conv", RecurrentEncoderStage(8, 16), x8,     # ConvLayer's, the stage's
         lambda m, x: F.leaky_relu(F.leaky_relu(c(m.conv.conv2d, x), 0.2), 0.2)),
        ("upsample_conv", UpsampleConvLayer(8, 4), x8,
         lambda m, x: F.relu(c(m.conv2d, F.interpolate(x, scale_factor=2, mode="bilinear",
                                                       align_corners=False)))),
        ("hin_block", HINConvBlock(8, 16, False), x8, hin),
        ("hin_block_plain", HINConvBlock(8, 16, False, use_hin=False), x8, hin),
    ]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("case", range(len(_blocks())),
                         ids=[b[0] for b in _blocks()])
def test_blocks_compute_what_they_computed_before(case, grad):
    """Each block whose activation now goes to its conv's entry point,
    against its forward as written before, on the CPU."""
    name, block, x, before = _blocks()[case]
    block = _filled(block, seed=case)
    with torch.set_grad_enabled(grad):
        if name == "stage_first_conv":
            got = block._first_conv(x, None)
        elif name == "upsample_conv":           # (output, the state passed through)
            got = block(x)[0]
        else:
            got = block(x)
        want = before(block, x)
    assert torch.equal(got, want)


def test_the_rule_reads_only_tensors_and_grad_mode():
    """The kernel takes 4-D float32 / bfloat16 CUDA tensors, contiguous or
    channels_last, with at most two activation steps; on the CPU nothing
    engages."""
    x = _x(2, 8, 5, 7)
    conv = HaloConv2d(8, 8, 3, 1, 1)
    with torch.no_grad():
        assert not ce.engages(conv, x)
    # PyTorch's backend choice, kept per module by the input's and weight's dtype and format
    assert not ce._cudnn_adds_bias(conv, x)
    assert len(conv.cudnn_choice) == 1
    ce._cudnn_adds_bias(conv, x.contiguous(memory_format=torch.channels_last))
    ce._cudnn_adds_bias(conv, x.double())
    assert len(conv.cudnn_choice) == 3
    assert conv_transpose_up(8, 4).cudnn_choice == {}
    # an input of 2**31 elements or more is not asked about, and not kept
    huge = torch.zeros(1, 1, 1, 1).expand(1, 8, 2 ** 14, 2 ** 14)
    assert not ce._cudnn_adds_bias(conv, huge)
    assert len(conv.cudnn_choice) == 3
    assert ce._kernel_args(x, None) is None
    assert ce._run(x) == 35
    assert ce._run(x.contiguous(memory_format=torch.channels_last)) == 1
    assert ce._run(x.transpose(2, 3)) is None
    assert ce._act_args(None) == (0, 0.0, 0.0)
    assert ce._act_args("relu") == (1, 0.0, 0.0)
    assert ce._act_args(0.1) == (2, 0.1, 0.0)
    assert ce._act_args((0.2, 0.1)) == (3, 0.2, 0.1)
    assert ce._act_args((0.2, 0.2, 0.2)) is None
    with pytest.raises(ValueError, match="takes"):
        ce.conv_epilogue_(x, torch.zeros(8), None)


def test_an_engaged_conv_the_kernel_cannot_finish_raises(monkeypatch):
    """Where the rule engages, the kernel finishes the output or the call
    raises: no engaged conv ends in the plain version (here a CPU output,
    which the kernel does not take)."""
    conv = _filled(HaloConv2d(8, 8, 3, 1, 1))
    monkeypatch.setattr(ce, "engages", lambda module, x: True)
    with torch.no_grad(), pytest.raises(ValueError, match="takes"):
        conv(_x(1, 8, 6, 6), act=0.2)


@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
def test_plain_version_is_the_eager_chain(act):
    """``epilogue_reference``: the cuDNN backend's add (the bias cast to
    the output dtype, as autocast casts it), then the activation."""
    y = _x(1, 16, 6, 8).bfloat16()
    bias = _x(16, seed=4)
    want = _eager(y + bias.bfloat16().view(1, -1, 1, 1), act)
    assert torch.equal(ce.epilogue_reference(y.clone(), bias, act), want)


# ---- the spans, as the reader reads them ----

H = W = 32
M, N = 2, 1
TOY = dict(img_chn=8, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
SHARE = load_module(ROOT / "metrics" / "conv_epilogue_share.vfi.py")


def _request(seed):
    rng = np.random.RandomState(seed)
    n = 800
    ev = np.stack([np.sort(rng.rand(n)), rng.randint(0, W, n), rng.randint(0, H, n),
                   rng.randint(0, 2, n)], 1).astype(np.float32)
    return rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32), ev


def _traced_share(pipe, request):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            out = pipe(*request)
    trace = from_profiler(prof, "portbench.window", 1)
    return out, SHARE.read(type("Run", (), {"trace": trace})), trace


def test_spans_nest_as_the_metric_reads_them(monkeypatch):
    """A toy window: every biased conv opens ``refid.conv`` inside the
    network span.  On the CPU none finishes in the epilogue (the share reads
    0); with the rule and the kernel replaced by CPU stand-ins (the plain
    version in the kernel's place), every one does, its
    ``refid.conv.epilogue`` inside its ``refid.conv`` (100)."""
    torch.manual_seed(17)
    model = FinalBidirectionAttenfusion(RefidConfig(**TOY)).eval()
    pipe = BlurVFIPipeline(model, model.cfg, m=M, n=N, device="cpu")
    request = _request(1)
    plain, share, trace = _traced_share(pipe, request)
    convs = [s for s in trace.host_ops if s[0] == "refid.conv"]
    assert convs and share == 0.0
    assert not any(s[0] == "refid.conv.epilogue" for s in trace.host_ops)

    launched = []
    monkeypatch.setattr(ce, "engages", lambda module, x: not torch.is_grad_enabled())
    monkeypatch.setattr(ce, "conv_epilogue_", lambda y, bias, act: launched.append(1)
                        or ce.epilogue_reference(y, bias, act))
    out, share, trace = _traced_share(pipe, request)
    assert share == 100.0
    epilogues = [s for s in trace.host_ops if s[0] == "refid.conv.epilogue"]
    assert len(epilogues) == len(launched) == len(convs)
    # the conv without its bias and the bias added after it round differently on the CPU
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)


# ---- the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _output(shape, dtype, layout, device, seed, specials=True):
    """A conv-output-like tensor with ties, signed zeros and infinities."""
    gen = torch.Generator(device).manual_seed(seed)
    y = torch.randn(shape, generator=gen, device=device) * 3
    if specials:
        flat = y.view(-1)
        flat[::97] = -0.0
        flat[5::101] = float("inf")
        flat[7::103] = -float("inf")
        flat[11::89] = 1.0 + 2.0 ** -8          # a bf16 tie
    y = y.to(dtype)
    return y.contiguous(memory_format=torch.channels_last) if layout == "cl" else y


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("channels", [2, 3, 32, 64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("hw", [(7, 9), (16, 24)], ids=["odd_plane", "even_plane"])
def test_kernel_matches_eager_chain(cuda, layout, dtype, channels, act, hw):
    y = _output((2, channels) + hw, dtype, layout, cuda, channels)
    bias = torch.randn(channels, generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    want = ce.epilogue_reference(y.clone(), bias, act)
    got = y.clone()
    before = ce.LAUNCHES
    assert ce.conv_epilogue_(got, bias, act) is got
    assert ce.LAUNCHES == before + 1
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
def test_kernel_on_nans(cuda, act):
    y = _output((1, 64, 9, 11), torch.bfloat16, "cl", cuda, 3)
    y[:, 3::7, ::2, 1::3] = float("nan")
    bias = torch.randn(64, device=cuda)
    want = ce.epilogue_reference(y.clone(), bias, act)
    got = ce.conv_epilogue_(y.clone(), bias, act)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(_bits(got.nan_to_num(0.0)), _bits(want.nan_to_num(0.0)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,layout,dtype,act", [
    ((1, 64, 720, 1280), "cl", torch.bfloat16, 0.2),
    ((1, 128, 360, 640), "cl", torch.bfloat16, "relu"),
    ((1, 3, 720, 1280), "cl", torch.bfloat16, None),
    ((1, 64, 720, 1280), "nchw", torch.bfloat16, 0.2),
    ((1, 256, 180, 320), "nchw", torch.float32, (0.2, 0.2)),
])
def test_kernel_at_production_shapes(cuda, shape, layout, dtype, act):
    y = _output(shape, dtype, layout, cuda, 5, specials=False)
    bias = torch.randn(shape[1], device=cuda)
    want = ce.epilogue_reference(y.clone(), bias, act)
    assert torch.equal(_bits(ce.conv_epilogue_(y.clone(), bias, act)), _bits(want))


@pytest.mark.gpu
def test_entry_point_engages_only_without_gradients(cuda, monkeypatch):
    """Under ``inference_mode`` a cuDNN conv (NCHW and channels_last, bf16
    autocast and float32, the transposed conv) finishes in one launch,
    equal to the eager path; with gradients on, or where PyTorch's own
    backend fuses the bias (an NCHW depthwise conv), nothing launches."""
    conv = _filled(HaloConv2d(32, 64, 3, 1, 1)).to(cuda)
    depthwise = _filled(HaloConv2d(32, 32, 3, 1, 1, groups=32)).to(cuda)
    up = _filled(conv_transpose_up(32, 16)).to(cuda)
    x = torch.randn(1, 32, 40, 56, device=cuda)

    def run(module, x, act, autocast):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            return module(x, act=act)

    for fmt in (torch.contiguous_format, torch.channels_last):
        xf = x.contiguous(memory_format=fmt)
        for module in (conv.to(memory_format=fmt), up):
            for autocast in (False, True):
                with torch.inference_mode():
                    before = ce.LAUNCHES
                    got = run(module, xf, 0.2, autocast)
                    assert ce.LAUNCHES == before + 1
                    with monkeypatch.context() as m:
                        m.setattr(ce, "engages", lambda module, x: False)
                        want = run(module, xf, 0.2, autocast)
                assert torch.equal(got, want)
                before = ce.LAUNCHES
                with torch.enable_grad():
                    run(module, xf, 0.2, autocast)
                assert ce.LAUNCHES == before
    with torch.inference_mode():
        before = ce.LAUNCHES
        with torch.autocast("cuda", dtype=torch.bfloat16):
            depthwise(x)
        assert ce.LAUNCHES == before


def _eager_and_epilogue(monkeypatch, call):
    """``call()`` twice on the eager path, then once through the epilogue."""
    with monkeypatch.context() as m:
        m.setattr(ce, "engages", lambda module, x: False)
        first, second = call(), call()
    before = ce.LAUNCHES
    got = call()
    return first, second, got, ce.LAUNCHES - before


def _vfi_request(seed, h=720, w=1280, n=1 << 20):
    rng = np.random.RandomState(seed)
    ev = np.stack([np.sort(rng.uniform(0, 5e4, n)), rng.randint(0, w, n),
                   rng.randint(0, h, n), rng.randint(0, 2, n)], 1).astype(np.float32)
    return rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32), ev


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, "static"], ids=["bf16", "int8_static"])
def test_served_vfi_window_equals_the_eager_path(cuda, monkeypatch, int8):
    """A 720p window (m = 11, n = 1, t = 23) of the flagship in bf16, float
    (channels_last) or int8 static (NCHW): the network call on one packed
    input, bit for bit."""
    torch.manual_seed(0)
    cfg = RefidConfig(dtype=torch.bfloat16)
    pipe = BlurVFIPipeline(FinalBidirectionAttenfusion(cfg), cfg, m=11, n=1, int8=int8,
                           device=cuda)
    if int8:
        pipe.calibrate(*_vfi_request(1))
    with torch.inference_mode():
        lq, pairs = pipe._pack(*_vfi_request(2), None, pipe.channels_last)
        first, second, got, launches = _eager_and_epilogue(
            monkeypatch, lambda: pipe.served(lq, pairs))
    assert torch.equal(first, second)           # the eager path repeats itself
    assert launches > 0
    assert torch.equal(got, first)


@pytest.mark.gpu
@pytest.mark.parametrize("network", ["SingleMultiConnectEVHINet", "EFNet"])
def test_served_deblur_image_equals_the_eager_path(cuda, monkeypatch, network):
    """A 720p image through the single-image task (bf16 autocast, NCHW)."""
    from refid_tpu_torch.tasks import build_task

    torch.manual_seed(0)
    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {},
                       "network_g": {"type": network, "in_chn": 3, "ev_chn": 6, "wf": 64,
                                     "compute_dtype": "bfloat16"}}, "cuda")
    rng = np.random.RandomState(3)
    lq = rng.rand(1, 720, 1280, 3).astype(np.float32)
    vox = rng.randn(1, 720, 1280, 6).astype(np.float32)
    first, second, got, launches = _eager_and_epilogue(
        monkeypatch, lambda: task.predict_tensor(lq, vox))
    assert torch.equal(first, second)
    assert launches > 0
    assert torch.equal(got, first)
