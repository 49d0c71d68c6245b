"""The pre-norm kernel (``csrc/prenorm.cu``, wrapper ``ops/prenorm.py``) on
the card, against its plain version ``prenorm_reference`` (the bf16 add,
then ``F.layer_norm`` in float32, cast to bf16, channels_last) and the eager
add: at Restormer's five pre-norm shapes in each mode (the norm alone, the
add of an NCHW or a channels_last residual and the norm, the add alone),
``s`` is the eager bf16 add bit for bit with its strides, and ``y`` is
within one bf16 step of the plain version, channels_last; edge shapes (an
odd plane, ragged last tiles, two images, a channels_last stream, 8 to
512 channels); operands and widths the kernel does not take raise; a 720p Restormer call launches it 96
times (88 pre-norms, 8 stage ends) and answers as the eager path does
within bf16 rounding.

The CPU side (the rule, the eager path bit for bit, the spans) is in
``tests/test_torch_restormer.py``.  The ``gpu`` marker: a CUDA kernel has no
CPU mode, so these skip without a CUDA device.  On the GPU machine:
``python -m pytest tests/test_torch_prenorm.py -m gpu --noconftest``.
"""

import json

import pytest
import torch

from portbench.drivers.restormer_serve import restormer_state
from portbench.harness import ROOT
from refid_tpu_torch.models.restormer import Restormer
from refid_tpu_torch.ops import prenorm

EPS = 1e-5
SHAPES = [(1, 48, 720, 1280), (1, 96, 720, 1280), (1, 96, 360, 640), (1, 192, 180, 320),
          (1, 384, 90, 160)]
SHAPE_IDS = ["48x720p", "96x720p", "96x360p", "192x180p", "384x90p"]
# the residual: none (the first norm of a stage), NCHW (norm2: MDTA's
# output), channels_last (norm1: the last FFN's output); "add": the add alone
MODES = ["none", "nchw", "cl", "add"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(shape, seed, device, layout="nchw", scale=1.0, shift=0.0):
    gen = torch.Generator(device).manual_seed(seed)
    t = (torch.randn(shape, generator=gen, device=device) * scale + shift).bfloat16()
    return t.contiguous(memory_format=torch.channels_last) if layout == "cl" else t


def _params(c, device, seed=7):
    gen = torch.Generator(device).manual_seed(seed)
    return (1 + 0.1 * torch.randn(c, generator=gen, device=device),
            0.1 * torch.randn(c, generator=gen, device=device))


def _within_one_step(got, want, bias):
    """Whether every element of bf16 ``got`` is within one bf16 step of
    ``want``'s, and the share that differs.  The step is taken at the
    largest of the two values and the channel's bias: ``y = x_hat w + b``
    is a float32 sum, and where its two terms cancel (a ``y`` of 1e-6 from
    terms of 0.1) either float32 evaluation is off by a float32 step of the
    terms, many bf16 steps of the tiny result."""
    g, w = got.float(), want.float()
    m = torch.maximum(torch.maximum(g.abs(), w.abs()), bias.abs().view(1, -1, 1, 1))
    m = m.clamp_min(torch.finfo(torch.bfloat16).tiny)
    step = torch.ldexp(torch.ones_like(m), torch.frexp(m).exponent - 8)
    return bool(((g - w).abs() <= step).all()), float((g != w).float().mean())


def _check(x, r, mode, w, b, record):
    before = prenorm.LAUNCHES
    if mode == "add":
        with torch.inference_mode():
            s = prenorm.residual_add(x, r)
        y = None
    else:
        s, y = prenorm.prenorm(x, r, w, b, EPS)
    torch.cuda.synchronize()
    assert prenorm.LAUNCHES == before + 1
    want_s = x if r is None else x + r
    if r is None:
        assert s is x
    assert s.stride() == want_s.stride()
    assert torch.equal(s.view(torch.int16), want_s.view(torch.int16))
    if y is None:
        return
    _, want_y = prenorm.prenorm_reference(x, r, w, b, EPS)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    close, differ = _within_one_step(y, want_y, b)
    record("y_differ_share", differ)
    assert close, f"y beyond one bf16 step of the plain version ({differ:.2e} differ)"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_kernel_at_the_networks_shapes(cuda, shape, mode, record_property):
    x = _bf16(shape, 1, cuda, scale=2.0, shift=0.5)
    r = None if mode == "none" else _bf16(shape, 2, cuda, "nchw" if mode == "nchw" else "cl")
    _check(x, r, mode, *_params(shape[1], cuda), record_property)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,x_layout", [
    ((1, 16, 5, 7), "nchw"),          # a plane of 35 pixels: masked 2-byte accesses
    ((2, 32, 9, 15), "nchw"),         # two images, ragged last tiles
    ((2, 64, 16, 24), "cl"),          # a channels_last stream
    ((1, 8, 12, 12), "nchw"),
    ((1, 512, 8, 24), "nchw"),     # the widest: 64 groups, 2 a warp
    ((1, 40, 11, 13), "cl"),
])
def test_kernel_at_edge_shapes(cuda, shape, x_layout, mode, record_property):
    x = _bf16(shape, 3, cuda, x_layout, scale=3.0, shift=-1.0)
    r = None if mode == "none" else _bf16(shape, 4, cuda, "nchw" if mode == "nchw" else "cl")
    _check(x, r, mode, *_params(shape[1], cuda, 8), record_property)


@pytest.mark.gpu
def test_specials_and_a_constant_pixel(cuda):
    """Ties of the add, a pixel whose channels are all equal (variance 0),
    and infinities, which the eager add and the plain norm carry as NaN or
    inf alike."""
    x = _bf16((1, 96, 16, 32), 5, cuda)
    r = _bf16((1, 96, 16, 32), 6, cuda)
    x[0, :, 0, 0] = 1.5
    r[0, :, 0, 0] = 0.0
    x.view(-1)[3::101] = 1.0
    r.view(-1)[3::101] = 2.0 ** -8                       # 1 + 2^-8: a bf16 tie
    x[0, 5, 3, 4] = float("inf")
    s, y = prenorm.prenorm(x, r, *_params(96, cuda), EPS)
    _, want_y = prenorm.prenorm_reference(x, r, *_params(96, cuda), EPS)
    assert torch.equal(s.view(torch.int16), (x + r).view(torch.int16))
    assert torch.equal(y.isnan(), want_y.isnan())
    finite = want_y.isfinite()
    bias = _params(96, cuda)[1]
    assert _within_one_step(y.where(finite, 0.0), want_y.where(finite, 0.0), bias)[0]


@pytest.mark.gpu
def test_operands_the_kernel_does_not_take_raise(cuda):
    x = _bf16((1, 48, 8, 8), 1, cuda)
    for bad, residual in [(x.float(), None), (x.cpu(), None), (x[:, :, :, :4], None),
                          (x, x.float()), (x, x[:, :, :4].contiguous()),
                          (x, x.transpose(2, 3))]:
        c = bad.shape[1]
        with pytest.raises(ValueError, match="pre-norm kernel takes"):
            prenorm.prenorm(bad, residual, torch.ones(c, device=cuda),
                            torch.zeros(c, device=cuda), EPS)
    # widths: not a multiple of 8; past 512; 35 groups of 8, which 2 a warp
    # do not split.  The launcher refuses them, before any launch.
    before = prenorm.LAUNCHES
    for c in (12, 520, 280):
        with pytest.raises(RuntimeError, match="invalid argument"):
            prenorm.prenorm(_bf16((1, c, 2, 8), 1, cuda), None, torch.ones(c, device=cuda),
                            torch.zeros(c, device=cuda), EPS)
    assert prenorm.LAUNCHES == before
    with pytest.raises(ValueError, match="do not match"):
        prenorm.prenorm(x, None, torch.ones(8, device=cuda), torch.zeros(8, device=cuda), EPS)


@pytest.mark.gpu
def test_a_720p_call_launches_96_times_and_answers_as_the_eager_path(cuda, monkeypatch):
    """The benchmark's Restormer (dim 48, seeded weights) on one 720p image
    under ``inference_mode``: 88 pre-norms and 8 stage ends on the kernel,
    and an answer within the bf16 rounding of the eager path's (the two
    round the norm's output at the same point, from float32 statistics)."""
    config = json.loads((ROOT / "configs" / "restormer_dim48.json").read_text())
    net = Restormer(inp_channels=9, dtype=torch.bfloat16).to(cuda).eval()
    net.load_state_dict(restormer_state(config, 26, cuda))
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.rand(1, 3, 720, 1280, generator=gen, device=cuda)
    event = torch.randn(1, 6, 720, 1280, generator=gen, device=cuda)
    with torch.inference_mode():
        before = prenorm.LAUNCHES
        got = net(x, event)
        assert prenorm.LAUNCHES - before == 96
        with monkeypatch.context() as m:
            m.setattr(prenorm, "engages", lambda x: False)
            want = net(x, event)
            assert prenorm.LAUNCHES - before == 96
    network = want - x
    rel = float((got - want).square().mean().sqrt() / network.square().mean().sqrt())
    assert rel < 0.02, rel
