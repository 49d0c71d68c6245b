"""The ablation lineages' building blocks against refid_tpu (CPU, f32): the
modulated deformable conv, the recurrent cells, encoder stages and decoders
of every lineage, the siamese fusion, ``arch_util`` and the DCN first conv
in whole networks."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import flax.linen as fnn

from refid_tpu.models import arch_util as jau
from refid_tpu.models import fusion as jfusion
from refid_tpu.models import recurrent as jrec
from refid_tpu.ops import deform_conv as jdcn
from refid_tpu_torch.models import arch_util, convert, fusion, recurrent
from refid_tpu_torch.ops import deform_conv
from tests.test_torch_helpers import (
    ablation_opt, build_ablation, max_diff, random_params, to_nchw, to_nhwc,
)

torch.set_num_threads(1)
TOL = 2e-5


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _port_state(mapping, params):
    state = {}
    src = convert.flatten_params(params)
    mapping(state, src)
    assert not src, sorted(src)     # every JAX leaf has a port counterpart
    return state


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module


# --- the deformable conv --------------------------------------------------------

@pytest.mark.parametrize("k,stride,padding,dilation", [(3, 1, 1, 1), (5, 2, 2, 1), (3, 1, 2, 2)])
def test_deform_conv2d_matches_jax(k, stride, padding, dilation):
    """Offsets of a few pixels: samples off the grid and outside the frame."""
    b, cin, cout, h, w = 2, 3, 4, 9, 11
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x, weight, bias, offset, mask = _inputs(0, (b, cin, h, w), (cout, cin, k, k), (cout,),
                                            (b, 2 * k * k, ho, wo), (b, k * k, ho, wo))
    offset *= 2.5
    mask = 1 / (1 + np.exp(-mask))
    got = deform_conv.deform_conv2d(_t(x), _t(offset), _t(weight), _t(bias), _t(mask),
                                    stride, padding, dilation)
    want = jdcn.deform_conv2d(to_nhwc(x), to_nhwc(offset),
                              jnp.asarray(np.transpose(weight, (2, 3, 1, 0))), bias,
                              to_nhwc(mask), stride, padding, dilation)
    assert got.shape == (b, cout, ho, wo)
    assert max_diff(got, to_nchw(want)) < 1e-5


def test_deform_conv2d_zero_offset_is_conv():
    x, weight = _inputs(1, (1, 4, 10, 12), (6, 4, 3, 3))
    got = deform_conv.deform_conv2d(_t(x), torch.zeros(1, 18, 10, 12), _t(weight))
    torch.testing.assert_close(got, F.conv2d(_t(x), _t(weight), padding=1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_conv_pack_matches_jax(stride):
    (x,) = _inputs(2, (1, 4, 10, 12))
    jmod = jdcn.ModulatedDeformConvPack(6, 3, stride, 1)
    params = random_params(jmod, to_nhwc(x), seed=2)   # random offsets and masks

    def mapping(dst, src):
        convert._conv(dst, src, "conv_offset.", "conv_offset/")
        convert._conv(dst, src, "", "")

    tmod = _load(deform_conv.ModulatedDeformConvPack(4, 6, 3, stride, 1),
                 _port_state(mapping, params))
    with torch.no_grad():
        got = tmod(_t(x))
    assert max_diff(got, to_nchw(jmod.apply(params, to_nhwc(x)))) < TOL


def test_modulated_deform_conv_pack_starts_as_half_conv():
    """Zero-initialised side conv: offsets 0, mask sigmoid(0) = 0.5."""
    torch.manual_seed(0)
    mod = deform_conv.ModulatedDeformConvPack(4, 6)
    (x,) = _inputs(3, (1, 4, 8, 8))
    with torch.no_grad():
        torch.testing.assert_close(mod(_t(x)), 0.5 * F.conv2d(_t(x), mod.weight, padding=1)
                                   + mod.bias.view(1, -1, 1, 1), rtol=1e-5, atol=1e-5)
    assert not mod.conv_offset.weight.any() and not mod.bias.any()


def test_modulated_deform_conv_gradients_reach_offsets():
    torch.manual_seed(0)
    mod = deform_conv.ModulatedDeformConvPack(3, 4)
    with torch.no_grad():
        mod.conv_offset.weight.normal_(0, 0.1)
    mod(torch.randn(1, 3, 8, 8)).square().sum().backward()
    assert mod.conv_offset.weight.grad.abs().sum() > 0
    assert mod.weight.grad.abs().sum() > 0


# --- recurrent cells, stages and decoders ---------------------------------------

def test_conv_gru_matches_jax():
    x, s = _inputs(4, (1, 6, 8, 12), (1, 6, 8, 12))
    jmod = jrec.ConvGRU(6)
    params = random_params(jmod, to_nhwc(x), to_nhwc(s))
    state = _port_state(lambda d, src: convert._cell(d, src, "", ""), params)
    tmod = _load(recurrent.ConvGRU(6, 6), state)
    with torch.no_grad():
        out, new = tmod(_t(x), _t(s))
    jout, jnew = jmod.apply(params, to_nhwc(x), to_nhwc(s))
    assert max_diff(out, to_nchw(jout)) < TOL and max_diff(new, to_nchw(jnew)) < TOL


def test_conv_lstm_matches_jax():
    """The 4*hidden gate conv splits in the JAX order (input, remember,
    output, cell); the state is (hidden, cell)."""
    x, h, c = _inputs(5, (1, 6, 8, 12), (1, 6, 8, 12), (1, 6, 8, 12))
    jmod = jrec.ConvLSTM(6)
    params = random_params(jmod, to_nhwc(x), (to_nhwc(h), to_nhwc(c)))
    state = _port_state(lambda d, src: convert._cell(d, src, "", ""), params)
    tmod = _load(recurrent.ConvLSTM(6, 6), state)
    with torch.no_grad():
        out, (nh, nc) = tmod(_t(x), (_t(h), _t(c)))
    jout, (jh, jc) = jmod.apply(params, to_nhwc(x), (to_nhwc(h), to_nhwc(c)))
    for a, b in ((out, jout), (nh, jh), (nc, jc)):
        assert max_diff(a, to_nchw(b)) < TOL


def test_conv_gru_init_is_orthogonal_with_zero_bias():
    torch.manual_seed(0)
    gru = recurrent.ConvGRU(4, 4)
    for name in ("reset_gate", "update_gate", "out_gate"):
        conv = getattr(gru, name)
        w = conv.weight.detach().reshape(4, -1)
        torch.testing.assert_close(w @ w.T, torch.eye(4), rtol=0, atol=1e-5)
        assert not conv.bias.any()


# (stage_type, cell, with image feature, bidirectional fuse, DCN)
STAGE_CASES = [
    ("conv_down", "simpleconv", False, False, False),
    ("conv_down", "simpleconv", True, True, False),
    ("conv_down", "simpleconv", True, False, True),
    ("conv_down", "convlstm", True, True, False),
    ("then_down", "convgru", True, True, False),
    ("then_down", "simpleconv", True, True, True),
    ("rec_conv", "convlstm", False, False, False),
    ("rec_conv", "convgru", True, False, False),
]


@pytest.mark.parametrize("stage_type,cell,with_image,bidir,dcn", STAGE_CASES,
                         ids=["-".join(str(v) for v in c) for c in STAGE_CASES])
def test_encoder_stage_lineages_match_jax(stage_type, cell, with_image, bidir, dcn):
    cin, cout, h, w = 4, 8, 8, 12
    sh, sw = (h, w) if stage_type == "then_down" else (h // 2, w // 2)
    x, y, s, c, bd, bc = _inputs(6, (1, cin, h, w), (1, cin, h, w), (1, cout, sh, sw),
                                 (1, cout, sh, sw), (1, cout, sh, sw), (1, cout, sh, sw))
    lstm = cell == "convlstm"
    state = (s, c) if lstm else s
    bstate = ((bd, bc) if lstm else bd) if bidir else None
    y = y if with_image else None

    def nhwc(v):
        if v is None:
            return None
        return tuple(to_nhwc(a) for a in v) if isinstance(v, tuple) else to_nhwc(v)

    def tt(v):
        if v is None:
            return None
        return tuple(_t(a) for a in v) if isinstance(v, tuple) else _t(v)

    kw = dict(fuse_two_direction=bidir, cell=cell, stage_type=stage_type, use_first_dcn=dcn)
    jmod = jrec.RecurrentEncoderStage(cin, cout, **kw)
    jargs = [to_nhwc(x), nhwc(y), nhwc(state), nhwc(bstate)]
    params = random_params(jmod, *jargs, seed=6)
    tmod = _load(recurrent.RecurrentEncoderStage(cin, cout, **kw),
                 _port_state(lambda d, src: convert._stage(d, src, "", ""), params))
    with torch.no_grad():
        out, new = tmod(_t(x), tt(y), tt(state), tt(bstate))
    jout, jnew = jmod.apply(params, *jargs)
    assert out.shape == (1, cout, h // 2, w // 2)
    assert max_diff(out, to_nchw(jout)) < TOL
    for a, b in zip(new if lstm else (new,), jnew if lstm else (jnew,)):
        assert a.shape == (1, cout, sh, sw)
        assert max_diff(a, to_nchw(b)) < TOL


def test_transpose_decoder_bidirectional_fuse_matches_jax():
    x, s, bd = _inputs(7, (1, 8, 4, 6), (1, 4, 8, 12), (1, 4, 8, 12))
    jmod = jrec.TransposeRecurrentConvLayer(4, num_block=1, fuse_two_direction=True)
    params = random_params(jmod, to_nhwc(x), to_nhwc(s), to_nhwc(bd))
    tmod = _load(recurrent.TransposeRecurrentConvLayer(8, 4, fuse_two_direction=True),
                 _port_state(lambda d, src: convert._decoder(d, src, "", ""), params))
    with torch.no_grad():
        out, _ = tmod(_t(x), _t(s), _t(bd))
    assert max_diff(out, to_nchw(jmod.apply(params, to_nhwc(x), to_nhwc(s),
                                            to_nhwc(bd))[0])) < TOL


def test_pixel_shuffle_decoder_matches_jax():
    """torch's channel order: out channel c draws input channel 4c + 2dy + dx."""
    x, s = _inputs(8, (1, 16, 4, 6), (1, 4, 8, 12))
    jmod = jrec.PixelShuffleRecurrentConvLayer(4, num_block=1)
    params = random_params(jmod, to_nhwc(x), to_nhwc(s))
    tmod = _load(recurrent.PixelShuffleRecurrentConvLayer(16, 4),
                 _port_state(lambda d, src: convert._decoder(d, src, "", ""), params))
    with torch.no_grad():
        out, new = tmod(_t(x), _t(s))
    assert max_diff(out, to_nchw(jmod.apply(params, to_nhwc(x), to_nhwc(s))[0])) < TOL
    assert new is out


def test_upsample_decoder_matches_jax_resize():
    """Bilinear x2 by F.interpolate (clamped edges) equals jax.image.resize
    (renormalised edge weights), then the k5 conv and ReLU; the state passes
    through."""
    x, s = _inputs(9, (1, 8, 5, 7), (1, 4, 10, 14))
    jmod = jrec.UpsampleConvLayer(4)
    params = random_params(jmod, to_nhwc(x))
    tmod = _load(recurrent.UpsampleConvLayer(8, 4),
                 _port_state(lambda d, src: convert._decoder(d, src, "", ""), params))
    with torch.no_grad():
        out, new = tmod(_t(x), _t(s))
    assert max_diff(out, to_nchw(jmod.apply(params, to_nhwc(x))[0])) < TOL
    assert new is not None and torch.equal(new, _t(s))
    up = F.interpolate(_t(x), scale_factor=2, mode="bilinear", align_corners=False)
    jup = jax.image.resize(to_nhwc(x), (1, 10, 14, 8), method="bilinear")
    assert max_diff(up, to_nchw(jup)) < 1e-6


def test_img_ev_fusion_matches_jax():
    ev, f0, f1 = _inputs(10, (2, 8, 6, 6), (2, 8, 6, 6), (2, 8, 6, 6))
    jmod = jfusion.ImgEvFusion(8)
    params = random_params(jmod, to_nhwc(ev), to_nhwc(f0), to_nhwc(f1))

    def mapping(dst, src):
        for g in ("se_0", "se_1"):
            convert._conv(dst, src, f"{g}.1.", f"{g}/")

    tmod = _load(fusion.ImgEvFusion(8), _port_state(mapping, params))
    with torch.no_grad():
        got = tmod(_t(ev), _t(f0), _t(f1))
    assert max_diff(got, to_nchw(jmod.apply(params, to_nhwc(ev), to_nhwc(f0),
                                            to_nhwc(f1)))) < TOL


# --- the DCN first conv in whole networks ---------------------------------------

# one stage type of each kind; rec_conv keeps its plain conv, as in JAX
DCN_CASES = [("UNetDecoderRecurrent", "simpleconv"),
             ("UNetDecoderRecurrent", "simpleconvThendown"),
             ("FinalBidirection", None),
             ("UNetRecurrent", "convgru")]


@pytest.mark.parametrize("name,rbt", DCN_CASES,
                         ids=[f"{n}-{r}" if r else n for n, r in DCN_CASES])
def test_first_dcn_network_matches_jax(name, rbt):
    """Random offsets and masks (the side conv filled like every other
    parameter), so the gather samples off the grid and outside the frame."""
    jnet, params, tnet = build_ablation(name, ablation_opt(rbt, use_first_dcn=True), seed=1)
    if tnet.cfg.encoder_stage != "rec_conv":
        assert any(k.endswith("conv_offset.weight") for k in tnet.state_dict())
    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 3, 16, 16).astype(np.float32)
    ev = rng.randn(1, 3, 2, 16, 16).astype(np.float32)
    with torch.no_grad():
        got = tnet.eval()(_t(x), _t(ev))
    assert max_diff(got, to_nchw(jnet.apply(params, to_nhwc(x), to_nhwc(ev)))) < 2e-4


# --- arch_util ------------------------------------------------------------------

def test_flow_warp_matches_jax():
    x, flow = _inputs(11, (2, 3, 8, 10), (2, 8, 10, 2))
    flow *= 3.0
    got = arch_util.flow_warp(_t(x), _t(flow))
    assert max_diff(got, to_nchw(jau.flow_warp(to_nhwc(x), jnp.asarray(flow)))) < 1e-5


@pytest.mark.parametrize("size_type,sizes", [("shape", (16, 20)), ("ratio", (0.5, 0.5)),
                                             ("shape", (6, 7))])
def test_resize_flow_matches_jax(size_type, sizes):
    (flow,) = _inputs(12, (1, 2, 8, 10))
    got = arch_util.resize_flow(_t(flow), size_type, sizes)
    want = jau.resize_flow(to_nhwc(flow), size_type, sizes)
    assert max_diff(got, to_nchw(want)) < 1e-5


def test_pixel_shuffle_functions_match_jax():
    (x,) = _inputs(13, (2, 4, 8, 6))
    down = arch_util.pixel_unshuffle(_t(x), 2)
    assert max_diff(down, to_nchw(jau.pixel_unshuffle(to_nhwc(x), 2))) == 0
    up = arch_util.pixel_shuffle(down, 2)
    assert torch.equal(up, _t(x))
    (y,) = _inputs(14, (1, 18, 3, 4))
    assert max_diff(arch_util.pixel_shuffle(_t(y), 3),
                    to_nchw(jau.pixel_shuffle(to_nhwc(y), 3))) == 0


def _dense(dst, src, t, f):
    dst[t + "weight"] = torch.from_numpy(np.array(src.pop(f + "kernel").T))
    if f + "bias" in src:
        dst[t + "bias"] = torch.from_numpy(np.array(src.pop(f + "bias")))


def test_eica_block_matches_jax():
    img, ev = _inputs(15, (1, 8, 6, 5), (1, 8, 6, 5))
    jmod = jau.EventImageChannelAttentionTransformerBlock(dim=8, num_heads=2)
    params = random_params(jmod, to_nhwc(img), to_nhwc(ev), seed=15)

    def mapping(dst, src):
        for n in ("norm1_image", "norm1_event", "norm2"):
            convert._norm(dst, src, f"{n}.", f"{n}/")
        for c in ("q", "k", "v", "project_out"):
            convert._conv(dst, src, f"attn.{c}.", f"attn/{c}/", bias=False)
        dst["attn.temperature"] = torch.from_numpy(np.array(src.pop("attn/temperature")))
        for fc in ("fc1", "fc2"):
            _dense(dst, src, f"{fc}.", f"{fc}/")

    tmod = _load(arch_util.EventImageChannelAttentionTransformerBlock(8, 2),
                 _port_state(mapping, params))
    with torch.no_grad():
        got = tmod(_t(img), _t(ev))
    assert max_diff(got, to_nchw(jmod.apply(params, to_nhwc(img), to_nhwc(ev)))) < TOL


class _TokenGrid(fnn.Module):
    """SpatialCrossAttention with its token grid's H and W bound (static
    under tracing)."""
    sr_ratio: int

    @fnn.compact
    def __call__(self, x, y):
        grid = (8, 8) if self.sr_ratio > 1 else (None, None)
        return jau.SpatialCrossAttention(dim=16, num_heads=4, sr_ratio=self.sr_ratio,
                                         name="attn")(x, y, *grid)


@pytest.mark.parametrize("sr_ratio", [1, 2])
def test_spatial_cross_attention_matches_jax(sr_ratio):
    x, y = _inputs(16, (1, 64, 16), (1, 64, 16))
    jmod = _TokenGrid(sr_ratio)
    params = random_params(jmod, jnp.asarray(x), jnp.asarray(y), seed=16)

    def mapping(dst, src):
        for n in ("q", "kv", "proj"):
            _dense(dst, src, f"{n}.", f"attn/{n}/")
        if sr_ratio > 1:
            convert._conv(dst, src, "sr.", "attn/sr/")
            convert._norm(dst, src, "norm.", "attn/norm/")

    tmod = _load(arch_util.SpatialCrossAttention(16, 4, sr_ratio=sr_ratio),
                 _port_state(mapping, params))
    with torch.no_grad():
        got = tmod(_t(x), _t(y), *((8, 8) if sr_ratio > 1 else ()))
    assert max_diff(got, jmod.apply(params, jnp.asarray(x), jnp.asarray(y))) < TOL
