"""Port layers, EGACA and recurrent stages against the flax modules (CPU, f32).

Each flax module gets random weights in every parameter; the port module
receives them through ``refid_tpu_torch.models.convert``'s mapping helpers,
the same ones ``state_dict_from_jax`` composes for the whole network.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn

from refid_tpu.models import fusion as jfusion
from refid_tpu.models import layers as jlayers
from refid_tpu.models import recurrent as jrec
from refid_tpu_torch.models import convert
from refid_tpu_torch.models import fusion, layers, recurrent
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig
from tests.test_torch_helpers import max_diff, random_params, to_nchw, to_nhwc

torch.set_num_threads(1)
TOL = 2e-5


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _run_port(module, state, *xs):
    convert.load_state(module, state)
    with torch.no_grad():
        out = module(*[None if x is None else torch.from_numpy(x) for x in xs])
    return out


class _Up(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return jlayers.conv_transpose_up(x, self.features, name="up")


def _conv_map(t, f, bias=True):
    return lambda dst, src: convert._conv(dst, src, t, f, bias)


def _resblock_map(dst, src):
    for c in ("conv1", "conv2"):
        convert._conv(dst, src, f"{c}.", f"{c}/")


def _se_map(dst, src):
    convert._conv(dst, src, "1.", "fc1/")
    convert._conv(dst, src, "3.", "fc2/")


# name -> (flax module, port module, mapping, input channels)
LAYER_CASES = {
    "conv_layer": (jlayers.ConvLayer(6, 5, 1, 2, 0.2),
                   layers.ConvLayer(4, 6, 5, 1, 2, 0.2),
                   _conv_map("conv2d.", "conv/"), 4),
    "conv_layer_plain": (jlayers.ConvLayer(3, 3, 1, 1, relu_slope=None),
                         layers.ConvLayer(4, 3, 3, 1, 1, relu_slope=None),
                         _conv_map("conv2d.", "conv/"), 4),
    "image_encoder_block": (jlayers.ImageEncoderConvBlock(8),
                            layers.ImageEncoderConvBlock(4, 8),
                            lambda d, s: convert._img_block(d, s, "", ""), 4),
    "residual_block": (jlayers.ResidualBlock(6), layers.ResidualBlock(6),
                       _resblock_map, 6),
    "residual_block_nobn": (jlayers.ResidualBlockNoBN(6),
                            layers.ResidualBlockNoBN(6), _resblock_map, 6),
    "conv_residual_blocks": (jlayers.ConvResidualBlocks(6, num_block=2),
                             layers.ConvResidualBlocks(10, 6, num_block=2),
                             lambda d, s: convert._trunk(d, s, "", ""), 10),
    "layer_norm_2d": (jlayers.LayerNorm2d(6), layers.LayerNorm2d(6),
                      lambda d, s: convert._norm(d, s, "", ""), 6),
    "se_layer": (jlayers.SELayer(3, 6), layers.SELayer(6, 3, 6), _se_map, 6),
    "conv_transpose_up": (_Up(5), layers.conv_transpose_up(6, 5),
                          _conv_map("", "up/"), 6),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_flax(name):
    jmod, tmod, mapping, cin = LAYER_CASES[name]
    (x,) = _inputs(1, (2, cin, 8, 12))
    params = random_params(jmod, to_nhwc(x))
    state = {}
    mapping(state, convert.flatten_params(params))
    tout = _run_port(tmod, state, x)
    jout = to_nchw(jmod.apply(params, to_nhwc(x)))
    assert max_diff(tout, jout) < TOL


@pytest.mark.parametrize("c,c_out", [(8, 16), (8, 8)])
def test_egaca_matches_flax(c, c_out):
    ev, img = _inputs(2, (2, c, 8, 12), (2, c, 8, 12))
    jmod = jfusion.CrossmodalAtten(c, c_out, all_add=True)
    params = random_params(jmod, to_nhwc(ev), to_nhwc(img))
    state = {}
    convert._atten(state, convert.flatten_params(params), "", "")
    tmod = fusion.CrossmodalAtten(c, c_out)
    missing, unexpected = tmod.load_state_dict(state, strict=False)
    assert not unexpected and all(k.startswith("se_2.") for k in missing)
    with torch.no_grad():
        tout = tmod(torch.from_numpy(ev), torch.from_numpy(img))
    jout = to_nchw(jmod.apply(params, to_nhwc(ev), to_nhwc(img)))
    assert max_diff(tout, jout) < TOL


def test_simple_recurrent_conv_matches_flax():
    x, s = _inputs(3, (1, 6, 8, 12), (1, 6, 8, 12))
    jmod = jrec.SimpleRecurrentConv(6, num_block=1)
    params = random_params(jmod, to_nhwc(x), to_nhwc(s))
    state = {}
    convert._trunk(state, convert.flatten_params(params), "forward_trunk.", "trunk/")
    tout, tstate = _run_port(recurrent.SimpleRecurrentConv(6), state, x, s)
    jout, jstate = jmod.apply(params, to_nhwc(x), to_nhwc(s))
    assert max_diff(tout, to_nchw(jout)) < TOL
    assert max_diff(tstate, to_nchw(jstate)) < TOL


@pytest.mark.parametrize("with_image,atten,bidir", [
    (False, False, False),   # scale 0, backward pass
    (False, False, True),    # scale 0, forward pass
    (True, False, True),     # an image-fused scale with the plain conv
    (True, True, False),     # EGACA scale, backward pass
    (True, True, True),      # EGACA scale, forward pass
])
def test_encoder_stage_matches_flax(with_image, atten, bidir):
    cin, cout = 4, 8
    x, y, s, b = _inputs(4, (1, cin, 8, 12), (1, cin, 8, 12),
                         (1, cout, 8, 12), (1, cout, 8, 12))
    y = y if with_image else None
    b = b if bidir else None
    jmod = jrec.RecurrentEncoderStage(cin, cout, use_atten_fuse=atten,
                                      fuse_two_direction=bidir)
    jargs = [to_nhwc(x), None if y is None else to_nhwc(y), to_nhwc(s),
             None if b is None else to_nhwc(b)]
    params = random_params(jmod, *jargs)
    state = {}
    convert._stage(state, convert.flatten_params(params), "", "")
    tmod = recurrent.RecurrentEncoderStage(cin, cout, use_atten_fuse=atten,
                                           fuse_two_direction=bidir)
    tout, tstate = _run_port(tmod, state, x, y, s, b)
    jout, jstate = jmod.apply(params, *jargs)
    assert tout.shape == (1, cout, 4, 6)
    assert max_diff(tout, to_nchw(jout)) < TOL
    assert max_diff(tstate, to_nchw(jstate)) < TOL


def test_transpose_decoder_matches_flax():
    x, s = _inputs(5, (1, 8, 4, 6), (1, 4, 8, 12))
    jmod = jrec.TransposeRecurrentConvLayer(4, num_block=1)
    params = random_params(jmod, to_nhwc(x), to_nhwc(s))
    state = {}
    convert._decoder(state, convert.flatten_params(params), "", "")
    tout, _ = _run_port(recurrent.TransposeRecurrentConvLayer(8, 4), state, x, s)
    jout, _ = jmod.apply(params, to_nhwc(x), to_nhwc(s))
    assert max_diff(tout, to_nchw(jout)) < TOL


# the configurations that the JAX network refuses, refused here with its
# reasons (the ids are the axes these cases pinned as unported before the
# ablation lineages were ported)
@pytest.mark.parametrize("build,reason", [
    (lambda: FinalBidirectionAttenfusion(RefidConfig(
        encoder_stage="rec_conv", recurrent_cell="convgru")),
     "rec_conv has no bidirectional-state fuse"),
    (lambda: FinalBidirectionAttenfusion(RefidConfig(
        encoder_stage="rec_conv", bidirectional=False)),
     "rec_conv stage is the ConvLSTM/ConvGRU lineage"),
    (lambda: FinalBidirectionAttenfusion(RefidConfig(
        bidir_decoder=True, aliased_backward_states=False)),
     "bidir_decoder replicates the aliased all-bidirection lineage"),
    (lambda: FinalBidirectionAttenfusion(RefidConfig(
        bidir_decoder=True, bidirectional=False)),
     "bidir_decoder replicates the aliased all-bidirection lineage"),
    (lambda: FinalBidirectionAttenfusion(RefidConfig(siamese_fusion="se")),
     "the siamese lineage is unidirectional"),
], ids=["convgru", "conv_down", "bidir_decoder", "unidirectional",
        "siamese"])
def test_unported_ablation_axes_raise(build, reason):
    with pytest.raises(ValueError, match=reason):
        build()


# --- default initialisation ---------------------------------------------------

def test_residual_block_nobn_init_matches_jax_statistics():
    """0.1-scaled kaiming-normal weights (variance 0.02 / fan_in) and zero
    biases, as the JAX block's ``residual_scaled_init``."""
    import jax
    import jax.numpy as jnp
    params = jlayers.ResidualBlockNoBN(64).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8, 8, 64)))["params"]
    torch.manual_seed(0)
    block = layers.ResidualBlockNoBN(64)
    for c in ("conv1", "conv2"):
        want = float(np.asarray(params[c]["kernel"]).std())
        got = float(getattr(block, c).weight.detach().std())
        assert abs(got - want) <= 0.1 * want, (c, got, want)
        assert not np.asarray(params[c]["bias"]).any()
        assert not getattr(block, c).bias.any()


def test_network_init_matches_jax_per_tensor():
    """Every parameter of the default-initialised port network against the
    JAX init (converted by ``state_dict_from_jax``), base 8: the std of each
    tensor, pooled over 32 draws a side, within 10 %."""
    import jax
    import jax.numpy as jnp
    from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
    from refid_tpu.models import RefidConfig as JaxConfig
    cfg = dict(img_chn=26, ev_chn=2, num_encoders=2, base_num_channels=8,
               num_residual_blocks=1)
    init = jax.jit(JaxNet(JaxConfig(**cfg)).init)
    lq, vox = jnp.zeros((1, 16, 16, 26)), jnp.zeros((1, 2, 16, 16, 2))
    jax_draws = [convert.state_dict_from_jax(init(jax.random.PRNGKey(k), lq, vox),
                                             RefidConfig(**cfg)) for k in range(32)]
    port_draws = []
    for k in range(32):
        torch.manual_seed(k)
        port_draws.append(FinalBidirectionAttenfusion(RefidConfig(**cfg)).state_dict())
    for key in jax_draws[0]:
        want = float(torch.stack([d[key] for d in jax_draws]).std())
        got = float(torch.stack([d[key] for d in port_draws]).std())
        assert abs(got - want) <= 0.1 * want, (key, got, want)
