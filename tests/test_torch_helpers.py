"""Shared helpers for the refid_tpu_torch parity tests, and their own checks.

The parity tests hand the same seeded numpy arrays to the JAX package and to
the port.  Random weights fill EVERY JAX parameter (EGACA's zero-init
``beta``/``gamma`` included, so the attention branch is exercised) and reach
the port through ``refid_tpu_torch.models.convert``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def random_params(module, *inputs, seed=0):
    """Shape-trace ``module.init`` (nothing compiles) and fill every leaf with
    a scaled normal: kernels at 1/sqrt(fan_in), LayerNorm scales near 1,
    everything else at 0.1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape)
        name = path[-1].key
        if name == "kernel":
            value = noise / math.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * noise
        else:
            value = 0.1 * noise
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# the ablation combinations: the 13 cases of tests/test_ablation_shapes.py
# (registry name x recurrent_block_type), UNetPSDecoderRecurrent/convgru of
# tests/test_ablation_parity.py and FinalBidirection; their toy widths
ABLATION_COMBOS = [
    ("UNetRecurrent", "convlstm"), ("UNetRecurrent", "convgru"),
    ("UNetDecoderRecurrent", "simpleconv"), ("UNetDecoderRecurrent", "simpleconvThendown"),
    ("UNetDecoderRecurrent", "convlstm"), ("UNetDecoderRecurrent", "convgru"),
    ("BidirUNetRecurrent", "simpleconv"),
    ("UNetDecoderRecurrentBidirection", "simpleconv"),
    ("UNetDecoderRecurrentBidirection", "simpleconvThendown"),
    ("UNetDecoderRecurrentAllBidirection", "simpleconvThendown"),
    ("UNetPSDecoderRecurrent", "convlstm"),
    ("UNetDecoderRecurrentSiameseImg", "simpleconvThendown"),
    ("UNetDecoderRecurrentSiameseImgNoAtten", "simpleconvThendown"),
    ("UNetPSDecoderRecurrent", "convgru"),
    ("FinalBidirection", None),
]
ABLATION_IDS = [f"{n}-{r}" if r else n for n, r in ABLATION_COMBOS]
ABLATION_KW = dict(img_chn=6, ev_chn=2, out_chn=3, num_encoders=2, base_num_channels=8,
                   num_residual_blocks=1, num_block=1)


def ablation_opt(rbt, **kw):
    """A ``network_g`` option dict at the toy widths."""
    opt = dict(ABLATION_KW, **kw)
    if rbt is not None:
        opt["recurrent_block_type"] = rbt
    return opt


def build_ablation(name, opt, seed=0, b=1, t=3, h=16, w=16):
    """The JAX network from ``refid_tpu``'s registry with every parameter
    random, and the port's from its registry with the same weights (through
    ``state_dict_from_jax``): (jax net, jax params, port net)."""
    from refid_tpu.core.registry import ARCHS as JAX_ARCHS
    import refid_tpu.models.archs  # noqa: F401
    from refid_tpu_torch.core.registry import ARCHS
    import refid_tpu_torch.models.archs  # noqa: F401
    from refid_tpu_torch.models.convert import load_state, state_dict_from_jax

    jnet = JAX_ARCHS.get(name)(opt)
    params = random_params(jnet, jnp.zeros((b, h, w, opt["img_chn"])),
                           jnp.zeros((b, t, h, w, opt["ev_chn"])), seed=seed)
    tnet = ARCHS.get(name)(opt)
    load_state(tnet, state_dict_from_jax(params, tnet.cfg))
    return jnet, params, tnet


def to_nhwc(x):
    """(..., C, H, W) numpy -> (..., H, W, C) jax array."""
    return jnp.asarray(np.moveaxis(x, -3, -1))


def to_nchw(y):
    """(..., H, W, C) jax / numpy -> (..., C, H, W) numpy."""
    return np.moveaxis(np.asarray(y), -1, -3)


def served_nchw(pipe):
    """A float ``BlurVFIPipeline`` (served channels_last) switched to NCHW,
    weights included: the layout that its int8 modes, its calibration and
    its spatial plans compute in, for tests that hold those bit for bit
    against the float path."""
    pipe.served.channels_last = False
    pipe.model.to(memory_format=torch.contiguous_format)
    return pipe


def max_diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def parity_db(want, got):
    """20 log10(span / rmse), the JAX package's production-parity measure."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    rmse = np.sqrt(np.mean((want - got) ** 2))
    return math.inf if rmse == 0 else 20 * math.log10((want.max() - want.min()) / rmse)


def test_random_params_fill_every_leaf_nonzero():
    from refid_tpu.models.fusion import CrossmodalAtten
    x = jnp.zeros((1, 4, 4, 8))
    params = random_params(CrossmodalAtten(8, 8), x, x)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    names = {jax.tree_util.keystr(p) for p, _ in leaves}
    assert any("beta" in n for n in names) and any("gamma" in n for n in names)
    assert all(np.all(np.asarray(v) != 0) for _, v in leaves)


@pytest.mark.parametrize("noise,expect", [(0.0, math.inf), (1e-3, 60.0), (1e-6, 120.0)])
def test_parity_db_scale(noise, expect):
    want = np.linspace(0.0, 1.0, 1001)
    got = want + noise * np.where(np.arange(1001) % 2, 1.0, -1.0)
    assert parity_db(want, got) == pytest.approx(expect, abs=1e-3)
