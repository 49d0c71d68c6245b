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


def to_nhwc(x):
    """(..., C, H, W) numpy -> (..., H, W, C) jax array."""
    return jnp.asarray(np.moveaxis(x, -3, -1))


def to_nchw(y):
    """(..., H, W, C) jax / numpy -> (..., C, H, W) numpy."""
    return np.moveaxis(np.asarray(y), -1, -3)


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
