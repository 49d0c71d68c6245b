"""refid_tpu_torch FinalBidirectionAttenfusion against the JAX network (CPU, f32),
and the weight-name round trip through the JAX package's converter."""

import dataclasses

import numpy as np
import pytest
import torch

import flax

from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.models.convert import convert_state_dict
from refid_tpu_torch.models import FinalBidirectionAttenfusion, RefidConfig
from refid_tpu_torch.models.convert import load_state, state_dict_from_jax
from tests.test_torch_helpers import (
    max_diff, parity_db, random_params, to_nchw, to_nhwc,
)

torch.set_num_threads(1)

TOY = dict(img_chn=26, ev_chn=2, num_encoders=2, base_num_channels=4,
           num_residual_blocks=1)


def _configs(**kw):
    return JaxConfig(**kw), RefidConfig(**kw)


def _build(jcfg, tcfg, b, t, h, w, seed=0):
    jnet = JaxNet(jcfg)
    params = random_params(jnet, to_nhwc(np.zeros((b, jcfg.img_chn, h, w), np.float32)),
                           to_nhwc(np.zeros((b, t, 2, h, w), np.float32)), seed=seed)
    tnet = FinalBidirectionAttenfusion(tcfg)
    load_state(tnet, state_dict_from_jax(params, tcfg))
    return jnet, params, tnet.eval()


def _forward_both(jnet, params, tnet, x, ev):
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), torch.from_numpy(ev)).numpy()
    jout = to_nchw(jnet.apply(params, to_nhwc(x), to_nhwc(ev)))
    return tout, jout


@pytest.mark.parametrize("aliased", [True, False])
def test_network_matches_jax_at_toy_shape(aliased):
    jcfg, tcfg = _configs(aliased_backward_states=aliased, **TOY)
    b, t, h, w = 1, 3, 16, 24
    jnet, params, tnet = _build(jcfg, tcfg, b, t, h, w)
    rng = np.random.RandomState(1)
    x = rng.randn(b, 26, h, w).astype(np.float32)
    ev = rng.randn(b, t, 2, h, w).astype(np.float32)
    tout, jout = _forward_both(jnet, params, tnet, x, ev)
    assert tout.shape == (b, t, 3, h, w)
    assert max_diff(tout, jout) < 2e-4


def test_aliasing_flag_changes_later_frames_only():
    """Frame 0 fuses the same backward state either way; later frames differ."""
    b, t, h, w = 1, 3, 16, 24
    _, jparams, _ = _build(*_configs(**TOY), b, t, h, w)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(b, 26, h, w).astype(np.float32))
    ev = torch.from_numpy(rng.randn(b, t, 2, h, w).astype(np.float32))
    outs = []
    for aliased in (True, False):
        cfg = RefidConfig(aliased_backward_states=aliased, **TOY)
        net = FinalBidirectionAttenfusion(cfg)
        load_state(net, state_dict_from_jax(jparams, cfg))
        with torch.no_grad():
            outs.append(net.eval()(x, ev))
    torch.testing.assert_close(outs[0][:, 0], outs[1][:, 0], rtol=0, atol=0)
    assert (outs[0][:, 1:] - outs[1][:, 1:]).abs().max() > 1e-3


def test_two_frame_input_is_channel_concat():
    cfg = RefidConfig(**TOY)
    net = FinalBidirectionAttenfusion(cfg).eval()
    rng = np.random.RandomState(3)
    x2 = torch.from_numpy(rng.randn(1, 2, 13, 16, 24).astype(np.float32))
    ev = torch.from_numpy(rng.randn(1, 2, 2, 16, 24).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(net(x2, ev), net(x2.flatten(1, 2), ev),
                                   rtol=0, atol=0)


def _flat(tree):
    return flax.traverse_util.flatten_dict(flax.core.unfreeze(tree), sep="/")


@pytest.mark.parametrize("kw", [TOY, {}], ids=["toy", "production"])
def test_weight_names_round_trip(kw):
    """convert_state_dict(state_dict_from_jax(p)) == p, key for key and
    value for value."""
    jcfg, tcfg = _configs(**kw)
    jnet = JaxNet(jcfg)
    params = random_params(jnet, to_nhwc(np.zeros((1, jcfg.img_chn, 16, 16), np.float32)),
                           to_nhwc(np.zeros((1, 1, 2, 16, 16), np.float32)))
    state = state_dict_from_jax(params, tcfg)
    # the port's state_dict covers every key but upstream's known-unused ones
    load_state(FinalBidirectionAttenfusion(tcfg), state)
    want, got = _flat(params), _flat(convert_state_dict(state, jcfg))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_production_config_defaults_match_jax():
    shared = {f.name for f in dataclasses.fields(RefidConfig)}
    jax_defaults = {k: v for k, v in dataclasses.asdict(JaxConfig()).items()
                    if k in shared}
    assert dataclasses.asdict(RefidConfig()) == jax_defaults
    n_params = sum(p.numel() for p in FinalBidirectionAttenfusion().parameters())
    assert 15.9e6 < n_params < 16.0e6


@pytest.mark.slow
def test_network_matches_jax_at_production_shape():
    """t=23, 256x256, base 32: >= 60 dB, the bar refid_tpu met against
    upstream at this shape."""
    jcfg, tcfg = _configs()
    b, t, h, w = 1, 23, 256, 256
    jnet, params, tnet = _build(jcfg, tcfg, b, t, h, w, seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(b, 26, h, w).astype(np.float32)
    ev = rng.randn(b, t, 2, h, w).astype(np.float32)
    torch.set_num_threads(4)
    try:
        tout, jout = _forward_both(jnet, params, tnet, x, ev)
    finally:
        torch.set_num_threads(1)
    assert parity_db(jout, tout) >= 60.0
