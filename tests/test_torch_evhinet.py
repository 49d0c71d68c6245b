"""EVHINet in refid_tpu_torch against refid_tpu's (CPU, f32): the network,
its parameter tree both ways, the registry entry, and int8 serving against
the JAX serving forward ``refid_tpu/serve/evhinet_fast.py`` in its dynamic,
calib and static modes.  Inputs come from numpy seeds; every JAX parameter
is filled randomly (HIN scales near 1, HIN biases included) and reaches the
port through ``models/convert.py::evhinet_state_dict_from_jax``."""

import logging

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import refid_tpu.models.archs  # noqa: F401 (registers the JAX archs)
import refid_tpu.serve.quant as jax_quant
from refid_tpu.core.registry import ARCHS as JAX_ARCHS
from refid_tpu.models.convert import convert_evhinet_state_dict
from refid_tpu.models.evhinet import EVHINet as JaxEVHINet
from refid_tpu.serve.evhinet_fast import evhinet_fast_forward
from refid_tpu.serve.packing import depth_to_space, space_to_depth
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models import archs  # noqa: F401 (registers the archs)
from refid_tpu_torch.models.convert import evhinet_state_dict_from_jax, load_state
from refid_tpu_torch.models.evhinet import EVHINet, evhinet_int8_applicable
from refid_tpu_torch.serve import quant
from tests.test_torch_helpers import parity_db, random_params

torch.set_num_threads(1)

TOL = 2e-4          # f32 network against JAX, max |diff|
INT8_DB = 60.0      # int8 port against the JAX int8 forward
INT8_GAP_DB = 3.0   # the two packages' int8-vs-f32 dB
SITES = 25          # EVHINet's int8 sites
REL = 1e-6          # plain int8 conv against JAX's folded one, relative max |diff|


def _inputs(seed, h, w, ev_shape=None):
    """(NHWC image, NHWC voxel) numpy; ``ev_shape`` (t, c) for a 5-D voxel."""
    rng = np.random.RandomState(seed)
    x = rng.rand(1, h, w, 3).astype(np.float32)
    if ev_shape is None:
        ev = rng.randn(1, h, w, 6).astype(np.float32)
    else:
        ev = rng.randn(1, ev_shape[0], h, w, ev_shape[1]).astype(np.float32)
    return x, ev


def _jax_params(net, x, ev, seed):
    """Every leaf random (tests/test_torch_helpers.py), HIN scales near 1."""
    params = random_params(net, jnp.asarray(x), jnp.asarray(ev), seed=seed)
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    flat = {k: (1.0 + v if k.endswith("hin_scale") else v) for k, v in flat.items()}
    return flax.traverse_util.unflatten_dict(flat, sep="/")


def _pair(wf, x, ev, seed=0):
    jnet = JaxEVHINet(wf=wf)
    params = _jax_params(jnet, x, ev, seed)
    net = EVHINet(wf=wf)
    net.load_state_dict(evhinet_state_dict_from_jax(params))
    return jnet, params, net.eval()


def _nchw(a):
    """NHWC numpy -> NCHW tensor; a 5-D (b, t, h, w, c) -> (b, t, c, h, w)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _port(net, x, ev, q=None):
    with torch.no_grad():
        return net(_nchw(x), _nchw(ev), q).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("wf,h,w,ev_shape", [(8, 32, 32, None), (16, 48, 64, None),
                                             (8, 32, 32, (3, 2)), (16, 48, 64, (2, 3))])
def test_evhinet_matches_jax(wf, h, w, ev_shape):
    x, ev = _inputs(wf + h, h, w, ev_shape)
    jnet, params, net = _pair(wf, x, ev, seed=wf)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(ev)))
    got = _port(net, x, ev)
    assert got.shape == want.shape == (1, h, w, 3)
    assert float(np.abs(got - want).max()) < TOL


def test_param_tree_converts_both_ways():
    x, ev = _inputs(0, 16, 16)
    net = EVHINet(wf=8)
    params = convert_evhinet_state_dict(net.state_dict())
    init = JaxEVHINet(wf=8).init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ev))
    got = flax.traverse_util.flatten_dict(params["params"], sep="/")
    want = flax.traverse_util.flatten_dict(init["params"], sep="/")
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    back = evhinet_state_dict_from_jax(params)
    state = net.state_dict()
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_registry_builds_evhinet_with_the_jax_option_keys():
    opt = {"in_chn": 3, "ev_chn": 6, "wf": 8, "depth": 3, "fac_place": 1,
           "hin_position_left": 1, "hin_position_right": 2}
    net = ARCHS.get("SingleMultiConnectEVHINet")(dict(opt))
    jnet = JAX_ARCHS.get("SingleMultiConnectEVHINet")(dict(opt))
    assert isinstance(net, EVHINet)
    assert (net.depth, net.fac_place, net.hin_left, net.hin_right) == (
        jnet.depth, jnet.fac_place, jnet.hin_left, jnet.hin_right)
    assert [blk.norm is not None for blk in net.down_path_1] == [False, True, True]
    assert len(net.down_path_ev) == 2 and net.dtype is None
    assert not evhinet_int8_applicable(net)
    bf16 = ARCHS.get("SingleMultiConnectEVHINet")({"compute_dtype": "bfloat16"})
    assert bf16.dtype == torch.bfloat16 and evhinet_int8_applicable(bf16)
    x, ev = _inputs(1, 16, 16)
    jparams = _jax_params(jnet, x, ev, 1)
    net.load_state_dict(evhinet_state_dict_from_jax(jparams))
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x), jnp.asarray(ev)))
    assert float(np.abs(_port(net.eval(), x, ev) - want).max()) < TOL


def test_bf16_compute_dtype_tracks_f32():
    x, ev = _inputs(2, 32, 32)
    _, _, net = _pair(8, x, ev)
    want = _port(net, x, ev)
    net.dtype = torch.bfloat16
    got = _port(net, x, ev)
    assert got.dtype == np.float32 and parity_db(want, got) >= 35.0


@pytest.mark.slow
def test_production_geometry_matches_jax():
    """wf 64 (the shipped width) on a 256x256 crop, >= 100 dB: float32 reads
    about 140 dB here and the port under bf16 compute about 60 dB, so a leak
    of reduced precision into the float32 forward fails."""
    x, ev = _inputs(3, 256, 256)
    jnet, params, net = _pair(64, x, ev, seed=3)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(ev)))
    assert parity_db(want, _port(net, x, ev)) >= 100.0


def test_dead_branches_keep_their_parameters_and_get_no_gradient():
    """The last event block, the downsample of the last event block that
    runs, and SAM's conv1 / conv3 are never computed (the JAX forward's dead
    code); the Trainer's zero fill then decays them as optax does."""
    x, ev = _inputs(4, 16, 16)
    _, _, net = _pair(8, x, ev)
    net(_nchw(x), _nchw(ev)).square().mean().backward()
    dead = {k for k, p in net.named_parameters() if p.grad is None}
    assert dead == {k for k, _ in net.named_parameters()
                    if k.startswith(("down_path_ev.2.", "down_path_ev.1.downsample",
                                     "sam12.conv1.", "sam12.conv3."))}


# --- int8 -----------------------------------------------------------------------


class _RecordingState(quant.QuantState):
    """A QuantState that records each site's input shape."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.shapes = []

    def resolve(self, x):
        self.shapes.append(tuple(x.shape))
        return super().resolve(x)


def _jax_site_shapes(monkeypatch, run):
    shapes = []
    act_scale = jax_quant._act_scale

    def counted(cache, x):
        shapes.append(tuple(x.shape))
        return act_scale(cache, x)

    monkeypatch.setattr(jax_quant, "_act_scale", counted)
    run()
    monkeypatch.setattr(jax_quant, "_act_scale", act_scale)
    return shapes


def _same_site(jax_shape, port_shape):
    """A JAX site (NHWC, width-folded by 2 at full resolution) against the
    port's (NCHW, unfolded)."""
    b, h, wq, cq = jax_shape
    pb, c, ph, w = port_shape
    return (b, h) == (pb, ph) and (wq, cq) in ((w, c), (w // 2, 2 * c))


@pytest.fixture(scope="module")
def toy():
    x, ev = _inputs(5, 48, 64)
    jnet, params, net = _pair(16, x, ev, seed=5)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(ev)))
    return x, ev, params, net, want


@pytest.mark.parametrize("mode", [True, "static"])
def test_int8_matches_the_jax_serving_forward(toy, mode, monkeypatch):
    x, ev, params, net, want = toy
    jq = {}
    calib = np.asarray(evhinet_fast_forward(params, jnp.asarray(x), jnp.asarray(ev),
                                            int8="calib", qstate=jq))
    jax_amax = [float(a) for a in jq["amax"]]
    q = quant.QuantState("calib")
    np.testing.assert_allclose(_port(net, x, ev, q), calib, atol=TOL)
    amax, _ = quant.calibration_stats(q)
    assert len(amax) == len(jax_amax) == SITES
    np.testing.assert_allclose(amax, jax_amax, rtol=1e-5)

    # static serves each package from the other's calibration
    jkw = {"int8": True} if mode is True else {"int8": "static", "qstate": {"amax": amax}}
    outs = []
    jshapes = _jax_site_shapes(monkeypatch, lambda: outs.append(np.asarray(
        evhinet_fast_forward(params, jnp.asarray(x), jnp.asarray(ev), **jkw))))
    jout = outs[0]
    q = _RecordingState(mode, amax=jax_amax if mode == "static" else ())
    got = _port(net, x, ev, q)
    assert q.sites == len(jshapes) == SITES
    assert all(_same_site(j, p) for j, p in zip(jshapes, q.shapes)), (jshapes, q.shapes)
    assert parity_db(jout, got) >= INT8_DB
    assert abs(parity_db(want, got) - parity_db(want, jout)) <= INT8_GAP_DB


def test_int8_modes_and_gate(toy):
    x, ev, _, net, _ = toy
    with pytest.raises(ValueError, match="scale0"):
        _port(net, x, ev, quant.QuantState("scale0"))
    with pytest.raises(ValueError, match="site-count"):
        _port(net, x, ev, quant.QuantState("static", amax=[1.0] * (SITES - 1)))
    with pytest.raises(ValueError, match="fac_place"):
        _port(EVHINet(wf=8, fac_place=1), x, ev, quant.QuantState(True))
    assert evhinet_int8_applicable(net)
    assert quant.EVHINET_PRODUCTION_SHAPE_DB == jax_quant.EVHINET_PRODUCTION_SHAPE_DB
    # every site excluded serves the float forward exactly
    calib = quant.QuantState("calib")
    exact = _port(net, x, ev, calib)
    amax, _ = quant.calibration_stats(calib)
    all_out = quant.QuantState("static", amax=amax, exclude=range(SITES))
    np.testing.assert_array_equal(_port(net, x, ev, all_out), exact)


# EVHINet's full-resolution int8 sites at wf 64: (cin, cout, k)
FULL_RES_SITES = {"conv_1": (64, 64, 3), "identity_ev0": (64, 64, 1),
                  "merge_ev0": (64, 128, 1), "upblk1_conv_1": (128, 64, 3),
                  "upblk1_identity": (128, 64, 1), "skip_1": (64, 64, 3)}


@pytest.mark.parametrize("site", list(FULL_RES_SITES))
def test_conv_int8_matches_conv_s2d_int8_at_evhinet_sites(site):
    """The JAX serving forward runs these sites width-folded
    (``conv_s2d_int8``); the port's unfolded ``conv_int8`` computes the same
    integer sums, so the two agree to float rounding."""
    cin, cout, k = FULL_RES_SITES[site]
    rng = np.random.RandomState(cin + cout + k)
    x = rng.randn(1, 8, 16, cin).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    yf = jax_quant.conv_s2d_int8(space_to_depth(jnp.asarray(x), (1, 2)), jnp.asarray(kern),
                                 jnp.asarray(bias), (1, 2))
    want = np.asarray(depth_to_space(yf, (1, 2)))
    got = quant.conv_int8({"weight": torch.from_numpy(kern).permute(3, 2, 0, 1),
                           "bias": torch.from_numpy(bias)},
                          torch.from_numpy(x).permute(0, 3, 1, 2), 1, k // 2)
    got = got.permute(0, 2, 3, 1).numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= REL


def test_load_state_takes_upstream_checkpoints_with_stage_two_keys(caplog):
    net = EVHINet(wf=8)
    state = dict(net.state_dict())
    state["down_path_2.0.conv_1.weight"] = torch.zeros(8, 3, 3, 3)
    state["sam23.conv1.weight"] = torch.zeros(8, 8, 3, 3)
    fresh = EVHINet(wf=8)
    # a CLI run earlier in the process may have turned off propagation
    # (get_root_logger): catch the package logger's records directly
    logger = logging.getLogger("refid_tpu_torch")
    with caplog.at_level("INFO", logger="refid_tpu_torch"):
        logger.addHandler(caplog.handler)
        try:
            load_state(fresh, state)
        finally:
            logger.removeHandler(caplog.handler)
    assert "down_path_2.0.conv_1.weight" in caplog.text
    assert all(torch.equal(v, state[k]) for k, v in fresh.state_dict().items())
    del state["down_path_1.0.conv_1.weight"]
    with pytest.raises(KeyError, match="down_path_1.0.conv_1.weight"):
        load_state(EVHINet(wf=8), state)
    with pytest.raises(ValueError, match="EVHINet checkpoint"):
        load_state(EVHINet(wf=8), {"head.conv2d.weight": torch.zeros(1)})
