"""The ablation lineages of refid_tpu_torch against refid_tpu (CPU, f32):
every registry name and block type of the JAX package's ablation tests,
forward parity with every parameter random, the registry itself, int8
applicability, the refused configurations and the upstream-name round trip
through the JAX package's converter."""

import dataclasses

import numpy as np
import pytest
import torch

import flax

import refid_tpu.models.archs  # noqa: F401
from refid_tpu.core.registry import ARCHS as JAX_ARCHS
from refid_tpu.models.convert import convert_state_dict
from refid_tpu.models.refid import RefidConfig as JaxConfig
from refid_tpu.pipeline import _fast_serving_applicable
import refid_tpu_torch.models.archs  # noqa: F401
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models.convert import load_state, state_dict_from_jax
from refid_tpu_torch.models.refid import (
    FinalBidirectionAttenfusion, RefidConfig, int8_applicable,
)
from tests.test_torch_helpers import (
    ABLATION_COMBOS, ABLATION_IDS, ablation_opt, build_ablation, max_diff, to_nchw,
    to_nhwc,
)

torch.set_num_threads(1)
B, T, H, W = 1, 3, 16, 16


def _inputs(seed=0):
    """Two 3-channel frames, as tests/test_ablation_parity.py feeds them."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 2, 3, H, W).astype(np.float32),
            rng.randn(B, T, 2, H, W).astype(np.float32))


def _forward_both(jnet, params, tnet, x, ev):
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x), torch.from_numpy(ev)).numpy()
    want = to_nchw(jnet.apply(params, to_nhwc(x), to_nhwc(ev)))
    return got, want


@pytest.mark.parametrize("name,rbt", ABLATION_COMBOS, ids=ABLATION_IDS)
def test_ablation_forward_matches_jax(name, rbt):
    jnet, params, tnet = build_ablation(name, ablation_opt(rbt))
    got, want = _forward_both(jnet, params, tnet, *_inputs())
    assert got.shape == (B, T, 3, H, W)
    assert max_diff(got, want) < 2e-4


def test_registry_names_equal_jax():
    # every JAX name, and the port's own EFNet, Restormer and Uformer (held
    # to the benchmark's plain references, tests/test_torch_efnet.py,
    # tests/test_torch_restormer.py and tests/test_torch_uformer.py)
    assert sorted(ARCHS._map) == sorted(set(JAX_ARCHS._map) | {"EFNet", "Restormer", "Uformer"})
    assert len(JAX_ARCHS._map) == 11 and len(ARCHS._map) == 14


def _shared_fields(jcfg):
    names = {f.name for f in dataclasses.fields(RefidConfig)} - {"dtype"}
    return {k: getattr(jcfg, k) for k in names}


@pytest.mark.parametrize("name,rbt", ABLATION_COMBOS + [("FinalBidirectionAttenfusion", None)],
                         ids=ABLATION_IDS + ["FinalBidirectionAttenfusion"])
def test_registry_maps_like_jax_and_int8_applicability(name, rbt):
    """Each name and block type gives the JAX config, axis for axis, and
    int8 applies exactly where the JAX pipeline's serving forward does."""
    opt = ablation_opt(rbt)
    jcfg = JAX_ARCHS.get(name)(opt).cfg
    tcfg = ARCHS.get(name)(opt).cfg
    assert _shared_fields(tcfg) == _shared_fields(jcfg)
    assert int8_applicable(tcfg) == _fast_serving_applicable(jcfg)
    assert int8_applicable(tcfg) == (name in ("FinalBidirectionAttenfusion",
                                              "FinalBidirection"))


@pytest.mark.parametrize("name,rbt", [("UNetRecurrent", "simpleconv"),
                                      ("UNetPSDecoderRecurrent", "simpleconvThendown"),
                                      ("UNetDecoderRecurrentSiameseImg", "convlstm")])
def test_off_table_block_types_match_jax(name, rbt):
    """Block types upstream cannot run for these names build here as the
    flags say, as in JAX."""
    jnet, params, tnet = build_ablation(name, ablation_opt(rbt), seed=2)
    got, want = _forward_both(jnet, params, tnet, *_inputs(2))
    assert max_diff(got, want) < 2e-4


@pytest.mark.parametrize("name,rbt", [("BidirUNetRecurrent", "convlstm"),
                                      ("UNetDecoderRecurrentBidirection", "convgru")])
def test_bidirectional_rec_conv_is_refused_like_jax(name, rbt):
    import jax.numpy as jnp
    with pytest.raises(AssertionError, match="rec_conv has no bidirectional"):
        JAX_ARCHS.get(name)(ablation_opt(rbt)).init(
            __import__("jax").random.PRNGKey(0), jnp.zeros((1, H, W, 6)),
            jnp.zeros((1, 1, H, W, 2)))
    with pytest.raises(ValueError, match="rec_conv has no bidirectional"):
        ARCHS.get(name)(ablation_opt(rbt))


def _flat(tree):
    return flax.traverse_util.flatten_dict(flax.core.unfreeze(tree), sep="/")


NON_SIAMESE = [c for c in ABLATION_COMBOS if "Siamese" not in c[0]]


@pytest.mark.parametrize("name,rbt", NON_SIAMESE,
                         ids=[f"{n}-{r}" if r else n for n, r in NON_SIAMESE])
def test_upstream_names_round_trip_through_jax_converter(name, rbt):
    """convert_state_dict(state_dict_from_jax(p)) == p, key for key and
    value for value.  The all-bidirection lineage's backward decoders and
    decoder fuses have no upstream checkpoint (upstream's arch never runs)
    and no map in the JAX converter: they are the only keys it leaves out."""
    jnet, params, tnet = build_ablation(name, ablation_opt(rbt))
    state = tnet.state_dict()
    want, got = _flat(params), _flat(convert_state_dict(state, jnet.cfg))
    left_out = sorted(set(want) - set(got))
    assert set(got) <= set(want)
    if tnet.cfg.bidir_decoder:
        assert left_out and all(k.startswith("params/bwd/dec_") or (
            k.startswith("params/fwd/dec_") and "/fuse_bidir/" in k) for k in left_out)
    else:
        assert not left_out
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_upstream_checkpoint_dead_resblocks_are_ignored():
    """An upstream UNetDecoderRecurrentBidirection checkpoint carries the
    bottleneck resblocks upstream builds and never calls."""
    opt = ablation_opt("simpleconvThendown")
    net = ARCHS.get("UNetDecoderRecurrentBidirection")(opt)
    state = dict(net.state_dict())
    state["resblocks.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    load_state(ARCHS.get("UNetDecoderRecurrentBidirection")(opt), state)
    # a network with resblocks takes no key outside its own
    with_res = ARCHS.get("UNetDecoderRecurrent")(opt)
    extra = dict(with_res.state_dict())
    extra["resblocks.1.conv1.weight"] = torch.zeros(32, 32, 3, 3)
    with pytest.raises(KeyError, match="resblocks.1"):
        load_state(with_res, extra)


def test_stage_outputs_builds_and_maps_like_jax():
    opt = ablation_opt("convlstm", remat=True, remat_policy="stage_outputs")
    jcfg = JAX_ARCHS.get("UNetDecoderRecurrent")(opt).cfg
    tcfg = ARCHS.get("UNetDecoderRecurrent")(opt).cfg
    assert tcfg.remat_policy == jcfg.remat_policy == "stage_outputs"
    with pytest.raises(ValueError, match="remat_policy"):
        FinalBidirectionAttenfusion(RefidConfig(remat_policy="everything"))


def test_jax_config_axes_are_all_ported():
    """Every ablation axis of the JAX config exists here with its default."""
    ported = {f.name for f in dataclasses.fields(RefidConfig)}
    jax_axes = {f.name for f in dataclasses.fields(JaxConfig)}
    # the JAX package's TPU loop controls, not model axes
    assert jax_axes - ported == {"unroll", "scan_unroll", "scan_split_transpose"}


@pytest.mark.parametrize("name,rbt", ABLATION_COMBOS, ids=ABLATION_IDS)
def test_production_width_trees_match_jax(name, rbt):
    """At the production widths (26 image channels, base 32, 3 encoders, 2
    resblocks) the JAX tree maps onto the port's state_dict key for key and
    shape for shape."""
    import jax
    import jax.numpy as jnp
    opt = dict(ablation_opt(rbt), img_chn=26, num_encoders=3, base_num_channels=32,
               num_residual_blocks=2)
    jnet = JAX_ARCHS.get(name)(opt)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 26)),
                            jnp.zeros((1, 1, 16, 16, 2)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = ARCHS.get(name)(opt)
    load_state(net, state_dict_from_jax(zeros, net.cfg))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == n_jax


@pytest.mark.parametrize("k", range(6))
def test_chip_smoke_ablation_training_changes_only_the_network(k):
    """chip_smoke.py's ablation_train options are the production recipe as
    its train phase runs it (bf16), with network_g's type, block type and
    overrides replaced and no validation dataset; its networks and
    ABLATIONS are this file's combinations."""
    import yaml
    import chip_smoke

    assert [(n, r) for n, r, dcn in chip_smoke.ABLATIONS if not dcn] == ABLATION_COMBOS
    name, rbt, overrides = chip_smoke.ABLATION_TRAIN[k]
    opt = chip_smoke.ablation_train_options("/data", name, rbt, overrides)
    with open(chip_smoke.RECIPE) as f:
        want = chip_smoke.recipe_overrides(yaml.safe_load(f), "/data", opt["name"], "bf16")
    net_want = dict(want.pop("network_g"), type=name, **overrides)
    if rbt:
        net_want["recurrent_block_type"] = rbt
    assert opt.pop("network_g") == net_want
    del want["datasets"]["val"]
    assert opt == want
    cfg = ARCHS.get(name)(net_want).cfg
    assert cfg.remat and cfg.dtype == torch.bfloat16 and cfg.base_num_channels == 32
