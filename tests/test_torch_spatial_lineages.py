"""The paper's ablation lineages of refid_tpu_torch on row shards against
refid_tpu: every combination of tests/test_ablation_shapes.py (the ConvGRU /
ConvLSTM cells, the k5/s2 and RecurrentConvLayer stages, the pixel-shuffle and
bilinear decoders, the all-bidirection decoder, the siamese fusions) and the
DCN first conv, split by image height over 4 gloo ranks on the CPU, against
the JAX package's unsharded forward and gradients of the mean Charbonnier
loss at the same weights (tests/test_spatial_sharding.py's bars: forward
within 2e-5, gradients within 3e-5).

One 4-rank job (tests/torch_dist.py::lineage_job) computes every sharded
result; the JAX references run here."""

import jax
import numpy as np
import pytest
import torch

from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu_torch.models.convert import state_dict_from_jax
from tests import torch_dist
from tests.test_torch_helpers import (
    ABLATION_COMBOS, ABLATION_IDS, ablation_opt, build_ablation, to_nchw, to_nhwc,
)

torch.set_num_threads(1)

B, T, H, W = 1, 2, 32, 16          # S = 4, blocks of 4 rows: 2 blocks a shard
FWD_TOL, GRAD_TOL = 2e-5, 3e-5
CASES = dict(zip(ABLATION_IDS, ABLATION_COMBOS))
CASES["UNetDecoderRecurrent-simpleconvThendown-dcn"] = ("UNetDecoderRecurrent",
                                                        "simpleconvThendown")
CASES["UNetDecoderRecurrent-simpleconv-dcn"] = ("UNetDecoderRecurrent", "simpleconv")
# remat recomputes the new exchanges (the edge-mode halo, the DCN's gather)
# in the backward pass under the same plan
CASES["UNetRecurrent-convgru-remat_stage_outputs"] = ("UNetRecurrent", "convgru")
CASES["UNetDecoderRecurrent-simpleconv-dcn-remat_all"] = ("UNetDecoderRecurrent", "simpleconv")


def _opt(key, rbt):
    remat = key.rsplit("remat_", 1)[1] if "remat_" in key else None
    return ablation_opt(rbt, use_first_dcn="-dcn" in key, remat=remat is not None,
                        remat_policy=remat or "all")


@pytest.fixture(scope="module")
def lineages(tmp_path_factory):
    """The JAX forward and gradients of each case, and the port's sharded
    ones."""
    rng = np.random.RandomState(0)
    x = rng.randn(B, 6, H, W).astype(np.float32)
    ev = rng.randn(B, T, 2, H, W).astype(np.float32)
    gt = rng.rand(B, T, 3, H, W).astype(np.float32)
    want, cases = {}, {}
    for key, (name, rbt) in CASES.items():
        opt = _opt(key, rbt)
        jnet, params, tnet = build_ablation(name, opt, seed=3, b=B, t=T, h=H, w=W)

        def loss(p, jnet=jnet):
            out = jnet.apply(p, to_nhwc(x), to_nhwc(ev))
            return jax_charbonnier(out, to_nhwc(gt)), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        want[key] = (to_nchw(out), {k: v.numpy() for k, v in
                                    state_dict_from_jax(grads, tnet.cfg).items()})
        cases[key] = (name, opt, tnet.state_dict())
    work = str(tmp_path_factory.mktemp("lineages"))
    torch.save({"cases": cases, "data": tuple(torch.from_numpy(a) for a in (x, ev, gt))},
               f"{work}/lineages.pt")
    torch_dist.run_ranks(torch_dist.lineage_job, 4, work)
    return want, torch.load(f"{work}/lineages_out.pt", weights_only=False)


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_lineage_matches_jax(lineages, key):
    """Forward within 2e-5 and every gradient within 3e-5 of the JAX
    package's unsharded ones; the shards exchanged halos."""
    want, got = lineages
    out, grads, (exchanges, _) = got[key]
    want_out, want_grads = want[key]
    assert out.shape == want_out.shape
    assert np.abs(out.numpy() - want_out).max() < FWD_TOL
    for k, g in grads.items():      # a stage conv EGACA replaces: not in JAX, never applied
        ref = want_grads[k] if k in want_grads else np.zeros(g.shape, np.float32)
        assert np.abs(g.numpy() - ref).max() < GRAD_TOL, k
    assert exchanges > 0
