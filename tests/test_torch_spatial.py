"""The spatial axis of refid_tpu_torch (parallel/spatial.py) against refid_tpu:
the flagship split by image height over gloo ranks on the CPU equals the JAX
package's unsharded forward and gradients at the converted weights, as
GSPMD's halos do in tests/test_spatial_sharding.py; the halo exchange
against slices of one tensor and in a float64 gradcheck; the pipeline's
``mesh=`` against the JAX pipeline; and the configurations that raise.

One 4-rank job (tests/torch_dist.py::spatial_job) computes every sharded
result; the JAX references run here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.pipeline import BlurVFIPipeline as JaxBlur
from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.models.convert import load_state, state_dict_from_jax
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion
from refid_tpu_torch.parallel.mesh import Mesh, mesh_layout
from refid_tpu_torch.parallel.spatial import (
    SpatialPlan, halo_exchange, row_split, spatial_scope,
)
from tests import torch_dist
from tests.test_torch_helpers import random_params, to_nchw, to_nhwc

torch.set_num_threads(1)

# tests/test_spatial_sharding.py's geometry
CFG = dict(img_chn=6, ev_chn=2, num_encoders=2, base_num_channels=4, num_residual_blocks=1)
B, T, W = 2, 3, 32
PIPE_CFG = dict(img_chn=8, ev_chn=2, num_encoders=2, base_num_channels=8,
                num_residual_blocks=1)
FWD_TOL, GRAD_TOL = 2e-5, 3e-5


def _mesh(spatial, index=0):
    """A mesh record for checks that run before any collective."""
    return Mesh(data=1, spatial=spatial, data_index=0, spatial_index=index)


@pytest.fixture(scope="module")
def jax_side():
    jnet = JaxNet(JaxConfig(**CFG))
    params = random_params(jnet, jnp.zeros((1, 32, W, CFG["img_chn"])),
                           jnp.zeros((1, T, 32, W, CFG["ev_chn"])), seed=4)
    rng = np.random.RandomState(0)
    data, want = {}, {}

    def loss(p, x, ev, gt):
        return jax_charbonnier(jnet.apply(p, x, ev), gt)

    for h in (32, 40):
        x = rng.randn(B, CFG["img_chn"], h, W).astype(np.float32)
        ev = rng.randn(B, T, CFG["ev_chn"], h, W).astype(np.float32)
        gt = rng.rand(B, T, 3, h, W).astype(np.float32)
        data[h] = (x, ev, gt)
        out = to_nchw(jnet.apply(params, to_nhwc(x), to_nhwc(ev)))
        grads = jax.grad(loss)(params, to_nhwc(x), to_nhwc(ev), to_nhwc(gt))
        want[h] = (out, {k: v.numpy() for k, v in
                         state_dict_from_jax(grads, RefidConfig(**CFG)).items()})

    pjnet = JaxNet(JaxConfig(**PIPE_CFG))
    pparams = random_params(pjnet, jnp.zeros((1, 64, 64, 8)), jnp.zeros((1, 5, 64, 64, 2)),
                            seed=3)
    prng = np.random.RandomState(3)
    ne = 2000
    request = (prng.rand(64, 64, 3).astype(np.float32), prng.rand(64, 64, 3).astype(np.float32),
               np.stack([np.sort(prng.rand(ne)), prng.randint(0, 64, ne).astype(np.float32),
                         prng.randint(0, 64, ne).astype(np.float32),
                         prng.randint(0, 2, ne).astype(np.float32)], 1).astype(np.float32))
    pipe_want = np.asarray(JaxBlur(pparams, JaxConfig(**PIPE_CFG), m=2, n=1, fast=False)(*request))
    return {"state": state_dict_from_jax(params, RefidConfig(**CFG)), "data": data,
            "want": want, "pipe_state": state_dict_from_jax(pparams, RefidConfig(**PIPE_CFG)),
            "request": request, "pipe_want": pipe_want}


@pytest.fixture(scope="module")
def sharded(jax_side, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial"))
    data = jax_side["data"]
    torch.save({"cfg": CFG, "state": jax_side["state"],
                "x": {h: torch.from_numpy(d[0]) for h, d in data.items()},
                "ev": {h: torch.from_numpy(d[1]) for h, d in data.items()},
                "gt": {h: torch.from_numpy(d[2]) for h, d in data.items()},
                "pipe_cfg": PIPE_CFG, "pipe_state": jax_side["pipe_state"],
                "request": jax_side["request"]}, f"{work}/inputs.pt")
    torch_dist.run_ranks(torch_dist.spatial_job, 4, work)
    torch_dist.run_ranks(torch_dist.halo_job, 4, work)
    return (torch.load(f"{work}/spatial.pt", weights_only=False),
            torch.load(f"{work}/halo.pt", weights_only=False))


def test_row_split_takes_whole_blocks_first_shards_larger():
    assert row_split(720, 4, 8) == [(0, 184), (184, 368), (368, 544), (544, 720)]
    assert [b - a for a, b in row_split(40, 4, 4)] == [12, 12, 8, 8]
    with pytest.raises(ValueError, match="multiple"):
        row_split(30, 2, 4)


def test_halo_exchange_matches_slices_forward_and_backward(sharded):
    _, halo = sharded
    for (rows, above, below), case in ((k, v) for k, v in halo.items() if k != "gradcheck"):
        x, v, ranks = case["x"], case["v"], case["ranks"]
        padded = torch.nn.functional.pad(x, (0, 0, above, below))
        grad_padded = torch.zeros_like(padded)
        offset = 0
        for (start, stop), y, grad in ranks:
            n = stop - start + above + below
            torch.testing.assert_close(y, padded[..., start:start + n, :], rtol=0, atol=0)
            grad_padded[..., start:start + n, :] += v[..., offset:offset + n, :]
            offset += n
        want_grad = grad_padded[..., above:above + rows, :]
        got_grad = torch.cat([grad for _, _, grad in ranks], -2)
        torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=1e-12)


def test_halo_exchange_float64_gradcheck(sharded):
    assert sharded[1]["gradcheck"] is True


def test_halo_exchange_of_one_rank_is_zero_padding():
    x = torch.randn(1, 2, 5, 3)
    torch.testing.assert_close(halo_exchange(x, 2, 1, None),
                               torch.nn.functional.pad(x, (0, 0, 2, 1)))


def test_mesh_layouts_in_the_job(sharded):
    layout = sharded[0]["layout"]
    assert [r[0] for r in layout] == [(1, 4, 0, r) for r in range(4)]
    assert [r[1] for r in layout] == [(2, 2, r // 2, r % 2) for r in range(4)]


@pytest.mark.parametrize("name,h", [("s4_h32", 32), ("s4_h40", 40), ("d2s2_h32", 32),
                                    ("s4_h40_all", 40), ("s4_h40_stage", 40)])
def test_sharded_flagship_matches_jax_and_unsharded_port(jax_side, sharded, name, h):
    """S = 4 (even, and uneven at H = 40: 3/3/2/2 blocks), data 2 x spatial
    2, and both remat policies: forward within 2e-5 and every gradient
    within 3e-5 of the JAX package's, and of the unsharded port's."""
    out, grads, (exchanges, reductions) = sharded[0][name]
    want_out, want_grads = jax_side["want"][h]
    assert np.abs(out.numpy() - want_out).max() < FWD_TOL
    for k, g in grads.items():      # the stage convs EGACA replaces: not in JAX, never applied
        want = want_grads[k] if k in want_grads else np.zeros(g.shape, np.float32)
        assert np.abs(g.numpy() - want).max() < GRAD_TOL, k
    assert exchanges > 0 and reductions > 0

    net = FinalBidirectionAttenfusion(RefidConfig(**CFG))
    load_state(net, jax_side["state"])
    x, ev, _ = jax_side["data"][h]
    with torch.no_grad():
        plain = net(torch.from_numpy(x), torch.from_numpy(ev))
    assert (out - plain).abs().max() < FWD_TOL


def test_pipeline_mesh_matches_jax_pipeline(jax_side, sharded):
    res = sharded[0]
    got = res["pipeline"].numpy()
    assert got.shape == (5, 64, 64, 3)
    assert np.abs(got - jax_side["pipe_want"]).max() < 2e-5
    rows, exchanges, lent, carried = res["pipeline_plan"]
    assert rows == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert exchanges > 0 and carried == 4 * lent
    pipe = BlurVFIPipeline(jax_side["pipe_state"], RefidConfig(**PIPE_CFG), m=2, n=1,
                           device="cpu")
    assert np.abs(got - pipe(*jax_side["request"]).numpy()).max() < 2e-5


def test_too_few_rows_int8_and_other_networks_raise(jax_side, tmp_path):
    """What still raises on row shards: a shard with fewer than two rows at
    the deepest scale, an input that is not this rank's rows, and a mesh
    that does not divide the world.  int8 and every other network run
    (tests/test_torch_spatial_lineages.py)."""
    with pytest.raises(ValueError, match="deepest scale"):
        SpatialPlan(_mesh(4), 16, 4)          # one row a shard at the deepest scale
    net = FinalBidirectionAttenfusion(RefidConfig(**CFG))
    with spatial_scope(SpatialPlan(_mesh(2), 32, 4)):
        with pytest.raises(ValueError, match="rows"):
            net(torch.zeros(1, 6, 8, W), torch.zeros(1, T, 2, 8, W))
    with pytest.raises(ValueError, match="divide"):
        mesh_layout(4, spatial=3)
