"""EVHINet's task and the losses that are not a row-weighted mean on row
shards (CPU, f32), against refid_tpu's single-process results.  On row
shards the Trainer takes each loss of the gathered whole frames divided by
the group's size (``train/trainer.py::sharded_loss``).

Four gloo ranks (tests/torch_dist.py::single_task_job) run
``ImageEventRestorationModel`` with ``mesh: {spatial: 4}`` on EVHINet (wf 8):
a whole prediction and a tiled one (``val.crop_size``; every tile split
over the ranks; a tile too short to split raises), and one training step
through ``task.train_step`` per ``pixel_opt``: the mean Charbonnier loss,
``PSNRLoss`` (the log of each image's MSE), ``L1Loss`` with ``reduction:
sum`` and ``WeightedTVLoss``.
Each step's loss and gradient norm are held against
``refid_tpu/train/trainer.py::make_train_step`` on the whole batch, and its
gradients against the unsharded port's and ``jax.grad``'s; the prediction
against the JAX network within 2e-4 (tests/test_torch_evhinet.py) and the
unsharded port within 2e-5 (tests/test_spatial_sharding.py).

Besides: the TV loss of a ``(b, t, c, h, w)`` stack (the recurrent tasks'
output) against the JAX loss on NTHWC, whole and on row shards,
``SRNLoss`` raising as the JAX loss does, and the demo CLI as two processes
(``--coordinator / --num-processes / --process-id``, ``mesh: {spatial: 2}``)
writing the one-process demo's PNG.
"""

import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refid_tpu.models.evhinet import EVHINet as JaxEVHINet
from refid_tpu.train.losses import build_loss as jax_build_loss
from refid_tpu.train.trainer import build_optimizer as jax_build_optimizer
from refid_tpu.train.trainer import create_train_state, make_train_step
from refid_tpu_torch.cli import demo
from refid_tpu_torch.data.img_util import imread
from refid_tpu_torch.models.convert import evhinet_state_dict_from_jax
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.train.losses import build_loss
from tests import torch_dist
from tests.synthetic_data import make_gopro_tree
from tests.test_torch_helpers import random_params

torch.set_num_threads(1)

WF, B, H, W = 8, 2, 32, 48
S = 4
TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2e-3, "betas": [0.9, 0.99],
                         "weight_decay": 1e-4},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 50, "eta_min": 1e-7},
             "grad_clip_norm": 0.01, "total_iter": 50}
LOSSES = {"charbonnier_mean": {"type": "CharbonnierLoss", "loss_weight": 1.0},
          "psnr": {"type": "PSNRLoss", "loss_weight": 0.5},
          "l1_sum": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "sum"},
          "tv": {"type": "WeightedTVLoss", "loss_weight": 1.0}}
PRED_TOL, SHARD_TOL = 2e-4, 2e-5


def _opt(pixel=None, val=None):
    opt = {"name": "spatial_evhinet", "model_type": "ImageEventRestorationModel",
           "is_train": pixel is not None, "path": {}, "mesh": {"spatial": S},
           "network_g": {"type": "SingleMultiConnectEVHINet", "wf": WF}, "val": val or {}}
    if pixel is not None:
        opt["train"] = dict(TRAIN_OPT, pixel_opt=pixel)
    return opt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.RandomState(0)
    lq = rng.rand(B, H, W, 3).astype(np.float32)
    voxel = rng.randn(B, H, W, 6).astype(np.float32)
    gt = rng.rand(B, H, W, 3).astype(np.float32)
    jnet = JaxEVHINet(wf=WF)
    flat = flax.traverse_util.flatten_dict(
        random_params(jnet, jnp.asarray(lq), jnp.asarray(voxel), seed=1), sep="/")
    params = flax.traverse_util.unflatten_dict(     # HIN scales near 1
        {k: (1.0 + v if k.endswith("hin_scale") else v) for k, v in flat.items()}, sep="/")
    state = evhinet_state_dict_from_jax(params)
    tv_rng = np.random.RandomState(1)
    tv = (torch.from_numpy(tv_rng.rand(2, 3, 3, 16, 8).astype(np.float32)),
          torch.from_numpy(tv_rng.rand(2, 3, 3, 16, 8).astype(np.float32)))
    opts = {key: _opt(pixel) for key, pixel in LOSSES.items()}
    opts["predict"] = _opt(val={"crop_size": 32, "max_minibatch": 2})
    opts["predict_short_tiles"] = _opt(val={"crop_size": 16})
    work = str(tmp_path_factory.mktemp("single"))
    torch.save({"opts": opts, "state": state, "batch": (lq, voxel, gt), "tv": tv},
               f"{work}/single.pt")
    torch_dist.run_ranks(torch_dist.single_task_job, S, work)
    return {"jnet": jnet, "params": params, "state": state, "batch": (lq, voxel, gt),
            "tv": tv, "sharded": torch.load(f"{work}/single_out.pt", weights_only=False)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _unsharded_task(setup, val):
    opt = _opt(val=val)
    opt["mesh"] = {"spatial": 1}
    task = build_task(opt, "cpu")
    task.net.load_state_dict(setup["state"])
    return task


def test_sharded_prediction_matches_jax_and_unsharded(setup):
    lq, voxel, _ = setup["batch"]
    whole, tiled = setup["sharded"]["predict"]
    want = np.asarray(setup["jnet"].apply(setup["params"], jnp.asarray(lq), jnp.asarray(voxel)))
    assert whole.shape == want.shape == (B, H, W, 3)
    assert np.abs(whole - want).max() < PRED_TOL
    task = _unsharded_task(setup, {"crop_size": 32, "max_minibatch": 2})
    assert np.abs(whole - task.predict(lq, voxel)).max() < SHARD_TOL
    assert np.abs(tiled - task._predict_item(lq[0], voxel[0]).numpy()).max() < SHARD_TOL


def test_tile_too_short_to_split_raises(setup):
    assert "deepest scale" in setup["sharded"]["predict_short_tiles"]


@pytest.mark.parametrize("key", list(LOSSES))
def test_sharded_step_matches_jax(setup, key):
    """One step on row shards against the single-process step: the loss and
    the gradient norm within 1e-4 relative of ``make_train_step``'s, and
    every gradient the optimiser gets (reduced over the group, unclipped
    again) within 2e-5 of the largest of the unsharded port's, and no
    further from ``jax.grad``'s than 1e-4 of the largest
    (tests/test_torch_evhinet_train.py's bar) or twice the unsharded port's
    own distance, whichever is larger.  At this input one HIN channel of
    ``down_path_ev.0`` has a small variance that magnifies rounding: the
    unsharded port's gradients sit 9.3e-4 of the largest from JAX's there
    (1e-6 at 32 x 24 or at another seed), the sharding adds none."""
    grads, got_loss, got_norm = setup["sharded"][key]
    loss_fn = jax_build_loss(LOSSES[key])
    lq, voxel, gt = (jnp.asarray(a) for a in setup["batch"])
    tx, _ = jax_build_optimizer(TRAIN_OPT, TRAIN_OPT["total_iter"])
    _, metrics = make_train_step(setup["jnet"].apply, loss_fn, donate=False)(
        create_train_state(setup["params"], tx), lq, voxel, gt)
    np.testing.assert_allclose(got_loss, float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got_norm, float(metrics["grad_norm"]), rtol=1e-4)
    want = evhinet_state_dict_from_jax(jax.grad(
        lambda p: loss_fn(setup["jnet"].apply(p, lq, voxel), gt))(setup["params"]))
    net = _unsharded_task(setup, {}).net
    build_loss(LOSSES[key])(net(*(_nchw(a) for a in setup["batch"][:2])),
                            _nchw(setup["batch"][2])).backward()
    whole = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in net.named_parameters()}
    unclip = max(1.0, (got_norm + 1e-6) / TRAIN_OPT["grad_clip_norm"])   # clip_grad_norm_'s
    scale = max(float(g.abs().max()) for g in want.values())
    shard_err = max(float((g * unclip - whole[k]).abs().max()) for k, g in grads.items())
    jax_err = max(float((g * unclip - want[k]).abs().max()) for k, g in grads.items())
    port_err = max(float((g - want[k]).abs().max()) for k, g in whole.items())
    assert shard_err < SHARD_TOL * scale, (key, shard_err, scale)
    assert jax_err <= max(1e-4 * scale, 2 * port_err), (key, jax_err, port_err, scale)


def test_tv_loss_of_a_frame_stack_matches_jax_whole_and_sharded(setup):
    """The JAX loss differences NTHWC axes 1 and 2 (time and height of a
    recurrent output); so does the port on ``(b, t, c, h, w)``.  On 4 row
    shards the shares sum to it and the gradients are the whole one's."""
    pred, weight = setup["tv"]
    jax_tv = jax_build_loss(LOSSES["tv"])
    want = float(jax_tv(jnp.asarray(np.moveaxis(pred.numpy(), 2, -1)),
                        jnp.asarray(np.moveaxis(weight.numpy(), 2, -1))))
    local = pred.clone().requires_grad_(True)
    whole = build_loss(LOSSES["tv"])(local, weight)
    whole.backward()
    assert float(whole.detach()) == pytest.approx(want, rel=1e-6)
    ranks = setup["sharded"]["tv_stack"]
    assert sum(share for share, _ in ranks) == pytest.approx(want, rel=1e-6)
    grad = torch.cat([g for _, g in ranks], -2)
    torch.testing.assert_close(grad, local.grad, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 3, 3, 16, 8), (2, 3, 16, 8)], ids=["stack", "image"])
def test_srn_loss_raises_as_jax_does(shape):
    pred = np.random.RandomState(0).rand(*shape).astype(np.float32)
    with pytest.raises(ValueError):
        jax_build_loss({"type": "SRNLoss"})(jnp.asarray(pred), jnp.asarray(pred))
    with pytest.raises(ValueError):
        build_loss({"type": "SRNLoss"})(torch.from_numpy(pred), torch.from_numpy(pred))


def test_two_process_demo_writes_the_one_process_png(setup, tmp_path):
    """The demo CLI split over 2 gloo processes by height (rank 0 writes the
    image) against the same demo in one process: within one uint8 step."""
    import yaml
    make_gopro_tree(str(tmp_path), split="test", videos=("VID_A",), h=H, w=W)
    torch.save({"params": setup["state"]}, tmp_path / "net_g.pth")
    video = tmp_path / "test" / "VID_A"
    outs = {}
    for name, spatial in (("one", 1), ("two", 2)):
        opt = {"name": "demo", "model_type": "ImageEventRestorationModel",
               "network_g": {"type": "SingleMultiConnectEVHINet", "wf": WF}, "val": {},
               "mesh": {"spatial": spatial},
               "path": {"pretrain_network_g": str(tmp_path / "net_g.pth")},
               "img_path": {"input_img": str(video / "blur" / "000002.png"),
                            "input_events": str(tmp_path / "test_event" / "VID_A" / "000004.npz"),
                            "output_img": str(tmp_path / f"{name}.png")}}
        yml = tmp_path / f"{name}.yml"
        yml.write_text(yaml.safe_dump(opt))
        outs[name] = tmp_path / f"{name}.png"
        if spatial == 1:
            demo.main(["-opt", str(yml), "--root", str(tmp_path), "--device", "cpu"])
            continue
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        port = torch_dist.free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "refid_tpu_torch.cli.demo", "-opt", str(yml), "--root",
             str(tmp_path), "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(rank)],
            env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    one, two = (imread(str(outs[k])).astype(np.int32) for k in ("one", "two"))
    assert one.shape == two.shape == (H, W, 3)
    assert int(np.abs(one - two).max()) <= 1
