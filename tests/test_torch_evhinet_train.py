"""Training EVHINet in refid_tpu_torch against refid_tpu (CPU, f32, wf 8):
one step's loss and gradients against ``jax.value_and_grad`` on
``EVHINet.apply``, a 5-step trajectory through the port's ``Trainer``
against ``refid_tpu/train/trainer.py::make_train_step``, the dead branches
(zero gradients, decayed by AdamW as optax decays them), and the train CLI
on the single-image task with its TensorBoard file against what
``refid_tpu.core.tb_writer`` writes for the same calls.

Tolerances: the loss within 1e-5 relative; the worst gradient within 1e-4 of
the largest; the trajectory's losses within rtol 1e-4 and its parameters
within a fraction of the steps' size; event files equal scalar for scalar
(float32 values, exact) and, with the clock fixed, byte for byte.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refid_tpu.core import tb_writer as jax_tb
from refid_tpu.models.evhinet import EVHINet as JaxEVHINet
from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu.train.trainer import build_optimizer as jax_build_optimizer
from refid_tpu.train.trainer import create_train_state, make_train_step
from refid_tpu_torch.cli import train as cli
from refid_tpu_torch.core import logging_util, tb_writer
from refid_tpu_torch.models.convert import evhinet_state_dict_from_jax, known_unused_keys
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.train.losses import charbonnier_loss
from refid_tpu_torch.train.trainer import Trainer
from tests.synthetic_data import make_gopro_tree
from tests.test_torch_helpers import random_params

torch.set_num_threads(1)

WF, B, H, W = 8, 2, 16, 24
TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2e-3, "betas": [0.9, 0.99],
                         "weight_decay": 1e-4},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 50, "eta_min": 1e-7},
             "grad_clip_norm": 0.01}
# what the forward does not compute at depth 3, fac_place 2 (models/evhinet.py)
DEAD = ("down_path_ev.2.", "down_path_ev.1.downsample.", "sam12.conv1.", "sam12.conv3.")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.fixture(scope="module")
def setup():
    """JAX parameters (every leaf random, HIN scales near 1), one NHWC batch
    and the JAX package's jitted train step."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    ev = rng.randn(B, H, W, 6).astype(np.float32)
    gt = rng.rand(B, H, W, 3).astype(np.float32)
    jnet = JaxEVHINet(wf=WF)
    params = random_params(jnet, jnp.asarray(x), jnp.asarray(ev), seed=1)
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    params = flax.traverse_util.unflatten_dict(
        {k: (1.0 + v if k.endswith("hin_scale") else v) for k, v in flat.items()}, sep="/")
    tx, _ = jax_build_optimizer(TRAIN_OPT, 50)
    step = make_train_step(jnet.apply, jax_charbonnier, donate=False)
    return dict(jnet=jnet, params=params, tx=tx, step=step, batch=(x, ev, gt))


def _port_net(params):
    net = EVHINet(wf=WF)
    net.load_state_dict(evhinet_state_dict_from_jax(params))
    return net


def _dead(name):
    return name.startswith(DEAD)


def test_one_step_loss_and_grads_match_jax(setup):
    jnet, params = setup["jnet"], setup["params"]
    x, ev, gt = (jnp.asarray(a) for a in setup["batch"])
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_charbonnier(jnet.apply(p, x, ev), gt))(params)
    grads_j = evhinet_state_dict_from_jax(grads_j)

    net = _port_net(params)
    x, ev, gt = (_nchw(a) for a in setup["batch"])
    loss = charbonnier_loss(net(x, ev), gt)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    names = dict(net.named_parameters())
    assert names.keys() == grads_j.keys()
    dead = {k for k in names if _dead(k)}
    assert dead and all(names[k].grad is None for k in dead)     # never computed here
    assert all(not grads_j[k].any() for k in dead)                # zeros in JAX
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in names.items()}
    scale = max(float(g.abs().max()) for g in grads_j.values())
    worst = max(float((got[k] - grads_j[k]).abs().max()) for k in got)
    assert worst < 1e-4 * scale, (worst, scale)


def test_five_step_trajectory_matches_jax(setup):
    state = create_train_state(setup["params"], setup["tx"])
    jbatch = [jnp.asarray(a) for a in setup["batch"]]
    want, want_norms = [], []
    for _ in range(5):
        state, metrics = setup["step"](state, *jbatch)
        want.append(float(metrics["loss"]))
        want_norms.append(float(metrics["grad_norm"]))

    net = _port_net(setup["params"])
    trainer = Trainer(net, charbonnier_loss, TRAIN_OPT, 50, frozen=known_unused_keys(net))
    batch = [_nchw(a) for a in setup["batch"]]
    got, norms = [], []
    for _ in range(5):
        metrics = trainer.train_step(*batch)
        got.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    assert got[-1] < got[0]
    # a HIN block's conv_1 bias on its normalized half has a gradient that is
    # zero but for rounding (the instance norm subtracts the mean), which
    # AdamW turns into steps of +-lr in either package: those elements are
    # held to 2 x 5 steps, every other element to a fraction of one
    lr = TRAIN_OPT["optim_g"]["lr"]
    moved = evhinet_state_dict_from_jax(state.params)
    worst = noisy = 0.0
    for k, p in net.named_parameters():
        diff = (p.detach() - moved[k]).abs()
        block = net.get_submodule(k.rsplit(".", 2)[0]) if k.endswith("conv_1.bias") else None
        if block is not None and block.norm is not None:
            half = block.norm.weight.shape[0]
            noisy = max(noisy, float(diff[:half].max()))
            diff = diff[half:]
        worst = max(worst, float(diff.max()))
    assert worst < 2e-3 * lr * 5, worst
    assert noisy <= 2 * 5 * lr, noisy


def test_dead_branches_get_zero_grads_and_decay_as_under_optax(setup):
    """One step: the dead parameters' gradients are zeros, and AdamW moves
    them by the decay alone, p * (1 - lr * wd), to what optax gives."""
    net = _port_net(setup["params"])
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    trainer = Trainer(net, charbonnier_loss, TRAIN_OPT, 50)
    lr = trainer.current_lr()
    trainer.train_step(*[_nchw(a) for a in setup["batch"]])
    state, _ = setup["step"](create_train_state(setup["params"], setup["tx"]),
                             *[jnp.asarray(a) for a in setup["batch"]])
    optax_params = evhinet_state_dict_from_jax(state.params)
    decay = 1.0 - lr * TRAIN_OPT["optim_g"]["weight_decay"]
    dead = [(k, p) for k, p in net.named_parameters() if _dead(k)]
    assert {d for d in DEAD if any(k.startswith(d) for k, _ in dead)} == set(DEAD)
    for k, p in dead:
        assert not p.grad.any(), k
        torch.testing.assert_close(p.detach(), before[k] * decay, rtol=1e-6, atol=0)
        torch.testing.assert_close(p.detach(), optax_params[k], rtol=1e-6, atol=1e-9)
        assert not torch.equal(p.detach(), before[k])
    live = [k for k, p in net.named_parameters() if not _dead(k)]
    assert all(net.get_parameter(k).grad.abs().sum() > 0 for k in live if k.endswith("weight"))


# --- TensorBoard ---------------------------------------------------------------------

CALLS = [({"losses/loss": 0.125, "losses/grad_norm": 3.5e-3, "learning_rate": 2e-4}, 1),
         ({"losses/loss": -1.0e30, "learning_rate": 1e-7}, 200000),
         ({"metrics/synth/psnr": 31.25, "metrics/synth/ssim": 0.875}, 2 ** 40),
         ({"metrics/ünï/x": float("inf")}, 0)]


def _fixed_clock(monkeypatch):
    for mod in (tb_writer, jax_tb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(tb_writer.socket, "gethostname", lambda: "host")
    monkeypatch.setattr(jax_tb.socket, "gethostname", lambda: "host")


def test_event_file_is_the_jax_writers_byte_for_byte(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    files = []
    for mod, sub in ((tb_writer, "ours"), (jax_tb, "ref")):
        with mod.TensorBoardWriter(str(tmp_path / sub)) as w:
            for tags, step in CALLS:
                w.add_scalars(tags, step)
            w.add_scalar("learning_rate", 0.5, 7)
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as f, open(files[1], "rb") as g:
        assert f.read() == g.read()
    got = tb_writer.read_scalars(files[0])
    want = [(step, tag, np.float32(v)) for tags, step in CALLS for tag, v in tags.items()]
    assert got[:-1] == want and got[-1] == (7, "learning_rate", 0.5)


def test_event_file_crc_is_checked(tmp_path):
    with tb_writer.TensorBoardWriter(str(tmp_path)) as w:
        w.add_scalar("a", 1.0, 1)
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 1
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tb_writer.read_scalars(w.path)


def test_tb_and_wandb_gating_match_jax(tmp_path, monkeypatch, caplog):
    import sys
    monkeypatch.setitem(sys.modules, "wandb", None)
    base = {"name": "exp", "path": {"root": str(tmp_path)}}
    assert logging_util.init_tb_logger({**base, "logger": {"use_tb_logger": False}}) is None
    w = logging_util.init_tb_logger({**base, "logger": {"use_tb_logger": True,
                                                         "wandb": {"project": "p"}}})
    assert os.path.dirname(w.path) == str(tmp_path / "tb_logger" / "exp")
    w.close()
    assert logging_util.init_wandb_logger({**base, "logger": {"wandb": {"project": "p"}}}) \
        is None
    assert logging_util.init_wandb_logger({**base, "logger": {}}) is None
    logger = logging_util.get_root_logger()
    logger.addHandler(caplog.handler)
    try:
        logging_util.init_tb_logger({**base, "logger": {"use_tb_logger": False,
                                                        "wandb": {"project": "p"}}})
        logging_util.init_wandb_logger({**base, "logger": {"wandb": {"project": "p"}}})
    finally:
        logger.removeHandler(caplog.handler)
    text = caplog.text
    assert "DISABLED" in text and "wandb package is not installed" in text


# --- the train CLI on EVHINet --------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gopro_single"))
    for split in ("train", "test"):
        make_gopro_tree(root, split=split, videos=("VID_A",), num_blur=4, h=24, w=32)
    return root


def _cli_opt(tmp_path, data_root):
    single = {"type": "GoProSingleImageEventDataset", "dataroot": data_root,
              "num_bins": 6, "video_list": ["VID_A"], "scale": 1}
    return {
        "name": "evhinet_toy", "model_type": "ImageEventRestorationModel", "scale": 1,
        "manual_seed": 10, "is_train": True,
        "datasets": {
            "train": {**single, "name": "synth_train", "phase": "train", "gt_size": 16,
                      "use_hflip": True, "use_rot": True, "use_shuffle": True,
                      "num_worker_per_gpu": 1, "batch_size_per_gpu": 2,
                      "dataset_enlarge_ratio": 2},
            "val": {**single, "name": "synth", "phase": "val"}},
        "network_g": {"type": "SingleMultiConnectEVHINet", "wf": WF},
        "path": {"pretrain_network_g": None, "root": str(tmp_path),
                 "experiments_root": str(tmp_path / "exp"),
                 "models": str(tmp_path / "exp" / "models"), "log": str(tmp_path / "exp"),
                 "visualization": str(tmp_path / "vis")},
        "train": dict(TRAIN_OPT, total_iter=2, warmup_iter=-1,
                      pixel_opt={"type": "CharbonnierLoss", "loss_weight": 1.0,
                                 "reduction": "mean"}),
        "val": {"val_freq": 2, "save_img": False,
                "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0,
                                     "test_y_channel": False}}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 0, "use_tb_logger": True},
    }


def test_cli_trains_evhinet_and_writes_the_jax_event_file(tmp_path, data_root):
    task = cli.train(_cli_opt(tmp_path, data_root), device="cpu")
    steps = [h for h in task.history if "loss" in h]
    vals = [h for h in task.history if "val" in h]
    assert [h["iter"] for h in steps] == [1, 2] and [h["iter"] for h in vals] == [2]
    assert all(np.isfinite(h["loss"]) for h in steps) and np.isfinite(vals[0]["psnr"])
    assert isinstance(task.net, EVHINet)
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "tb_logger" / "evhinet_toy")
               for f in fs if f.startswith("events.out.tfevents.")]

    # the same calls through the JAX package's writer
    with jax_tb.TensorBoardWriter(str(tmp_path / "ref")) as ref:
        for h in steps:
            ref.add_scalars({"losses/loss": h["loss"], "losses/grad_norm": h["grad_norm"],
                             "learning_rate": h["lr"]}, h["iter"])
        ref.add_scalars({"metrics/synth/psnr": vals[0]["psnr"]}, vals[0]["iter"])
    got, want = tb_writer.read_scalars(path), tb_writer.read_scalars(ref.path)
    assert got == want and len(got) == 7
    assert {tag for _, tag, _ in got} == {"losses/loss", "losses/grad_norm", "learning_rate",
                                         "metrics/synth/psnr"}
