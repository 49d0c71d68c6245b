"""refid_tpu_torch training (task, trainer, remat, checkpoints, CLI) against
the JAX package's train step (CPU, f32, toy widths)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu.train.trainer import build_optimizer as jax_build_optimizer
from refid_tpu.train.trainer import create_train_state, make_train_step
from refid_tpu_torch.cli import train as cli
from refid_tpu_torch.models import FinalBidirectionAttenfusion, RefidConfig
from refid_tpu_torch.models.archs import _refid_cfg
from refid_tpu_torch.models.convert import (
    known_unused_keys, load_state, state_dict_from_jax,
)
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.train.losses import charbonnier_loss
from refid_tpu_torch.train.trainer import Trainer
from tests.synthetic_data import make_gopro_tree
from tests.test_torch_helpers import random_params, to_nhwc

torch.set_num_threads(1)

TOY = dict(img_chn=26, ev_chn=2, num_encoders=2, base_num_channels=4,
           num_residual_blocks=1)
B, T, H, W = 1, 3, 16, 24
TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2e-3, "betas": [0.9, 0.99],
                         "weight_decay": 1e-4},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 50,
                           "eta_min": 1e-7},
             "grad_clip_norm": 0.01}


@pytest.fixture(scope="module")
def setup():
    """JAX params, the same weights in the port, one NCHW batch, and the
    JAX package's jitted train step (compiled once for the module)."""
    rng = np.random.RandomState(0)
    lq = rng.rand(B, 26, H, W).astype(np.float32)
    vox = rng.randn(B, T, 2, H, W).astype(np.float32)
    gt = rng.rand(B, T, 3, H, W).astype(np.float32)
    jnet = JaxNet(JaxConfig(**TOY))
    params = random_params(jnet, to_nhwc(lq), to_nhwc(vox), seed=1)
    tx, _ = jax_build_optimizer(TRAIN_OPT, 50)
    step = make_train_step(jnet.apply, jax_charbonnier, donate=False)
    return dict(jnet=jnet, params=params, tx=tx, step=step,
                batch=(lq, vox, gt),
                jbatch=(to_nhwc(lq), to_nhwc(vox), to_nhwc(gt)))


def _port_net(params, **cfg):
    net = FinalBidirectionAttenfusion(RefidConfig(**TOY, **cfg))
    load_state(net, state_dict_from_jax(params, net.cfg))
    return net


def _tensors(batch):
    return [torch.from_numpy(a) for a in batch]


def test_one_step_loss_and_grads_match_jax(setup):
    jnet, params = setup["jnet"], setup["params"]
    jlq, jvox, jgt = setup["jbatch"]
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_charbonnier(jnet.apply(p, jlq, jvox), jgt))(params)
    grads_j = state_dict_from_jax(grads_j, RefidConfig(**TOY))

    net = _port_net(params)
    lq, vox, gt = _tensors(setup["batch"])
    loss = charbonnier_loss(net(lq, vox), gt)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    # the last backward stage's down conv does not reach the loss: no grad
    # here, zeros in JAX
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in net.named_parameters() if k in grads_j}
    assert got.keys() == grads_j.keys()
    assert not grads_j["encoders_backward.1.down.weight"].any()
    scale = max(float(g.abs().max()) for g in grads_j.values())
    worst = max(float((got[k] - grads_j[k]).abs().max()) for k in got)
    assert worst < 1e-4 * scale, (worst, scale)


def test_five_step_trajectory_matches_jax(setup):
    state = create_train_state(setup["params"], setup["tx"])
    want = []
    for _ in range(5):
        state, metrics = setup["step"](state, *setup["jbatch"])
        want.append(float(metrics["loss"]))

    net = _port_net(setup["params"])
    trainer = Trainer(net, charbonnier_loss, TRAIN_OPT, 50,
                      frozen=known_unused_keys(net))
    got = [float(trainer.train_step(*_tensors(setup["batch"]))["loss"])
           for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    moved = state_dict_from_jax(state.params, net.cfg)
    worst = max(float((p.detach() - moved[k]).abs().max())
                for k, p in net.named_parameters() if k in moved)
    assert worst < 2e-3 * TRAIN_OPT["optim_g"]["lr"] * 5   # a fraction of the steps


def test_remat_equals_no_remat(setup):
    results = []
    for remat in (False, True):
        net = _port_net(setup["params"], remat=remat)
        trainer = Trainer(net, charbonnier_loss, TRAIN_OPT, 50)
        losses = [float(trainer.train_step(*_tensors(setup["batch"]))["loss"])
                  for _ in range(2)]
        unused = known_unused_keys(net)     # never filled from JAX: random init
        results.append((losses, {k: v.clone() for k, v in net.state_dict().items()
                                 if k not in unused}))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], v, rtol=0, atol=0)


def test_bf16_autocast_tracks_f32(setup):
    lq, vox, _ = _tensors(setup["batch"])
    with torch.no_grad():
        f32 = _port_net(setup["params"])(lq, vox)
        bf16 = _port_net(setup["params"], dtype=torch.bfloat16)(lq, vox)
    assert bf16.dtype == torch.float32
    assert float((bf16 - f32).abs().max()) < 0.05 * float(f32.abs().max())


def test_config_options_map_like_jax():
    opt = {"img_chn": 26, "ev_chn": 2, "remat": True, "compute_dtype": "bfloat16"}
    cfg = _refid_cfg(opt)
    assert cfg.remat and cfg.remat_policy == "all" and cfg.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        FinalBidirectionAttenfusion(dataclasses.replace(cfg, remat_policy="stage_outputs"))
    with pytest.raises(ValueError):
        _refid_cfg(dict(opt, compute_dtype="float16"))


# --- the task, checkpoints and the CLI -------------------------------------

def _task_opt(tmp_path, data_root, **train_kw):
    return {
        "name": "toy", "model_type": "TwoImageEventRecurrentRestorationModel",
        "scale": 1, "manual_seed": 10, "is_train": True,
        "datasets": {"train": {
            "name": "synth", "type": "GoProEventRecurrentDataset", "phase": "train",
            "dataroot": data_root, "num_end_interpolation": 2,
            "num_inter_interpolation": 1, "norm_voxel": True, "one_voxel_flag": True,
            "return_deblur_voxel": True, "gt_size": 16, "use_hflip": True,
            "use_rot": True, "use_shuffle": True, "num_worker_per_gpu": 1,
            "batch_size_per_gpu": 1, "dataset_enlarge_ratio": 2,
            "video_list": ["VID_A", "VID_B"]}},
        "network_g": {"type": "FinalBidirectionAttenfusion", "img_chn": 8,
                      "ev_chn": 2, "num_encoders": 2, "base_num_channels": 4,
                      "num_residual_blocks": 1},
        "path": {"pretrain_network_g": None, "root": str(tmp_path),
                 "experiments_root": str(tmp_path / "exp"),
                 "models": str(tmp_path / "exp" / "models"),
                 "log": str(tmp_path / "exp")},
        "train": dict(TRAIN_OPT, total_iter=4, warmup_iter=-1, ema_decay=0.9,
                      pixel_opt={"type": "CharbonnierLoss", "loss_weight": 1.0,
                                 "reduction": "mean"}, **train_kw),
        "logger": {"print_freq": 1, "save_checkpoint_freq": 0},
    }


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(root, m=2, n=1)
    return root


def _batches(n):
    rng = np.random.RandomState(3)
    return [{"lq": rng.rand(1, 16, 16, 8).astype(np.float32),
             "voxel": rng.randn(1, 3, 16, 16, 2).astype(np.float32),
             "gt": rng.rand(1, 3, 16, 16, 3).astype(np.float32),
             "seq": ["x"]} for _ in range(n)]


def test_resume_is_bitwise_equal_to_straight_steps(tmp_path, data_root):
    batches = _batches(4)
    straight = build_task(_task_opt(tmp_path / "a", data_root), device="cpu")
    straight.init_params(3)
    straight.setup_train_state()
    want = [float(straight.train_step(b)["loss"]) for b in batches]

    first = build_task(_task_opt(tmp_path / "b", data_root), device="cpu")
    first.init_params(3)
    first.setup_train_state()
    got = [float(first.train_step(b)["loss"]) for b in batches[:2]]
    first.save(2, epoch=1)
    second = build_task(_task_opt(tmp_path / "b", data_root), device="cpu")
    second.init_params(99)                 # overwritten by the resume
    second.setup_train_state()
    assert second.auto_resume() and second.start_iter == 2 and second.start_epoch == 1
    got += [float(second.train_step(b)["loss"]) for b in batches[2:]]
    assert got == want
    for k, v in straight.net.state_dict().items():
        torch.testing.assert_close(second.net.state_dict()[k], v, rtol=0, atol=0)
    for k, v in straight.trainer.ema.items():
        torch.testing.assert_close(second.trainer.ema[k], v, rtol=0, atol=0)


def test_batches_go_to_nchw(tmp_path, data_root):
    task = build_task(_task_opt(tmp_path, data_root), device="cpu")
    dev = list(task.device_prefetch(iter(_batches(2))))
    assert len(dev) == 2
    assert dev[0]["lq"].shape == (1, 8, 16, 16)
    assert dev[0]["voxel"].shape == (1, 3, 2, 16, 16)
    assert dev[0]["gt"].shape == (1, 3, 3, 16, 16)
    np.testing.assert_array_equal(dev[1]["voxel"][0, 2, 1].numpy(),
                                  _batches(2)[1]["voxel"][0, 2, :, :, 1])


def test_load_pretrained_reads_upstream_pth_and_port_checkpoints(tmp_path, data_root):
    """An upstream-style ``.pth`` (known-unused keys left out) loads into
    the port, and the JAX package's ``load_pth_params`` reads the same file
    into a network whose forward equals the port's."""
    task = build_task(_task_opt(tmp_path, data_root), device="cpu")
    task.init_params(5)
    unused = known_unused_keys(task.net)
    state = {k: v for k, v in task.net.state_dict().items() if k not in unused}
    pth = tmp_path / "net_g.pth"
    torch.save({"params": state}, pth)
    ddp = tmp_path / "net_g_ddp.pth"
    torch.save({"params_ema": {f"module.{k}": v for k, v in state.items()}}, ddp)
    for path in (pth, ddp):
        other = build_task(_task_opt(tmp_path, data_root), device="cpu")
        other.init_params(6)
        other.load_pretrained(str(path))
        for k, v in state.items():
            torch.testing.assert_close(other.net.state_dict()[k], v, rtol=0, atol=0)

    from refid_tpu.models.convert import load_pth_params
    net_opt = _task_opt(tmp_path, data_root)["network_g"]
    jcfg = JaxConfig(**{k: v for k, v in net_opt.items() if k != "type"})
    jparams = load_pth_params(str(pth), jcfg)
    rng = np.random.RandomState(4)
    lq = rng.rand(1, 8, 16, 24).astype(np.float32)
    vox = rng.randn(1, 3, 2, 16, 24).astype(np.float32)
    want = np.moveaxis(np.asarray(JaxNet(jcfg).apply(jparams, to_nhwc(lq), to_nhwc(vox))), -1, -3)
    with torch.no_grad():
        got = other.net.eval()(torch.from_numpy(lq), torch.from_numpy(vox)).numpy()
    assert float(np.abs(got - want).max()) < 2e-4

    task.setup_train_state()
    task.save(7)
    third = build_task(_task_opt(tmp_path / "c", data_root), device="cpu")
    third.load_pretrained(task.ckpt.directory)
    for k, v in task.net.state_dict().items():
        torch.testing.assert_close(third.net.state_dict()[k], v, rtol=0, atol=0)
    torch.save({"params": {"bogus": torch.zeros(1)}}, tmp_path / "bad.pth")
    with pytest.raises(KeyError):
        third.load_pretrained(str(tmp_path / "bad.pth"))


def test_cli_trains_two_iterations_on_cpu(tmp_path, data_root):
    opt = _task_opt(tmp_path, data_root)
    opt.pop("is_train")
    opt["path"] = {"pretrain_network_g": None}
    opt["train"]["total_iter"] = 5
    cfg = tmp_path / "toy.yml"
    cfg.write_text(yaml.safe_dump(opt))
    task = cli.main(["-opt", str(cfg), "--root", str(tmp_path), "--max-iters", "2",
                     "--device", "cpu"])
    assert task.trainer.step == 2 and len(task.history) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in task.history)
    assert task.ckpt.latest_step() == 2
    assert os.path.isfile(os.path.join(tmp_path, "experiments", "toy", "train_toy.log"))
    # a second run resumes from the final checkpoint
    task = cli.main(["-opt", str(cfg), "--root", str(tmp_path), "--max-iters", "3",
                     "--device", "cpu"])
    assert task.start_iter == 2 and task.trainer.step == 3


def test_cli_refuses_validation_and_defaults_to_the_card(tmp_path, data_root):
    """Validation runs (tests/test_torch_validate.py); the CLI refuses, before
    any step, what it cannot validate: a static int8 predict (no calibration)
    and a val dataset of no registered type."""
    opt = _task_opt(tmp_path, data_root)
    with pytest.raises(ValueError, match="calibrat"):
        cli.train(dict(opt, val={"val_freq": 5, "int8": "static"}), device="cpu")
    with pytest.raises(KeyError):
        cli.train(dict(opt, datasets=dict(opt["datasets"], val={"type": "x"})),
                  device="cpu")
    assert cli.parse_args(["-opt", "x.yml"]).device == "cuda"
    with pytest.raises(SystemExit):
        cli.parse_args(["-opt", "x.yml", "--num-processes", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.train(opt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chip_smoke_trains_the_recipe_with_listed_overrides_only(tmp_path, dtype):
    """chip_smoke.py's training options equal what parse_options makes of
    the production recipe, apart from the overrides listed here."""
    import chip_smoke
    from refid_tpu_torch.core.config import parse_options

    with open(chip_smoke.RECIPE) as f:
        opt = chip_smoke.recipe_overrides(yaml.safe_load(f), "/data", f"run_{dtype}", dtype)
    path = tmp_path / "run.yml"
    path.write_text(yaml.safe_dump(opt))
    got = parse_options(str(path), root=str(tmp_path))
    want = parse_options(chip_smoke.RECIPE, root=str(tmp_path))
    # the listed overrides
    assert got["val"]["val_freq"] == chip_smoke.VAL_FREQ
    want["val"]["val_freq"] = chip_smoke.VAL_FREQ
    assert got["name"] == f"run_{dtype}"
    want["name"] = got["name"]
    for key in ("experiments_root", "models", "training_states", "log", "visualization"):
        want["path"][key] = got["path"][key]
    assert got["datasets"]["train"]["dataroot"] == got["datasets"]["val"]["dataroot"] == "/data"
    assert got["datasets"]["train"]["video_list"] == ["SYNTH"]
    want["datasets"]["train"].update(dataroot="/data", video_list=["SYNTH"])
    want["datasets"]["val"]["dataroot"] = "/data"
    assert got["logger"] == dict(want["logger"], print_freq=1, save_checkpoint_freq=0,
                                 use_tb_logger=False)
    want["logger"] = got["logger"]
    if dtype == "bf16":
        assert got["network_g"].pop("compute_dtype") == "bfloat16"
    assert got == want
    assert want["network_g"]["remat"] and want["datasets"]["train"]["gt_size"] == 256
