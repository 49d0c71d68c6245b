"""refid_tpu_torch evaluation against the JAX package on the CPU: the tasks'
``predict`` and ``validate``, the test CLI, validation inside the train
CLI, and the test datasets (toy network, ``tests/synthetic_data.py``)."""

import math
import os

import numpy as np
import pytest
import torch
import yaml

from refid_tpu.data import build_dataset as jax_build_dataset
from refid_tpu.data import build_loader as jax_build_loader
from refid_tpu.data.img_util import tensor2img as jax_tensor2img
from refid_tpu.eval.metrics import calculate_psnr as jax_psnr
from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.tasks import build_task as jax_build_task
from refid_tpu_torch.cli import test as test_cli
from refid_tpu_torch.cli import train as train_cli
from refid_tpu_torch.core.checkpoint import CheckpointManager
from refid_tpu_torch.data.loader import build_dataset, build_loader
from refid_tpu_torch.models import RefidConfig
from refid_tpu_torch.models.convert import load_state, state_dict_from_jax
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.tasks.recurrent import TwoImageEventRecurrentRestorationTask
from tests.synthetic_data import make_gopro_tree
from tests.test_torch_helpers import random_params, to_nhwc

torch.set_num_threads(1)

M, N = 2, 1
H, W = 32, 48
NET = {"type": "FinalBidirectionAttenfusion", "img_chn": 8, "ev_chn": 2,
       "num_encoders": 2, "base_num_channels": 4, "num_residual_blocks": 1}
SHARP_NET = dict(NET, img_chn=26)
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 0, "test_y_channel": False},
           "ssim": {"type": "calculate_ssim", "crop_border": 0, "test_y_channel": False}}
PRED_TOL, PSNR_DB, SSIM_TOL = 2e-4, 0.05, 1e-3


def _task_opt(tmp_path, net=NET, model="TestTwoImageEventRecurrentRestorationModel", **val):
    return {"name": "toy_eval", "model_type": model, "is_train": False,
            "network_g": dict(net), "path": {"visualization": str(tmp_path / "vis")},
            "val": {"metrics_deblur": METRICS, "metrics_interpo": METRICS,
                    "max_minibatch": 2, "crop_size": None, **val}}


def _dataset_opt(root, dtype="GoProEventRecurrentDataset", m=M, n=N, **kw):
    opt = {"name": "synth", "type": dtype, "phase": "val", "scale": 1, "dataroot": root,
           "num_end_interpolation": m, "num_inter_interpolation": n, "norm_voxel": True,
           "one_voxel_flag": True, "return_deblur_voxel": True, "gt_size": None,
           "use_hflip": False, "use_rot": False, "video_list": ["VID_A"]}
    opt.update(kw)
    return opt


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    gopro = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(gopro, m=M, n=N, h=H, w=W)
    make_gopro_tree(gopro, split="test", m=M, n=N, h=H, w=W, seed=1)
    highrev = str(tmp_path_factory.mktemp("highrev"))
    make_gopro_tree(highrev, layout="highrev", split="test", m=M, n=N, h=H, w=W, seed=2)
    return {"gopro": gopro, "highrev": highrev}


def _weights(net, seed):
    """Random JAX params for ``net`` and the same weights as a port state_dict."""
    cfg = {k: v for k, v in net.items() if k != "type"}
    rng = np.random.RandomState(0)
    lq = to_nhwc(rng.rand(1, cfg["img_chn"], 16, 16).astype(np.float32))
    vox = to_nhwc(rng.rand(1, 3, 2, 16, 16).astype(np.float32))
    params = random_params(JaxNet(JaxConfig(**cfg)), lq, vox, seed=seed)
    return params, state_dict_from_jax(params, RefidConfig(**cfg))


def _pair(tmp_path, net=NET, seed=1, **kw):
    """The JAX task and the port task (CPU) with the same weights."""
    params, state = _weights(net, seed)
    jtask = jax_build_task(_task_opt(tmp_path, net, **kw))
    jtask.params = params
    task = build_task(_task_opt(tmp_path, net, **kw), device="cpu")
    load_state(task.net, state)
    return jtask, task


def _loaders(dopt):
    return (jax_build_loader(jax_build_dataset(dict(dopt)), dopt, False),
            build_loader(build_dataset(dict(dopt), device="cpu"), dopt, False))


def _assert_close_results(got, want, psnr_tol=PSNR_DB, ssim_tol=SSIM_TOL):
    assert got.keys() == want.keys() and got
    for k, v in want.items():
        assert math.isfinite(got[k])
        assert abs(got[k] - v) <= (ssim_tol if "ssim" in k else psnr_tol), (k, got[k], v)


def test_predict_matches_jax(tmp_path, roots):
    jtask, task = _pair(tmp_path)
    item = build_dataset(_dataset_opt(roots["gopro"]), device="cpu")[1]
    lq, vox = item["lq"][None], item["voxel"][None]
    got = task.predict(lq, vox)
    want = np.asarray(jtask.predict(lq, vox))
    assert got.shape == want.shape == (1, 2 * M + N, H, W, 3)
    assert float(np.abs(got - want).max()) < PRED_TOL
    assert task.predict_tensor(lq, vox).shape == (1, 2 * M + N, H, W, 3)


def test_validate_matches_jax(tmp_path, roots):
    jtask, task = _pair(tmp_path)
    dopt = _dataset_opt(roots["gopro"])
    jloader, loader = _loaders(dopt)
    want = jtask.validate(jloader, dopt)
    got = task.validate(loader, dopt)
    assert set(got) == {f"{b}_{k}" for b in ("deblur", "interpo", "total")
                        for k in ("psnr", "ssim")}
    _assert_close_results(got, want)
    assert task.val_timing["items"] == 2 and task.val_timing["predict_ms"] > 0
    assert task.val_timing["metric_ms"] > 0 and task.val_timing["save_ms"] == 0


def test_validate_given_the_same_predictions(tmp_path, roots):
    """Identical frames in: PSNR within 1e-9 dB and SSIM within 1e-5."""
    jtask, task = _pair(tmp_path)
    dopt = _dataset_opt(roots["gopro"])
    jloader, loader = _loaders(dopt)
    preds = [np.asarray(jtask.predict(b["lq"], b["voxel"])) for b in jloader]
    jpreds, ppreds = iter(preds), iter(preds)
    jtask.predict = lambda lq, vox: next(jpreds)
    task.predict_tensor = lambda lq, vox: torch.tensor(next(ppreds))
    want, got = jtask.validate(jloader, dopt), task.validate(loader, dopt)
    _assert_close_results(got, want, psnr_tol=1e-9, ssim_tol=1e-5)


def test_validate_mixed_frame_counts():
    """The average divides by the frames that fed each bucket across all
    items (tests/test_e2e.py::test_validation_mixed_frame_counts)."""
    task = TwoImageEventRecurrentRestorationTask.__new__(TwoImageEventRecurrentRestorationTask)
    task.opt = {"val": {"metrics_deblur": {"psnr": {"type": "calculate_psnr"}},
                        "metrics_interpo": {"psnr": {"type": "calculate_psnr"}}},
                "path": {}}
    task.device = torch.device("cpu")
    rng = np.random.RandomState(0)
    items = []
    for t_out in (5, 6):          # 2m+n, then as if n were 2
        gt = rng.rand(t_out, 8, 8, 3).astype(np.float32)
        items.append((np.clip(gt + 0.1 * rng.randn(*gt.shape).astype(np.float32), 0, 1), gt))
    preds = iter([p for p, _ in items])
    task.predict_tensor = lambda lq, vox: torch.from_numpy(next(preds))[None]
    loader = [{"lq": np.zeros((1, 8, 8, 3), np.float32),
               "voxel": np.zeros((1, 5, 8, 8, 2), np.float32),
               "gt": gt[None], "seq": ["s"], "origin_index": ["0"]} for _, gt in items]
    res = task.validate(loader, {"num_end_interpolation": M, "num_inter_interpolation": N})
    deblur, interpo = [], []
    for pred, gt in items:
        for f in range(pred.shape[0]):
            v = jax_psnr(jax_tensor2img(pred[f]), jax_tensor2img(gt[f]))
            (interpo if M <= f < M + N else deblur).append(v)
    assert abs(res["deblur_psnr"] - np.mean(deblur)) < 1e-9
    assert abs(res["interpo_psnr"] - np.mean(interpo)) < 1e-9
    assert abs(res["total_psnr"] - (2 * M * np.mean(deblur) + N * np.mean(interpo))
               / (2 * M + N)) < 1e-9


def test_sharp_vfi_validate_matches_jax(tmp_path, roots):
    jtask, task = _pair(tmp_path, SHARP_NET, seed=2,
                        model="TestTwoSharpImageEventRecurrentRestorationModel")
    dopt = _dataset_opt(roots["gopro"], "GoProSharpEventRecurrentDataset", m=1, n=3)
    jloader, loader = _loaders(dopt)
    want, got = jtask.validate(jloader, dopt), task.validate(loader, dopt, 0)
    assert set(got) == {"psnr", "ssim"}
    _assert_close_results(got, want)


@pytest.mark.parametrize("trans_num", [1, 8])
def test_tiled_validate_matches_jax(tmp_path, roots, trans_num):
    jtask, task = _pair(tmp_path, crop_size=16, trans_num=trans_num)
    dopt = _dataset_opt(roots["gopro"])
    jloader, loader = _loaders(dopt)
    want = jtask.validate(jloader, dopt, max_items=1)
    got = task.validate(loader, dopt, max_items=1)
    _assert_close_results(got, want)
    assert task.val_timing["items"] == 1


def test_validate_saves_images(tmp_path, roots):
    _, task = _pair(tmp_path)
    dopt = _dataset_opt(roots["gopro"])
    task.validate(build_loader(build_dataset(dopt, device="cpu"), dopt, False), dopt,
                  save_img=True, max_items=1)
    saved = sorted(os.listdir(tmp_path / "vis" / "synth" / "VID_A"))
    assert len(saved) == 2 * M + N and saved[0].endswith("_0.png")
    assert task.val_timing["save_ms"] > 0       # the writes, apart from the metrics


@pytest.mark.parametrize("dtype,root,m,n,kw", [
    ("GoProSharpEventRecurrentDataset", "gopro", 1, 3, {}),
    ("GoProSharpwithVoxelEventRecurrentDataset", "gopro", 1, 3, {}),
    ("GoProSharpEventRecurrentDataset", "gopro", 1, 3, {"return_deblur_voxel": False}),
    ("RuisiEventRecurrentDataset", "highrev", M, N, {"video_list": None}),
    ("RuisiSharpEventRecurrentDataset", "highrev", 1, 3, {"video_list": None}),
])
def test_test_datasets_equal_jax(roots, dtype, root, m, n, kw):
    """The datasets the shipped test options name, item by item; voxels at
    the C++ host path's 1e-5 (tests/test_torch_data.py)."""
    dopt = _dataset_opt(roots[root], dtype, m=m, n=n, **kw)
    ours, ref = build_dataset(dict(dopt), device="cpu"), jax_build_dataset(dict(dopt))
    assert len(ours) == len(ref) > 0
    for idx in range(len(ref)):
        got, want = ours[idx], ref[idx]
        assert got.keys() == want.keys()
        for key in ("lq", "gt", "voxel"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
        assert (got["seq"], got["origin_index"]) == (want["seq"], want["origin_index"])


def test_every_shipped_test_option_has_its_dataset_and_task():
    import refid_tpu_torch.data  # noqa: F401 (registers the datasets)
    from refid_tpu_torch.core.registry import DATASETS, MODELS
    from refid_tpu_torch.tasks import recurrent  # noqa: F401 (registers the tasks)
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "options", "test")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                   if f.endswith(".yml"))
    assert len(files) == 8
    for path in files:
        opt = yaml.safe_load(open(path))
        MODELS.get(opt["model_type"])
        for dataset_opt in opt["datasets"].values():
            DATASETS.get(dataset_opt["type"])


# --- predict's options and modes -------------------------------------------------

def test_predict_restores_the_mode_and_reads_the_ema(tmp_path, roots):
    opt = _task_opt(tmp_path, folded_predict=False)
    opt.update(is_train=True, train={
        "optim_g": {"type": "AdamW", "lr": 1e-2, "betas": [0.9, 0.99], "weight_decay": 0.0},
        "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 10, "eta_min": 1e-7},
        "total_iter": 10, "ema_decay": 0.5})
    task = build_task(opt, device="cpu")
    task.init_params(3)
    task.setup_train_state()
    rng = np.random.RandomState(4)
    batch = {"lq": rng.rand(1, 16, 16, 8).astype(np.float32),
             "voxel": rng.randn(1, 5, 16, 16, 2).astype(np.float32),
             "gt": rng.rand(1, 5, 16, 16, 3).astype(np.float32)}
    for _ in range(2):
        task.train_step(batch)
    assert task.net.training
    live = task.predict(batch["lq"], batch["voxel"])
    assert task.net.training
    ema = task.predict(batch["lq"], batch["voxel"], use_ema=True)
    assert np.abs(live - ema).max() > 1e-6
    task.net.eval()
    np.testing.assert_array_equal(task.predict(batch["lq"], batch["voxel"]), live)
    assert not task.net.training


def test_int8_predict_raises(tmp_path):
    """val.int8 True / "scale0" predict in int8 (tests/test_torch_quant.py);
    "static" raises (a task records no calibration), as do other values and
    int8 with the folded predict turned off, as in the JAX task."""
    with pytest.raises(ValueError, match="calibrat"):
        build_task(_task_opt(tmp_path, int8="static"), device="cpu")
    with pytest.raises(ValueError, match="val.int8"):
        build_task(_task_opt(tmp_path, int8="dynamic"), device="cpu")
    with pytest.raises(ValueError, match="folded"):
        build_task(_task_opt(tmp_path, int8=True, folded_predict=False), device="cpu")


# --- the test CLI -------------------------------------------------------------------

def _test_yml(tmp_path, roots, pretrain, **kw):
    opt = _task_opt(tmp_path, **kw)
    opt.pop("is_train")
    opt["path"] = {"pretrain_network_g": pretrain}
    opt["datasets"] = {"test": _dataset_opt(roots["gopro"], name="synth")}
    path = tmp_path / "test.yml"
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def test_test_cli_on_a_checkpoint_directory(tmp_path, roots):
    params, state = _weights(NET, 1)
    CheckpointManager(str(tmp_path / "models")).save(7, state)
    yml = _test_yml(tmp_path, roots, str(tmp_path / "models"))
    results = test_cli.main(["-opt", yml, "--root", str(tmp_path), "--max-items", "1",
                             "--device", "cpu"])
    (name, res), = results.items()
    assert name == "synth" and math.isfinite(res["total_psnr"])
    # the same weights through the JAX task's validate, first item
    jtask = jax_build_task(_task_opt(tmp_path))
    jtask.params = params
    dopt = _dataset_opt(roots["gopro"])
    want = jtask.validate(jax_build_loader(jax_build_dataset(dict(dopt)), dopt, False), dopt,
                          max_items=1)
    _assert_close_results(res, want)


def test_test_cli_defaults_to_the_card_and_needs_weights(tmp_path, roots):
    assert test_cli.parse_args(["-opt", "x.yml"]).device == "cuda"
    with pytest.raises(ValueError, match="pretrain_network_g"):
        test_cli.main(["-opt", _test_yml(tmp_path, roots, None), "--device", "cpu",
                       "--root", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            test_cli.main(["-opt", _test_yml(tmp_path, roots, None), "--root", str(tmp_path)])


# --- validation inside the train CLI ---------------------------------------------

def _train_opt(tmp_path, roots, val):
    opt = {
        "name": "toy_train_val", "model_type": "TwoImageEventRecurrentRestorationModel",
        "scale": 1, "manual_seed": 10,
        "datasets": {"train": {
            "name": "synth", "type": "GoProEventRecurrentDataset", "phase": "train",
            "dataroot": roots["gopro"], "num_end_interpolation": M,
            "num_inter_interpolation": N, "norm_voxel": True, "one_voxel_flag": True,
            "return_deblur_voxel": True, "gt_size": 16, "use_hflip": True,
            "use_rot": True, "use_shuffle": True, "num_worker_per_gpu": 1,
            "batch_size_per_gpu": 1, "dataset_enlarge_ratio": 2,
            "video_list": ["VID_A", "VID_B"]}},
        "network_g": dict(NET),
        "path": {"pretrain_network_g": None, "root": str(tmp_path),
                 "experiments_root": str(tmp_path / "exp"),
                 "models": str(tmp_path / "exp" / "models"), "log": str(tmp_path / "exp"),
                 "visualization": str(tmp_path / "exp" / "vis")},
        "train": {"optim_g": {"type": "AdamW", "lr": 2e-3, "betas": [0.9, 0.99],
                              "weight_decay": 1e-4},
                  "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 50,
                                "eta_min": 1e-7},
                  "total_iter": 5, "warmup_iter": -1},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 0},
    }
    if val:
        opt["datasets"]["val"] = _dataset_opt(roots["gopro"])
        opt["val"] = {"val_freq": 2, "metrics_deblur": METRICS, "metrics_interpo": METRICS}
    return opt


def test_train_cli_validates_without_changing_the_trajectory(tmp_path, roots):
    """5 steps with validations after steps 2 and 4 and at the end equal 5
    steps without them."""
    plain = train_cli.train(_train_opt(tmp_path / "a", roots, val=False), device="cpu")
    task = train_cli.train(_train_opt(tmp_path / "b", roots, val=True), device="cpu")
    losses = [h["loss"] for h in task.history if "loss" in h]
    assert losses == [h["loss"] for h in plain.history] and len(losses) == 5
    vals = [h for h in task.history if "val" in h]
    assert [h["iter"] for h in vals] == [2, 4, 5]
    for h in vals:
        assert h["val"] == "synth" and math.isfinite(h["total_psnr"]) and h["seconds"] > 0
        assert 0 < h["total_ssim"] <= 1
    assert task.net.training
    for k, v in plain.net.state_dict().items():
        torch.testing.assert_close(task.net.state_dict()[k], v, rtol=0, atol=0)
