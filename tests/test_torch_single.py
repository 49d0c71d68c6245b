"""The single-image deblurring path of refid_tpu_torch against refid_tpu's
(CPU, f32): the GoPro and HighREV single-image datasets, the
``ImageEventRestorationModel`` / ``ImageRestorationModel`` tasks' predict and
validate (untiled and tiled), ``val.int8``, checkpoint loading, the test CLI
and the demo CLI.  A toy EVHINet (wf 8) with the same random weights in
both packages; data from ``tests/synthetic_data.py``."""

import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from refid_tpu.cli import demo as jax_demo
from refid_tpu.data import build_dataset as jax_build_dataset
from refid_tpu.data import build_loader as jax_build_loader
from refid_tpu.models.evhinet import EVHINet as JaxEVHINet
from refid_tpu.tasks import build_task as jax_build_task
from refid_tpu_torch.cli import demo
from refid_tpu_torch.cli import test as test_cli
from refid_tpu_torch.data.loader import build_dataset, build_loader
from refid_tpu_torch.models.convert import evhinet_state_dict_from_jax, load_state
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.tasks.single import ImageEventRestorationTask, ImageRestorationTask
from tests.synthetic_data import make_gopro_tree
from tests.test_torch_evhinet import _jax_params
from tests.test_torch_helpers import parity_db

torch.set_num_threads(1)

H, W = 32, 48
NET = {"type": "SingleMultiConnectEVHINet", "in_chn": 3, "ev_chn": 6, "wf": 8, "depth": 3}
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 0, "test_y_channel": False},
           "ssim": {"type": "calculate_ssim", "crop_border": 0, "test_y_channel": False}}
PRED_TOL = 2e-4     # predictions against the JAX task's, max |diff|
METRIC_TOL = 1e-5   # PSNR (dB) and SSIM against the JAX task's
VOXEL_TOL = 1e-5    # voxels against the JAX host voxelizer (tests/test_torch_data.py)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    gopro = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(gopro, h=H, w=W)
    make_gopro_tree(gopro, split="test", h=H, w=W, seed=1)
    highrev = str(tmp_path_factory.mktemp("highrev"))
    make_gopro_tree(highrev, layout="highrev", split="test", h=H, w=W, seed=2)
    make_gopro_tree(highrev, layout="highrev", split="train", h=H, w=W, seed=3)
    return {"gopro": gopro, "highrev": highrev}


def _dataset_opt(root, dtype="GoProSingleImageEventDataset", phase="val", **kw):
    opt = {"name": "synth", "type": dtype, "phase": phase, "scale": 1, "dataroot": root,
           "num_bins": 6, "gt_size": None, "use_hflip": False, "use_rot": False,
           "video_list": ["VID_A"]}
    opt.update(kw)
    return opt


def _task_opt(tmp_path, net=NET, model="TestImageEventRestorationModel", **val):
    return {"name": "toy_single", "model_type": model, "is_train": False,
            "network_g": dict(net), "path": {"visualization": str(tmp_path / "vis")},
            "val": {"metrics": METRICS, "max_minibatch": 2, "crop_size": None, **val}}


def _weights(net=NET, seed=7):
    cfg = {k: v for k, v in net.items() if k != "type"}
    rng = np.random.RandomState(seed)
    x = rng.rand(1, 16, 16, cfg["in_chn"]).astype(np.float32)
    ev = rng.rand(1, 16, 16, cfg["ev_chn"]).astype(np.float32)
    params = _jax_params(JaxEVHINet(wf=cfg["wf"], ev_chn=cfg["ev_chn"]), x, ev, seed)
    return params, evhinet_state_dict_from_jax(params)


def _pair(tmp_path, net=NET, model="TestImageEventRestorationModel", **val):
    """The JAX task and the port task (CPU) with the same weights."""
    params, state = _weights(net)
    jtask = jax_build_task(_task_opt(tmp_path, net, model, **val))
    jtask.params = params
    task = build_task(_task_opt(tmp_path, net, model, **val), device="cpu")
    load_state(task.net, state)
    return jtask, task


def _loaders(dopt):
    return (jax_build_loader(jax_build_dataset(dict(dopt)), dopt, False),
            build_loader(build_dataset(dict(dopt), device="cpu"), dopt, False))


# --- datasets -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,root", [("GoProSingleImageEventDataset", "gopro"),
                                        ("RuisiSingleImageEventDataset", "highrev")])
@pytest.mark.parametrize("phase,kw", [
    ("val", {}),
    ("val", {"video_list": None}),
    ("train", {"gt_size": 16, "use_hflip": True, "use_rot": True, "seed": 3}),
])
def test_datasets_equal_jax(roots, dtype, root, phase, kw, monkeypatch):
    """Item by item, on the JAX package's float32 host voxelizer, whose
    operation order the port's plain voxelizer follows.  Its default C++
    path rescales time in double: a cell whose votes cancel can come out 0
    there and 2**-21 here, and ``voxel_norm`` (a mean and deviation over the
    nonzero cells) then rescales the whole grid by ~1e-4 (ROADMAP queue 3,
    logged choices)."""
    monkeypatch.setenv("REFID_TPU_NO_NATIVE", "1")
    dopt = _dataset_opt(roots[root], dtype, phase, **kw)
    ours, ref = build_dataset(dict(dopt), device="cpu"), jax_build_dataset(dict(dopt))
    assert len(ours) == len(ref) > 0
    for idx in range(len(ref)):
        got, want = ours[idx], ref[idx]
        assert got.keys() == want.keys()
        for key in ("lq", "gt"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["voxel"].shape == want["voxel"].shape
        assert got["voxel"].shape[-1] == 6 and np.any(got["voxel"] != 0)
        np.testing.assert_allclose(got["voxel"], want["voxel"], rtol=0, atol=VOXEL_TOL)
        assert (got["seq"], got["origin_index"]) == (want["seq"], want["origin_index"])
    assert ours.timing["items"] == len(ref) and ours.timing["voxelize_ms"] > 0


# --- tasks ----------------------------------------------------------------------------

def test_predict_matches_jax(tmp_path, roots):
    jtask, task = _pair(tmp_path)
    item = build_dataset(_dataset_opt(roots["gopro"]), device="cpu")[1]
    lq, vox = item["lq"][None], item["voxel"][None]
    got = task.predict(lq, vox)
    want = np.asarray(jtask.predict(lq, vox))
    assert got.shape == want.shape == (1, H, W, 3)
    assert float(np.abs(got - want).max()) < PRED_TOL


@pytest.mark.parametrize("val", [{}, {"crop_size": 16}, {"crop_size": 16, "trans_num": 8}],
                         ids=["untiled", "tiled", "tiled_x8"])
def test_validate_matches_jax(tmp_path, roots, val):
    jtask, task = _pair(tmp_path, **val)
    dopt = _dataset_opt(roots["gopro"])
    jloader, loader = _loaders(dopt)
    want, got = jtask.validate(jloader, dopt), task.validate(loader, dopt)
    assert got.keys() == want.keys() == {"psnr", "ssim"}
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    timing = task.val_timing
    assert timing["items"] == len(loader.dataset) and timing["predict_ms"] > 0
    assert timing["metric_ms"] > 0 and timing["save_ms"] == 0


def test_validate_saves_images(tmp_path, roots):
    _, task = _pair(tmp_path)
    dopt = _dataset_opt(roots["gopro"])
    task.validate(_loaders(dopt)[1], dopt, save_img=True, max_items=1)
    saved = os.listdir(tmp_path / "vis" / "synth" / "VID_A")
    assert saved == ["000000.png"] and task.val_timing["save_ms"] > 0


def test_image_only_task_passes_a_zero_voxel(tmp_path, roots):
    net = dict(NET, ev_chn=2)
    jtask, task = _pair(tmp_path, net, "ImageRestorationModel")
    assert type(task) is ImageRestorationTask
    lq = build_dataset(_dataset_opt(roots["gopro"]), device="cpu")[0]["lq"]
    got = task._predict_item(lq, None).numpy()
    np.testing.assert_array_equal(
        got, task._predict_item(lq, np.zeros((H, W, 2), np.float32)).numpy())
    want = np.asarray(jtask._forward(lq[None], None))[0]
    assert float(np.abs(got - want).max()) < PRED_TOL


def test_val_int8_predicts_in_int8_as_the_jax_task(tmp_path, roots):
    """A truthy ``val.int8`` means dynamic scales for EVHINet, in both
    packages (``int8=bool(int8)``)."""
    jtask, task = _pair(tmp_path, int8=True)
    _, static = _pair(tmp_path, int8="static")
    _, exact = _pair(tmp_path)
    assert task.int8 is True and static.int8 is True
    item = build_dataset(_dataset_opt(roots["gopro"]), device="cpu")[1]
    lq, vox = item["lq"][None], item["voxel"][None]
    got = task.predict(lq, vox)
    want = np.asarray(jtask.predict(lq, vox))
    np.testing.assert_array_equal(static.predict(lq, vox), got)
    assert parity_db(want, got) >= 60.0
    assert parity_db(exact.predict(lq, vox), got) < 100.0      # int8 did run
    with pytest.raises(ValueError, match="folded"):
        build_task(_task_opt(tmp_path, int8=True, folded_predict=False), device="cpu")
    with pytest.raises(ValueError, match="fac_place"):
        build_task(_task_opt(tmp_path, dict(NET, fac_place=1), int8=True), device="cpu")


def test_load_pretrained_takes_upstream_evhinet_checkpoints(tmp_path):
    """An upstream ``.pth`` also carries stage-2 modules: they are ignored; a
    missing stage-1 key raises."""
    _, state = _weights()
    upstream = {"params": {**state, "down_path_2.0.conv_1.weight": torch.zeros(8, 3, 3, 3),
                           "conv_02.weight": torch.zeros(8, 3, 3, 3)}}
    torch.save(upstream, tmp_path / "net_g.pth")
    task = build_task(_task_opt(tmp_path), device="cpu")
    task.load_pretrained(str(tmp_path / "net_g.pth"))
    assert all(torch.equal(v, state[k]) for k, v in task.net.state_dict().items())
    del upstream["params"]["sam12.conv2.bias"]
    torch.save(upstream, tmp_path / "net_g.pth")
    with pytest.raises(KeyError, match="sam12.conv2.bias"):
        task.load_pretrained(str(tmp_path / "net_g.pth"))


# --- the CLIs -------------------------------------------------------------------------

def _write_yml(path, opt):
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path)


def test_test_cli_matches_validate(tmp_path, roots):
    params, state = _weights()
    torch.save({"params": state}, tmp_path / "net_g.pth")
    opt = _task_opt(tmp_path, crop_size=16)
    opt.pop("is_train")
    opt["path"] = {"pretrain_network_g": str(tmp_path / "net_g.pth")}
    opt["datasets"] = {"test": _dataset_opt(roots["gopro"], phase="test")}
    yml = _write_yml(tmp_path / "test.yml", opt)
    got = test_cli.main(["-opt", yml, "--root", str(tmp_path), "--device", "cpu"])
    jtask = jax_build_task(_task_opt(tmp_path, crop_size=16))
    jtask.params = params
    dopt = opt["datasets"]["test"]
    want = jtask.validate(_loaders(dopt)[0], dopt)
    assert got.keys() == {"synth"}
    for k in want:
        assert abs(got["synth"][k] - want[k]) <= METRIC_TOL


@pytest.mark.parametrize("events", [True, False], ids=["events", "zero_voxel"])
def test_demo_writes_the_jax_demo_png(tmp_path, roots, events, monkeypatch):
    """Both demos from the same converted weights, up to one uint8 step; the
    JAX demo voxelizes on its float32 host path, as in
    :func:`test_datasets_equal_jax`."""
    monkeypatch.setenv("REFID_TPU_NO_NATIVE", "1")
    _, state = _weights()
    torch.save({"params": state}, tmp_path / "net_g.pth")
    video = os.path.join(roots["gopro"], "test", "VID_A")
    paths = {"input_img": os.path.join(video, "blur", "000002.png")}
    if events:
        paths["input_events"] = os.path.join(roots["gopro"], "test_event", "VID_A",
                                             "000004.npz")
    outs = {}
    for name, cli, extra in (("jax", jax_demo, []), ("port", demo, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.png")
        opt = {"name": "demo", "model_type": "ImageEventRestorationModel",
               "network_g": dict(NET), "val": {},
               "path": {"pretrain_network_g": str(tmp_path / "net_g.pth")},
               "img_path": {**paths, "output_img": out}}
        yml = _write_yml(tmp_path / f"{name}.yml", opt)
        result = cli.main(["-opt", yml, "--root", str(tmp_path)] + extra)
        outs[name] = cv2.imread(out, cv2.IMREAD_UNCHANGED).astype(np.int32)
    assert isinstance(result, ImageEventRestorationTask)
    assert tuple(result.demo_output.shape) == (H, W, 3)
    assert outs["port"].shape == outs["jax"].shape == (H, W, 3)
    assert int(np.abs(outs["port"] - outs["jax"]).max()) <= 1


def test_demo_defaults_to_the_card_and_needs_weights(tmp_path, roots):
    video = os.path.join(roots["gopro"], "test", "VID_A")
    opt = {"name": "demo", "model_type": "ImageEventRestorationModel",
           "network_g": dict(NET), "path": {},
           "img_path": {"input_img": os.path.join(video, "blur", "000001.png"),
                        "output_img": str(tmp_path / "out.png")}}
    yml = _write_yml(tmp_path / "demo.yml", opt)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            demo.main(["-opt", yml])
    with pytest.raises(ValueError, match="pretrain_network_g"):
        demo.main(["-opt", yml, "--device", "cpu"])


def test_jax_demo_path_is_what_the_port_serves(tmp_path, roots):
    """The JAX ``single_image_inference`` and the port's on the same
    image and voxel: equal predictions within the f32 bar."""
    jtask, task = _pair(tmp_path)
    item = build_dataset(_dataset_opt(roots["gopro"]), device="cpu")[2]
    got = task.single_image_inference(item["lq"], item["voxel"], str(tmp_path / "p.png"))
    want = jtask.single_image_inference(item["lq"], item["voxel"], str(tmp_path / "j.png"))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < PRED_TOL
    assert jnp.asarray(want).shape == (H, W, 3)


def test_a_cli_after_the_demo_still_writes_its_log_file(tmp_path):
    """The demo logs without a file; a CLI run after it in the same process
    still gets the log file it names."""
    from refid_tpu_torch.core.logging_util import get_root_logger
    get_root_logger().info("demo")
    log = tmp_path / "later.log"
    get_root_logger(log_file=str(log)).info("later")
    assert "later" in log.read_text()
    assert get_root_logger(log_file=str(log)) is get_root_logger()
    get_root_logger().info("again")
    assert log.read_text().count("later") == 1 and "again" in log.read_text()
