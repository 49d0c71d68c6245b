"""scripts/eval_released_torch.py against scripts/eval_released.py on the CPU:
one seeded port state saved as ``{"params": state_dict}`` (upstream names,
so it is a released checkpoint to both scripts), the same option file and
synthetic tree, results within the tolerances of tests/test_torch_validate.py
(PSNR 0.05 dB, SSIM 1e-3) and the same table rows but for the Hardware cell.
Both released lineages: the toy flagship in float and int8, and a toy
EVHINet with tiled inference."""

import contextlib
import importlib.util
import io
import json
import math
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import pytest
import torch
import yaml

from tests.synthetic_data import make_gopro_tree
from tests.test_torch_single import _weights as evhinet_weights
from tests.test_torch_validate import METRICS, NET, PSNR_DB, SSIM_TOL, M, N, H, W
from tests.test_torch_validate import _weights as flagship_weights

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EVHINET = {"type": "SingleMultiConnectEVHINet", "in_chn": 3, "ev_chn": 6, "wf": 8,
           "depth": 3, "fac_place": 2}
HEADER = "| Metric | Value | Hardware | Source |"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv):
    """``mod.main(argv)``: its results and the table rows it printed.  The
    JAX script's update of JAX's persistent compilation cache directory is
    dropped, so the process keeps its own setting."""
    update = jax.config.update
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()), \
            mock.patch.object(jax.config, "update", lambda key, value: None
                              if key == "jax_compilation_cache_dir" else update(key, value)):
        results = mod.main(argv)
    return results, [line for line in out.getvalue().splitlines() if line.startswith("|")]


def _flagship_options():
    dataset = {"name": "synth", "type": "GoProEventRecurrentDataset",
               "dataroot": "/unset", "num_end_interpolation": M,
               "num_inter_interpolation": N, "norm_voxel": True, "one_voxel_flag": True,
               "return_deblur_voxel": True, "io_backend": {"type": "disk"},
               "gt_size": None, "use_hflip": False, "use_rot": False,
               "video_list": ["VID_A"]}
    return {"name": "eval_released_toy", "model_type": "TestTwoImageEventRecurrentRestorationModel",
            "scale": 1, "num_gpu": 1, "manual_seed": 10, "datasets": {"test_1": dataset},
            "network_g": dict(NET),
            "path": {"pretrain_network_g": "/unset", "strict_load_g": True,
                     "resume_state": None},
            "val": {"save_img": False, "crop_size": None, "max_minibatch": 2,
                    "metrics_deblur": METRICS, "metrics_interpo": METRICS}}


def _evhinet_options():
    """tests/test_eval_released.py's tiled single-image configuration."""
    return {"name": "eval_released_single_tiled", "model_type": "TestImageEventRestorationModel",
            "scale": 1, "num_gpu": 1, "manual_seed": 1,
            "datasets": {"test_1": {"name": "test_si", "type": "GoProSingleImageEventDataset",
                                    "dataroot": "/unset", "num_bins": 6, "norm_voxel": True,
                                    "io_backend": {"type": "disk"}}},
            "network_g": dict(EVHINET),
            "path": {"pretrain_network_g": "/unset", "strict_load_g": True,
                     "resume_state": None},
            "val": {"save_img": False, "crop_size": 16, "max_minibatch": 2,
                    "metrics": METRICS}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The tree, both checkpoints and option files, and the JAX script's
    results and rows for every comparison."""
    work = tmp_path_factory.mktemp("eval_released")
    flagship_root, single_root = str(work / "gopro"), str(work / "gopro_single")
    make_gopro_tree(flagship_root, split="test", m=M, n=N, h=H, w=W, seed=1)
    make_gopro_tree(single_root, split="test", m=2, n=1, videos=("VID_A",))
    files = {}
    for name, state, opt in (("flagship", flagship_weights(NET, 1)[1], _flagship_options()),
                             ("evhinet", evhinet_weights()[1], _evhinet_options())):
        files[name] = (str(work / f"net_g_{name}.pth"), str(work / f"{name}.yml"))
        torch.save({"params": state}, files[name][0])
        Path(files[name][1]).write_text(yaml.safe_dump(opt))

    def argv(name, root, mode, tag):
        pth, yml = files[name]
        return (["--pth", pth, "--config", yml, "--dataroot", root, "--max-items", "1",
                 "--root", str(work / f"results_{tag}")] + (["--int8"] if mode else []))

    jax_script = _load("eval_released")
    runs = {"flagship": (flagship_root, False), "flagship_int8": (flagship_root, True),
            "evhinet": (single_root, False), "evhinet_int8": (single_root, True)}
    want = {k: _run(jax_script, argv(k.split("_")[0], root, mode, f"jax_{k}"))
            for k, (root, mode) in runs.items()}
    return SimpleNamespace(work=work, want=want,
                           argv=lambda k, tag: argv(k.split("_")[0], *runs[k], tag))


def _assert_close(got, want):
    assert got.keys() == want.keys() and got
    for name, res in want.items():
        assert got[name].keys() == res.keys() and res
        for k, v in res.items():
            assert math.isfinite(got[name][k])
            assert abs(got[name][k] - v) <= (SSIM_TOL if "ssim" in k else PSNR_DB), \
                (name, k, got[name][k], v)


def _without_hardware(row):
    cells = row.split(" | ")
    return cells[:2] + cells[3:]


RUNS = ["flagship", "flagship_int8", "evhinet", "evhinet_int8"]


def _psnr(res):
    return res.get("total_psnr", res.get("psnr"))


@pytest.mark.parametrize("run", RUNS)
def test_results_and_rows_equal_the_jax_script(case, run):
    results, rows = _run(_load("eval_released_torch"),
                         case.argv(run, f"torch_{run}") + ["--device", "cpu"])
    want, want_rows = case.want[run]
    _assert_close(results, want)
    assert rows[0] == HEADER and rows[1] == "|---|---|---|---|"
    assert len(rows) == 2 + len(want) == len(want_rows)
    assert [_without_hardware(r) for r in rows] == [_without_hardware(r) for r in want_rows]
    assert all(r.split(" | ")[2] == "cpu" for r in rows[2:])
    if run.endswith("_int8"):
        # int8 may move PSNR by less than the tolerance: the run must lie
        # nearer the JAX int8 result than the JAX float one
        (name, got), = results.items()
        q8, fl = _psnr(want[name]), _psnr(case.want[run[:-5]][0][name])
        assert abs(_psnr(got) - q8) < abs(_psnr(got) - fl)


@pytest.mark.parametrize("lineage", ["flagship", "evhinet"])
def test_int8_really_runs(case, lineage):
    """32 x 48 and the 16-px tiles are multiples of the networks' int8_side:
    the int8 run's PSNR is not the float run's, and stays within the JAX
    test's 1 dB of it."""
    (_, fl), = case.want[lineage][0].items()
    (_, q8), = case.want[lineage + "_int8"][0].items()
    assert _psnr(q8) != _psnr(fl)
    assert abs(_psnr(q8) - _psnr(fl)) < 1.0
    assert "(int8=true)" in case.want[lineage + "_int8"][1][2]


def test_the_script_evaluates_through_cli_test(case):
    """``run`` returns the task of ``cli.test.evaluate``: the results that
    ``main`` returns, the per-dataset timing it prints, and ``--json-out``."""
    out = case.work / "torch_results.json"
    script = _load("eval_released_torch")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()) as err:
        task = script.run(case.argv("flagship", "torch_json")
                          + ["--device", "cpu", "--json-out", str(out)])
    assert json.loads(out.read_text()) == task.results
    (name, timing), = task.test_timing.items()
    assert name == "synth" and timing["items"] == 1 and timing["predict_ms"] > 0
    assert "evaluated synth: 1 items; ms per item: predict" in err.getvalue()
    assert "details: " in err.getvalue()


def test_options_are_overridden_as_the_jax_script_does(tmp_path, monkeypatch):
    """--dataroot rewrites every ``dataroot*`` key of every dataset, --pth the
    weights, --int8 ``val.int8`` ("true" is True); a dataset without a name
    is named by its key."""
    opt = _flagship_options()
    opt["datasets"]["test_1"]["dataroot_lq"] = "/elsewhere"
    opt["datasets"]["test_2"] = {k: v for k, v in opt["datasets"]["test_1"].items()
                                 if k != "name"}
    yml = tmp_path / "opt.yml"
    yml.write_text(yaml.safe_dump(opt))
    seen = []

    def evaluate(opt, device, save_img=False, max_items=None, logger=None):
        seen.append((opt, device, save_img, max_items))
        return SimpleNamespace(results={}, test_timing={})

    from refid_tpu_torch.cli import test as test_cli
    monkeypatch.setattr(test_cli, "evaluate", evaluate)
    script = _load("eval_released_torch")
    for mode, want in ((None, None), ("true", True), ("scale0", "scale0")):
        with contextlib.redirect_stdout(io.StringIO()):
            script.main(["--pth", "w.pth", "--config", str(yml), "--dataroot", "/data/GoPro",
                         "--root", str(tmp_path), "--max-items", "3", "--device", "cpu"]
                        + (["--int8", mode] if mode else []))
        got, device, save_img, max_items = seen.pop()
        assert device == torch.device("cpu") and save_img is False and max_items == 3
        assert got["path"]["pretrain_network_g"] == "w.pth"
        assert (got.get("val") or {}).get("int8") == want
        for key, dopt in got["datasets"].items():
            assert dopt["name"] == {"test_1": "synth"}.get(key, key)
            roots = [v for k, v in dopt.items() if k.startswith("dataroot")]
            assert roots and set(roots) == {"/data/GoPro"}
        assert got["datasets"]["test_1"]["dataroot_lq"] == "/data/GoPro"


def test_int8_static_is_not_a_choice_and_the_device_defaults_to_the_card(tmp_path):
    script = _load("eval_released_torch")
    args = script.parse_args(["--pth", "x.pth", "--config", "c.yml"])
    assert args.device == "cuda" and args.int8 is None and args.max_items is None
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        script.parse_args(["--pth", "x.pth", "--config", "c.yml", "--int8", "static"])
    assert script.hardware(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            script.main(["--pth", "x.pth", "--config", str(tmp_path / "absent.yml")])
