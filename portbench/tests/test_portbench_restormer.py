"""The ``deblur720-restormer-bf16`` cell's own files: a toy copy of the
cell (dim 8, one block a level, 32x48, float32, the CPU) through the
harness, sound, with its answer altered, and as the control (weights and
layer outputs in float8); the reference's imports; the FLOPs the metrics
read against the closed form and the published count; and the frozen
reference against the program on the card with TF32 off."""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.drivers.restormer_serve import blocks_per_call, restormer_state
from portbench.flops.count import conv_flops
from portbench.flops.restormer import mdta_blocks, mdta_matmul_flops, restormer_image_flops
from portbench.harness import ROOT, reference_precision
from portbench.reference.restormer import RestormerRef
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.tests.toy import manifest
from portbench.traffic import generate

CELL = "deblur720-restormer-bf16"
SEED = 2 ** 33 + 31
TOY_NET = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _toy_root(tmp: Path) -> Path:
    for kind in ("configs", "workloads", "traffic"):
        (tmp / kind).mkdir()
    for kind in ("drivers", "metrics"):
        os.symlink(ROOT / kind, tmp / kind)
    workload = json.loads((ROOT / "workloads" / f"{CELL}.json").read_text())
    config = json.loads((ROOT / "configs" / f"{workload['config']}.json").read_text())
    config["network_g"].update(TOY_NET)
    config["compute_dtype"] = "float32"
    traffic = json.loads((ROOT / "traffic" / f"{workload['traffic']}.json").read_text())
    traffic.update(height=32, width=48, events=800, sample_within=5)
    for kind, name, body in (("configs", workload["config"], config),
                             ("traffic", workload["traffic"], traffic),
                             ("workloads", CELL, workload)):
        (tmp / kind / f"{name}.json").write_text(json.dumps(body))
    return tmp


def _run(tmp_path, control=False, numbers=None):
    return harness.run(CELL, SEED, 0.3, False, root=_toy_root(tmp_path), manifest=manifest(),
                       device="cpu", control=control, numbers=numbers)


def test_sound_run_is_correct(tmp_path):
    result = _run(tmp_path)
    assert result["correct"], result["checks"]
    assert result["checks"]["rel_rms"]["value"] < 1e-5
    assert set(result["metrics"]) == {"deblur_images_per_s", "setup_s"}


def test_altered_answer_is_caught(tmp_path, monkeypatch):
    from refid_tpu_torch.tasks.single import ImageEventRestorationTask

    fn = ImageEventRestorationTask.single_image_inference

    def altered(*args, **kw):
        out = fn(*args, **kw)
        return out + 0.05 * out.abs().max()

    monkeypatch.setattr(ImageEventRestorationTask, "single_image_inference", altered)
    assert not _run(tmp_path)["correct"]


def test_float8_control_is_caught(tmp_path):
    numbers = {}
    result = _run(tmp_path, control=True, numbers=numbers)
    assert not result["correct"], result["checks"]
    limits = result["checks"]
    assert all(numbers[k] > limits[k]["limit"] for k in limits), numbers


def test_setup_counts_every_block(tmp_path, monkeypatch):
    from refid_tpu_torch.models import restormer

    root = _toy_root(tmp_path)
    cell = harness.load_cell(CELL, root)
    assert blocks_per_call(cell.config["network_g"]) == 8
    assert blocks_per_call(harness.load_cell(CELL).config["network_g"]) == 44
    driver = harness.load_module(root / "drivers" / "restormer_serve.py").Driver(
        cell, SEED, torch.device("cpu"))
    forward = restormer.TransformerBlock.forward
    monkeypatch.setattr(restormer.TransformerBlock, "forward",
                        lambda self, x: x if self.norm1.body.normalized_shape[0] == 8
                        else forward(self, x))
    with pytest.raises(RuntimeError, match="ran 14 transformer blocks, not 16"):
        driver.setup()


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "reference" / "restormer.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names == {"__future__", "torch"}


def test_image_flops_are_the_convs_and_mdtas_products():
    # dim 8 at 16 x 24, one block a level: per block 2 products of 2 P C^2 / h
    blocks = mdta_blocks(16, 24, 8, (1, 1, 1, 1), 1, (1, 2, 4, 8))
    assert [c for _, c, _ in blocks] == [8, 16, 32, 64, 32, 16, 16, 16]
    want = sum(2 * 2 * p * c * c // h for p, c, h in blocks)
    assert want == 2 * 2 * (384 * 64 + 96 * 256 // 2 + 24 * 1024 // 4 + 6 * 4096 // 8
                            + 24 * 1024 // 4 + 96 * 256 // 2 + 2 * 384 * 256)
    assert mdta_matmul_flops(16, 24, 8, (1, 1, 1, 1), 1, (1, 2, 4, 8)) == want
    with torch.device("meta"):
        net = RestormerRef(9, 3, 8, (1, 1, 1, 1), 1, (1, 2, 4, 8))
        args = torch.empty(1, 3, 16, 24), torch.empty(1, 6, 16, 24)
    assert restormer_image_flops(16, 24, 9, 8, (1, 1, 1, 1), 1) == (
        conv_flops(net, *args) + want)


def test_published_count_and_720p_image_flops():
    # the paper's 140.99 G multiply-adds at 256 x 256 (3 input channels),
    # which leave out MDTA's two products
    at256 = restormer_image_flops(256, 256, 3)
    conv = at256 - mdta_matmul_flops(256, 256, 48, (4, 6, 6, 8), 4, (1, 2, 4, 8))
    assert conv / 2e9 == pytest.approx(140.990, abs=5e-4)
    assert restormer_image_flops(720, 1280) / 1e12 == pytest.approx(4.3608, abs=5e-4)
    assert mdta_matmul_flops(720, 1280, 48, (4, 6, 6, 8), 4, (1, 2, 4, 8)) / 1e12 == (
        pytest.approx(0.3907, abs=5e-4))
    assert len(mdta_blocks(720, 1280, 48, (4, 6, 6, 8), 4, (1, 2, 4, 8))) == 44


@pytest.mark.gpu
def test_restormer_image_matches_the_program_on_the_card(cuda):
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.tasks.base import build_task

    config = json.loads((ROOT / "configs" / "restormer_dim48.json").read_text())
    config["network_g"].update(TOY_NET)
    state = restormer_state(config, SEED, cuda)
    img, ev = generate.make({"kind": "deblur_image", "height": 32, "width": 48, "events": 800,
                             "t_span": 5e4, "pool": 1}, SEED)[0]
    with reference_precision():
        task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                           "is_train": False, "val": {},
                           "network_g": dict(config["network_g"])}, cuda)
        load_state(task.net, state)
        voxel = voxel_norm_np(events_to_voxel_grid(ev, 6, 48, 32, "HWC", device=cuda))
        got = task.single_image_inference(img, voxel, None)
        with torch.no_grad():
            vox = voxel_norm(voxel_grid(torch.from_numpy(ev).to(cuda), 6, 48, 32))
            x = torch.from_numpy(img).to(cuda).permute(2, 0, 1)[None]
            ref = RestormerRef(9, 3, 8, (1, 1, 1, 1), 1).to(cuda)
            ref.load_state_dict(state)
            want = ref(x, vox[None])[0].permute(1, 2, 0)
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert rel < 1e-5
