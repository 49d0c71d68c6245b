"""The ``deblur720-efnet-bf16`` cell's own files: a toy copy of the cell
(wf 16, 32x48, float32, the CPU) through the harness, sound, with its
answer altered, and as the control (weights and layer outputs in
float8); the FLOPs the metric reads against hand counts; and the frozen
reference against the program on the card with TF32 off, as for
EVHINet."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.drivers.efnet_serve import efnet_state
from portbench.flops.count import conv_flops
from portbench.flops.efnet import efnet_image_flops, eica_matmul_flops
from portbench.harness import ROOT, reference_precision
from portbench.reference.efnet import EFNetRef
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.tests.toy import manifest
from portbench.traffic import generate

CELL = "deblur720-efnet-bf16"
SEED = 2 ** 33 + 29


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
    config["network_g"]["wf"], config["compute_dtype"] = 16, "float32"
    traffic = json.loads((ROOT / "traffic" / f"{workload['traffic']}.json").read_text())
    traffic.update(height=32, width=48, events=800, sample_within=5)
    for kind, name, body in (("configs", workload["config"], config),
                             ("traffic", workload["traffic"], traffic),
                             ("workloads", CELL, workload)):
        (tmp / kind / f"{name}.json").write_text(json.dumps(body))
    return tmp


def _run(tmp_path, control=False):
    return harness.run(CELL, SEED, 0.3, False, root=_toy_root(tmp_path), manifest=manifest(),
                       device="cpu", control=control)


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
    result = _run(tmp_path, control=True)
    assert not result["correct"], result["checks"]


def test_eica_matmul_hand_count():
    # wf 8 at 16 x 24: per scale i, 2 linear layers of 2 P C 4C and two
    # attention products of 2 P C^2 / n
    want = 0
    for i, n in enumerate((1, 2, 4)):
        p, c = (16 >> i) * (24 >> i), 8 << i
        want += 2 * (2 * p * c * 4 * c) + 2 * (2 * p * c * c // n)
    assert eica_matmul_flops(16, 24, 8, (1, 2, 4), 4) == want
    with torch.device("meta"):
        net = EFNetRef(3, 6, 8)
        args = torch.empty(1, 3, 16, 24), torch.empty(1, 6, 16, 24)
    assert efnet_image_flops(16, 24, wf=8) == conv_flops(net, *args) + want


def test_efnet_720p_image_flops():
    assert efnet_image_flops(720, 1280) / 1e12 == pytest.approx(3.4235, abs=5e-4)
    assert efnet_image_flops(64, 64) * 4 == efnet_image_flops(128, 128)


@pytest.mark.gpu
def test_efnet_image_matches_the_program_on_the_card(cuda):
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.tasks.base import build_task

    config = json.loads((ROOT / "configs" / "efnet_wf64.json").read_text())
    config["network_g"]["wf"] = 16
    state = efnet_state(config, SEED, cuda)
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
            ref = EFNetRef(wf=16).to(cuda)
            ref.load_state_dict(state)
            want = ref(x, vox[None])[0].permute(1, 2, 0)
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert rel < 1e-5
