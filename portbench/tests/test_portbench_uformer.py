"""The ``deblur720-uformer-bf16`` cell's own files: a toy copy of the cell
(embed_dim 16, 4x4 windows, one block a layer but two in the bottleneck,
40x72, float32, the CPU) through the harness, sound, with its answer
altered, and as the control (weights and layer outputs in float8); the
driver's block count; the reference's imports; the FLOPs the metrics read
against torch's own count and the published shapes; the five readers on
synthetic traces; and the frozen reference against the program on the
card with TF32 off."""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.drivers.uformer_serve import blocks_per_call, uformer_state
from portbench.flops.uformer import (lewin_blocks, linear_flops, uformer_image_flops,
                                     window_matmul_flops)
from portbench.harness import ROOT, load_module, reference_precision
from portbench.peaks import PEAKS
from portbench.reference.uformer import UformerRef, uformer_args
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.tests.toy import manifest
from portbench.trace import Trace
from portbench.traffic import generate

CELL = "deblur720-uformer-bf16"
SEED = 2 ** 33 + 37
TOY_NET = {"embed_dim": 16, "win_size": 4, "depths": [1, 1, 1, 1, 2, 1, 1, 1, 1],
           "num_heads": [1, 2, 2, 4, 4, 4, 4, 2, 2]}
TOY_H, TOY_W = 40, 72


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
    traffic.update(height=TOY_H, width=TOY_W, events=1500, sample_within=5)
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
    from refid_tpu_torch.models import uformer

    root = _toy_root(tmp_path)
    cell = harness.load_cell(CELL, root)
    assert blocks_per_call(cell.config["network_g"]) == 10
    assert blocks_per_call(harness.load_cell(CELL).config["network_g"]) == 40
    driver = harness.load_module(root / "drivers" / "uformer_serve.py").Driver(
        cell, SEED, torch.device("cpu"))
    forward = uformer.LeWinTransformerBlock.forward
    monkeypatch.setattr(uformer.LeWinTransformerBlock, "forward",
                        lambda self, pair, h, w: pair if self.norm1.normalized_shape[0] == 16
                        else forward(self, pair, h, w))
    with pytest.raises(RuntimeError, match="ran 18 LeWin blocks, not 20"):
        driver.setup()


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference/uformer.py", "drivers/uformer_serve.py", "flops/uformer.py"):
        tree = ast.parse((ROOT / name).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not names & {"jax", "jaxlib", "flax", "refid_tpu"}, name
    tree = ast.parse((ROOT / "reference" / "uformer.py").read_text())
    names = {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    names |= {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names}
    assert names == {"__future__", "torch"}


def test_image_flops_are_torchs_own_count():
    """The count (convs by hooks, linears and window products from the
    shapes) equals torch's ``FlopCounterMode`` over the reference's forward,
    which counts every matmul and conv it runs."""
    from torch.utils.flop_counter import FlopCounterMode

    args = (9, 16, (1, 2, 2, 2, 2, 2, 2, 2, 1), (1, 2, 2, 4, 4, 4, 4, 2, 2), 4)
    with torch.device("meta"):
        net = UformerRef(*args)
        x, ev = torch.empty(1, 3, 72, 136), torch.empty(1, 6, 72, 136)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(x, ev)
    assert uformer_image_flops(72, 136, *args) == counter.get_total_flops()


def test_published_shapes_flops():
    # 1.32274 M multiply-adds a pixel, linear in pixels: 86.69 G at 256 x 256
    # and 1,300.3 G at 1280 x 768, the padded 720p frame
    at256 = uformer_image_flops(256, 256)
    assert at256 / 2 / (256 * 256) / 1e6 == pytest.approx(1.32274, abs=5e-6)
    at720 = uformer_image_flops(720, 1280)
    assert at720 == uformer_image_flops(768, 1280)
    assert at720 / 2e9 == pytest.approx(1300.30, abs=5e-3)
    assert at720 / 2 / (768 * 1280) / 1e6 == pytest.approx(1.32274, abs=5e-6)
    assert window_matmul_flops(720, 1280) / 2e9 == pytest.approx(60.90, abs=5e-3)
    assert linear_flops(720, 1280) / 2e9 == pytest.approx(1171.72, abs=5e-3)
    blocks = lewin_blocks(720, 1280)
    assert len(blocks) == 40 and sum(s for *_, s in blocks) == 19
    assert blocks[0] == (768 * 1280, 32, 1, False) and blocks[-1] == (768 * 1280, 64, 2, False)


# ---- the five readers on synthetic traces ----

SDPA = "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1"
ROLL = "void at::native::roll_cuda_kernel<c10::BFloat16>(...)"
GEMM = "nvjet_tst_128x64_64x6_1x2_h_bz_coopA_NNT"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32"


def _read(name, run):
    return load_module(ROOT / "metrics" / f"{name}.py").read(run)


def _cell_run(trace, peaks=None, calls=2, elapsed=1.0):
    cell = harness.load_cell(CELL)
    return SimpleNamespace(cell=cell, trace=trace, peaks=peaks or {},
                           window=SimpleNamespace(calls=calls, failed=0, elapsed=elapsed))


def test_wmsa_ms_reads_only_the_window_kernels():
    device = [(SDPA, 0.0, 0.010), (ROLL, 0.010, 0.012), (GEMM, 0.020, 0.030),
              (CONV, 0.030, 0.040)]
    assert _read("wmsa_ms.uformer", _cell_run(Trace(0.0, 1.0, device, [], 2))) == (
        pytest.approx((10 + 2) / 2))
    assert _read("wmsa_ms.uformer", _cell_run(Trace(0.0, 1.0, [(GEMM, 0, 1)], [], 2))) is None
    assert _read("wmsa_ms.uformer", _cell_run(None)) is None


def test_wmsa_roofline_is_the_least_time_over_the_attention_kernels():
    peaks = PEAKS["H100"]

    reader = load_module(ROOT / "metrics" / "wmsa_roofline.uformer.py")
    cell = harness.load_cell(CELL)
    least = reader.least_seconds(cell.config["network_g"], 720, 1280, peaks)
    # by hand: every block is bound by bytes; q, k, v and the output in
    # bf16 (8 T C bytes), and the bias as it lies
    want = 0.0
    for t, c, heads, shifted in lewin_blocks(720, 1280):
        bias = (t // 64 if shifted else 1) * heads * 64 * 64
        want += (8 * t * c + 2 * bias) / peaks["hbm_bytes_per_s"]
        assert 4 * t * 64 * c / peaks["bf16_flop_per_s"] < (8 * t * c) / peaks["hbm_bytes_per_s"]
    assert least == pytest.approx(want)
    assert 1.3e-3 < least < 1.6e-3       # 3.81 GB of q, k, v, out and ~0.76 GB of bias
    ms = 2 * least * 1e3                 # the kernels at half their bound
    trace = Trace(0.0, 1.0, [(SDPA, 0.0, ms * 1e-3), (ROLL, 0.5, 0.6)], [], 1)
    assert _read("wmsa_roofline.uformer", _cell_run(trace, peaks, calls=1)) == (
        pytest.approx(50.0))
    assert _read("wmsa_roofline.uformer", _cell_run(trace)) is None          # no peaks: CPU
    assert _read("wmsa_roofline.uformer",
                 _cell_run(Trace(0.0, 1.0, [(ROLL, 0, 1)], [], 1), peaks)) is None


def test_mfu_is_the_model_work_at_peak_over_an_image():
    peaks = PEAKS["H100"]
    trace = Trace(0.0, 1.0, [(GEMM, 0.0, 0.1)], [], 1)
    run = _cell_run(trace, peaks, calls=10, elapsed=1.0)          # 10 images a second
    want = 100 * uformer_image_flops(720, 1280) / peaks["bf16_flop_per_s"] / 0.1
    assert _read("mfu.uformer", run) == pytest.approx(want)
    assert 2.5 < want < 2.7
    assert _read("mfu.uformer", _cell_run(trace)) is None


def _image_spans(i, norms, on_card):
    host = [("refid.task.network", 3 * i + 1, 3 * i + 2)]
    step = 1.0 / (norms + 1)
    for k in range(norms):
        a = 3 * i + 1 + (k + 0.5) * step
        host.append(("refid.uformer.norm", a, a + 0.5 * step))
        if k < on_card:
            host.append(("refid.uformer.norm_card", a + 0.1 * step, a + 0.4 * step))
    return host


@pytest.mark.parametrize("on_card,share", [(4, 100.0), (1, 25.0), (0, 0.0)])
def test_norm_card_share(on_card, share):
    host = [("portbench.window", 0.0, 9.0), ("refid.uformer.norm_card", 9.6, 9.7),
            ("refid.restormer.norm", 9.1, 9.5)]
    for i in range(3):
        host += _image_spans(i, 4, on_card)
    trace = Trace(0.0, 10.0, [("k", 0.5, 1.0)], sorted(host, key=lambda e: e[1]), 3)
    assert _read("norm_card_share.uformer", SimpleNamespace(trace=trace)) == pytest.approx(share)
    restormer_only = Trace(0.0, 10.0, [("k", 0.5, 1.0)],
                           [("refid.restormer.norm", 1.0, 2.0),
                            ("refid.restormer.norm_card", 1.1, 1.9)], 1)
    assert _read("norm_card_share.uformer", SimpleNamespace(trace=restormer_only)) is None
    assert _read("norm_card_share.uformer", SimpleNamespace(trace=None)) is None


def test_block_idle_reads_the_gaps_inside_the_block_spans():
    """Two images; the device idles 0.2 s inside a block span and 0.3 s
    outside any."""
    device = [("k", 0.0, 1.0), ("k", 1.2, 2.0), ("k", 2.3, 3.0)]
    host = [("refid.task.network", 0.0, 3.0), ("refid.uformer.block", 0.5, 1.5)]
    trace = Trace(0.0, 3.0, device, host, 2)
    assert _read("block_idle_ms.uformer", SimpleNamespace(trace=trace)) == pytest.approx(100.0)
    parent = Trace(0.0, 3.0, device, [("refid.task.network", 0.0, 3.0)], 2)
    assert _read("block_idle_ms.uformer", SimpleNamespace(trace=parent)) is None


@pytest.mark.gpu
def test_uformer_image_matches_the_program_on_the_card(cuda):
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.tasks.base import build_task

    config = json.loads((ROOT / "configs" / "uformer_b.json").read_text())
    config["network_g"].update(TOY_NET)
    state = uformer_state(config, SEED, cuda)
    img, ev = generate.make({"kind": "deblur_image", "height": TOY_H, "width": TOY_W,
                             "events": 1500, "t_span": 5e4, "pool": 1}, SEED)[0]
    with reference_precision():
        task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                           "is_train": False, "val": {},
                           "network_g": dict(config["network_g"])}, cuda)
        load_state(task.net, state)
        voxel = voxel_norm_np(events_to_voxel_grid(ev, 6, TOY_W, TOY_H, "HWC", device=cuda))
        got = task.single_image_inference(img, voxel, None)
        with torch.no_grad():
            vox = voxel_norm(voxel_grid(torch.from_numpy(ev).to(cuda), 6, TOY_W, TOY_H))
            x = torch.from_numpy(img).to(cuda).permute(2, 0, 1)[None]
            ref = UformerRef(**uformer_args(config["network_g"])).to(cuda)
            ref.load_state_dict(state)
            want = ref(x, vox[None])[0].permute(1, 2, 0)
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert rel < 1e-5
