"""A run with the timed path broken underneath comes out not correct; a
sound run comes out correct.  Each drives the harness through a whole run
of a toy copy of a cell (float32, on the CPU: the look for a card is
skipped), with the cell's own limits.  Faults: an answer altered where the
program produces it (every cell), a training step that leaves the state
unchanged."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.toy import manifest, toy_root

SEED = 2 ** 33 + 17


def _run(tmp_path, cell, seconds=0.3):
    root = toy_root(tmp_path, cell)
    return harness.run(cell, SEED, seconds, False, root=root, manifest=manifest(),
                       device="cpu")


@pytest.mark.parametrize("cell", ["vfi720-bf16", "deblur720-bf16", "train256-bf16"])
def test_sound_run_is_correct(tmp_path, cell):
    result = _run(tmp_path, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _shift_output(fn):
    def altered(*args, **kw):
        out = fn(*args, **kw)
        return out + 0.05 * out.abs().max()
    return altered


def test_altered_vfi_answer_is_caught(tmp_path, monkeypatch):
    from refid_tpu_torch.pipeline import BlurVFIPipeline

    monkeypatch.setattr(BlurVFIPipeline, "__call__", _shift_output(BlurVFIPipeline.__call__))
    assert not _run(tmp_path, "vfi720-bf16")["correct"]


def test_altered_deblur_answer_is_caught(tmp_path, monkeypatch):
    from refid_tpu_torch.tasks.single import ImageEventRestorationTask

    fn = ImageEventRestorationTask.single_image_inference
    monkeypatch.setattr(ImageEventRestorationTask, "single_image_inference", _shift_output(fn))
    assert not _run(tmp_path, "deblur720-bf16")["correct"]


def test_altered_training_forward_is_caught(tmp_path, monkeypatch):
    from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion

    forward = FinalBidirectionAttenfusion.forward
    monkeypatch.setattr(FinalBidirectionAttenfusion, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * 1.05)
    assert not _run(tmp_path, "train256-bf16")["correct"]


def test_unchanged_training_state_is_caught(tmp_path, monkeypatch):
    step = torch.optim.AdamW.step

    def unchanged(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        step(self, closure)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)

    monkeypatch.setattr(torch.optim.AdamW, "step", unchanged)
    result = _run(tmp_path, "train256-bf16")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
