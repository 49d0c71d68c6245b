"""The frozen reference against the program at toy sizes, on the same
seeded weights: a blurry-VFI window through ``BlurVFIPipeline``, an EVHINet
image through the demo's calls, three recipe training steps through the
task's ``train_step``.  Float32 on the CPU; the card-only cases repeat the
forwards on the card with TF32 off.  The tests may import the program; the
reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.drivers import train_step as train_driver
from portbench.harness import reference_precision
from portbench.reference.evhinet import EVHINetRef
from portbench.reference.refid import RefidNet, blur_vfi_window
from portbench.reference.train import run_steps
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state

SEED = 2 ** 32 + 99
TRAIN = {"optim_g": {"type": "AdamW", "lr": 2e-4, "weight_decay": 1e-4, "betas": [0.9, 0.99]},
         "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 200000, "eta_min": 1e-7},
         "total_iter": 200000, "warmup_iter": -1,
         "pixel_opt": {"type": "CharbonnierLoss", "loss_weight": 1, "reduction": "mean"}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _meta(cls, **kw):
    with torch.device("meta"):
        return cls(**kw)


def _ref(cls, state, device, **kw):
    net = _meta(cls, **kw).to_empty(device=device)
    net.load_state_dict(state)
    return net


def _vfi(device):
    from refid_tpu_torch.models.refid import RefidConfig
    from refid_tpu_torch.pipeline import BlurVFIPipeline

    state = seeded_state(_meta(RefidNet, base=8), SEED, device)
    traffic = {"kind": "vfi_window", "height": 32, "width": 48, "events": 5000,
               "t_span": 5e4, "pool": 1}
    b0, b1, ev = generate.make(traffic, SEED)[0]
    got = BlurVFIPipeline(state, RefidConfig(base_num_channels=8), device=device)(b0, b1, ev)
    with torch.no_grad():
        vox = voxel_grid(torch.from_numpy(ev).to(device), 24, 48, 32)
        want = blur_vfi_window(_ref(RefidNet, state, device, base=8),
                               torch.from_numpy(b0).to(device),
                               torch.from_numpy(b1).to(device), vox)
    return got, want


def _deblur(device):
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.tasks.base import build_task

    state = seeded_state(_meta(EVHINetRef, wf=16), SEED, device)
    traffic = {"kind": "deblur_image", "height": 32, "width": 48, "events": 5000,
               "t_span": 5e4, "pool": 1}
    img, ev = generate.make(traffic, SEED)[0]
    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {},
                       "network_g": {"type": "SingleMultiConnectEVHINet", "wf": 16}}, device)
    load_state(task.net, state)
    voxel = voxel_norm_np(events_to_voxel_grid(ev, 6, 48, 32, "HWC", device=device))
    got = task.single_image_inference(img, voxel, None)
    with torch.no_grad():
        vox = voxel_norm(voxel_grid(torch.from_numpy(ev).to(device), 6, 48, 32))
        x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None]
        want = _ref(EVHINetRef, state, device, wf=16)(x, vox[None])[0].permute(1, 2, 0)
    return got, want


def _rel(got, want):
    return float((got.float() - want).square().mean().sqrt() / want.square().mean().sqrt())


def test_vfi_window_matches_the_program():
    got, want = _vfi(torch.device("cpu"))
    assert got.shape == want.shape == (23, 32, 48, 3)
    assert _rel(got, want) < 1e-5


def test_evhinet_image_matches_the_program():
    got, want = _deblur(torch.device("cpu"))
    assert got.shape == want.shape == (32, 48, 3)
    assert _rel(got, want) < 1e-5


def test_voxel_grid_matches_the_program():
    from refid_tpu_torch.events.voxel import voxelize_padded_reference

    ev = generate.events(np.random.default_rng(3), 20000, 40, 56, 5e4)
    ev[::97, 1] = 60                                        # out of frame: dropped
    want = voxelize_padded_reference(torch.from_numpy(ev), len(ev), 24, 56, 40)
    assert torch.equal(voxel_grid(torch.from_numpy(ev), 24, 56, 40), want)


def test_voxel_norm_of_zeros_is_zeros():
    assert torch.equal(voxel_norm(torch.zeros(2, 3, 4)), torch.zeros(2, 3, 4))


def test_three_training_steps_match_the_program():
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.tasks.base import build_task

    device = torch.device("cpu")
    state = seeded_state(_meta(RefidNet, base=8), SEED, device)
    traffic = {"kind": "train_batch", "crop": 32, "frames": 3, "lq_bins_each": 10, "batch": 1,
               "voxel_density": 0.1, "pool": 3}
    batches = generate.make(traffic, SEED)
    task = build_task({"name": "t", "model_type": "TwoImageEventRecurrentRestorationModel",
                       "is_train": True, "train": TRAIN,
                       "network_g": {"type": "FinalBidirectionAttenfusion", "img_chn": 26,
                                     "ev_chn": 2, "base_num_channels": 8, "remat": True}},
                      device)
    load_state(task.net, state)
    trainer = task.setup_train_state()
    losses = []
    for i, batch in enumerate(batches):
        losses.append(float(task.train_step(batch)["loss"]))
        if i == 0:
            first = {n: float(trainer.optimizer.state[p]["exp_avg"].norm() / 0.1)
                     for n, p in trainer.named}
    change = {n: float((p.detach() - state[n]).norm()) for n, p in trainer.named}
    want = run_steps(_ref(RefidNet, state, device, base=8), batches, TRAIN)
    got = {"losses": losses, "first_grad": first, "change": change}
    g = train_driver.gaps(got, want)
    assert g["loss_gap"] < 1e-6 and g["grad_gap"] < 1e-4 and g["change_gap"] < 1e-4, g


@pytest.mark.gpu
def test_vfi_window_matches_the_program_on_the_card(cuda):
    with reference_precision():
        got, want = _vfi(cuda)
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
def test_evhinet_image_matches_the_program_on_the_card(cuda):
    with reference_precision():
        got, want = _deblur(cuda)
    assert _rel(got, want) < 1e-5
