"""Training the ablation lineages: one step's loss and gradients and a
3-step trajectory of the port's Trainer against the JAX package's
``make_train_step`` (CPU, f32, toy widths), for the unidirectional
lineages of chip_smoke.py's ``ablation_train`` phase.  The bidirectional
and siamese choices, and ``remat_policy='stage_outputs'``, are in
test_torch_ablation_remat.py."""

import numpy as np
import pytest
import torch

import jax

from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu.train.trainer import build_optimizer as jax_build_optimizer
from refid_tpu.train.trainer import create_train_state, make_train_step
from refid_tpu_torch.models.convert import known_unused_keys, state_dict_from_jax
from refid_tpu_torch.train.losses import charbonnier_loss
from refid_tpu_torch.train.trainer import Trainer
from tests.test_torch_helpers import ablation_opt, build_ablation, parity_db, to_nhwc

torch.set_num_threads(1)

B, T, H, W = 1, 3, 16, 16
TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2e-3, "betas": [0.9, 0.99],
                         "weight_decay": 1e-4},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 50,
                           "eta_min": 1e-7},
             "grad_clip_norm": 0.01}
STEPS = 3


def batch(img_chn, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, img_chn, H, W).astype(np.float32),
            rng.randn(B, T, 2, H, W).astype(np.float32),
            rng.rand(B, T, 3, H, W).astype(np.float32))


def check_step_and_trajectory(name, rbt, seed):
    """The loss and every gradient of one step, then the losses and the
    parameters after ``STEPS`` optimiser steps, against JAX."""
    jnet, params, net = build_ablation(name, ablation_opt(rbt), seed=seed)
    lq, vox, gt = batch(net.cfg.img_chn, seed)
    jlq, jvox, jgt = to_nhwc(lq), to_nhwc(vox), to_nhwc(gt)

    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_charbonnier(jnet.apply(p, jlq, jvox), jgt))(params)
    grads_j = state_dict_from_jax(grads_j, net.cfg)
    loss = charbonnier_loss(net(torch.from_numpy(lq), torch.from_numpy(vox)),
                            torch.from_numpy(gt))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in net.named_parameters()}
    assert got.keys() == grads_j.keys()
    scale = max(float(g.abs().max()) for g in grads_j.values())
    worst = max(float((got[k] - grads_j[k]).abs().max()) for k in got)
    assert worst < 1e-4 * scale, (worst, scale)

    tx, _ = jax_build_optimizer(TRAIN_OPT, 50)
    step = make_train_step(jnet.apply, jax_charbonnier, donate=False)
    state = create_train_state(params, tx)
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jlq, jvox, jgt)
        want.append(float(metrics["loss"]))

    _, _, net = build_ablation(name, ablation_opt(rbt), seed=seed)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    trainer = Trainer(net, charbonnier_loss, TRAIN_OPT, 50, frozen=known_unused_keys(net))
    tensors = [torch.from_numpy(a) for a in (lq, vox, gt)]
    losses = [float(trainer.train_step(*tensors)["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert losses[-1] < losses[0]
    # the update of all parameters over the steps, >= 60 dB (the card-vs-CPU
    # training bar of chip_smoke.py): Adam turns the float noise of a
    # gradient element near zero into up to a whole step, so an elementwise
    # bound would hold the summation order, not the math
    moved = state_dict_from_jax(state.params, net.cfg)
    want_update = torch.cat([(moved[k] - before[k]).flatten() for k in before])
    got_update = torch.cat([(p.detach() - before[k]).flatten()
                            for k, p in net.named_parameters()])
    assert parity_db(want_update.numpy(), got_update.numpy()) >= 60.0


@pytest.mark.parametrize("name,rbt", [("UNetRecurrent", "convlstm"),
                                      ("UNetPSDecoderRecurrent", "convgru")])
def test_step_and_trajectory_match_jax(name, rbt):
    check_step_and_trajectory(name, rbt, seed=3)
