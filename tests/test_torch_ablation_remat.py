"""Training the bidirectional and siamese ablation lineages against JAX
(one step's gradients and a 3-step trajectory, as
test_torch_ablation_train.py), and ``remat_policy='stage_outputs'``:
gradients equal to ``'all'``'s and to no remat's, bit for bit, and to the
JAX network's under the same policy (CPU, f32, toy widths)."""

import numpy as np
import pytest
import torch

import jax

from refid_tpu.train.losses import charbonnier_loss as jax_charbonnier
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models.convert import load_state, state_dict_from_jax
from refid_tpu_torch.train.losses import charbonnier_loss
from tests.test_torch_ablation_train import batch, check_step_and_trajectory
from tests.test_torch_helpers import ablation_opt, build_ablation, to_nhwc

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["UNetDecoderRecurrentAllBidirection",
                                  "UNetDecoderRecurrentSiameseImg"])
def test_step_and_trajectory_match_jax(name):
    check_step_and_trajectory(name, None, seed=4)


def _grads(name, rbt, state, inputs, **opt):
    net = ARCHS.get(name)(ablation_opt(rbt, **opt))
    load_state(net, state)
    lq, vox, gt = (torch.from_numpy(a) for a in inputs)
    loss = charbonnier_loss(net(lq, vox), gt)
    loss.backward()
    return float(loss.detach()), {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for k, p in net.named_parameters()}


# every kind of segment: EGACA and the image add at the bottleneck, the
# all-bidirection backward decoders, the siamese fusion, ConvLSTM's tuple
# states with the stateless decoder
REMAT_CASES = [("FinalBidirectionAttenfusion", None),
               ("UNetDecoderRecurrentAllBidirection", None),
               ("UNetDecoderRecurrentSiameseImg", None),
               ("UNetRecurrent", "convlstm")]


@pytest.mark.parametrize("name,rbt", REMAT_CASES,
                         ids=[f"{n}-{r}" if r else n for n, r in REMAT_CASES])
def test_stage_outputs_gradients_equal_all(name, rbt):
    _, _, net = build_ablation(name, ablation_opt(rbt), seed=5)
    state = net.state_dict()
    inputs = batch(net.cfg.img_chn, seed=5)
    plain = _grads(name, rbt, state, inputs)
    every = _grads(name, rbt, state, inputs, remat=True)
    stage = _grads(name, rbt, state, inputs, remat=True, remat_policy="stage_outputs")
    assert stage[0] == every[0] == plain[0]
    for k, g in plain[1].items():
        torch.testing.assert_close(every[1][k], g, rtol=0, atol=0)
        torch.testing.assert_close(stage[1][k], g, rtol=0, atol=0)


def test_stage_outputs_gradients_match_jax():
    """The flagship under ``stage_outputs`` in both packages."""
    opt = ablation_opt(None, remat=True, remat_policy="stage_outputs")
    jnet, params, net = build_ablation("FinalBidirectionAttenfusion", opt, seed=6)
    assert jnet.cfg.remat_policy == net.cfg.remat_policy == "stage_outputs"
    lq, vox, gt = batch(net.cfg.img_chn, seed=6)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_charbonnier(jnet.apply(p, to_nhwc(lq), to_nhwc(vox)), to_nhwc(gt)))(
            params)
    grads_j = state_dict_from_jax(grads_j, net.cfg)
    loss = charbonnier_loss(net(torch.from_numpy(lq), torch.from_numpy(vox)),
                            torch.from_numpy(gt))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in net.named_parameters() if k in grads_j}
    assert got.keys() == grads_j.keys()
    scale = max(float(g.abs().max()) for g in grads_j.values())
    assert max(float((got[k] - grads_j[k]).abs().max()) for k in got) < 1e-4 * scale


def test_stage_outputs_keeps_less_than_no_remat():
    """What the step keeps for the backward pass: ``'all'`` < ``'stage_outputs'``
    < no remat, counted as the bytes of the tensors autograd saves."""
    _, _, net = build_ablation("FinalBidirectionAttenfusion", ablation_opt(None), seed=7)
    state = net.state_dict()
    lq, vox, _ = (torch.from_numpy(a) for a in batch(net.cfg.img_chn, seed=7))
    kept = {}
    for label, opt in (("none", {}), ("all", {"remat": True}),
                       ("stage_outputs", {"remat": True, "remat_policy": "stage_outputs"})):
        model = ARCHS.get("FinalBidirectionAttenfusion")(ablation_opt(None, **opt))
        load_state(model, state)
        saved = {}

        def pack(t):
            saved[(t.data_ptr(), t.shape, t.stride())] = t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(lq, vox).sum()
        kept[label] = sum(saved.values())
    assert kept["all"] < kept["stage_outputs"] < kept["none"], kept
