"""refid_tpu_torch.train (losses, schedules, optimiser step, EMA) against the
JAX package's functions (CPU, f32)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from refid_tpu.train import losses as jl
from refid_tpu.train import schedules as js
from refid_tpu.train.trainer import build_optimizer as jax_build_optimizer
from refid_tpu.train.trainer import create_train_state, make_train_step
from refid_tpu_torch.train import losses as tl
from refid_tpu_torch.train import schedules as ts
from refid_tpu_torch.train.trainer import Trainer, build_optimizer

torch.set_num_threads(1)


def _nhwc_pair(shape=(2, 8, 10, 3), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def _t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("name,kw", [
    ("charbonnier_loss", {}),
    ("charbonnier_loss", {"reduction": "sum", "loss_weight": 0.5}),
    ("charbonnier_loss", {"reduction": "none"}),
    ("l1_loss", {}),
    ("mse_loss", {"reduction": "sum"}),
])
def test_pixel_losses_match_jax(name, kw):
    a, b = _nhwc_pair(seed=1)
    w = np.abs(_nhwc_pair(seed=2)[0])
    for weight in (None, w):
        want = np.asarray(getattr(jl, name)(a, b, weight=weight, **kw))
        got = getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b),
                                weight=None if weight is None else torch.from_numpy(weight),
                                **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_charbonnier_eps_is_unsquared():
    zero = torch.zeros(4)
    assert float(tl.charbonnier_loss(zero, zero)) == pytest.approx(1e-6, rel=1e-4)


@pytest.mark.parametrize("toY", [False, True])
def test_psnr_loss_matches_jax(toY):
    a, b = _nhwc_pair(seed=3)
    want = float(jl.psnr_loss(a, b, loss_weight=0.5, toY=toY))
    got = float(tl.psnr_loss(_t(a), _t(b), loss_weight=0.5, toY=toY))
    assert got == pytest.approx(want, rel=1e-5)


def test_srn_and_tv_losses_match_jax():
    rng = np.random.RandomState(4)
    gt = rng.rand(2, 16, 24, 3).astype(np.float32)
    preds = [rng.rand(2, 16 // s, 24 // s, 3).astype(np.float32) for s in (4, 2, 1)]
    want = float(jl.srn_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt)))
    got = float(tl.srn_loss([_t(p) for p in preds], _t(gt)))
    assert got == pytest.approx(want, rel=1e-5)
    w = rng.rand(2, 16, 24, 3).astype(np.float32)
    for weight in (None, w):
        want = float(jl.weighted_tv_loss(gt, weight, loss_weight=2.0))
        got = float(tl.weighted_tv_loss(_t(gt), None if weight is None else _t(weight),
                                        loss_weight=2.0))
        assert got == pytest.approx(want, rel=1e-5)


def test_build_loss_matches_jax():
    a, b = _nhwc_pair(seed=5)
    opt = {"type": "CharbonnierLoss", "loss_weight": 2.0, "reduction": "mean"}
    want = float(jl.build_loss(opt)(a, b))
    assert float(tl.build_loss(opt)(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError):
        tl.build_loss({"type": "NoSuchLoss"})


# (options, warmup_iter, steps past the first 130 to check); the JAX
# schedules compute in float32, so steps stay where its argument rounding
# is below the tolerance
_SCHEDULES = [
    ({"type": "TrueCosineAnnealingLR", "T_max": 200000, "eta_min": 1e-7}, -1,
     [150000, 199999]),
    ({"type": "CosineAnnealingLR", "T_max": 50, "eta_min": 0.0}, 10, []),
    ({"type": "CosineAnnealingRestartLR", "periods": [30, 40, 50],
      "restart_weights": [1, 0.5, 0.25], "eta_min": 1e-6}, -1, []),
    ({"type": "MultiStepLR", "milestones": [20, 60], "gamma": 0.5}, -1, []),
    ({"type": "MultiStepRestartLR", "milestones": [20, 60, 90], "gamma": 0.5,
      "restarts": [50], "restart_weights": [0.7]}, 5, []),
    ({"type": "LinearLR"}, -1, []),
    ({"type": "VibrateLR", "total_iter": 8000}, -1, [3000, 4000, 7999]),
]


@pytest.mark.parametrize("sched,warmup,extra", _SCHEDULES,
                         ids=[c[0]["type"] for c in _SCHEDULES])
def test_schedules_match_jax(sched, warmup, extra):
    base, total = 2e-4, 120
    want_fn = js.build_schedule(sched, base, total, warmup)
    got_fn = ts.build_schedule(sched, base, total, warmup)
    steps = list(range(0, 130)) + extra
    want = np.array([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-10)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        ts.build_schedule({"type": "Nope"}, 1e-3, 10)


_TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99],
                          "weight_decay": 1e-4},
              "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 10,
                            "eta_min": 1e-7},
              "grad_clip_norm": 0.01}


def _toy_problem(seed=0):
    """|w| < 1, so 2e-7 is a couple of float32 ulps after three updates."""
    rng = np.random.RandomState(seed)
    return {"w": (0.3 * rng.randn(6, 5)).astype(np.float32),
            "b": (0.3 * rng.randn(5)).astype(np.float32)}


@pytest.mark.parametrize("optim", [
    {"type": "AdamW", "lr": 2e-4, "betas": [0.9, 0.99], "weight_decay": 1e-4},
    {"type": "Adam", "lr": 1e-3, "betas": [0.9, 0.999]},
    {"type": "SGD", "lr": 1e-2, "momentum": 0.9},
])
def test_three_clipped_steps_match_optax(optim):
    """clip 0.01 then the optimiser, with the schedule's lr at optax's count."""
    train_opt = dict(_TRAIN_OPT, optim_g=optim)
    init = _toy_problem()
    rng = np.random.RandomState(1)
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]

    tx, _ = jax_build_optimizer(train_opt, 10)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt, schedule = build_optimizer(train_opt, 10, module.named_parameters())
    for step, g in enumerate(grads):
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, up)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        torch.nn.utils.clip_grad_norm_(list(module.parameters()), 0.01)
        for group in opt.param_groups:
            group["lr"] = schedule(step) * group["lr_mult"]
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=0, atol=2e-7)


def test_dcn_lr_mult_groups():
    net = torch.nn.Module()
    net.offsets = torch.nn.Linear(2, 2)
    net.body = torch.nn.Module()
    net.body.conv_offset = torch.nn.Linear(2, 2)
    net.body.offset_embed = torch.nn.Linear(2, 2)
    opt, _ = build_optimizer(dict(_TRAIN_OPT, dcn_lr_mult=0.1), 10,
                             net.named_parameters())
    mults = {id(p): g["lr_mult"] for g in opt.param_groups for p in g["params"]}
    assert mults[id(net.offsets.weight)] == 0.1
    assert mults[id(net.body.conv_offset.bias)] == 0.1
    assert mults[id(net.body.offset_embed.weight)] == 1.0
    opt, _ = build_optimizer(_TRAIN_OPT, 10, net.named_parameters())
    assert len(opt.param_groups) == 1


class _Affine(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x, _voxel):
        return x @ self.w + self.b


def test_trainer_steps_and_ema_match_jax_train_step():
    """Loss, pre-clip grad norm, params and EMA after each of 3 steps."""
    init = _toy_problem(2)
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6).astype(np.float32)
    # every residual negative: no gradient entry sums to rounding noise,
    # which Adam would blow up to a full step
    y = (rng.randn(4, 5) + 4.0).astype(np.float32)

    def apply_fn(params, lq, _voxel):
        return lq @ params["w"] + params["b"]

    tx, _ = jax_build_optimizer(_TRAIN_OPT, 10)
    step_fn = make_train_step(apply_fn, jl.charbonnier_loss, ema_decay=0.9,
                              donate=False)
    state = create_train_state({k: jnp.asarray(v) for k, v in init.items()}, tx,
                               ema_decay=0.9)

    model = _Affine(init["w"], init["b"])
    trainer = Trainer(model, tl.charbonnier_loss, _TRAIN_OPT, 10, ema_decay=0.9)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        state, want = step_fn(state, jnp.asarray(x), None, jnp.asarray(y))
        got = trainer.train_step(xt, None, yt)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-6)
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-5)
        for k in init:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(state.params[k]), rtol=0, atol=2e-7)
            np.testing.assert_allclose(trainer.ema[k].numpy(),
                                       np.asarray(state.ema_params[k]), rtol=0, atol=2e-7)
    assert trainer.step == int(state.step) == 3
    assert trainer.current_lr() == pytest.approx(
        float(js.build_schedule(_TRAIN_OPT["scheduler"], 2e-4, 10)(3)), rel=1e-6)


def test_unknown_optimizer_raises():
    net = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError):
        build_optimizer(dict(_TRAIN_OPT, optim_g={"type": "Lion", "lr": 1.0}), 10,
                        net.named_parameters())
