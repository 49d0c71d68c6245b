"""Learning-rate schedules (mirrors ``refid_tpu/train/schedules.py``).

Each factory returns a plain ``schedule(step) -> lr`` function.  ``step``
counts optimiser updates from 0, as optax's count does: the first update
uses ``schedule(0)``.  Linear warmup overrides the first ``warmup_iter``
steps with ``base_lr * step / warmup_iter``.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = [
    "true_cosine_annealing", "cosine_annealing_restart",
    "multi_step_restart", "linear_lr", "vibrate_lr", "with_warmup",
    "build_schedule",
]


def true_cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    """torch's CosineAnnealingLR as the reference wires it."""
    def schedule(step):
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * step / t_max))
    return schedule


def cosine_annealing_restart(base_lr: float, periods: Sequence[int],
                             restart_weights: Sequence[float] = (1,),
                             eta_min: float = 0.0):
    """Cosine segments of ``periods`` steps, each scaled by its restart
    weight; the last segment runs on past its end."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights differ in length")
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]

    def schedule(step):
        lr = base_lr
        for idx in range(len(periods)):
            lo = 0 if idx == 0 else cumulative[idx - 1]
            last = idx == len(periods) - 1
            if step >= lo and (last or step < cumulative[idx]):
                lr = eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
                    1 + math.cos(math.pi * (step - lo) / periods[idx]))
        return lr
    return schedule


def multi_step_restart(base_lr: float, milestones: Sequence[int],
                       gamma: float = 0.1,
                       restarts: Sequence[int] = (0,),
                       restart_weights: Sequence[float] = (1,)):
    """Piecewise constant: times ``gamma`` at each milestone, back to
    ``base_lr * weight`` at each restart."""
    def schedule(step):
        lr = base_lr
        for m in sorted(milestones):
            if step >= m:
                lr = lr * gamma
        for r, w in zip(restarts, restart_weights):
            if r > 0 and step >= r:
                restart_lr = base_lr * w
                for m in sorted(milestones):
                    if m >= r and step >= m:
                        restart_lr = restart_lr * gamma
                lr = restart_lr
        return lr
    return schedule


def linear_lr(base_lr: float, total_iter: int):
    def schedule(step):
        return base_lr * (1 - step / total_iter)
    return schedule


def vibrate_lr(base_lr: float, total_iter: int):
    """Triangular oscillation under a stepped envelope."""
    period = total_iter // 80
    half = period // 2

    def schedule(step):
        process = step / total_iter
        if process < 3 / 8:
            f = 1 - process * 8 / 3
        elif process < 5 / 8:
            f = 0.2
        else:
            f = 0.1
        t = step % period
        f2 = t / half
        if t >= half:
            f2 = 2 - f2
        weight = f * f2
        if step < half:
            weight = max(weight, 0.1)
        return base_lr * weight
    return schedule


def with_warmup(schedule, base_lr: float, warmup_iter: int):
    """Linear warmup over the first ``warmup_iter`` steps."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step):
        if step < warmup_iter:
            return base_lr * step / warmup_iter
        return schedule(step)
    return warmed


def build_schedule(scheduler_opt: dict, base_lr: float, total_iter: int,
                   warmup_iter: int = -1):
    """Build from a reference-style ``train.scheduler`` dict."""
    opt = dict(scheduler_opt)
    typ = opt.pop("type")
    if typ in ("TrueCosineAnnealingLR", "CosineAnnealingLR"):
        sched = true_cosine_annealing(base_lr, opt.get("T_max", total_iter),
                                      opt.get("eta_min", 0.0))
    elif typ == "CosineAnnealingRestartLR":
        sched = cosine_annealing_restart(base_lr, opt["periods"],
                                         opt.get("restart_weights", (1,)),
                                         opt.get("eta_min", 0.0))
    elif typ == "MultiStepLR":
        sched = multi_step_restart(base_lr, opt["milestones"],
                                   opt.get("gamma", 0.1))
    elif typ == "MultiStepRestartLR":
        sched = multi_step_restart(base_lr, opt["milestones"],
                                   opt.get("gamma", 0.1),
                                   opt.get("restarts", (0,)),
                                   opt.get("restart_weights", (1,)))
    elif typ == "LinearLR":
        sched = linear_lr(base_lr, opt.get("total_iter", total_iter))
    elif typ == "VibrateLR":
        sched = vibrate_lr(base_lr, opt.get("total_iter", total_iter))
    else:
        raise ValueError(f"unknown scheduler {typ!r}")
    return with_warmup(sched, base_lr, warmup_iter)
