"""The training step and optimiser wiring (mirrors
``refid_tpu/train/trainer.py``).

Recipe parity (production blur-VFI 11+1 config): AdamW (lr 2e-4, betas
(0.9, 0.99), weight decay 1e-4), TrueCosineAnnealingLR to 1e-7,
Charbonnier over the full frame stack, global grad-norm clip 0.01 before
the update, no EMA unless ``ema_decay`` is set.

optax semantics kept: the clip comes before the optimiser (``clip_grad_norm_``
matches ``optax.clip_by_global_norm``), the step counter starts at 0 and the
update of step ``k`` uses ``schedule(k)``, the reported ``grad_norm`` is
the norm before clipping, and ``dcn_lr_mult`` scales the whole update of
the deformable-conv parameters (the top-level ``offsets`` / ``dcns``
modules and any ``conv_offset``), which for these optimisers equals scaling
their group's learning rate.

On a ``(data, spatial)`` mesh (``parallel/mesh.py``) the step is the
single-process step on the global batch: under the step's spatial plan each
rank gathers the prediction and the target of the whole frame and takes
the unchanged loss of it divided by the group's size (:func:`sharded_loss`),
the gradients are summed over the world and divided by the data axis (a sum
over the spatial ranks, a mean over the data ranks), and the clip, the
update and the EMA then run on the reduced gradient, the same on every
rank.  The reduction is one
``all_reduce`` of a flat buffer per dtype after the backward pass, not
DDP: the zero gradient of a parameter the loss never reaches is filled
before it (DDP would need ``find_unused_parameters`` and a traversal of the
graph each step), the spatial sum and the data mean are one division, and
no bucket's collective can interleave with the halo exchanges that the
backward pass itself runs on the spatial group.  It does not overlap
communication with the backward pass.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from refid_tpu_torch.parallel.mesh import all_reduce_mean
from refid_tpu_torch.parallel.spatial import spatial_scope
from refid_tpu_torch.train.schedules import build_schedule

__all__ = ["build_optimizer", "sharded_loss", "Trainer"]


def _is_dcn(name: str) -> bool:
    parts = name.split(".")
    return "conv_offset" in parts or parts[0] in ("offsets", "dcns")


def build_optimizer(train_opt: dict, total_iter: int,
                    named_params: Iterable[Tuple[str, nn.Parameter]]):
    """Build the optimiser and the schedule from a reference-style
    ``train`` option dict.  Each param group carries ``lr_mult``."""
    optim = dict(train_opt["optim_g"])
    typ = optim.pop("type")
    lr = optim.pop("lr")
    schedule = build_schedule(train_opt["scheduler"], lr, total_iter,
                              train_opt.get("warmup_iter", -1))
    mult = train_opt.get("dcn_lr_mult", 1.0)
    plain, dcn = [], []
    for name, p in named_params:
        (dcn if mult != 1.0 and _is_dcn(name) else plain).append(p)
    groups = [{"params": plain, "lr_mult": 1.0}]
    if dcn:
        groups.append({"params": dcn, "lr_mult": mult})

    if typ == "AdamW":
        betas = tuple(optim.pop("betas", (0.9, 0.999)))
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=optim.pop("weight_decay", 0.0))
    elif typ == "Adam":
        betas = tuple(optim.pop("betas", (0.9, 0.999)))
        opt = torch.optim.Adam(groups, lr=lr, betas=betas, eps=1e-8)
    elif typ == "SGD":
        opt = torch.optim.SGD(groups, lr=lr, momentum=optim.pop("momentum", 0.0))
    else:
        raise ValueError(f"unknown optimizer {typ!r}")
    return opt, schedule


def sharded_loss(loss_fn: Callable, pred, gt, plan=None):
    """``loss_fn(pred, gt)``, or on row shards (``plan`` a
    ``parallel.spatial.SpatialPlan``) the loss of the gathered whole frames
    divided by the group's size: the ranks' losses sum to the frame's, and
    the gather's backward hands each rank the whole loss's gradient of its
    own rows.  Any loss of whole frames thus runs unchanged."""
    if plan is None:
        return loss_fn(pred, gt)
    return loss_fn(plan.gather(pred), plan.gather(gt)) / plan.size


class Trainer:
    """Owns the optimiser, the step counter and the EMA of one network.

    ``loss_fn(pred, gt) -> scalar``.  :meth:`train_step` runs forward,
    backward, clip, update and EMA on tensors already on the network's
    device and returns ``{'loss', 'grad_norm'}`` as 0-d tensors (reading
    them synchronises with the card).

    ``frozen`` names parameters that are neither trained nor averaged: the
    ones the JAX network does not have (``convert.known_unused_keys``).
    Every other parameter is updated each step; one that the loss does not
    reach (the last backward stage's ``down`` conv) gets a zero gradient,
    so weight decay still applies to it as it does under optax.

    ``mesh`` (a ``parallel.mesh.Mesh``, with a process group: a world of one
    included) reduces the gradients and the logged loss over its ranks
    (module docstring).
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, train_opt: dict,
                 total_iter: int, ema_decay: Optional[float] = None,
                 frozen: Iterable[str] = (), mesh=None):
        self.model = model
        self.mesh = mesh if mesh is not None and dist.is_initialized() else None
        self.loss_fn = loss_fn
        frozen = set(frozen)
        self.named = [(k, p) for k, p in model.named_parameters() if k not in frozen]
        self.params = [p for _, p in self.named]
        self.optimizer, self.schedule = build_optimizer(
            train_opt, total_iter, self.named)
        self.clip = train_opt.get("grad_clip_norm", 0.01)
        self.ema_decay = ema_decay
        self.step = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay:
            self.ema = {k: p.detach().clone() for k, p in self.named}

    def current_lr(self) -> float:
        return float(self.schedule(self.step))

    def train_step(self, lq, voxel, gt, plan=None) -> Dict[str, torch.Tensor]:
        """One step; ``plan`` (``parallel.spatial.SpatialPlan``) when the
        tensors are this rank's rows of the frame."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with spatial_scope(plan):       # the backward pass recomputes under remat
            loss = sharded_loss(self.loss_fn, self.model(lq, voxel), gt, plan)
            loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            loss = loss.detach()
            all_reduce_mean([p.grad for p in self.params] + [loss], self.mesh.data)
        max_norm = self.clip if self.clip and self.clip > 0 else float("inf")
        grad_norm = torch.nn.utils.clip_grad_norm_(self.params, max_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.optimizer.step()
        self.step += 1
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, p in self.named:
                    self.ema[k] = self.ema[k] * d + p * (1.0 - d)
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    def state_dict(self) -> dict:
        return {"step": self.step, "optimizer": self.optimizer.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None and state.get("ema") is not None:
            self.ema = {k: v.to(self.ema[k].device) for k, v in state["ema"].items()}
