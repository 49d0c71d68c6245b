"""Plain reference of the recipe's training step
(``options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml``):
the network's forward over the batch, the Charbonnier loss
``mean(sqrt((pred - gt)^2 + 1e-12))``, the backward (a parameter the loss
does not reach gets a zero gradient), the clip of the global gradient norm
to 0.01, and AdamW (decoupled weight decay, bias-corrected moments) at the
cosine schedule's rate for the step (``eta_min + (lr - eta_min) (1 +
cos(pi step / T_max)) / 2``, step counted from 0).

Parameters of modules the forward never runs (the 3x3 conv that EGACA
replaces, EGACA's unused ``se_2``) are neither trained nor decayed.

``fp8=True`` is the control: every conv reads its input and its weights
rounded to float8 e4m3 (each tensor scaled so its largest magnitude is
e4m3's 448), the gradients passing straight through.
"""

from __future__ import annotations

import math
import types
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.refid import EncoderStage

__all__ = ["charbonnier", "cosine_lr", "trained_names", "fp8_convs", "run_steps", "to_nchw"]


def charbonnier(pred, gt, eps: float = 1e-12):
    return torch.sqrt((pred - gt) ** 2 + eps).mean()


def cosine_lr(step: int, base: float, t_max: int, eta_min: float) -> float:
    return eta_min + (base - eta_min) * 0.5 * (1 + math.cos(math.pi * step / t_max))


def trained_names(net: nn.Module) -> List[str]:
    skip = []
    for name, mod in net.named_modules():
        if isinstance(mod, EncoderStage) and mod.atten_fuse is not None:
            skip += [f"{name}.conv.", f"{name}.atten_fuse.se_2."]
    return [n for n, _ in net.named_parameters() if not any(n.startswith(s) for s in skip)]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def fp8_convs(net: nn.Module) -> nn.Module:
    """Round every conv's input and weights to float8 e4m3 (the control)."""
    for mod in net.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            def fwd(self, x):
                return F.conv_transpose2d(_fp8(x), _fp8(self.weight), self.bias, self.stride,
                                          self.padding, self.output_padding, self.groups,
                                          self.dilation)
            mod.forward = types.MethodType(fwd, mod)
        elif isinstance(mod, nn.Conv2d):
            def fwd(self, x):
                return F.conv2d(_fp8(x), _fp8(self.weight), self.bias, self.stride,
                                self.padding, self.dilation, self.groups)
            mod.forward = types.MethodType(fwd, mod)
    return net


def to_nchw(batch: Dict, device) -> tuple:
    """A loader batch (NHWC host arrays) as the network's tensors."""
    def t(a):
        return torch.from_numpy(a).to(device).movedim(-1, -3).contiguous()
    return t(batch["lq"]), t(batch["voxel"]), t(batch["gt"])


def run_steps(net: nn.Module, batches: Sequence[Dict], train: dict, clip: float = 0.01
              ) -> dict:
    """``len(batches)`` recipe steps from ``net``'s parameters: each step's
    loss, each trained leaf's first gradient as AdamW reads it (after the
    clip), and each leaf's change after the last step."""
    opt, sched = train["optim_g"], train["scheduler"]
    lr0, wd = opt["lr"], opt["weight_decay"]
    b1, b2 = opt["betas"]
    params = dict(net.named_parameters())
    names = trained_names(net)
    start = {n: params[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    device = next(net.parameters()).device
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        lq, voxel, gt = to_nchw(batch, device)
        for p in params.values():
            p.grad = None
        loss = charbonnier(net(lq, voxel), gt)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names}
        total = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        coef = min(1.0, clip / (float(total) + 1e-6))
        grads = {n: g * coef for n, g in grads.items()}
        if first_grad is None:
            first_grad = {n: float(g.norm()) for n, g in grads.items()}
        lr = cosine_lr(step, lr0, sched["T_max"], sched["eta_min"])
        with torch.no_grad():
            for n in names:
                p, g = params[n], grads[n]
                p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** (step + 1))).sqrt_().add_(1e-8)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (step + 1)))
        del loss, lq, voxel, gt
    change = {n: float((params[n].detach() - start[n]).norm()) for n in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}
