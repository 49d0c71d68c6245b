"""Training losses (mirrors ``refid_tpu/train/losses.py``).

All losses take (pred, target[, weight]) and support 'none' | 'mean' |
'sum' reduction.  The spatial losses take channels-first tensors (the JAX
package's take NHWC): ``psnr_loss`` projects to luma over dim 1,
``weighted_tv_loss`` differences over the axes that the JAX loss's axes 1
and 2 are in NHWC (height and width of an image, time and height of a
``(b, t, c, h, w)`` stack), ``srn_loss`` resizes over the last two.

A loss always sees whole frames: on row shards the Trainer gathers the
prediction and the target first (``train/trainer.py::sharded_loss``).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

__all__ = ["charbonnier_loss", "l1_loss", "mse_loss", "psnr_loss",
           "srn_loss", "weighted_tv_loss", "build_loss"]


def _reduce(x, weight, reduction):
    if weight is not None:
        x = x * weight
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unsupported reduction mode: {reduction}")


def charbonnier_loss(pred, target, weight=None, eps=1e-12, loss_weight=1.0,
                     reduction="mean"):
    """sqrt((pred-target)^2 + eps), the production loss; eps is the
    reference's 1e-12, not squared."""
    return loss_weight * _reduce(
        torch.sqrt((pred - target) ** 2 + eps), weight, reduction)


def l1_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * _reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * _reduce((pred - target) ** 2, weight, reduction)


def psnr_loss(pred, target, loss_weight=1.0, toY=False):
    """scale * mean over images of log(mse + 1e-8), NCHW; ``toY`` projects
    RGB in [0, 1] to BT.601 luma first."""
    if pred.dim() != 4:
        raise ValueError(f"psnr_loss takes 4-D NCHW, got {tuple(pred.shape)}")
    if toY:
        coef = pred.new_tensor([65.481, 128.553, 24.966]).view(1, 3, 1, 1)
        pred = ((pred * coef).sum(1, keepdim=True) + 16.0) / 255.0
        target = ((target * coef).sum(1, keepdim=True) + 16.0) / 255.0
    scale = 10.0 / math.log(10.0)
    per_image = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    return loss_weight * scale * torch.log(per_image + 1e-8).mean()


def srn_loss(preds, target, loss_weight=1.0):
    """3-scale MSE pyramid: ``preds`` a sequence of the predictions at 1/4,
    1/2 and full resolution; the target ``(b, c, h, w)`` is resized with an
    antialiased bilinear filter.  As the JAX loss, it raises ``ValueError``
    for a target of another rank or a single prediction tensor (no network
    of either package returns the pyramid)."""
    if target.dim() != 4:
        raise ValueError(f"srn_loss takes a 4-D target, got {tuple(target.shape)}")
    if isinstance(preds, torch.Tensor) or len(preds) != 3:
        raise ValueError("srn_loss takes the three predictions (1/4, 1/2, full), "
                        f"got {type(preds).__name__}")
    h, w = target.shape[-2:]
    gt2 = F.interpolate(target, (h // 2, w // 2), mode="bilinear",
                        align_corners=False, antialias=True)
    gt3 = F.interpolate(target, (h // 4, w // 4), mode="bilinear",
                        align_corners=False, antialias=True)
    return loss_weight * (mse_loss(preds[0], gt3) + mse_loss(preds[1], gt2)
                          + mse_loss(preds[2], target))


def _tv_axis(ndim: int, axis: int) -> int:
    """The channels-first axis of the JAX loss's NHWC ``axis``: the axes
    before the image stay, height and width move past the channels."""
    return axis if axis < ndim - 3 else axis + 1


def weighted_tv_loss(pred, weight=None, loss_weight=1.0):
    """Total-variation loss with optional elementwise weights, differencing
    the axes of the JAX loss's NHWC axes 1 and 2; channels-first."""
    nd = pred.dim()
    terms = []
    for axis in (_tv_axis(nd, 2), _tv_axis(nd, 1)):     # the JAX loss's x, then y
        n = pred.shape[axis] - 1
        w = None if weight is None else weight.narrow(axis, 0, n)
        terms.append(l1_loss(pred.narrow(axis, 0, n), pred.narrow(axis, 1, n), weight=w,
                             loss_weight=loss_weight))
    return terms[0] + terms[1]


_LOSSES = {
    "CharbonnierLoss": charbonnier_loss,
    "L1Loss": l1_loss,
    "MSELoss": mse_loss,
    "PSNRLoss": psnr_loss,
    "SRNLoss": srn_loss,
    "WeightedTVLoss": weighted_tv_loss,
}


def build_loss(opt: dict):
    """Build a loss fn from a reference-style ``pixel_opt`` dict, e.g.
    ``{type: CharbonnierLoss, loss_weight: 1.0, reduction: mean}``."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type not in _LOSSES:
        raise ValueError(f"unknown loss {loss_type!r}")
    return partial(_LOSSES[loss_type], **opt)
