"""Seeded weights, made on the device in a few large calls.

The reference's module tree (built on the ``meta`` device) names every
parameter as upstream does, so the state_dict made here loads into the
program's own loader and into the reference alike.  Every value is a draw
of one normal vector from a ``torch.Generator`` on the device:

* conv and transposed-conv kernels: ``gain / sqrt(fan_in)`` (fan-in of a
  transposed conv whose stride equals its kernel: its input channels), so
  that activations keep their scale from layer to layer;
* 1-D weights (the norms' scales): ``1 + 0.1 N``;
* everything else (biases, EGACA's ``beta`` and ``gamma``): ``0.1 N``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

__all__ = ["seeded_state", "torch_seed"]


def torch_seed(seed: int) -> int:
    """A ``--seed`` (any whole number) as a generator's seed."""
    return seed % (1 << 63)


def _rule(module: nn.Module, pname: str, p: torch.Tensor, gain: float):
    if p.dim() == 4 and pname == "weight":
        if isinstance(module, nn.ConvTranspose2d) and module.stride == module.kernel_size:
            fan_in = module.in_channels
        else:
            fan_in = p[0].numel()
        return gain / math.sqrt(fan_in), 0.0
    if p.dim() == 1 and pname == "weight":
        return 0.1, 1.0
    return 0.1, 0.0


def seeded_state(model: nn.Module, seed: int, device, gain: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    """A float32 state_dict of ``model``'s parameters drawn from ``seed``."""
    names, shapes, scales, shifts = [], [], [], []
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            scale, shift = _rule(module, pname, p, gain)
            names.append(f"{mname}.{pname}" if mname else pname)
            shapes.append(p.shape)
            scales.append(scale)
            shifts.append(shift)
    counts = torch.tensor([math.prod(s) for s in shapes], device=device)
    gen = torch.Generator(device).manual_seed(torch_seed(seed))
    flat = torch.randn(int(counts.sum()), generator=gen, device=device)
    flat = (flat * torch.tensor(scales, device=device).repeat_interleave(counts)
            + torch.tensor(shifts, device=device).repeat_interleave(counts))
    out, offset = {}, 0
    for name, shape in zip(names, shapes):
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out
