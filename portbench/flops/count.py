"""Model work from shapes: the convolutions' floating-point operations
(2 x multiply-adds) that one forward of the frozen reference runs, counted
by forward hooks on the ``meta`` device, where nothing is computed.  The
count depends only on the reference and the shapes, never on the program.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn as nn

from portbench.reference.evhinet import EVHINetRef
from portbench.reference.refid import RefidNet

__all__ = ["conv_flops", "refid_window_flops", "evhinet_image_flops"]


def conv_flops(model: nn.Module, *inputs: torch.Tensor) -> int:
    """FLOPs of the convs and transposed convs that ``model(*inputs)`` runs."""
    total = [0]

    def hook(mod, inp, out):
        taps = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * mod.out_channels * taps
        else:
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * taps

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for handle in handles:
            handle.remove()
    return total[0]


@lru_cache(maxsize=None)
def refid_window_flops(height: int, width: int, frames: int = 23, img_chn: int = 26,
                       ev_chn: int = 2, num_encoders: int = 3, base: int = 32,
                       batch: int = 1) -> int:
    """One forward of the blurry-VFI network over ``frames`` outputs."""
    with torch.device("meta"):
        net = RefidNet(img_chn, ev_chn, num_encoders, base)
        x = torch.empty(batch, img_chn, height, width)
        ev = torch.empty(batch, frames, ev_chn, height, width)
    return conv_flops(net, x, ev)


@lru_cache(maxsize=None)
def evhinet_image_flops(height: int, width: int, ev_chn: int = 6, wf: int = 64,
                        depth: int = 3, fac_place: int = 2, batch: int = 1) -> int:
    """One forward of EVHINet on a ``height`` x ``width`` image."""
    with torch.device("meta"):
        net = EVHINetRef(3, ev_chn, wf, depth, fac_place)
        x = torch.empty(batch, 3, height, width)
        ev = torch.empty(batch, ev_chn, height, width)
    return conv_flops(net, x, ev)
