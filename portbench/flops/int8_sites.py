"""The int8 sites of a blurry-VFI window (``reference/quant.py::is_site``
says which convs a mode quantizes) and each site's operations and bytes.

A site's work: ``2 H W Cin Cout k^2`` operations (H, W the output's), and
its bytes: its bf16 activation read once, its int8 weights, its bf16
output written once.  Counted by hooks on the frozen reference on the
``meta`` device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch
import torch.nn as nn

from portbench.reference.quant import is_site
from portbench.reference.refid import RefidNet

__all__ = ["int8_sites", "int8_site_ops", "int8_site_bounds"]


@lru_cache(maxsize=None)
def _site_list(mode, height: int, width: int, frames: int = 23, base: int = 32,
               num_encoders: int = 3) -> Tuple[Tuple[int, int], ...]:
    """(operations, bytes) of each int8 site a window runs, in call order."""
    with torch.device("meta"):
        net = RefidNet(num_encoders=num_encoders, base=base)
        x = torch.empty(1, 26, height, width)
        ev = torch.empty(1, frames, 2, height, width)
    sites = []

    def count(mod, inp, out):
        k2 = mod.kernel_size[0] * mod.kernel_size[1]
        sites.append((2 * out.numel() * mod.in_channels * k2,
                      2 * inp[0].numel() + mod.weight.numel() + 2 * out.numel()))

    handles = [m.register_forward_hook(count) for n, m in net.named_modules()
               if isinstance(m, nn.Conv2d) and is_site(n, mode, num_encoders)]
    try:
        with torch.no_grad():
            net(x, ev)
    finally:
        for h in handles:
            h.remove()
    return tuple(sites)


def int8_sites(mode, height: int, width: int, frames: int = 23, base: int = 32,
               num_encoders: int = 3) -> Tuple[int, int, int]:
    """(sites, operations, bytes) of one window in int8 ``mode``."""
    sites = _site_list(mode, height, width, frames, base, num_encoders)
    return len(sites), sum(o for o, _ in sites), sum(b for _, b in sites)


def int8_site_ops(mode, height: int, width: int, frames: int = 23, base: int = 32) -> int:
    return int8_sites(mode, height, width, frames, base)[1]


def int8_site_bounds(mode, height: int, width: int, frames: int, base: int,
                     ops_per_s: float, bytes_per_s: float) -> float:
    """Seconds: the sum over the sites of max(operations / ops_per_s,
    bytes / bytes_per_s)."""
    return sum(max(o / ops_per_s, b / bytes_per_s)
               for o, b in _site_list(mode, height, width, frames, base))
