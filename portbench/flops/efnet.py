"""EFNet's model work an image: the frozen reference's conv FLOPs
(``count.conv_flops``, hooks on the ``meta`` device) plus what EICA
computes outside convs, from the shapes: at each scale ``i`` with ``P_i``
pixels, ``C_i`` channels and ``n_i`` heads, its MLP's two linear layers
(``2 P C 4C`` FLOPs each at factor 4) and, per head, the Gram product of
the normalised queries and keys and the attention's product with the
values (``2 P (C/n)^2`` each, ``2 P C^2 / n`` over the heads)."""

from __future__ import annotations

from functools import lru_cache

import torch

from portbench.flops.count import conv_flops
from portbench.reference.efnet import EFNetRef

__all__ = ["efnet_image_flops", "eica_matmul_flops"]


def eica_matmul_flops(height: int, width: int, wf: int, num_heads, ffn_expansion_factor: int,
                      batch: int = 1) -> int:
    """EICA's linear layers and attention products over all scales."""
    total = 0
    for i, heads in enumerate(num_heads):
        p, c = batch * (height >> i) * (width >> i), wf << i
        total += 2 * 2 * p * c * c * ffn_expansion_factor + 2 * 2 * p * c * c // heads
    return total


@lru_cache(maxsize=None)
def efnet_image_flops(height: int, width: int, ev_chn: int = 6, wf: int = 64, depth: int = 3,
                      num_heads=(1, 2, 4), ffn_expansion_factor: int = 4, batch: int = 1) -> int:
    """One forward of EFNet on a ``height`` x ``width`` image."""
    with torch.device("meta"):
        net = EFNetRef(3, ev_chn, wf, depth, tuple(num_heads), ffn_expansion_factor)
        x = torch.empty(batch, 3, height, width)
        ev = torch.empty(batch, ev_chn, height, width)
    return (conv_flops(net, x, ev)
            + eica_matmul_flops(height, width, wf, num_heads, ffn_expansion_factor, batch))
