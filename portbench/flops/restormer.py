"""Restormer's model work an image: the frozen reference's conv FLOPs
(``count.conv_flops``, hooks on the ``meta`` device) plus MDTA's two
products outside convs, from the shapes: in a block at ``P`` pixels, ``C``
channels and ``h`` heads, per head the Gram product of the normalised
queries and keys and the attention's product with the values (``2 P
(C/h)^2`` each, ``2 * 2 P C^2 / h`` over the heads)."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import torch

from portbench.flops.count import conv_flops
from portbench.reference.restormer import RestormerRef

__all__ = ["mdta_blocks", "mdta_matmul_flops", "restormer_image_flops"]


def mdta_blocks(height: int, width: int, dim: int, num_blocks, num_refinement_blocks: int,
                heads, batch: int = 1) -> List[Tuple[int, int, int]]:
    """``(pixels, channels, heads)`` of each transformer block, in the
    forward's order."""
    def level(i):
        return batch * (height >> i) * (width >> i), dim << i, heads[i]

    out = []
    for i in range(3):
        out += [level(i)] * num_blocks[i]
    out += [level(3)] * num_blocks[3]
    for i in (2, 1):
        out += [level(i)] * num_blocks[i]
    p, c, _ = level(0)
    out += [(p, 2 * c, heads[0])] * (num_blocks[0] + num_refinement_blocks)
    return out


def mdta_matmul_flops(height: int, width: int, dim: int, num_blocks, num_refinement_blocks: int,
                      heads, batch: int = 1) -> int:
    """MDTA's Gram and ``attn @ v`` products over all blocks."""
    return sum(2 * 2 * p * c * c // h for p, c, h in
               mdta_blocks(height, width, dim, num_blocks, num_refinement_blocks, heads, batch))


@lru_cache(maxsize=None)
def restormer_image_flops(height: int, width: int, inp_channels: int = 9, dim: int = 48,
                          num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 4,
                          heads=(1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                          batch: int = 1) -> int:
    """One forward of Restormer on a ``height`` x ``width`` image."""
    with torch.device("meta"):
        net = RestormerRef(inp_channels, 3, dim, tuple(num_blocks), num_refinement_blocks,
                           tuple(heads), ffn_expansion_factor)
        x = torch.empty(batch, 3, height, width)
        ev = torch.empty(batch, inp_channels - 3, height, width)
    return (conv_flops(net, x, ev)
            + mdta_matmul_flops(height, width, dim, num_blocks, num_refinement_blocks, heads,
                                batch))
