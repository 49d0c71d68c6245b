"""Uformer's model work an image: the frozen reference's conv FLOPs
(``count.conv_flops``, hooks on the ``meta`` device, at the padded frame
the reference runs) plus, from the shapes, each LeWin block's token linears
and W-MSA's two products.  In a block at ``T`` tokens, ``C`` channels and
LeFF width ``D``: ``to_q``, ``to_kv``, ``proj``, ``linear1`` and
``linear2``, ``2 T (4 C^2 + 2 C D)`` FLOPs; the window products ``q k^T``
and ``A v``, each token against the ``n = win^2`` tokens of its window
over all heads, ``2 * 2 T n C``."""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import torch

from portbench.flops.count import conv_flops
from portbench.reference.uformer import UformerRef

__all__ = ["padded_frame", "lewin_blocks", "linear_flops", "window_matmul_flops",
           "uformer_image_flops"]

DEPTHS = (1, 2, 8, 8, 2, 8, 8, 2, 1)
HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)


def padded_frame(height: int, width: int, win_size: int = 8) -> Tuple[int, int]:
    """The frame the layers run on: whole windows at the bottleneck."""
    m = win_size * 16
    return -(-height // m) * m, -(-width // m) * m


def lewin_blocks(height: int, width: int, embed_dim: int = 32, depths=DEPTHS, num_heads=HEADS,
                 win_size: int = 8, batch: int = 1) -> List[Tuple[int, int, int, bool]]:
    """``(tokens, channels, heads, shifted)`` of each LeWin block, in the
    forward's order (odd blocks of a layer shifted)."""
    hp, wp = padded_frame(height, width, win_size)
    levels = (0, 1, 2, 3, 4, 3, 2, 1, 0)
    widths = (1, 2, 4, 8, 16, 16, 8, 4, 2)
    out = []
    for i, (level, mult) in enumerate(zip(levels, widths)):
        tokens = batch * (hp >> level) * (wp >> level)
        out += [(tokens, embed_dim * mult, num_heads[i], k % 2 == 1) for k in range(depths[i])]
    return out


def linear_flops(height: int, width: int, embed_dim: int = 32, depths=DEPTHS, num_heads=HEADS,
                 win_size: int = 8, mlp_ratio: float = 4.0, batch: int = 1) -> int:
    """The token linears of every block."""
    return sum(2 * t * (4 * c * c + 2 * c * int(c * mlp_ratio)) for t, c, _, _ in
               lewin_blocks(height, width, embed_dim, depths, num_heads, win_size, batch))


def window_matmul_flops(height: int, width: int, embed_dim: int = 32, depths=DEPTHS,
                        num_heads=HEADS, win_size: int = 8, batch: int = 1) -> int:
    """W-MSA's ``q k^T`` and ``A v`` over all blocks."""
    n = win_size * win_size
    return sum(2 * 2 * t * n * c for t, c, _, _ in
               lewin_blocks(height, width, embed_dim, depths, num_heads, win_size, batch))


@lru_cache(maxsize=None)
def uformer_image_flops(height: int, width: int, dd_in: int = 9, embed_dim: int = 32,
                        depths=DEPTHS, num_heads=HEADS, win_size: int = 8,
                        mlp_ratio: float = 4.0, batch: int = 1) -> int:
    """One forward of Uformer on a ``height`` x ``width`` image (padded)."""
    with torch.device("meta"):
        net = UformerRef(dd_in, embed_dim, tuple(depths), tuple(num_heads), win_size, mlp_ratio)
        x = torch.empty(batch, 3, height, width)
        ev = torch.empty(batch, dd_in - 3, height, width)
    return (conv_flops(net, x, ev)
            + linear_flops(height, width, embed_dim, depths, num_heads, win_size, mlp_ratio, batch)
            + window_matmul_flops(height, width, embed_dim, depths, num_heads, win_size, batch))
