"""The spatial axis: one frame split by height across the ranks of a spatial
group, with the halo exchanges that GSPMD inserts for the JAX package
(``refid_tpu/parallel/mesh.py``) written out.

A frame of height ``H`` splits into whole blocks of ``block = 2**num_encoders``
rows (:func:`row_split`; the first ``blocks % S`` shards take one block more),
so every scale of the network splits at the same place.  While a
:class:`SpatialPlan` is active (:func:`spatial_scope`), the network's modules
consult it:

  * :class:`HaloConv2d` (an ``nn.Conv2d`` with the same parameters and names)
    takes ``padding`` rows from the shard above and ``k - stride - padding``
    from the shard below through :func:`halo_exchange`, then convolves
    without height padding: the 5x5 heads, the 3x3 convs, EGACA's depthwise
    3x3 and the 4x4 stride-2 ``down``s.  The first and last shards receive
    zeros, the conv's own zero padding.
  * :class:`SpatialAvgPool` (the SE gates' global average pool) sums its
    rows, all-reduces the sum over the group and divides by the global
    ``H * W``; :meth:`SpatialPlan.mean` is the same statistic for any
    caller (EVHINet's half instance norm, the PSNR loss).
  * a bilinear x2 upsampling (the ``upsample_conv`` decoder) takes one row
    from each neighbour in ``edge`` mode: the first and last shards repeat
    their own edge row, as ``F.interpolate`` clamps at the frame's border.
  * the deformable conv gathers the whole stage input on every rank
    (:meth:`SpatialPlan.gather`, differentiable: each rank's gradient of the
    gathered rows is summed over the group and kept by the rank that owns
    them) and samples only its own output rows.
  * an int8 site (``serve/quant.py``) quantizes with the group's amax
    (:meth:`SpatialPlan.group_max`) and exchanges the halo rows of the
    quantized NHWC int8 tensor (:meth:`SpatialPlan.exchange_nhwc`).

Everything else is local: the 1x1 convs, the 2x2 transposed convs and the
pixel shuffle, LayerNorm2d's channel statistics, GELU, the recurrence.

Every exchange is one ``all_reduce`` over the spatial group of a buffer
with one slot per rank, each rank writing only its own slot, summed as
bytes (``uint8``): the sum of one written slot and zeros is that slot bit
for bit, whatever the dtype.  NCCL and gloo both carry an ``all_reduce`` of
CUDA tensors, so the same code runs on the card and on the CPU.  It moves
``S`` times the bytes of a point-to-point exchange; :class:`SpatialPlan`
counts both.

The plan is a module-level value, not a thread-local one, on purpose:
``torch.utils.checkpoint`` recomputes a forward (and its exchanges) inside
the backward pass, on the autograd engine's own thread for CUDA tensors,
so the scope must cover the backward pass as well (``train/trainer.py``).
Every rank of a group issues the same collectives in the same order,
forward and backward, because its graph is the same as its neighbours'.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from refid_tpu_torch.ops.conv_epilogue import Act, biased_conv

__all__ = ["MAX_HALO", "row_split", "halo_exchange", "SpatialPlan", "spatial_scope",
           "active", "HaloConv2d", "SpatialAvgPool", "halo_conv2d"]

MAX_HALO = 2        # the largest halo of the networks' convs: the 5x5 heads' and k5/s2 stages'
_ACTIVE: Optional["SpatialPlan"] = None


def row_split(height: int, parts: int, block: int = 1) -> List[Tuple[int, int]]:
    """``(start, stop)`` rows of each of ``parts`` shards of ``height`` rows,
    in whole blocks of ``block`` rows; the first ``blocks % parts`` shards
    take one block more (720 rows, 4 shards, blocks of 8: 23/23/22/22
    blocks)."""
    if height % block:
        raise ValueError(f"height {height} is not a multiple of {block} "
                         "(2**num_encoders) rows")
    blocks = height // block
    base, extra = divmod(blocks, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + (base + (i < extra)) * block
        out.append((start, stop))
        start = stop
    return out


def _group_size_rank(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _sum_bytes(buf: torch.Tensor, group) -> torch.Tensor:
    """All-reduce ``buf`` as bytes: exact when each byte is written by one
    rank at most and is zero on the others."""
    dist.all_reduce(buf.view(torch.uint8), op=dist.ReduceOp.SUM, group=group)
    return buf


def _exchange(x, above: int, below: int, group, edge: bool = False):
    size, r = _group_size_rank(group)
    n = x.shape[-2]
    if n < max(above, below):
        raise ValueError(f"a shard of {n} rows cannot lend a halo of {max(above, below)}")
    buf = x.new_zeros((size,) + x.shape[:-2] + (below + above, x.shape[-1]))
    buf[r] = torch.cat([x[..., :below, :], x[..., n - above:, :]], -2)
    _sum_bytes(buf, group)
    top = buf[r - 1][..., below:, :] if r > 0 else _border(x, above, 0, edge)
    bottom = buf[r + 1][..., :below, :] if r + 1 < size else _border(x, below, n - 1, edge)
    return torch.cat([top, x, bottom], -2)


def _border(x, rows: int, edge_row: int, edge: bool):
    """The rows past the frame's border: zeros, or ``x``'s edge row repeated."""
    if edge:
        return x[..., edge_row:edge_row + 1, :].expand(*x.shape[:-2], rows, x.shape[-1])
    return x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))


def _exchange_grad(g, above: int, below: int, group, edge: bool = False):
    size, r = _group_size_rank(group)
    n = g.shape[-2] - above - below
    buf = g.new_zeros((size,) + g.shape[:-2] + (above + below, g.shape[-1]))
    buf[r] = torch.cat([g[..., :above, :], g[..., above + n:, :]], -2)
    _sum_bytes(buf, group)
    gx = g[..., above:above + n, :].clone()
    if r + 1 < size:      # the shard below read my last `above` rows
        gx[..., n - above:, :] += buf[r + 1][..., :above, :]
    elif edge:            # my bottom border repeated my last row
        gx[..., n - 1:, :] += g[..., above + n:, :].sum(-2, keepdim=True)
    if r > 0:             # the shard above read my first `below` rows
        gx[..., :below, :] += buf[r - 1][..., above:, :]
    elif edge:
        gx[..., :1, :] += g[..., :above, :].sum(-2, keepdim=True)
    return gx


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, group, edge):
        ctx.halo = (above, below, group, edge)
        return _exchange(x, above, below, group, edge)

    @staticmethod
    def backward(ctx, g):
        return _exchange_grad(g.contiguous(), *ctx.halo), None, None, None, None


def halo_exchange(x: torch.Tensor, rows_above: int, rows_below: int, group,
                  edge: bool = False) -> torch.Tensor:
    """``x`` (``(..., h, w)``, this rank's rows) with ``rows_above`` rows of
    the previous rank of ``group`` on top and ``rows_below`` rows of the
    next one underneath; at the ends of the frame zeros, or with ``edge``
    the frame's edge row repeated.  The backward pass sends each halo's
    gradient back to the rank that lent the rows and adds it to them.
    ``group=None`` is a group of one rank."""
    if group is None or dist.get_world_size(group) == 1:
        n = x.shape[-2]
        return torch.cat([_border(x, rows_above, 0, edge), x,
                          _border(x, rows_below, n - 1, edge)], -2)
    return _HaloExchange.apply(x.contiguous(), rows_above, rows_below, group, edge)


class _GroupSum(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's rows into the full-height tensor on every rank; the
    gradient of the full tensor is summed over the group and each rank
    keeps its own rows of it."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        rows = x.shape[dim]
        ctx.group, ctx.dim, ctx.rows = plan.group, dim, rows
        ctx.start = plan.first_row(rows)
        shape = list(x.shape)
        shape[dim] = plan.frame_rows(rows)
        full = x.new_zeros(shape)
        full.narrow(dim, ctx.start, rows).copy_(x)
        return _sum_bytes(full, plan.group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.rows), None, None


class SpatialPlan:
    """How one frame of ``height`` rows splits over ``mesh``'s spatial
    group, and this rank's rows.  ``exchanges`` / ``exchange_bytes`` count
    the halo exchanges and the bytes they lend (the strips a point-to-point
    exchange would send), ``allreduce_bytes`` the buffers the collective
    carries, and ``reductions`` the pooled sums."""

    def __init__(self, mesh, height: int, block: int):
        self.group = mesh.spatial_group
        self.size, self.index = mesh.spatial, mesh.spatial_index
        self.height = height
        self.rows = row_split(height, self.size, block)
        fewest = min(stop - start for start, stop in self.rows) // block
        if fewest < MAX_HALO:
            raise ValueError(
                f"{height} rows over {self.size} spatial shards leave a shard {fewest} "
                f"row(s) at the deepest scale, fewer than the largest halo ({MAX_HALO})")
        self.start, self.stop = self.rows[self.index]
        self.exchanges = self.exchange_bytes = self.allreduce_bytes = self.reductions = 0

    @property
    def local_rows(self) -> int:
        return self.stop - self.start

    def shard(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This rank's rows of a full-height ``x``."""
        return x.narrow(dim, self.start, self.local_rows)

    def gather(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The full-height tensor from every rank's rows ``x`` (at any scale
        of the frame), on every rank; differentiable (:class:`_Gather`)."""
        if self.size == 1:
            return x
        return _Gather.apply(x.contiguous(), self, dim % x.dim())

    def exchange(self, x: torch.Tensor, above: int, below: int,
                 edge: bool = False) -> torch.Tensor:
        """:func:`halo_exchange` over the group, counted."""
        strip = x[..., :1, :].numel() * x.element_size()
        self.exchanges += 1
        self.exchange_bytes += (above + below) * strip
        self.allreduce_bytes += self.size * (above + below) * strip
        return halo_exchange(x, above, below, self.group, edge)

    def exchange_nhwc(self, x: torch.Tensor, above: int, below: int) -> torch.Tensor:
        """:meth:`exchange` of an NHWC ``(n, h, w, c)`` tensor's rows (an
        int8 site's quantized input): zeros at the frame's border."""
        n, h, w, c = x.shape
        return self.exchange(x.reshape(n, h, w * c), above, below).view(
            n, h + above + below, w, c)

    def group_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the group of every rank's ``(1,)`` ``x``, through
        the byte ``all_reduce`` of one slot a rank (exact)."""
        if self.size == 1:
            return x
        buf = x.new_zeros((self.size,) + tuple(x.shape))
        buf[self.index] = x
        self.reductions += 1
        self.allreduce_bytes += buf.numel() * buf.element_size()
        return _sum_bytes(buf, self.group).amax(0)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (autograd: the gradient is the sum
        of the ranks' gradients)."""
        if self.size == 1:
            return x
        self.reductions += 1
        return _GroupSum.apply(x, self.group)

    def frame_rows(self, h: int) -> int:
        """The frame's rows at the scale where this rank holds ``h``."""
        if (self.height * h) % self.local_rows:
            raise ValueError(f"{h} local rows are not a scale of {self.local_rows}")
        return self.height * h // self.local_rows

    def first_row(self, h: int) -> int:
        """This rank's first row at the scale where it holds ``h``."""
        return self.start * h // self.local_rows

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean over the last two axes of a row-sharded ``x``,
        keeping them as ones (``AdaptiveAvgPool2d(1)`` of the whole frame),
        in float32 cast back to ``x``'s dtype."""
        count = self.frame_rows(x.shape[-2]) * x.shape[-1]
        s = self.total(x.float().sum((-2, -1), keepdim=True))
        return (s / count).to(x.dtype)

    def check_rows(self, h: int) -> None:
        if h != self.local_rows:
            raise ValueError(f"input has {h} rows; this rank's shard of the "
                             f"{self.height}-row frame has {self.local_rows}")


def active() -> Optional[SpatialPlan]:
    """The plan of the spatial scope being run, if any."""
    return _ACTIVE


@contextlib.contextmanager
def spatial_scope(plan: Optional[SpatialPlan]):
    """Run the network on row shards under ``plan`` (None: unsharded)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = saved


def halo_conv2d(x, weight, bias=None, stride=(1, 1), padding=(0, 0), groups: int = 1):
    """``F.conv2d`` (undilated, zero padding) that, under an active plan,
    borrows its height padding from the neighbouring shards (``padding``
    rows above, ``kernel - stride - padding`` below) and pads only the
    width itself."""
    stride, padding = _pair(stride), _pair(padding)
    kh = weight.shape[2]
    if _ACTIVE is None or kh == 1:
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)
    x = _ACTIVE.exchange(x, padding[0], kh - stride[0] - padding[0])
    return F.conv2d(x, weight, bias, stride, (0, padding[1]), 1, groups)


class HaloConv2d(nn.Conv2d):
    """The port's conv module: every ``Conv2d`` of the networks, sharded or
    not, 1x1 included.  It is ``nn.Conv2d`` whose height padding, under an
    active plan, comes from the neighbouring shards (:func:`halo_conv2d`;
    a 1x1 conv needs none), and which applies the activation ``act`` that
    follows it (``ops/conv_epilogue.py``: None, ``"relu"``, a leaky slope
    or a tuple of slopes) through the conv layer's entry point
    :func:`~refid_tpu_torch.ops.conv_epilogue.biased_conv`, which may finish
    the output in one pass with the bias."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cudnn_choice = {}      # biased_conv's cache of PyTorch's backend choice

    def forward(self, x, act: Act = None):
        return biased_conv(self, x, act, self._conv)

    def _conv(self, x, bias):
        if _ACTIVE is None or self.kernel_size[0] == 1:
            return self._conv_forward(x, self.weight, bias)
        if self.dilation != (1, 1) or self.padding_mode != "zeros":
            raise ValueError("spatial sharding takes undilated zero-padded convs")
        return halo_conv2d(x, self.weight, bias, self.stride, self.padding, self.groups)


class SpatialAvgPool(nn.AdaptiveAvgPool2d):
    """``AdaptiveAvgPool2d(1)`` whose mean, under an active plan, covers the
    whole frame."""

    def __init__(self):
        super().__init__(1)

    def forward(self, x):
        return super().forward(x) if _ACTIVE is None else _ACTIVE.mean(x)
