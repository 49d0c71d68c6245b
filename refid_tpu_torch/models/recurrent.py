"""Recurrent encoder / decoder stages (NCHW), mirroring
``refid_tpu/models/recurrent.py`` for the flagship path only:
``SimpleRecurrentConv``, ``RecurrentEncoderStage`` with
``stage_type='then_down'`` and ``cell='simpleconv'``, and
``TransposeRecurrentConvLayer``.  Other ablation axes raise
``NotImplementedError``.  States are explicit tensors (zeros at t=0).

With an int8 quant state (``serve/quant.py::QuantState``) the stage conv,
the trunk's three convs and the 4x4/2 ``down`` run as int8 sites, in the JAX
serving forward's order; ``q`` quantizes the stage conv and ``down``,
``q_trunk`` the trunk (the model passes each only where the mode quantizes
it).  The stage conv's two leaky ReLUs (0.2, then 0.2 again) become one
slope-0.04 epilogue there, as ``refid_tpu/serve/fast_forward.py`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.models.fusion import CrossmodalAtten
from refid_tpu_torch.models.layers import (
    ConvLayer, ConvResidualBlocks, conv_transpose_up,
)

__all__ = [
    "SimpleRecurrentConv", "RecurrentEncoderStage",
    "TransposeRecurrentConvLayer",
]


class SimpleRecurrentConv(nn.Module):
    """cat([x, state]) -> ConvResidualBlocks; the new state is the output."""

    def __init__(self, features: int, num_block: int = 1):
        super().__init__()
        self.forward_trunk = ConvResidualBlocks(2 * features, features,
                                                num_block)

    def forward(self, x, prev_state, q=None):
        feat = self.forward_trunk(torch.cat([x, prev_state], 1), q)
        return feat, feat


class RecurrentEncoderStage(nn.Module):
    """One event-encoder scale (upstream
    ``SimpleRecurrentThenDownAttenfusionmodifiedConvLayer``):
    [3x3 conv of x(+y) | EGACA(x, y)] -> recurrent cell -> optional 1x1 fuse
    with the other direction's state -> 4x4/2 down.  The state lives at the
    pre-down resolution.

    ``conv`` is built even where EGACA replaces it, as upstream builds it, so
    that upstream state_dicts load strictly; there it is never applied.
    """

    def __init__(self, in_ch: int, out_ch: int, num_block: int = 1,
                 use_atten_fuse: bool = False,
                 fuse_two_direction: bool = False,
                 cell: str = "simpleconv", stage_type: str = "then_down",
                 use_first_dcn: bool = False):
        super().__init__()
        if stage_type != "then_down" or cell != "simpleconv" or use_first_dcn:
            raise NotImplementedError(
                f"only stage_type='then_down', cell='simpleconv' without DCN "
                f"is ported; got {stage_type!r}, {cell!r}, dcn={use_first_dcn}")
        self.conv = ConvLayer(in_ch, out_ch, 3, 1, 1, 0.2)
        self.atten_fuse = (CrossmodalAtten(in_ch, out_ch)
                           if use_atten_fuse else None)
        self.recurrent_block = SimpleRecurrentConv(out_ch, num_block)
        self.fuse_two_dir = (ConvLayer(2 * out_ch, out_ch, 1, 1, 0, 0.2)
                             if fuse_two_direction else None)
        self.down = nn.Conv2d(out_ch, out_ch, 4, 2, 1, bias=False)

    def forward(self, x, y: Optional[torch.Tensor], prev_state,
                bi_direction_state: Optional[torch.Tensor] = None, q=None, q_trunk=None):
        if y is not None and self.atten_fuse is not None:
            x = self.atten_fuse(x, y)
        else:
            if y is not None:
                x = x + y
            if q is None:
                # ConvLayer's own leaky ReLU, then the stage's: applied twice,
                # as upstream does
                x = F.leaky_relu(self.conv(x), 0.2)
            else:
                x = q.conv(self.conv.conv2d, x, slope=0.04,
                           exact=lambda v: F.leaky_relu(self.conv(v), 0.2))
        x, state = self.recurrent_block(x, prev_state, q_trunk)
        if bi_direction_state is not None:
            if self.fuse_two_dir is None:
                raise ValueError("stage built without fuse_two_direction")
            x = self.fuse_two_dir(torch.cat([x, bi_direction_state], 1))
        return (self.down(x) if q is None else q.conv(self.down, x)), state


class TransposeRecurrentConvLayer(nn.Module):
    """Decoder stage: 2x2/2 transposed conv up, cat with the state,
    one-block ConvResidualBlocks trunk; the new state is the output."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.transposed_conv2d = conv_transpose_up(in_ch, out_ch)
        self.forward_trunk = ConvResidualBlocks(2 * out_ch, out_ch, 1)

    def forward(self, x, prev_state, q=None):
        out = self.transposed_conv2d(x)
        out = self.forward_trunk(torch.cat([out, prev_state], 1), q)
        return out, out
