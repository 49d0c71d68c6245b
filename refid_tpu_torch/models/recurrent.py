"""Recurrent encoder / decoder stages (NCHW), mirroring
``refid_tpu/models/recurrent.py``: the recurrent cells ``SimpleRecurrentConv``,
``ConvGRU`` and ``ConvLSTM``, the three encoder stage lineages of
``RecurrentEncoderStage`` and the decoders ``TransposeRecurrentConvLayer``,
``PixelShuffleRecurrentConvLayer`` and ``UpsampleConvLayer``.  States are
explicit tensors (zeros at t=0); a ConvLSTM state is a ``(hidden, cell)``
tuple.

With an int8 quant state (``serve/quant.py::QuantState``) the stage conv,
the trunk's three convs and the 4x4/2 ``down`` run as int8 sites, in the JAX
serving forward's order; ``q`` quantizes the stage conv and ``down``,
``q_trunk`` the trunk (the model passes each only where the mode quantizes
it).  The stage conv's two leaky ReLUs (0.2, then 0.2 again) become one
slope-0.04 epilogue there, as ``refid_tpu/serve/fast_forward.py`` does.
Only the production lineage (``then_down``, ``simpleconv``, no DCN, the
transposed-conv decoder) serves in int8.
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
from refid_tpu_torch.ops.deform_conv import ModulatedDeformConvPack
from refid_tpu_torch.parallel import spatial
from refid_tpu_torch.parallel.spatial import HaloConv2d

__all__ = [
    "SimpleRecurrentConv", "ConvGRU", "ConvLSTM", "RecurrentEncoderStage",
    "TransposeRecurrentConvLayer", "PixelShuffleRecurrentConvLayer",
    "UpsampleConvLayer",
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


class ConvGRU(nn.Module):
    """Convolutional GRU cell (upstream ``ConvGRU``): gate convs over
    cat([x, state]) with orthogonal weights and zero biases."""

    def __init__(self, in_ch: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        p = kernel_size // 2
        for name in ("reset_gate", "update_gate", "out_gate"):
            conv = HaloConv2d(in_ch + hidden, hidden, kernel_size, padding=p)
            nn.init.orthogonal_(conv.weight)
            nn.init.zeros_(conv.bias)
            setattr(self, name, conv)

    def forward(self, x, prev_state, q=None):
        stacked = torch.cat([x, prev_state], 1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        cand = torch.tanh(self.out_gate(torch.cat([x, prev_state * reset], 1)))
        new_state = prev_state * (1 - update) + cand * update
        return new_state, new_state


class ConvLSTM(nn.Module):
    """Convolutional LSTM cell (upstream ``ConvLSTM``): one conv ``Gates``
    over cat([x, hidden]) whose 4*hidden channels split, in order, into the
    input, remember, output and cell gates.  The state is (hidden, cell)."""

    def __init__(self, in_ch: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.Gates = HaloConv2d(in_ch + hidden, 4 * hidden, kernel_size,
                                padding=kernel_size // 2)

    def forward(self, x, prev_state, q=None):
        prev_hidden, prev_cell = prev_state
        in_g, rem_g, out_g, cell_g = self.Gates(torch.cat([x, prev_hidden], 1)).chunk(4, 1)
        cell = torch.sigmoid(rem_g) * prev_cell + torch.sigmoid(in_g) * torch.tanh(cell_g)
        hidden = torch.sigmoid(out_g) * torch.tanh(cell)
        return hidden, (hidden, cell)


def _cell(cell: str, features: int, num_block: int) -> nn.Module:
    if cell == "simpleconv":
        return SimpleRecurrentConv(features, num_block)
    if cell == "convgru":
        return ConvGRU(features, features)
    if cell == "convlstm":
        return ConvLSTM(features, features)
    raise ValueError(f"unknown recurrent cell {cell!r}")


class RecurrentEncoderStage(nn.Module):
    """One event-encoder scale.  ``stage_type`` selects upstream's stage
    class:

    * ``then_down`` (``SimpleRecurrentThenDownAttenfusionmodifiedConvLayer``,
      the flagship): [3x3 conv of x(+y) | EGACA(x, y)] -> recurrent cell ->
      optional 1x1 fuse with the other direction's state -> 4x4/2 ``down``.
      The state lives at the pre-down resolution.
    * ``conv_down`` (``SimpleRecurrentConvLayer``): a k5/s2 conv of x + y ->
      recurrent cell -> optional fuse; no ``down``.  The state lives at the
      post-down resolution.
    * ``rec_conv`` (``RecurrentConvLayer``): a k5/s2 conv of x + y with a
      plain ReLU -> ConvGRU / ConvLSTM cell; no fuse, no ``down``.

    ``use_first_dcn`` makes the first conv of ``then_down`` and ``conv_down``
    a modulated deformable conv followed by one leaky ReLU (the plain conv
    path applies ConvLayer's leaky ReLU and then the stage's).  ``rec_conv``
    keeps its plain conv, as the JAX stage does.  With the bidirectional fuse
    a ConvLSTM stage fuses the other direction's hidden state.

    ``conv`` is built even where EGACA replaces it, as upstream builds it, so
    that upstream state_dicts load strictly; there it is never applied.
    """

    def __init__(self, in_ch: int, out_ch: int, num_block: int = 1,
                 use_atten_fuse: bool = False,
                 fuse_two_direction: bool = False,
                 cell: str = "simpleconv", stage_type: str = "then_down",
                 use_first_dcn: bool = False):
        super().__init__()
        if stage_type not in ("then_down", "conv_down", "rec_conv"):
            raise ValueError(f"unknown encoder stage {stage_type!r}")
        self.stage_type = stage_type
        self.atten_fuse = None
        self.fuse_two_dir = None
        self.down = None
        if stage_type == "rec_conv":
            if cell not in ("convgru", "convlstm"):
                raise ValueError("the rec_conv stage is the ConvLSTM/ConvGRU lineage; "
                                 f"got cell {cell!r}")
            self.conv = ConvLayer(in_ch, out_ch, 5, 2, 2, relu_slope=None)
            self.recurrent_block = _cell(cell, out_ch, num_block)
            return
        k, s, p = (3, 1, 1) if stage_type == "then_down" else (5, 2, 2)
        self.conv = (ModulatedDeformConvPack(in_ch, out_ch, k, s, p) if use_first_dcn
                     else ConvLayer(in_ch, out_ch, k, s, p, 0.2))
        if use_atten_fuse and stage_type == "then_down":   # the k5/s2 lineages add y
            self.atten_fuse = CrossmodalAtten(in_ch, out_ch)
        self.recurrent_block = _cell(cell, out_ch, num_block)
        if fuse_two_direction:
            self.fuse_two_dir = ConvLayer(2 * out_ch, out_ch, 1, 1, 0, 0.2)
        if stage_type == "then_down":
            self.down = HaloConv2d(out_ch, out_ch, 4, 2, 1, bias=False)

    def _first_conv(self, x, q):
        if q is None:
            # the DCN's one leaky ReLU; ConvLayer's own, then the stage's
            return F.leaky_relu(self.conv(x), 0.2)
        return q.conv(self.conv.conv2d, x, slope=0.04,
                      exact=lambda v: F.leaky_relu(self.conv(v), 0.2))

    def forward(self, x, y: Optional[torch.Tensor], prev_state,
                bi_direction_state=None, q=None, q_trunk=None):
        if self.stage_type == "rec_conv":
            x = F.relu(self.conv(x if y is None else x + y))
            return self.recurrent_block(x, prev_state)
        if y is not None and self.atten_fuse is not None:
            x = self.atten_fuse(x, y)
        else:
            x = self._first_conv(x if y is None else x + y, q)
        x, state = self.recurrent_block(x, prev_state, q_trunk)
        if bi_direction_state is not None:
            if self.fuse_two_dir is None:
                raise ValueError("stage built without fuse_two_direction")
            if isinstance(bi_direction_state, tuple):    # ConvLSTM: its hidden state
                bi_direction_state = bi_direction_state[0]
            x = self.fuse_two_dir(torch.cat([x, bi_direction_state], 1))
        if self.down is None:
            return x, state
        return (self.down(x) if q is None else q.conv(self.down, x)), state


class TransposeRecurrentConvLayer(nn.Module):
    """Decoder stage: 2x2/2 transposed conv up, cat with the state,
    one-block ConvResidualBlocks trunk; the new state is the output.

    ``fuse_two_direction`` adds the all-bidirection lineage's 1x1 fuse of
    the backward decoder state, applied to the upsampled feature before the
    trunk (upstream computes the fuse and then discards it; the JAX analog
    applies it, and so does this one)."""

    def __init__(self, in_ch: int, out_ch: int, fuse_two_direction: bool = False):
        super().__init__()
        self.transposed_conv2d = conv_transpose_up(in_ch, out_ch)
        self.fuse_two_dir = (ConvLayer(2 * out_ch, out_ch, 1, 1, 0, 0.2)
                             if fuse_two_direction else None)
        self.forward_trunk = ConvResidualBlocks(2 * out_ch, out_ch, 1)

    def forward(self, x, prev_state, bi_direction_state=None, q=None):
        out = self.transposed_conv2d(x)
        if bi_direction_state is not None:
            if self.fuse_two_dir is None:
                raise ValueError("decoder built without fuse_two_direction")
            out = self.fuse_two_dir(torch.cat([out, bi_direction_state], 1))
        out = self.forward_trunk(torch.cat([out, prev_state], 1), q)
        return out, out


class PixelShuffleRecurrentConvLayer(nn.Module):
    """Decoder ablation (upstream ``PixelShuffleRecurrentConvLayer``):
    pixel shuffle x2 (``in_ch`` -> ``in_ch / 4`` channels, torch's channel
    order), cat with the state, one-block ConvResidualBlocks trunk; the new
    state is the output."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.shuffle = nn.PixelShuffle(2)
        self.forward_trunk = ConvResidualBlocks(in_ch // 4 + out_ch, out_ch, 1)

    def forward(self, x, prev_state):
        out = self.forward_trunk(torch.cat([self.shuffle(x), prev_state], 1))
        return out, out


class UpsampleConvLayer(nn.Module):
    """Decoder ablation without recurrence (upstream ``UpsampleConvLayer``,
    k5): bilinear x2 upsampling, a 5x5 conv and a ReLU.  The state passes
    through unchanged.

    On row shards the upsampling reads one row of each neighbour (the frame's
    edge row repeated at its border, where ``F.interpolate`` clamps); the two
    output rows on each side that those rows make are cropped again."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv2d = HaloConv2d(in_ch, out_ch, 5, 1, 2)

    def forward(self, x, prev_state=None):
        plan = spatial.active()
        if plan is not None:
            x = plan.exchange(x, 1, 1, edge=True)
        up = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        if plan is not None:
            up = up[..., 2:-2, :]
        return F.relu(self.conv2d(up)), prev_state
