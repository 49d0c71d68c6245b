"""EVHINet, the event-guided HINet for single-image motion deblurring (NCHW),
mirroring ``refid_tpu/models/evhinet.py`` (upstream
``single_multiconnect_evhinet_arch.py``, ``SingleMultiConnectEVHINet``).

Stage 1 only, as the reference's forward runs it: an event encoder
(``conv_ev1`` and ``down_path_ev``) emits per-pixel (weight, bias) filters
that modulate the image encoder (``conv_01`` and ``down_path_1``, HIN blocks)
at scales ``0 .. fac_place``; a UNet decoder (``up_path_1`` and
``skip_conv_1``) and the SAM head (``sam12``) return the restored image.
Module names are upstream's, the ones that
``refid_tpu/models/convert.py::convert_evhinet_state_dict`` reads.

Reference quirks kept:
  * a 5-D voxel ``(b, t, c, h, w)`` becomes ``t * c`` channels, time-major,
    as the JAX network concatenates ``event[:, i]`` along channels;
  * the last encoder stage never gets the event filter, so the last event
    block (``down_path_ev.2`` at the default geometry) feeds nothing;
  * only SAM's ``conv2(x) + x_img`` reaches the output.
XLA drops the dead code that this implies; eager PyTorch would run it, so
the forward does not compute the last event block, nor the downsample of
the last event block it does compute, nor SAM's ``conv1`` / ``conv3``.  Their
parameters stay (an upstream checkpoint carries them), and the ``Trainer``
gives them zero gradients, so weight decay reaches them as under optax.

int8 serving (``serve/quant.py``): ``forward(x, event, q)`` with a
``QuantState`` runs the 25 stride-1 block convs as int8 sites in the call
order of ``refid_tpu/serve/evhinet_fast.py::evhinet_fast_forward``: each HIN
block's ``conv_1``, ``conv_2`` and ``identity`` (event blocks 0 and 1 then
their ``conv_before_merge``, image blocks 0-2, then per decoder stage the
skip conv and the up block), none with a fused activation.  ``conv_ev1``,
``conv_01``, the 4x4/2 downsamples, the transposed convs and SAM stay float.
It needs the geometry that the JAX serving forward implements
(:func:`evhinet_int8_applicable`: depth 3, fac_place 2).

``dtype=torch.bfloat16`` runs the network under bf16 autocast with float32
parameters and returns float32; the half instance norm computes its
statistics in float32.

Spatial sharding (``parallel/spatial.py``): under an active plan ``x`` and
``event`` are this rank's rows of the frame, in whole blocks of
:attr:`EVHINet.row_block` (2 to the power of the stride-2 convs).  The 3x3
convs, the 4x4/2 downsamples and SAM's conv take halos (``HaloConv2d``); the
half instance norm takes its mean and then its biased variance over the
whole frame through two group sums; the 1x1 convs, ``fac_bias`` and the
transposed convs are local; the int8 sites are ``serve/quant.py``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.models.layers import conv_transpose_up
from refid_tpu_torch.parallel import spatial
from refid_tpu_torch.parallel.spatial import HaloConv2d

__all__ = ["EVHINet", "HINConvBlock", "EVConvBlock", "UpBlock", "SAM",
           "half_instance_norm", "fac_bias", "evhinet_int8_applicable"]


def half_instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Affine instance norm (biased variance) over the first ``len(weight)``
    channels of NCHW ``x``; the other channels pass through.  Under an
    active spatial plan the statistics are the whole frame's."""
    half = weight.shape[0]
    h1 = x[:, :half].float()
    plan = spatial.active()
    if plan is None:
        mu = h1.mean((2, 3), keepdim=True)
        var = (h1 - mu).square().mean((2, 3), keepdim=True)
    else:
        mu = plan.mean(h1)
        var = plan.mean((h1 - mu).square())
    h1 = ((h1 - mu) * torch.rsqrt(var + eps) * weight.view(1, -1, 1, 1)
          + bias.view(1, -1, 1, 1))
    return torch.cat([h1.to(x.dtype), x[:, half:]], 1)


def fac_bias(feat: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """``feat * weight + bias`` with (weight, bias) the two channel halves of
    the event filter."""
    weight, bias = filt.chunk(2, dim=1)
    return feat * weight + bias


def evhinet_int8_applicable(net) -> bool:
    """True iff int8 serving applies: an :class:`EVHINet` of the geometry
    that the JAX serving forward implements (``evhinet_foldable``: depth 3,
    fac_place 2)."""
    return isinstance(net, EVHINet) and net.depth == 3 and net.fac_place == 2


def _conv(module: nn.Conv2d, x, q):
    return module(x) if q is None else q.conv(module, x)


class HINConvBlock(nn.Module):
    """conv_1 (+ half instance norm) -> leaky -> conv_2 -> leaky, plus the 1x1
    ``identity`` of the input; an optional event filter; the 4x4/2
    ``downsample`` is left to the caller (:meth:`forward` returns the
    full-resolution output)."""

    def __init__(self, in_size: int, out_size: int, downsample: bool,
                 relu_slope: float = 0.2, use_hin: bool = True):
        super().__init__()
        self.relu_slope = relu_slope
        self.conv_1 = HaloConv2d(in_size, out_size, 3, 1, 1)
        self.conv_2 = HaloConv2d(out_size, out_size, 3, 1, 1)
        self.identity = nn.Conv2d(in_size, out_size, 1, 1, 0)
        self.norm = nn.InstanceNorm2d(out_size // 2, affine=True) if use_hin else None
        self.downsample = (HaloConv2d(out_size, out_size, 4, 2, 1, bias=False)
                           if downsample else None)

    def forward(self, x, filt=None, q=None):
        out = _conv(self.conv_1, x, q)
        if self.norm is not None:
            out = half_instance_norm(out, self.norm.weight, self.norm.bias)
        out = F.leaky_relu(out, self.relu_slope)
        out = F.leaky_relu(_conv(self.conv_2, out, q), self.relu_slope)
        out = out + _conv(self.identity, x, q)
        if filt is not None:
            out = fac_bias(out, filt)
        return out


class EVConvBlock(HINConvBlock):
    """The event branch's HIN block: also lifts its full-resolution output to
    the (weight, bias) filter of ``2 * out_size`` channels by a 1x1
    ``conv_before_merge``.  :meth:`forward` returns (output, filter)."""

    def __init__(self, in_size: int, out_size: int, downsample: bool,
                 relu_slope: float = 0.2, use_hin: bool = True):
        super().__init__(in_size, out_size, downsample, relu_slope, use_hin)
        self.conv_before_merge = nn.Conv2d(out_size, 2 * out_size, 1, 1, 0)

    def forward(self, x, q=None):
        out = super().forward(x, q=q)
        return out, _conv(self.conv_before_merge, out, q)


class UpBlock(nn.Module):
    """2x2/2 transposed conv ``up``, then an HIN-free ``conv_block`` on
    ``[up, bridge]``."""

    def __init__(self, in_size: int, out_size: int, relu_slope: float = 0.2):
        super().__init__()
        self.up = conv_transpose_up(in_size, out_size)
        self.conv_block = HINConvBlock(in_size, out_size, False, relu_slope, use_hin=False)


class SAM(nn.Module):
    """Supervised attention head.  The single-stage network returns only
    ``conv2(x) + x_img``; ``conv1`` and ``conv3`` (the attention branch) are
    kept for the checkpoint and never run."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv1 = nn.Conv2d(n_feat, n_feat, 3, 1, 1)
        self.conv2 = HaloConv2d(n_feat, 3, 3, 1, 1)
        self.conv3 = nn.Conv2d(3, n_feat, 3, 1, 1)

    def forward(self, x, x_img):
        return self.conv2(x) + x_img


class EVHINet(nn.Module):
    """Single-image deblurring: ``x`` ``(b, in_chn, h, w)`` and ``event``
    ``(b, ev_chn, h, w)`` (or ``(b, t, c, h, w)`` with ``t * c = ev_chn``)
    -> ``(b, 3, h, w)``.  ``h`` and ``w`` must be multiples of
    ``2 ** (depth - 1)``."""

    def __init__(self, in_chn: int = 3, ev_chn: int = 6, wf: int = 64, depth: int = 3,
                 fac_place: int = 2, hin_left: int = 0, hin_right: int = 4,
                 relu_slope: float = 0.2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: only float32 and bfloat16")
        self.depth, self.fac_place = depth, fac_place
        self.hin_left, self.hin_right = hin_left, hin_right
        self.dtype = dtype
        hin = [hin_left <= i <= hin_right for i in range(depth)]

        self.conv_ev1 = HaloConv2d(ev_chn, wf, 3, 1, 1)
        self.down_path_ev = nn.ModuleList()
        prev = wf
        for i in range(min(fac_place + 1, depth)):
            self.down_path_ev.append(EVConvBlock(prev, 2 ** i * wf, i + 1 < depth,
                                                 relu_slope, hin[i]))
            prev = 2 ** i * wf

        self.conv_01 = HaloConv2d(in_chn, wf, 3, 1, 1)
        self.down_path_1 = nn.ModuleList()
        prev = wf
        for i in range(depth):
            self.down_path_1.append(HINConvBlock(prev, 2 ** i * wf, i + 1 < depth,
                                                 relu_slope, hin[i]))
            prev = 2 ** i * wf

        self.up_path_1 = nn.ModuleList()
        self.skip_conv_1 = nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path_1.append(UpBlock(prev, 2 ** i * wf, relu_slope))
            self.skip_conv_1.append(HaloConv2d(2 ** i * wf, 2 ** i * wf, 3, 1, 1))
            prev = 2 ** i * wf
        self.sam12 = SAM(prev)

    int8_side = 4    # a task predicts in int8 where both frame sides are multiples of this

    @property
    def row_block(self) -> int:
        """The rows of a spatial shard come in whole blocks of this many."""
        return 2 ** (self.depth - 1)

    def task_int8_mode(self, int8) -> bool:
        """The int8 mode that a task's ``val.int8`` selects: any truthy value
        means dynamic scales, as the JAX task's ``int8=bool(int8)``."""
        if int8 and not evhinet_int8_applicable(self):
            raise ValueError("val.int8 requires the EVHINet geometry of the JAX serving "
                             f"forward (depth 3, fac_place 2); got depth {self.depth}, "
                             f"fac_place {self.fac_place}")
        return bool(int8)

    def forward(self, x, event, q=None):
        if q is not None and not evhinet_int8_applicable(self):
            raise ValueError("int8 serving needs the EVHINet geometry that the JAX "
                             f"serving forward implements (depth 3, fac_place 2); got "
                             f"depth {self.depth}, fac_place {self.fac_place}")
        if q is not None and q.int8 not in (True, "calib", "static"):
            raise ValueError(f"EVHINet serves int8 True, 'calib' or 'static' (as the JAX "
                             f"serving forward); got {q.int8!r}")
        plan = spatial.active()
        if plan is not None:
            plan.check_rows(x.shape[-2])
        if self.dtype != torch.bfloat16:
            out = self._forward(x, event, q)
        else:
            with torch.autocast(x.device.type, dtype=torch.bfloat16):
                out = self._forward(x, event, q)
            out = out.float()
        if q is not None:
            q.finish()
        return out

    def _forward(self, x, event, q=None):
        if event.dim() == 5:   # (b, t, c, h, w) -> (b, t * c, h, w), time-major
            event = event.flatten(1, 2)

        # event encoder: only the blocks whose filter an image stage reads
        used = min(self.fac_place + 1, self.depth - 1)
        e = self.conv_ev1(event)
        filters = []
        for i in range(used):
            blk = self.down_path_ev[i]
            out, merged = blk(e, q)
            filters.append(merged)
            if i + 1 < used:
                e = blk.downsample(out)

        x1 = self.conv_01(x)
        encs = []
        for i, blk in enumerate(self.down_path_1):
            out = blk(x1, filters[i] if i < used else None, q)
            if blk.downsample is None:
                x1 = out
            else:
                encs.append(out)
                x1 = blk.downsample(out)

        for idx, (up_blk, skip) in enumerate(zip(self.up_path_1, self.skip_conv_1)):
            up = up_blk.up(x1)
            bridge = _conv(skip, encs[-idx - 1], q)
            x1 = up_blk.conv_block(torch.cat([up, bridge], 1), q=q)

        return self.sam12(x1, x)
