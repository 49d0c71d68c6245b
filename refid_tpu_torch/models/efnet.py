"""EFNet, event-image fusion for single-image motion deblurring (NCHW; Sun
et al., ECCV 2022, upstream ``basicsr/models/archs/EFNet_arch.py``), served
through the single-image task as ``network_g.type: EFNet``.

The JAX package has no EFNet: this network is held to the benchmark's
plain reference ``portbench/reference/efnet.py`` (``tests/test_torch_efnet.py``),
whose docstring gives the equations and where they depart from the
published file.  In short, with ``C_i = wf * 2**i`` at scale ``i``:

* the event encoder (``conv_ev1``, ``down_path_ev``: :class:`EVConvBlock`
  with a ``C_i -> C_i`` merge conv) gives one feature a scale;
* stage 1 (``conv_01``, ``down_path_1``) is an HIN encoder whose blocks
  end in EICA (``image_event_transformer``: the image attends over the
  event feature's channels, ``num_heads[i]`` heads) before the downsample,
  then a UNet decoder (``up_path_1``, ``skip_conv_1``) and SAM's whole head
  (``sam12``, :meth:`SAM.full`);
* stage 2 (``conv_02``, ``cat12``, ``down_path_2``, ``up_path_2``,
  ``skip_conv_2``, ``last``) is a second HIN UNet fed SAM's features,
  whose encoder blocks above the bottom add stage 1's encoder and decoder
  outputs through four 3x3 convs, two of them gated by the event mask
  (event-mask-gated connections, ``emgc_*``);
* the mask is 1 where any channel of the event input is nonzero, taken
  every ``2**i`` pixels at scale ``i``.

The forward returns stage 2's image, upstream's second output; stage 1's
image is computed (SAM needs it) and dropped.  Each EICA block runs inside
the profiler span ``refid.efnet.eica`` and adds one to ``EICA_BLOCKS``
(``depth`` a forward).  ``dtype=torch.bfloat16`` runs under bf16 autocast
with float32 parameters and returns float32.

Neither int8 serving nor spatial sharding applies: EICA's L2
normalisations, Gram products and softmax reduce over the whole frame, and
no int8 replay of the network exists.  ``val.int8``, an int8 state and a
spatial plan raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.models.arch_util import EventImageChannelAttentionTransformerBlock
from refid_tpu_torch.models.evhinet import EVConvBlock, HINConvBlock, SAM, UpBlock
from refid_tpu_torch.parallel import spatial
from refid_tpu_torch.parallel.spatial import HaloConv2d

__all__ = ["EFNet", "EFConvBlock", "EICA_BLOCKS"]

EICA_BLOCKS = 0      # EICA blocks run, over the process's life

_NO_INT8 = ("EFNet has no int8 path: no int8 replay of the network exists, and "
            "EICA's channel attention reduces over the whole frame")
_NO_SPATIAL = ("EFNet cannot run under a spatial plan: EICA's L2 normalisations, "
               "Gram products and softmax reduce over the whole frame")


class EFConvBlock(HINConvBlock):
    """A stage's HIN encoder block, then (stage 2) the event-mask-gated
    connections of stage 1's encoder output ``enc`` and decoder output
    ``dec`` under ``mask``, or (stage 1) EICA with the event feature.  The
    4x4/2 ``downsample`` is left to the caller."""

    def __init__(self, in_size: int, out_size: int, downsample: bool, relu_slope: float,
                 num_heads: Optional[int] = None, ffn_expansion_factor: int = 4,
                 emgc: bool = False):
        super().__init__(in_size, out_size, downsample, relu_slope, use_hin=True)
        if num_heads is not None:
            self.image_event_transformer = EventImageChannelAttentionTransformerBlock(
                out_size, num_heads, ffn_expansion_factor, bias=False, eps=1e-5)
        if emgc:
            for name in ("emgc_enc", "emgc_dec", "emgc_enc_mask", "emgc_dec_mask"):
                setattr(self, name, HaloConv2d(out_size, out_size, 3, 1, 1))

    def forward(self, x, enc=None, dec=None, mask=None, event=None):
        global EICA_BLOCKS
        out = super().forward(x)
        if mask is not None:
            m = mask.to(out.dtype)
            out_enc = self.emgc_enc(enc) + self.emgc_enc_mask((1 - m) * enc)
            out_dec = self.emgc_dec(dec) + self.emgc_dec_mask(m * dec)
            out = out + out_enc + out_dec
        if event is not None:
            with span("refid.efnet.eica"):
                out = self.image_event_transformer(out, event)
            EICA_BLOCKS += 1
        return out


def _decode(ups: nn.ModuleList, skips: nn.ModuleList, y, encs):
    """A UNet decoder from the bottom ``y``: each scale's output, coarse to
    fine."""
    decs = []
    for idx, (up_blk, skip) in enumerate(zip(ups, skips)):
        y = up_blk.conv_block(torch.cat([up_blk.up(y), skip(encs[-idx - 1])], 1))
        decs.append(y)
    return decs


class EFNet(nn.Module):
    """``x`` ``(b, in_chn, h, w)`` and ``event`` ``(b, ev_chn, h, w)`` ->
    ``(b, in_chn, h, w)``; ``h`` and ``w`` must be multiples of ``2 **
    (depth - 1)``."""

    def __init__(self, in_chn: int = 3, ev_chn: int = 6, wf: int = 64, depth: int = 3,
                 num_heads: Sequence[int] = (1, 2, 4), ffn_expansion_factor: int = 4,
                 fuse_before_downsample: bool = True, relu_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: only float32 and bfloat16")
        if len(num_heads) != depth:
            raise ValueError(f"EFNet needs a head count a scale: depth {depth}, "
                             f"num_heads {list(num_heads)}")
        if not fuse_before_downsample:
            raise ValueError("EFNet is ported with fuse_before_downsample: true (the "
                             "published setting) only")
        self.depth, self.dtype = depth, dtype
        self.conv_ev1 = HaloConv2d(ev_chn, wf, 3, 1, 1)
        self.conv_01 = HaloConv2d(in_chn, wf, 3, 1, 1)
        self.conv_02 = HaloConv2d(in_chn, wf, 3, 1, 1)
        self.down_path_ev = nn.ModuleList()
        self.down_path_1 = nn.ModuleList()
        self.down_path_2 = nn.ModuleList()
        prev = wf
        for i in range(depth):
            c, down = 2 ** i * wf, i + 1 < depth
            self.down_path_ev.append(EVConvBlock(prev, c, down, relu_slope, merge_size=c))
            self.down_path_1.append(EFConvBlock(prev, c, down, relu_slope, num_heads[i],
                                                ffn_expansion_factor))
            self.down_path_2.append(EFConvBlock(prev, c, down, relu_slope, emgc=down))
            prev = c
        self.up_path_1, self.up_path_2 = nn.ModuleList(), nn.ModuleList()
        self.skip_conv_1, self.skip_conv_2 = nn.ModuleList(), nn.ModuleList()
        for i in reversed(range(depth - 1)):
            c = 2 ** i * wf
            for ups, skips in ((self.up_path_1, self.skip_conv_1),
                               (self.up_path_2, self.skip_conv_2)):
                ups.append(UpBlock(prev, c, relu_slope))
                skips.append(HaloConv2d(c, c, 3, 1, 1))
            prev = c
        self.sam12 = SAM(prev)
        self.cat12 = HaloConv2d(2 * prev, prev, 1, 1, 0)
        self.last = HaloConv2d(prev, in_chn, 3, 1, 1)

    @property
    def row_block(self) -> int:
        raise ValueError(_NO_SPATIAL)

    def task_int8_mode(self, int8) -> bool:
        if int8:
            raise ValueError(f"val.int8: {_NO_INT8}")
        return False

    def forward(self, x, event, q=None):
        if q is not None:
            raise ValueError(_NO_INT8)
        if spatial.active() is not None:
            raise ValueError(_NO_SPATIAL)
        if self.dtype != torch.bfloat16:
            return self._forward(x, event)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = self._forward(x, event)
        return out.float()

    def _forward(self, x, event):
        mask = (event != 0).any(1, keepdim=True)

        e, feats = self.conv_ev1(event), []
        for blk in self.down_path_ev:
            out, merged = blk(e)
            feats.append(merged)
            if blk.downsample is not None:
                e = blk.downsample(out)

        x1, encs = self.conv_01(x), []
        for i, blk in enumerate(self.down_path_1):
            out = blk(x1, event=feats[i])
            if blk.downsample is None:
                x1 = out
            else:
                encs.append(out)
                x1 = blk.downsample(out)
        decs = _decode(self.up_path_1, self.skip_conv_1, x1, encs)
        sam_feature, _ = self.sam12.full(decs[-1], x)

        x2, blocks = self.cat12(torch.cat([self.conv_02(x), sam_feature], 1)), []
        for i, blk in enumerate(self.down_path_2):
            if blk.downsample is None:
                x2 = blk(x2)
            else:
                step = 2 ** i
                out = blk(x2, encs[i], decs[-i - 1], mask[..., ::step, ::step])
                blocks.append(out)
                x2 = blk.downsample(out)
        y = _decode(self.up_path_2, self.skip_conv_2, x2, blocks)[-1]
        return self.last(y) + x
