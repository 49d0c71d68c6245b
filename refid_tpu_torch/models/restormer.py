"""Restormer, a transformer for image restoration (NCHW; Zamir et al., CVPR
2022, upstream ``basicsr/models/archs/restormer_arch.py``), served through
the single-image task as ``network_g.type: Restormer``, with the photo and
the event voxel concatenated at its input.

The JAX package has no Restormer: this network is held to the benchmark's
plain reference ``portbench/reference/restormer.py``
(``tests/test_torch_restormer.py``), whose docstring gives the equations
and where they depart from the published file.  In short, a four-level
U-Net of transformer blocks at widths ``dim * 2**i``:

* ``patch_embed.proj`` (3x3) of ``cat([x, event])``;
* each :class:`TransformerBlock` is ``y + attn(norm1(y))``, then ``y +
  ffn(norm2(y))``: pre-norm ``WithBias`` LayerNorms over the channels of
  each pixel (each with the residual add in front of it, see below), MDTA
  (:class:`Attention`: a 1x1 conv to q, k, v, a 3x3 depthwise conv, then
  :func:`~refid_tpu_torch.models.arch_util.channel_attention`, the core
  EFNet's EICA shares) and GDFN (:class:`FeedForward`: a 1x1 conv
  to ``2 d``, a 3x3 depthwise conv, ``gelu(x1) * x2``, a 1x1 conv back);
* ``down*`` a 3x3 conv to half the channels and ``nn.PixelUnshuffle(2)``,
  ``up*`` a 3x3 conv to twice the channels and ``nn.PixelShuffle(2)``
  (torch's channel order, which upstream's weights assume);
* the decoders read ``cat([up(y), skip])``, through ``reduce_chan_level*``
  at levels 3 and 2; ``refinement`` at level 1; ``output(y) + x``, the
  photo's channels only.

Every conv is the port's :class:`HaloConv2d` without a bias.  A stage
(:class:`Stage`) hands each block's FFN output on, not yet added, as the
next block's residual: :class:`LayerNorm` takes the residual add in front of
it and returns the sum (the stream) and its norm, and the stage's last FFN
output is added by ``ops/prenorm.py::residual_add``.  Where
``ops/prenorm.py::engages`` holds (a bf16 CUDA stream, gradients off: every
served bf16 call) the add and the norm are one launch of
``csrc/prenorm.cu``; elsewhere PyTorch's add and ``nn.LayerNorm``, the ops
of the unfused forward in its order.  Each block runs inside the profiler
span ``refid.restormer.block``, its attention half inside
``refid.restormer.mdta``, each pre-norm inside ``refid.restormer.norm``
(and, on the kernel, ``refid.restormer.norm_card`` inside it), and adds one
to ``TRANSFORMER_BLOCKS`` (44 a forward at the published depths).
``dtype=torch.bfloat16`` runs under bf16 autocast with float32 parameters
and returns float32.

Neither int8 serving nor spatial sharding applies: MDTA's L2
normalisations, Gram products and softmax reduce over the whole frame, and
no int8 replay of the network exists.  ``val.int8``, an int8 state and a
spatial plan raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.models.arch_util import channel_attention, pre_norm
from refid_tpu_torch.ops import prenorm
from refid_tpu_torch.parallel import spatial
from refid_tpu_torch.parallel.spatial import HaloConv2d

__all__ = ["Restormer", "Stage", "TransformerBlock", "TRANSFORMER_BLOCKS"]

TRANSFORMER_BLOCKS = 0      # transformer blocks run, over the process's life

_NORM_SPANS = ("refid.restormer.norm", "refid.restormer.norm_card")
_NO_INT8 = ("Restormer has no int8 path: no int8 replay of the network exists, and "
            "MDTA's channel attention reduces over the whole frame")
_NO_SPATIAL = ("Restormer cannot run under a spatial plan: MDTA's L2 normalisations, "
               "Gram products and softmax reduce over the whole frame")


class LayerNorm(nn.Module):
    """Upstream's ``LayerNorm(dim, 'WithBias')``: over the channels of each
    pixel (biased variance, eps 1e-5 inside the root, a scale and a bias);
    state ``body.weight`` / ``body.bias`` as upstream's.  ``forward(x,
    residual)`` returns ``(s, y)``: ``s = x + residual`` (``x`` without a
    residual) and ``y`` its norm (``arch_util.pre_norm``: by the kernel
    where ``prenorm.engages(x)``, else ``nn.LayerNorm`` on a channels-last
    view)."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, residual=None):
        return pre_norm(x, residual, self.body, _NORM_SPANS)


class Attention(nn.Module):
    """MDTA: multi-Dconv head transposed attention, over channels."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = HaloConv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = HaloConv2d(dim * 3, dim * 3, 3, 1, 1, groups=dim * 3, bias=False)
        self.project_out = HaloConv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        return self.project_out(channel_attention(q, k, v, self.temperature, self.num_heads))


class FeedForward(nn.Module):
    """GDFN: gated depthwise feed-forward, hidden width
    ``int(dim * ffn_expansion_factor)``."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = HaloConv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = HaloConv2d(hidden * 2, hidden * 2, 3, 1, 1, groups=hidden * 2, bias=False)
        self.project_out = HaloConv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """``forward(pair)``: ``pair`` is ``(stream, residual)``, whose sum is
    the block's input (``residual`` None: the stream alone); returns the
    pair ``(stream after the attention residual, FFN output)``, whose sum
    is the block's output."""

    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, pair):
        global TRANSFORMER_BLOCKS
        x, residual = pair
        with span("refid.restormer.block"):
            with span("refid.restormer.mdta"):
                x, y = self.norm1(x, residual)
                residual = self.attn(y)
            x, y = self.norm2(x, residual)
            residual = self.ffn(y)
        TRANSFORMER_BLOCKS += 1
        return x, residual


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int):
        super().__init__()
        self.proj = HaloConv2d(in_c, embed_dim, 3, 1, 1, bias=False)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(HaloConv2d(n_feat, n_feat // 2, 3, 1, 1, bias=False),
                                  nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(HaloConv2d(n_feat, n_feat * 2, 3, 1, 1, bias=False),
                                  nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class Stage(nn.Sequential):
    """Transformer blocks in turn (upstream's ``nn.Sequential``, its state
    names kept): each block's FFN output goes on as the next block's
    residual, and the last one is added by ``prenorm.residual_add``."""

    def forward(self, x):
        pair = (x, None)
        for block in self:
            pair = block(pair)
        x, residual = pair          # residual None: no block added to the stream
        return x if residual is None else prenorm.residual_add(x, residual)


def _blocks(n: int, dim: int, heads: int, factor: float) -> Stage:
    return Stage(*[TransformerBlock(dim, heads, factor) for _ in range(n)])


class Restormer(nn.Module):
    """``x`` ``(b, out_channels, h, w)`` and ``event`` ``(b, inp_channels -
    out_channels, h, w)`` -> ``(b, out_channels, h, w)``; ``h`` and ``w``
    must be multiples of 8."""

    def __init__(self, inp_channels: int = 9, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 bias: bool = False, layer_norm_type: str = "WithBias",
                 dual_pixel_task: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: only float32 and bfloat16")
        if len(num_blocks) != 4 or len(heads) != 4:
            raise ValueError(f"Restormer needs four levels: num_blocks {list(num_blocks)}, "
                             f"heads {list(heads)}")
        if bias or layer_norm_type != "WithBias" or dual_pixel_task:
            raise ValueError("Restormer is ported with bias: false, LayerNorm_type: WithBias "
                             "and dual_pixel_task: false (the motion-deblurring settings) only")
        self.inp_channels, self.out_channels, self.dtype = inp_channels, out_channels, dtype
        f = ffn_expansion_factor
        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = _blocks(num_blocks[0], dim, heads[0], f)
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = _blocks(num_blocks[1], dim * 2, heads[1], f)
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = _blocks(num_blocks[2], dim * 4, heads[2], f)
        self.down3_4 = Downsample(dim * 4)
        self.latent = _blocks(num_blocks[3], dim * 8, heads[3], f)
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = HaloConv2d(dim * 8, dim * 4, 1, bias=False)
        self.decoder_level3 = _blocks(num_blocks[2], dim * 4, heads[2], f)
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = HaloConv2d(dim * 4, dim * 2, 1, bias=False)
        self.decoder_level2 = _blocks(num_blocks[1], dim * 2, heads[1], f)
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = _blocks(num_blocks[0], dim * 2, heads[0], f)
        self.refinement = _blocks(num_refinement_blocks, dim * 2, heads[0], f)
        self.output = HaloConv2d(dim * 2, out_channels, 3, 1, 1, bias=False)

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
        if x.shape[1] != self.out_channels or x.shape[1] + event.shape[1] != self.inp_channels:
            raise ValueError(f"Restormer({self.inp_channels} -> {self.out_channels} channels) "
                             f"fed an image of {x.shape[1]} and an event of {event.shape[1]}")
        if x.shape[-2] % 8 or x.shape[-1] % 8:
            raise ValueError(f"Restormer's frame sides must be multiples of 8: "
                             f"{tuple(x.shape[-2:])}")
        if self.dtype != torch.bfloat16:
            return self._forward(x, event)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = self._forward(x, event)
        return out.float()

    def _forward(self, x, event):
        enc1 = self.encoder_level1(self.patch_embed(torch.cat([x, event], 1)))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        dec3 = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3], 1)))
        dec2 = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(dec3), enc2], 1)))
        dec1 = self.decoder_level1(torch.cat([self.up2_1(dec2), enc1], 1))
        return self.output(self.refinement(dec1)) + x
