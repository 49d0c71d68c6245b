"""Plain PyTorch reference of Restormer (Zamir et al., "Restormer: Efficient
Transformer for High-Resolution Image Restoration", CVPR 2022; upstream
``basicsr/models/archs/restormer_arch.py``, ``Restormer``) at the motion
deblurring settings (``Motion_Deblurring/Options/Deblurring_Restormer.yml``).
Module names are upstream's, float32, NCHW; it imports nothing of the
program.

``x`` is the photo ``(b, 3, H, W)``, ``e`` the normalised voxel ``(b, 6, H,
W)``; ``H`` and ``W`` are multiples of 8.  Every conv is bias-free.

* input: ``patch_embed.proj``, a 3x3 conv ``inp_channels -> dim`` of
  ``cat([x, e])``;
* TransformerBlock(C, h): ``y = y + attn(norm1(y))``, then ``y = y +
  ffn(norm2(y))``;
* LayerNorm (``WithBias``, over the channels of each pixel):
  ``(y - mu) / sqrt(var + 1e-5) * w + b``, ``var`` biased;
* MDTA (``attn``): ``q, k, v = chunk_3(qkv_dwconv(qkv(y)))`` (``qkv`` a 1x1
  conv ``C -> 3C``, ``qkv_dwconv`` a 3x3 depthwise conv); each split
  head-major as ``(b, h, C/h, H W)``; ``q^, k^`` L2-normalised over the
  pixels (eps 1e-12); ``A = softmax(q^ k^T * temperature)`` over the last
  axis; the output ``project_out((A v)`` reshaped to ``(b, C, H, W))``;
* GDFN (``ffn``), ``d = int(ffn_expansion_factor * C)``: ``project_in``
  (1x1, ``C -> 2d``), ``dwconv`` (3x3 depthwise on ``2d``), ``z =
  gelu(x1) * x2`` of its two halves (exact GELU), ``project_out`` (1x1, ``d
  -> C``);
* sampling: ``down*.body`` a 3x3 conv ``C -> C/2`` then
  ``nn.PixelUnshuffle(2)``; ``up*.body`` a 3x3 conv ``C -> 2C`` then
  ``nn.PixelShuffle(2)``;
* levels 1-4 at ``dim * 2**i`` channels: the encoders, the latent, the
  decoders fed ``cat([up(y), skip])`` (levels 3 and 2 through a 1x1
  ``reduce_chan_level*``, level 1 without), ``refinement`` at ``2 dim``,
  and ``output(y) + x`` (``output`` a 3x3 conv ``2 dim -> 3``).

Departures from the published file: the input is the photo and the
event voxel concatenated (``inp_channels`` 9, which the published class
takes as an argument), and the global residual adds the photo's 3
channels, not the whole input.  Only ``LayerNorm_type: WithBias`` and
``dual_pixel_task: False`` are written.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["RestormerRef", "restormer_args"]


class WithBiasLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.weight + self.bias


class LayerNorm(nn.Module):
    """Upstream's ``LayerNorm(dim, 'WithBias')``: ``to_3d``, the norm over
    the last axis, ``to_4d``."""

    def __init__(self, dim):
        super().__init__()
        self.body = WithBiasLayerNorm(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.body(x.reshape(b, c, h * w).transpose(1, 2))
        return y.transpose(1, 2).reshape(b, c, h, w)


class Attention(nn.Module):
    """MDTA."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, 1, 1, groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)

        def split(z):
            return z.reshape(b, self.num_heads, c // self.num_heads, h * w)

        def unit(z):
            return z / z.pow(2).sum(-1, keepdim=True).sqrt().clamp_min(1e-12)

        q, k, v = unit(split(q)), unit(split(k)), split(v)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, -1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    """GDFN."""

    def __init__(self, dim, ffn_expansion_factor):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, 1, 1, groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ffn_expansion_factor):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, 1, 1, bias=False)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat // 2, 3, 1, 1, bias=False),
                                  nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat * 2, 3, 1, 1, bias=False),
                                  nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


def _blocks(n, dim, heads, factor):
    return nn.Sequential(*[TransformerBlock(dim, heads, factor) for _ in range(n)])


class RestormerRef(nn.Module):
    """``x (b, 3, H, W)``, ``event (b, inp_channels - 3, H, W)`` -> ``(b, 3,
    H, W)``."""

    def __init__(self, inp_channels=9, out_channels=3, dim=48, num_blocks=(4, 6, 6, 8),
                 num_refinement_blocks=4, heads=(1, 2, 4, 8), ffn_expansion_factor=2.66):
        super().__init__()
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
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=False)
        self.decoder_level3 = _blocks(num_blocks[2], dim * 4, heads[2], f)
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=False)
        self.decoder_level2 = _blocks(num_blocks[1], dim * 2, heads[1], f)
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = _blocks(num_blocks[0], dim * 2, heads[0], f)
        self.refinement = _blocks(num_refinement_blocks, dim * 2, heads[0], f)
        self.output = nn.Conv2d(dim * 2, out_channels, 3, 1, 1, bias=False)

    def forward(self, x, event):
        enc1 = self.encoder_level1(self.patch_embed(torch.cat([x, event], 1)))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        dec3 = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3], 1)))
        dec2 = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(dec3), enc2], 1)))
        dec1 = self.decoder_level1(torch.cat([self.up2_1(dec2), enc1], 1))
        return self.output(self.refinement(dec1)) + x


def restormer_args(network_g: dict) -> dict:
    """:class:`RestormerRef`'s arguments from an option file's ``network_g``."""
    return {"inp_channels": network_g["inp_channels"], "out_channels": network_g["out_channels"],
            "dim": network_g["dim"], "num_blocks": tuple(network_g["num_blocks"]),
            "num_refinement_blocks": network_g["num_refinement_blocks"],
            "heads": tuple(network_g["heads"]),
            "ffn_expansion_factor": network_g["ffn_expansion_factor"]}
