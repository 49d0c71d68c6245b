"""Plain PyTorch reference of EFNet (Sun et al., "Event-Based Fusion for
Motion Deblurring with Cross-modal Attention", ECCV 2022; upstream
``basicsr/models/archs/EFNet_arch.py``, ``EFNet``), the output it serves:
its second, stage 2's restored image.  Module names are upstream's,
float32, NCHW; it imports nothing of the program.

With ``C_i = wf * 2**i`` and ``n_i = num_heads[i]`` at scale ``i``:

* mask: ``M = 1[any channel of the event input != 0]``, ``M_i`` its
  nearest downsampling by ``2**i``;
* event encoder: ``conv_ev1``, then per scale an HIN block whose 1x1
  ``conv_before_merge`` (``C_i -> C_i``) gives the event feature ``f_i``
  and whose 4x4/2 ``downsample`` of the block output feeds the next scale;
* stage 1: ``conv_01``, per scale an HIN block, then EICA with ``f_i``
  before the downsample; a UNet decoder (2x2/2 transposed conv, ``cat``
  with ``skip_conv_1`` of the encoder output, an HIN-free block); SAM:
  ``img = conv2(y) + x``, ``s = conv1(y) * sigmoid(conv3(img)) + y``;
* stage 2: ``cat12([conv_02(x), s])``, per scale an HIN block plus, above
  the bottom, the event-mask-gated connections ``emgc_enc(a) +
  emgc_enc_mask((1 - M_i) a) + emgc_dec(d) + emgc_dec_mask(M_i d)`` of
  stage 1's encoder and decoder outputs ``a`` and ``d`` at that scale; the
  same decoder with ``up_path_2`` and ``skip_conv_2``; ``last(y) + x``;
* EICA: ``F = I + project_out(A V)``, with, per head, ``A =
  softmax(temperature * normalize(Q) normalize(K)^T)`` over the channels,
  ``Q = q(LN(I))``, ``K, V = k(LN(E)), v(LN(E))`` (1x1 convs without bias,
  L2 normalisation over the pixels, eps 1e-12), the LayerNorms over the
  channels of each pixel (``WithBias``: biased variance, eps 1e-5); then
  ``F + fc2(GELU(fc1(norm2(F))))`` (exact GELU, ``fc1``: ``C -> 4C``,
  ``norm2`` eps 1e-5).

Departures from the published file, which is not at hand: the mask is
derived from the event input inside the forward (EFNet's datasets supply
it); every encoder block of the event branch and of both stages runs the
half instance norm (HINet's rule), the up blocks none; the event block's
merge conv is ``C_i -> C_i`` and the downsample reads the pre-merge output;
the event-mask-gated connections apply whenever stage 2 runs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["EFNetRef", "efnet_args"]


def _channel_layer_norm(x, weight, bias, eps):
    """LayerNorm over the channels of each pixel of NCHW ``x``."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).pow(2).mean(1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * weight[:, None, None] + bias[:, None, None]


class HINBlock(nn.Module):
    def __init__(self, cin, cout, downsample, hin, slope, merge=False, heads=None,
                 ffn_factor=4, emgc=False):
        super().__init__()
        self.slope = slope
        self.conv_1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv_2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.identity = nn.Conv2d(cin, cout, 1)
        self.norm = nn.InstanceNorm2d(cout // 2, affine=True) if hin else None
        self.downsample = nn.Conv2d(cout, cout, 4, 2, 1, bias=False) if downsample else None
        if merge:
            self.conv_before_merge = nn.Conv2d(cout, cout, 1)
        if heads is not None:
            self.image_event_transformer = EICA(cout, heads, ffn_factor)
        if emgc:
            for name in ("emgc_enc", "emgc_dec", "emgc_enc_mask", "emgc_dec_mask"):
                setattr(self, name, nn.Conv2d(cout, cout, 3, 1, 1))

    def forward(self, x, enc=None, dec=None, mask=None):
        out = self.conv_1(x)
        if self.norm is not None:
            half = out.shape[1] // 2
            a = out[:, :half]
            mu = a.mean((2, 3), keepdim=True)
            var = (a - mu).pow(2).mean((2, 3), keepdim=True)
            a = ((a - mu) / torch.sqrt(var + 1e-5) * self.norm.weight[:, None, None]
                 + self.norm.bias[:, None, None])
            out = torch.cat([a, out[:, half:]], 1)
        out = F.leaky_relu(out, self.slope)
        out = F.leaky_relu(self.conv_2(out), self.slope) + self.identity(x)
        if mask is not None:
            out_enc = self.emgc_enc(enc) + self.emgc_enc_mask((1 - mask) * enc)
            out_dec = self.emgc_dec(dec) + self.emgc_dec_mask(mask * dec)
            out = out + out_enc + out_dec
        return out


class WithBiasLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """Upstream's ``LayerNorm(dim, 'WithBias')``: over the channels of each
    pixel of an NCHW tensor, eps 1e-5."""

    def __init__(self, dim):
        super().__init__()
        self.body = WithBiasLayerNorm(dim)

    def forward(self, x):
        return _channel_layer_norm(x, self.body.weight, self.body.bias, 1e-5)


class MutualAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.q = nn.Conv2d(dim, dim, 1, bias=False)
        self.k = nn.Conv2d(dim, dim, 1, bias=False)
        self.v = nn.Conv2d(dim, dim, 1, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x, y):
        b, c, h, w = x.shape

        def split(z):
            return z.reshape(b, self.heads, c // self.heads, h * w)

        def unit(z):
            return z / z.pow(2).sum(-1, keepdim=True).sqrt().clamp_min(1e-12)

        q, k, v = unit(split(self.q(x))), unit(split(self.k(y))), split(self.v(y))
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, -1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class EICA(nn.Module):
    """Upstream's ``EventImage_ChannelAttentionTransformerBlock``."""

    def __init__(self, dim, heads, ffn_factor):
        super().__init__()
        self.norm1_image = LayerNorm(dim)
        self.norm1_event = LayerNorm(dim)
        self.attn = MutualAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = Mlp(dim, dim * ffn_factor)

    def forward(self, image, event):
        fused = image + self.attn(self.norm1_image(image), self.norm1_event(event))
        t = fused.permute(0, 2, 3, 1)
        mu = t.mean(-1, keepdim=True)
        var = (t - mu).pow(2).mean(-1, keepdim=True)
        normed = (t - mu) / torch.sqrt(var + 1e-5) * self.norm2.weight + self.norm2.bias
        return (t + self.ffn(normed)).permute(0, 3, 1, 2)


class UpBlock(nn.Module):
    def __init__(self, cin, cout, slope):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv_block = HINBlock(cin, cout, False, False, slope)

    def forward(self, x, bridge):
        return self.conv_block(torch.cat([self.up(x), bridge], 1))


class SAM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv2 = nn.Conv2d(c, 3, 3, 1, 1)
        self.conv3 = nn.Conv2d(3, c, 3, 1, 1)

    def forward(self, x, x_img):
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class EFNetRef(nn.Module):
    """``x (b, 3, h, w)``, ``event (b, ev_chn, h, w)`` -> ``(b, 3, h, w)``
    (stage 2's output)."""

    def __init__(self, in_chn=3, ev_chn=6, wf=64, depth=3, num_heads=(1, 2, 4),
                 ffn_expansion_factor=4, relu_slope=0.2):
        super().__init__()
        self.depth = depth
        self.conv_ev1 = nn.Conv2d(ev_chn, wf, 3, 1, 1)
        self.conv_01 = nn.Conv2d(in_chn, wf, 3, 1, 1)
        self.conv_02 = nn.Conv2d(in_chn, wf, 3, 1, 1)
        self.down_path_ev, self.down_path_1, self.down_path_2 = (nn.ModuleList() for _ in range(3))
        prev = wf
        for i in range(depth):
            c, down = 2 ** i * wf, i + 1 < depth
            self.down_path_ev.append(HINBlock(prev, c, down, True, relu_slope, merge=True))
            self.down_path_1.append(HINBlock(prev, c, down, True, relu_slope, heads=num_heads[i],
                                             ffn_factor=ffn_expansion_factor))
            self.down_path_2.append(HINBlock(prev, c, down, True, relu_slope, emgc=down))
            prev = c
        self.up_path_1, self.up_path_2 = nn.ModuleList(), nn.ModuleList()
        self.skip_conv_1, self.skip_conv_2 = nn.ModuleList(), nn.ModuleList()
        for i in reversed(range(depth - 1)):
            c = 2 ** i * wf
            for ups, skips in ((self.up_path_1, self.skip_conv_1),
                               (self.up_path_2, self.skip_conv_2)):
                ups.append(UpBlock(prev, c, relu_slope))
                skips.append(nn.Conv2d(c, c, 3, 1, 1))
            prev = c
        self.sam12 = SAM(prev)
        self.cat12 = nn.Conv2d(2 * prev, prev, 1)
        self.last = nn.Conv2d(prev, in_chn, 3, 1, 1)

    def forward(self, x, event):
        mask = (event != 0).any(1, keepdim=True).float()
        masks = [F.interpolate(mask, scale_factor=0.5 ** i) for i in range(self.depth - 1)]

        e, ev = self.conv_ev1(event), []
        for blk in self.down_path_ev:
            out = blk(e)
            ev.append(blk.conv_before_merge(out))
            if blk.downsample is not None:
                e = blk.downsample(out)

        x1, encs = self.conv_01(x), []
        for i, blk in enumerate(self.down_path_1):
            out = blk.image_event_transformer(blk(x1), ev[i])
            if blk.downsample is None:
                x1 = out
            else:
                encs.append(out)
                x1 = blk.downsample(out)
        decs = []
        for i, (up, skip) in enumerate(zip(self.up_path_1, self.skip_conv_1)):
            x1 = up(x1, skip(encs[-i - 1]))
            decs.append(x1)
        sam_feature, _ = self.sam12(x1, x)

        x2, blocks = self.cat12(torch.cat([self.conv_02(x), sam_feature], 1)), []
        for i, blk in enumerate(self.down_path_2):
            if blk.downsample is None:
                x2 = blk(x2)
            else:
                out = blk(x2, encs[i], decs[-i - 1], masks[i])
                blocks.append(out)
                x2 = blk.downsample(out)
        for i, (up, skip) in enumerate(zip(self.up_path_2, self.skip_conv_2)):
            x2 = up(x2, skip(blocks[-i - 1]))
        return self.last(x2) + x


def efnet_args(network_g: dict) -> dict:
    """:class:`EFNetRef`'s arguments from an option file's ``network_g``."""
    return {"in_chn": network_g["in_chn"], "ev_chn": network_g["ev_chn"], "wf": network_g["wf"],
            "depth": network_g["depth"], "num_heads": tuple(network_g["num_heads"]),
            "ffn_expansion_factor": network_g["ffn_expansion_factor"],
            "relu_slope": network_g["relu_slope"]}
