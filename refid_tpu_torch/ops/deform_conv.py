"""Modulated deformable convolution v2 (NCHW), mirroring
``refid_tpu/ops/deform_conv.py``.

Plain PyTorch: per kernel tap the input is sampled at ``p + p_k + dp_k``
with bilinear interpolation (zeros outside the frame), scaled by the
modulation mask, and the k*k samples are contracted with the weights in one
matrix product.  The samples are gathered as rows of the channels-last
input, so each gather reads whole channel vectors, and every tap in one
gather per bilinear corner, so a call launches a few dozen kernels whatever
k is.  torchvision's ``deform_conv2d`` is not used.

Offsets follow torchvision's layout: ``offset (b, 2*kh*kw, ho, wo)`` with
(y, x) interleaved per tap; ``mask (b, kh*kw, ho, wo)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["deform_conv2d", "ModulatedDeformConvPack"]


def _bilinear_rows(rows, b, h, w, py, px):
    """Bilinear samples of ``rows`` ((b*h*w, c), the channels-last input) at
    absolute coordinates ``py``/``px`` ((b, n)); zeros outside.  Returns
    (b, n, c)."""
    y0, x0 = torch.floor(py), torch.floor(px)
    dy, dx = (py - y0).unsqueeze(-1), (px - x0).unsqueeze(-1)
    base = (torch.arange(b, device=rows.device) * (h * w)).view(b, 1)

    def gather(yi, xi):
        inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).unsqueeze(-1)
        idx = (base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        return rows.index_select(0, idx.reshape(-1)).view(b, -1, rows.shape[1]) * inb

    return (gather(y0, x0) * (1 - dy) * (1 - dx)
            + gather(y0, x0 + 1) * (1 - dy) * dx
            + gather(y0 + 1, x0) * dy * (1 - dx)
            + gather(y0 + 1, x0 + 1) * dy * dx)


def deform_conv2d(x, offset, weight, bias=None, mask=None, stride=1, padding=1,
                  dilation=1):
    """``x (b, cin, h, w)``; ``weight (cout, cin, kh, kw)``; ``offset (b,
    2*kh*kw, ho, wo)``; ``mask (b, kh*kw, ho, wo)`` or None.  One offset
    group.  All k*k taps are sampled in one gather per bilinear corner."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    kk = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, cin)

    def grid(n_out, k):    # (k, n_out): tap offset + output position, in pixels
        taps = torch.arange(k, device=x.device, dtype=torch.float32) * dilation
        pos = torch.arange(n_out, device=x.device, dtype=torch.float32) * stride - padding
        return taps.view(k, 1) + pos.view(1, n_out)

    # sample coordinates in float32 whatever the compute dtype: bf16 holds
    # whole pixel indices only up to 256
    offset = offset.float().view(b, kh, kw, 2, ho, wo)
    py = grid(ho, kh).view(1, kh, 1, ho, 1) + offset[:, :, :, 0]      # (b, kh, kw, ho, wo)
    px = grid(wo, kw).view(1, 1, kw, 1, wo) + offset[:, :, :, 1]
    s = _bilinear_rows(rows, b, h, w, py.reshape(b, -1), px.reshape(b, -1))
    s = s.view(b, kk, ho * wo, cin)
    if mask is not None:
        s = s * mask.reshape(b, kk, ho * wo, 1)
    patches = s.transpose(1, 2).reshape(b, ho * wo, kk * cin)
    wmat = weight.permute(2, 3, 1, 0).reshape(kk * cin, cout)
    out = (patches @ wmat.to(patches.dtype)).view(b, ho, wo, cout).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype).view(1, -1, 1, 1)
    return out.contiguous()


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 'pack': offsets and masks predicted from the input by the side
    conv ``conv_offset`` (zero-initialised, so the layer starts as a plain
    conv), as upstream's ``dcn_util.py``.  Its ``3*k*k`` outputs split into
    the y offsets, the x offsets and the mask logits of the k*k taps."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        # torch's conv default, the JAX layer's variance_scaling(1/3, fan_in, uniform)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.conv_offset = nn.Conv2d(in_ch, 3 * k * k, k, stride, padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        kk = self.weight.shape[2] * self.weight.shape[3]
        o1, o2, m = torch.chunk(self.conv_offset(x), 3, 1)
        b, _, ho, wo = o1.shape
        offset = torch.stack([o1, o2], 2).reshape(b, 2 * kk, ho, wo)   # (y, x) per tap
        return deform_conv2d(x, offset, self.weight, self.bias, torch.sigmoid(m),
                             self.stride, self.padding, self.dilation)
