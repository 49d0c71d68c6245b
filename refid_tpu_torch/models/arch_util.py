"""Arch utility ops, the channel-attention core and the EICA block (NCHW),
mirroring ``refid_tpu/models/arch_util.py`` (upstream basicsr
``arch_util.py``).

Library functions with no caller in the JAX package:
  * flow_warp        — bilinear warping by optical flow, zeros outside
  * resize_flow      — flow resampling with its magnitudes rescaled
  * pixel_unshuffle / pixel_shuffle — space-to-depth and back, in the JAX
    functions' channel order: output channel ``(dy * s + dx) * c + ch``
    (``nn.PixelShuffle`` orders them ``ch * s * s + dy * s + dx``; Restormer,
    ``models/restormer.py``, uses ``nn.PixelShuffle``'s, not these)
  * channel_attention — attention over channels, per head: L2 norms over the
    pixels, the Gram product, temperature, softmax, ``attn @ v``; its two
    callers: EICA's ``MutualAttention`` (EFNet, ``models/efnet.py``) and
    Restormer's MDTA (``models/restormer.py``)
  * window_attention — self-attention within windows of tokens with an
    additive bias, per head (Uformer's W-MSA, ``models/uformer.py``), and
    :func:`window_engages`, the rule that runs it as
    ``F.scaled_dot_product_attention``
  * pre_norm — a pre-norm transformer block's residual add and LayerNorm
    over the channels of a 4-D stream, on the pre-norm kernel where
    ``ops/prenorm.py::engages`` holds (Restormer's and Uformer's blocks)
  * MutualAttention + EventImageChannelAttentionTransformerBlock ("EICA") —
    channel-attention cross-modal transformer (its caller in this package:
    ``models/efnet.py``, at upstream EFNet's settings)
  * SpatialCrossAttention — token-space cross attention with an optional
    spatial reduction of the key/value source
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.ops import prenorm
from refid_tpu_torch.ops.deform_conv import _bilinear_rows

__all__ = ["flow_warp", "resize_flow", "pixel_unshuffle", "pixel_shuffle",
           "channel_attention", "window_engages", "window_attention", "pre_norm",
           "MutualAttention",
           "EventImageChannelAttentionTransformerBlock", "SpatialCrossAttention"]


def flow_warp(x, flow, align_corners=True):
    """Warp ``x (b, c, h, w)`` by ``flow (b, h, w, 2)`` (x-displacement
    first): bilinear sampling at pixel ``p + flow(p)``, zeros outside —
    ``grid_sample``'s ``align_corners=True``, ``padding_mode='zeros'``
    semantics, as the JAX version computes whatever ``align_corners`` says."""
    b, c, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    py = (gy[None] + flow[..., 1].float()).reshape(b, h * w)
    px = (gx[None] + flow[..., 0].float()).reshape(b, h * w)
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    return _bilinear_rows(rows, b, h, w, py, px).view(b, h, w, c).permute(0, 3, 1, 2)


def resize_flow(flow, size_type, sizes, align_corners=False):
    """Resize a flow field ``(b, 2, h, w)`` (x, y) and rescale its magnitudes
    by the size ratios: ``size_type`` ``'ratio'`` (``sizes`` = (ratio_h,
    ratio_w)) or ``'shape'`` (``sizes`` = (h, w)).  Bilinear, antialiased
    when shrinking, as ``jax.image.resize``."""
    _, _, h, w = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        out_h, out_w = sizes
    else:
        raise ValueError(f"unknown size_type {size_type!r}")
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype, device=flow.device)
    return F.interpolate(flow * scale.view(1, 2, 1, 1), size=(out_h, out_w),
                         mode="bilinear", align_corners=False, antialias=True)


def pixel_unshuffle(x, scale: int):
    """Space-to-depth: (b, c, h, w) -> (b, c*s*s, h/s, w/s)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // scale, scale, w // scale, scale)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, scale * scale * c, h // scale, w // scale)


def pixel_shuffle(x, scale: int):
    """Depth-to-space: (b, c, h, w) -> (b, c/(s*s), h*s, w*s)."""
    b, c, h, w = x.shape
    c_out = c // (scale * scale)
    x = x.reshape(b, scale, scale, c_out, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c_out, h * scale, w * scale)


def channel_attention(q, k, v, temperature, num_heads: int):
    """Attention over the channels of ``q``, ``k``, ``v`` ``(b, c, h, w)``:
    split head-major into ``(b, head, c/head, h*w)``, ``q`` and ``k``
    L2-normalised over the pixels (eps 1e-12), ``A = softmax(q k^T *
    temperature)`` (``temperature`` ``(head, 1, 1)``) over the last axis,
    and ``A v`` merged back to ``(b, c, h, w)``: O(c^2 * hw)."""
    b, c, h, w = q.shape

    def heads(z):   # (b, c, h, w) -> (b, head, c/head, h*w)
        return z.reshape(b, num_heads, c // num_heads, h * w)

    q = F.normalize(heads(q), dim=-1, eps=1e-12)
    k = F.normalize(heads(k), dim=-1, eps=1e-12)
    attn = torch.softmax(q @ k.transpose(-2, -1) * temperature, dim=-1)
    return (attn @ heads(v)).reshape(b, c, h, w)


def window_engages(q: torch.Tensor) -> bool:
    """True where :func:`window_attention` of the queries ``q`` runs as
    ``F.scaled_dot_product_attention``: a bfloat16 CUDA tensor with
    gradients off (every served bf16 call).  Its mask is then built in
    ``q``'s dtype."""
    return q.is_cuda and q.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def window_attention(q, k, v, bias):
    """Self-attention within windows: ``q``, ``k``, ``v`` ``(windows, head,
    n, d)``, ``softmax(q k^T / sqrt(d) + bias) v`` over the last axis, with
    ``bias`` additive and broadcastable to ``(windows, head, n, n)``.  Where
    :func:`window_engages` holds, one ``F.scaled_dot_product_attention``
    call (``bias`` in ``q``'s dtype); elsewhere the explicit product,
    bias, softmax and product."""
    if window_engages(q):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    attn = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1) + bias
    return torch.softmax(attn, -1) @ v


def pre_norm(x: torch.Tensor, residual: Optional[torch.Tensor], norm: nn.LayerNorm,
             spans: Tuple[str, str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pre-norm block's add and norm on the 4-D stream ``x`` (NCHW or
    channels_last) and the residual in front of it (None: none): ``(s, y)``
    with ``s = x + residual`` and ``y`` ``norm`` over the channels of each
    pixel of ``s``.  Where ``prenorm.engages(x)``, one launch of the
    pre-norm kernel with ``norm``'s weight, bias and eps (``y`` bf16
    channels_last); else PyTorch's add and ``norm`` on a channels-last view.
    The whole runs inside the span ``spans[0]``, the kernel's launch inside
    ``spans[1]``."""
    with span(spans[0]):
        if prenorm.engages(x):
            with span(spans[1]):
                return prenorm.prenorm(x, residual, norm.weight, norm.bias, norm.eps)
        if residual is not None:
            x = x + residual
        return x, norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MutualAttention(nn.Module):
    """Channel attention between image (query) and event (key / value):
    attention over channels, O(c^2 * hw)."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = nn.Conv2d(dim, dim, 1, bias=bias)
        self.k = nn.Conv2d(dim, dim, 1, bias=bias)
        self.v = nn.Conv2d(dim, dim, 1, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x, y):
        if x.shape != y.shape:
            raise ValueError(f"image {tuple(x.shape)} and event {tuple(y.shape)} differ")
        return self.project_out(channel_attention(self.q(x), self.k(y), self.v(y),
                                                  self.temperature, self.num_heads))


class EventImageChannelAttentionTransformerBlock(nn.Module):
    """EICA: cross-modal channel attention and an MLP, each with a residual,
    LayerNorm (over channels) before each.  ``nn.LayerNorm`` over the
    channels of a pixel is upstream's ``'WithBias'`` LayerNorm (biased
    variance, ``eps`` inside the root, a scale and a bias); the defaults
    (factor 2, eps 1e-6) are the JAX block's, EFNet passes 4 and 1e-5."""

    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: int = 2,
                 bias: bool = False, eps: float = 1e-6):
        super().__init__()
        self.norm1_image = nn.LayerNorm(dim, eps=eps)
        self.norm1_event = nn.LayerNorm(dim, eps=eps)
        self.attn = MutualAttention(dim, num_heads, bias)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, dim * ffn_expansion_factor)
        self.fc2 = nn.Linear(dim * ffn_expansion_factor, dim)

    def forward(self, image, event):
        if image.shape != event.shape:
            raise ValueError(f"image {tuple(image.shape)} and event {tuple(event.shape)} differ")

        def channels_last(norm, z):
            return norm(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

        fused = image + self.attn(channels_last(self.norm1_image, image),
                                  channels_last(self.norm1_event, event))
        y = self.fc2(F.gelu(self.fc1(self.norm2(fused.permute(0, 2, 3, 1)))))
        return fused + y.permute(0, 3, 1, 2)


class SpatialCrossAttention(nn.Module):
    """Token-space cross attention: image tokens ``x`` query event tokens
    ``y``, both ``(b, n, c)``; with ``sr_ratio > 1`` the key / value source
    is first reduced by an ``sr_ratio`` strided conv over its ``H x W`` grid
    and a LayerNorm."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, y, H=None, W=None):
        if x.dim() != 3 or x.shape != y.shape:
            raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must be one (b, n, c)")
        b, n, c = x.shape
        hd = self.num_heads
        q = self.q(x).reshape(b, n, hd, c // hd).transpose(1, 2)
        if self.sr_ratio > 1:
            if H is None or W is None:
                raise ValueError("sr_ratio > 1 needs the token grid's H and W")
            y = self.sr(y.reshape(b, H, W, c).permute(0, 3, 1, 2))
            y = self.norm(y.flatten(2).transpose(1, 2))
        kv = self.kv(y).reshape(b, -1, 2, hd, c // hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q @ kv[0].transpose(-2, -1) * (c // hd) ** -0.5, dim=-1)
        return self.proj((attn @ kv[1]).transpose(1, 2).reshape(b, n, c))
