"""Conv building blocks (NCHW), mirroring ``refid_tpu/models/layers.py``.

Attribute names are upstream REFID's, the names that
``refid_tpu/models/convert.py`` reads (``conv2d``, ``conv_1``, ``conv_2``,
``identity``, ``down``, ``main.0``, ``main.2.{j}.conv1``, ...), so an upstream
state_dict loads as it is.

``ResidualBlock`` and ``ConvResidualBlocks`` take an optional int8 quant
state ``q`` (``serve/quant.py::QuantState``): with it, their convs run as
int8 sites, in the JAX serving forward's order; without it, nothing changes.

Every biased conv goes through the conv layer's entry point
(``ops/conv_epilogue.py::biased_conv``: :class:`HaloConv2d`, 1x1 convs
included, and :class:`ConvTranspose2d`), and an activation that follows a
conv directly is passed to it as ``act``, so that on the card one pass adds
the bias and applies it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.ops.conv_epilogue import Act, biased_conv
from refid_tpu_torch.parallel.spatial import HaloConv2d, SpatialAvgPool

__all__ = [
    "ConvLayer", "ImageEncoderConvBlock", "ResidualBlock", "ResidualBlockNoBN",
    "ConvResidualBlocks", "LayerNorm2d", "SELayer", "ConvTranspose2d", "conv_transpose_up",
]


class ConvLayer(nn.Module):
    """conv (+ leaky ReLU).  ``relu_slope=None`` -> plain conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 relu_slope: Optional[float] = 0.2):
        super().__init__()
        self.conv2d = HaloConv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.relu_slope = relu_slope

    def forward(self, x):
        return self.conv2d(x, act=self.relu_slope)


class ImageEncoderConvBlock(nn.Module):
    """Two 3x3 convs (leaky 0.2) + 1x1 identity residual, then a 4x4/2
    downsample."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_1 = HaloConv2d(in_ch, out_ch, 3, 1, 1)
        self.conv_2 = HaloConv2d(out_ch, out_ch, 3, 1, 1)
        self.identity = HaloConv2d(in_ch, out_ch, 1, 1, 0)
        self.down = HaloConv2d(out_ch, out_ch, 4, 2, 1, bias=False)

    def forward(self, x):
        out = self.conv_2(self.conv_1(x, act=0.2), act=0.2)
        return self.down(out + self.identity(x))


class ResidualBlock(nn.Module):
    """relu(conv2(relu(conv1(x))) + x): the bottleneck block."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = HaloConv2d(features, features, 3, 1, 1)
        self.conv2 = HaloConv2d(features, features, 3, 1, 1)

    def forward(self, x, q=None):
        if q is None:
            return F.relu(self.conv2(self.conv1(x, act="relu")) + x)
        return F.relu(q.conv(self.conv2, q.conv(self.conv1, x, relu=True)) + x)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))).  Both convs start from kaiming-normal
    weights scaled by 0.1 (variance 0.02 / fan_in) and zero biases, as
    upstream's ``default_init_weights(..., 0.1)`` and the JAX package's
    ``residual_scaled_init`` do."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = HaloConv2d(features, features, 3, 1, 1)
        self.conv2 = HaloConv2d(features, features, 3, 1, 1)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                nn.init.kaiming_normal_(conv.weight, a=0, mode="fan_in")
                conv.weight.mul_(0.1)
                conv.bias.zero_()

    def forward(self, x):
        return x + self.conv2(self.conv1(x, act="relu"))


class ConvResidualBlocks(nn.Module):
    """3x3 conv + leaky ReLU(0.1) + ``num_block`` ResidualBlockNoBN."""

    def __init__(self, in_ch: int, features: int, num_block: int = 1):
        super().__init__()
        self.main = nn.Sequential(
            HaloConv2d(in_ch, features, 3, 1, 1),
            nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(features)
                            for _ in range(num_block)]))

    def forward(self, x, q=None):
        if q is None:   # main[1], the leaky ReLU, applied by main[0]'s entry point
            return self.main[2](self.main[0](x, act=self.main[1].negative_slope))
        h = q.conv(self.main[0], x, slope=0.1)
        for block in self.main[2]:
            h = h + q.conv(block.conv2, q.conv(block.conv1, h, relu=True))
        return h


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of NCHW; eps on the BIASED variance."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class SELayer(nn.Sequential):
    """Squeeze-excite gate: avg pool -> 1x1 -> relu -> 1x1 -> sigmoid.  The
    two convs are children ``1`` and ``3``, as in upstream's Sequential; the
    ReLU (child ``2``) is applied by the first conv's entry point."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__(SpatialAvgPool(), HaloConv2d(in_ch, mid, 1),
                         nn.ReLU(), HaloConv2d(mid, out, 1), nn.Sigmoid())

    def forward(self, x):
        return self[4](self[3](self[1](self[0](x), act="relu")))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` through the conv layer's entry point
    (``ops/conv_epilogue.py::biased_conv``), with the activation ``act``
    that follows it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cudnn_choice = {}      # biased_conv's cache of PyTorch's backend choice

    def forward(self, x, act: Act = None):
        return biased_conv(self, x, act, self._conv)

    def _conv(self, x, bias):
        return F.conv_transpose2d(x, self.weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def conv_transpose_up(in_ch: int, out_ch: int) -> ConvTranspose2d:
    """The decoders' 2x2 stride-2 transposed conv."""
    return ConvTranspose2d(in_ch, out_ch, 2, stride=2)
