"""Conv building blocks (NCHW), mirroring ``refid_tpu/models/layers.py``.

Attribute names are upstream REFID's, the names that
``refid_tpu/models/convert.py`` reads (``conv2d``, ``conv_1``, ``conv_2``,
``identity``, ``down``, ``main.0``, ``main.2.{j}.conv1``, ...), so an upstream
state_dict loads as it is.

``ResidualBlock`` and ``ConvResidualBlocks`` take an optional int8 quant
state ``q`` (``serve/quant.py::QuantState``): with it, their convs run as
int8 sites, in the JAX serving forward's order; without it, nothing changes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "ConvLayer", "ImageEncoderConvBlock", "ResidualBlock", "ResidualBlockNoBN",
    "ConvResidualBlocks", "LayerNorm2d", "SELayer", "conv_transpose_up",
]


class ConvLayer(nn.Module):
    """conv (+ leaky ReLU).  ``relu_slope=None`` -> plain conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 relu_slope: Optional[float] = 0.2):
        super().__init__()
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.relu_slope = relu_slope

    def forward(self, x):
        out = self.conv2d(x)
        if self.relu_slope is not None:
            out = F.leaky_relu(out, self.relu_slope)
        return out


class ImageEncoderConvBlock(nn.Module):
    """Two 3x3 convs (leaky 0.2) + 1x1 identity residual, then a 4x4/2
    downsample."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.conv_2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.identity = nn.Conv2d(in_ch, out_ch, 1, 1, 0)
        self.down = nn.Conv2d(out_ch, out_ch, 4, 2, 1, bias=False)

    def forward(self, x):
        out = F.leaky_relu(self.conv_1(x), 0.2)
        out = F.leaky_relu(self.conv_2(out), 0.2)
        return self.down(out + self.identity(x))


class ResidualBlock(nn.Module):
    """relu(conv2(relu(conv1(x))) + x): the bottleneck block."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x, q=None):
        if q is None:
            return F.relu(self.conv2(F.relu(self.conv1(x))) + x)
        return F.relu(q.conv(self.conv2, q.conv(self.conv1, x, relu=True)) + x)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))).  Both convs start from kaiming-normal
    weights scaled by 0.1 (variance 0.02 / fan_in) and zero biases, as
    upstream's ``default_init_weights(..., 0.1)`` and the JAX package's
    ``residual_scaled_init`` do."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                nn.init.kaiming_normal_(conv.weight, a=0, mode="fan_in")
                conv.weight.mul_(0.1)
                conv.bias.zero_()

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ConvResidualBlocks(nn.Module):
    """3x3 conv + leaky ReLU(0.1) + ``num_block`` ResidualBlockNoBN."""

    def __init__(self, in_ch: int, features: int, num_block: int = 1):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(in_ch, features, 3, 1, 1),
            nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(features)
                            for _ in range(num_block)]))

    def forward(self, x, q=None):
        if q is None:
            return self.main(x)
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
    two convs are children ``1`` and ``3``, as in upstream's Sequential."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), nn.Conv2d(in_ch, mid, 1),
                         nn.ReLU(), nn.Conv2d(mid, out, 1), nn.Sigmoid())


def conv_transpose_up(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """The decoders' 2x2 stride-2 transposed conv."""
    return nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)
