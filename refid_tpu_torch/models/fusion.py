"""Cross-modal fusion blocks (NCHW), mirroring ``refid_tpu/models/fusion.py``:
EGACA (``CrossmodalAtten`` with ``all_add=True``, the production block,
upstream ``CrossmodalAtten_imgeventalladd``) and the siamese lineage's
``ImgEvFusion``.

LayerNorm2d -> 1x1 + depthwise 3x3 -> exact GELU on each branch; the EVENT
branch's SE gate ``se_1`` gates BOTH branches (upstream's quirk, kept for
checkpoint parity); concat + 1x1 fuse; ``event + image + beta * fused``;
an FFN with a ``gamma`` residual.  ``se_2`` is built but never applied: it
exists so that upstream state_dicts load strictly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.models.layers import LayerNorm2d, SELayer
from refid_tpu_torch.parallel.spatial import HaloConv2d, SpatialAvgPool

__all__ = ["CrossmodalAtten", "ImgEvFusion"]


class CrossmodalAtten(nn.Module):

    # the production block: depthwise expansion 1, FFN expansion 2
    def __init__(self, c: int, c_out: int):
        super().__init__()
        self.norm1 = LayerNorm2d(c)
        self.norm1_e = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, c, 1)
        self.conv2 = HaloConv2d(c, c, 3, 1, 1, groups=c)
        self.conv1_e = nn.Conv2d(c, c, 1)
        self.conv2_e = HaloConv2d(c, c, 3, 1, 1, groups=c)
        self.se_1 = SELayer(c, c // 2, c)
        self.se_2 = SELayer(c, c // 2, c)    # unused, as upstream
        self.conv3 = nn.Conv2d(2 * c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, 2 * c, 1)
        self.conv5 = nn.Conv2d(2 * c, c_out, 1)
        self.gamma = nn.Parameter(torch.zeros(1, c_out, 1, 1))
        self.conv_y_side = nn.Conv2d(c, c_out, 1)

    def forward(self, event_feat, image_feat):
        x = F.gelu(self.conv2(self.conv1(self.norm1(image_feat))))
        x_e = F.gelu(self.conv2_e(self.conv1_e(self.norm1_e(event_feat))))
        gate = self.se_1(x_e)
        x = self.conv3(torch.cat([x * gate, x_e * gate], 1))
        y = event_feat + image_feat + x * self.beta
        ffn = self.conv5(F.gelu(self.conv4(self.norm2(y))))
        return self.conv_y_side(y) + ffn * self.gamma


class ImgEvFusion(nn.Module):
    """Siamese two-image fusion gated by the event features (upstream
    ``img_ev_fusion``): two SE gates, each a 1x1 conv of the event features'
    spatial mean and a sigmoid, weight the two image-encoder features;
    ``feat_0 * se_0(ev) + feat_1 * se_1(ev)``.  The event features are not
    passed through."""

    def __init__(self, c: int):
        super().__init__()
        self.se_0 = nn.Sequential(SpatialAvgPool(), nn.Conv2d(c, c, 1), nn.Sigmoid())
        self.se_1 = nn.Sequential(SpatialAvgPool(), nn.Conv2d(c, c, 1), nn.Sigmoid())

    def forward(self, ev, feat_0, feat_1):
        return feat_0 * self.se_0(ev) + feat_1 * self.se_1(ev)
