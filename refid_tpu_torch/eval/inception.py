"""The InceptionV3 feature extractor for FID (mirrors
``refid_tpu/eval/inception.py``): pytorch-fid's "patched" torchvision
InceptionV3, the model upstream's ``basicsr/metrics/fid.py`` meant to build
(its import is broken), written out because torchvision is not a
dependency.

  * BasicConv2d = conv (no bias) + BatchNorm (eps 1e-3, inference) + relu;
  * Inception blocks A-E as torchvision's, with pytorch-fid's patches: the
    A/C/E branch pools average with count_include_pad=False, and the second
    InceptionE (Mixed_7c) pools by a 3x3 stride-1 MAX;
  * ``resize_input`` resizes bilinearly to 299 x 299 (half-pixel centres),
    ``normalize_input`` maps [0, 1] to [-1, 1].

Module names are the pt_inception-2015-12-05 checkpoint's state_dict keys,
so :func:`convert_torch_state_dict` only drops what the features do not use
(``fc``, ``AuxLogits``, BatchNorm step counters).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.core.device import resolve_device

__all__ = ["InceptionV3Features", "convert_torch_state_dict",
           "load_patched_inception_v3", "extract_inception_features"]


class BasicConv2d(nn.Module):
    def __init__(self, ci, co, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(ci, co, k, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(co, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, ci, pool):
        super().__init__()
        self.branch1x1 = BasicConv2d(ci, 64, 1)
        self.branch5x5_1 = BasicConv2d(ci, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(ci, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(ci, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, ci):
        super().__init__()
        self.branch3x3 = BasicConv2d(ci, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(ci, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, ci, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(ci, 192, 1)
        self.branch7x7_1 = BasicConv2d(ci, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(ci, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(ci, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(bd))
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, ci):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(ci, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(ci, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(
            self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, ci, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(ci, 320, 1)
        self.branch3x3_1 = BasicConv2d(ci, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(ci, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(ci, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3Features(nn.Module):
    """(b, 3, h, w) float in [0, 1] -> (b, 2048) pool3 features."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = False):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")

    def forward(self, x):
        if self.resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))        # adaptive average pool to 1 x 1


def convert_torch_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A pytorch-fid / torchvision Inception3 state_dict (tensors or numpy
    arrays) -> :class:`InceptionV3Features`'s, without ``fc``,
    ``AuxLogits`` and ``num_batches_tracked``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            for k, v in sd.items()
            if not k.startswith(("fc.", "AuxLogits.")) and not k.endswith("num_batches_tracked")}


def load_patched_inception_v3(weights_path: str, resize_input: bool = True,
                              normalize_input: bool = False,
                              device="cuda") -> InceptionV3Features:
    """The extractor with the pt_inception ``.pth`` state_dict at
    ``weights_path``, in eval mode on ``device`` (default the card; without
    one it raises before reading the weights: pass ``device="cpu"``)."""
    device = resolve_device(device)
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    model = InceptionV3Features(resize_input, normalize_input)
    model.load_state_dict(convert_torch_state_dict(sd))
    return model.to(device).eval()


@torch.inference_mode()
def extract_inception_features(data_generator: Iterable[np.ndarray],
                               model: InceptionV3Features) -> np.ndarray:
    """Stacked (N, 2048) features of (b, h, w, 3) [0, 1] numpy batches."""
    device = next(model.parameters()).device
    feats = [model(torch.from_numpy(np.ascontiguousarray(batch, np.float32))
                   .to(device).permute(0, 3, 1, 2)).cpu().numpy()
             for batch in data_generator]
    return np.concatenate(feats, axis=0)
