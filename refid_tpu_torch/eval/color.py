"""MATLAB-faithful colour conversions, numpy (a copy of
``refid_tpu/eval/color.py``; upstream ``basicsr/utils/matlab_functions.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["rgb2ycbcr", "bgr2ycbcr", "to_y_channel"]

_YCBCR_WEIGHTS_RGB = np.array(
    [[65.481, -37.797, 112.0],
     [128.553, -74.203, -93.786],
     [24.966, 112.0, -18.214]]
)
_YCBCR_OFFSET = np.array([16, 128, 128])


def _convert_input_type_range(img):
    img = img.astype(np.float32)
    if img.max() > 1:
        img = img / 255.0
    return img


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """An RGB image (range [0, 1] or [0, 255]) in MATLAB's YCbCr, float32:
    [0, 255] for a uint8 input, [0, 1] otherwise."""
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, _YCBCR_WEIGHTS_RGB[:, 0]) + 16.0
    else:
        out = np.matmul(img, _YCBCR_WEIGHTS_RGB) + _YCBCR_OFFSET
    if img_type != np.uint8:
        out = out / 255.0
    return out.astype(np.float32)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR variant (images are written and measured in BGR order)."""
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """A [0, 255] BGR image -> its Y channel in [0, 255], with a trailing
    singleton axis (upstream ``basicsr/metrics/metric_util.py``)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        img = img[..., None]
    return img * 255.0
