"""Optical-flow IO: ``.flo`` (Middlebury "PIEH") read / write and uint8
quantization (mirrors ``refid_tpu/utils/flow_util.py``; upstream
``basicsr/utils/flow_util.py:7-180``).

The quantized pair is a grey PNG written and read by the port's own codec
(``data/img_util.py``), not cv2; like the JAX package, it is written with
the arguments in the right order (upstream's quantized ``flowwrite`` swaps
them) and the levels keep upstream's 255-level convention, so 0 survives a
round trip.
"""

from __future__ import annotations

import os

import numpy as np

from refid_tpu_torch.data.img_util import imfrombytes, imwrite

__all__ = ["flowread", "flowwrite", "quantize_flow", "dequantize_flow",
           "quantize", "dequantize"]


def flowread(flow_path, quantize=False, concat_axis=0, *args, **kwargs):
    """Read an optical flow map -> ``(h, w, 2)`` float32: the lossless
    ``.flo`` format, or with ``quantize=True`` a uint8 dx/dy pair PNG
    (``flowwrite(..., quantize=True)``), dequantized."""
    if quantize:
        if concat_axis not in (0, 1):
            raise ValueError(f"concat_axis must be 0 or 1, got {concat_axis}")
        try:
            with open(flow_path, "rb") as f:
                cat_flow = imfrombytes(f.read(), "unchanged")
        except (OSError, ValueError) as e:
            raise IOError(f"{flow_path} is not a valid quantized flow file ({e})") from e
        if cat_flow.ndim != 2 or cat_flow.shape[concat_axis] % 2:
            raise IOError(f"{flow_path} is not a valid quantized flow file "
                          f"(shape {cat_flow.shape})")
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *args, **kwargs).astype(np.float32)
    with open(flow_path, "rb") as f:
        if f.read(4) != b"PIEH":
            raise IOError(f"Invalid flow file: {flow_path}, header does not contain PIEH")
        w = int(np.fromfile(f, np.int32, 1).squeeze())
        h = int(np.fromfile(f, np.int32, 1).squeeze())
        flow = np.fromfile(f, np.float32, w * h * 2).reshape((h, w, 2))
    return flow.astype(np.float32)


def flowwrite(flow, filename, quantize=False, concat_axis=0, *args, **kwargs):
    """Write ``(h, w, 2)`` flow: lossless ``.flo``, or a quantized uint8
    dx/dy pair as a grey PNG (``filename`` must end in ``.png``)."""
    if not quantize:
        with open(filename, "wb") as f:
            f.write(b"PIEH")
            np.array([flow.shape[1], flow.shape[0]], dtype=np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
        return
    if concat_axis not in (0, 1):
        raise ValueError(f"concat_axis must be 0 or 1, got {concat_axis}")
    dxdy = np.concatenate(quantize_flow(flow, *args, **kwargs), axis=concat_axis)
    parent = os.path.dirname(str(filename))
    if parent:
        os.makedirs(parent, exist_ok=True)
    imwrite(dxdy, str(filename))


def quantize_flow(flow, max_val=0.02, norm=True):
    """``(h, w, 2)`` flow -> ``(dx_u8, dy_u8)``; values outside
    ``[-max_val, max_val]`` (after the optional width / height
    normalization) saturate."""
    h, w, _ = flow.shape
    dx = flow[..., 0]
    dy = flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8) for d in (dx, dy))


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    """Inverse of :func:`quantize_flow`."""
    if dx.shape != dy.shape or not (dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)):
        raise ValueError(f"dx {dx.shape} and dy {dy.shape} must be equal (h, w) maps")
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx = dx * dx.shape[1]
        dy = dy * dy.shape[0]
    return np.dstack((dx, dy))


def _check_levels(min_val, max_val, levels):
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer > 1, got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """Clip to ``[min_val, max_val]`` and quantize to ``[0, levels - 1]``."""
    _check_levels(min_val, max_val, levels)
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val)).astype(dtype), levels - 1)


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """Map quantized levels back to bin centres."""
    _check_levels(min_val, max_val, levels)
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val
