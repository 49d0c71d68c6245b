"""MATLAB-faithful bicubic imresize, numpy (a copy of
``refid_tpu/eval/matlab.py``; upstream ``basicsr/utils/matlab_functions.py``):
cubic kernel a=-0.5, antialiasing when downscaling (kernel widened by
1/scale), symmetric edge replication via index clamping with full-width
weight normalization.  ``duf_downsample``'s Gaussian blur is a torch op
(the JAX package calls cv2 for it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from refid_tpu_torch.eval.metrics import gaussian_kernel_1d

__all__ = ["imresize", "cubic", "duf_downsample"]


def cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    f = ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
         + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
         * ((absx > 1) & (absx <= 2)))
    return f


def _weights_indices(in_length, out_length, scale, antialiasing=True):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based later

    dist = u[:, None] - (indices + 1)
    if scale < 1 and antialiasing:
        weights = scale * cubic(dist * scale)
    else:
        weights = cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # trim zero columns
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    weights = weights[:, nz[0]: nz[-1] + 1]
    indices = indices[:, nz[0]: nz[-1] + 1]

    # MATLAB boundary: symmetric reflection WITH edge duplication
    # ([c b a | a b c ...])
    indices = indices.astype(np.int64)
    indices = np.where(indices < 0, -indices - 1, indices)
    indices = np.where(indices >= in_length, 2 * in_length - 1 - indices,
                       indices)
    indices = np.clip(indices, 0, in_length - 1)
    return weights, indices


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """img: (h, w) or (h, w, c) float; returns float64 resized image."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    out_h = int(np.ceil(h * scale))
    out_w = int(np.ceil(w * scale))

    wts_h, idx_h = _weights_indices(h, out_h, scale, antialiasing)
    wts_w, idx_w = _weights_indices(w, out_w, scale, antialiasing)

    img = img.astype(np.float64)
    # rows: out[i] = sum_k wts_h[i,k] * img[idx_h[i,k]]
    tmp = np.einsum("ik,ikwc->iwc", wts_h, img[idx_h])
    out = np.einsum("jk,ijkc->ijc", wts_w, tmp[:, idx_w])
    return out[:, :, 0] if squeeze else out


def gaussian_blur(img: np.ndarray, ksize: int = 13, sigma: float = 1.6) -> np.ndarray:
    """cv2.GaussianBlur((ksize, ksize), sigma) of an (h, w) or (h, w, c)
    image: the separable kernel of ``gaussian_kernel_1d``, mirrored borders
    without the edge repeated (cv2's BORDER_REFLECT_101), in float64; the
    result in the image's dtype (uint8 rounded and saturated)."""
    planes = torch.from_numpy(np.asarray(img, np.float64))
    planes = (planes[..., None] if planes.dim() == 2 else planes).permute(2, 0, 1)[:, None]
    k = torch.from_numpy(gaussian_kernel_1d(ksize, sigma))
    pad = ksize // 2
    out = F.pad(planes, (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(F.conv2d(out, k.view(1, 1, ksize, 1)), k.view(1, 1, 1, ksize))
    out = out[:, 0].permute(1, 2, 0).numpy().reshape(np.shape(img))
    if np.asarray(img).dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(np.asarray(img).dtype)


def duf_downsample(img: np.ndarray, kernel_sigma: float = 1.6,
                   scale: int = 4) -> np.ndarray:
    """Gaussian blur + subsample used by DUF-style eval pipelines
    (upstream ``basicsr/data/data_util.py`` semantics)."""
    blurred = gaussian_blur(img, 13, kernel_sigma)
    return blurred[scale // 2::scale, scale // 2::scale, ...]
