"""PSNR and SSIM with the reference's semantics (mirrors
``refid_tpu/eval/metrics.py``; upstream ``basicsr/metrics/psnr_ssim.py``).

PSNR infers the peak from the image's range ([0, 1] or [0, 255]) and works
in float64 torch ops on the tensor's device (validation hands it the
frames on the card; numpy images are measured on the CPU).  The Y-channel
variants convert colour on the host with the reference's numpy.

SSIM is upstream's NONSTANDARD 3-D formulation: one 11 x 11 x 11 Gaussian
window (sigma 1.5 a side, the outer product of three 1-D kernels) over the
``(H, W, C)`` volume, edge-padded by 5 on every axis, three separable
11-tap valid convolutions, in float32 torch ops on ``device`` (by default
the tensor's own, the CPU for numpy).  The taps are written out as shifted
multiply-adds, so the arithmetic is the same on the CPU and the card and no
TF32 setting reaches it.  ``test_y_channel`` takes the classic 2-D 11 x 11
Gaussian SSIM of the Y channel, constants for [0, 255].

Called with numpy ``uint8`` images, as upstream's validation calls them,
both return a Python float.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from refid_tpu_torch.eval.color import to_y_channel

__all__ = ["calculate_psnr", "calculate_ssim", "gaussian_kernel_1d"]


def gaussian_kernel_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel-equivalent 1-D kernel (normalized, float64)."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


# the window's taps in float32, as the JAX package convolves with them
_TAPS = [float(w) for w in gaussian_kernel_1d().astype(np.float32)]
_PAD = len(_TAPS) // 2


def _device_of(img1, img2, device=None) -> torch.device:
    """``device``, else the first tensor's device, else the CPU."""
    if device is not None:
        return torch.device(device)
    return next((i.device for i in (img1, img2) if isinstance(i, torch.Tensor)),
                torch.device("cpu"))


def _prepare(img1, img2, crop_border, input_order, device):
    """Both images as HWC float64 tensors on ``device``, cropped."""
    assert tuple(img1.shape) == tuple(img2.shape), (
        f"Image shapes are different: {tuple(img1.shape)}, {tuple(img2.shape)}.")
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order!r}")
    out = []
    for img in (img1, img2):
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        if input_order == "CHW":
            img = img.permute(1, 2, 0)
        img = img.to(device, torch.float64)
        if crop_border != 0:
            img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        out.append(img)
    return out


def _y_channel(img: torch.Tensor) -> np.ndarray:
    """The Y channel of a prepared image, float32 on the host (the colour
    conversion is the reference's numpy)."""
    return to_y_channel(img.cpu().numpy())


def calculate_psnr(img1, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False) -> float:
    """PSNR with max value inferred from the range ([0,1] vs [0,255])."""
    img1, img2 = _prepare(img1, img2, crop_border, input_order, _device_of(img1, img2))
    if test_y_channel:
        # the reference's float32 arithmetic on the Y planes, the mean and
        # the log's argument included: numpy's pairwise float32 sum, which
        # torch's differs from in the last bits
        y1, y2 = _y_channel(img1), _y_channel(img2)
        mse, peak = np.mean((y1 - y2) ** 2), float(y1.max())
    else:
        mse, peak = float(torch.mean((img1 - img2) ** 2)), float(img1.max())
    if mse == 0:
        return float("inf")
    max_value = 1.0 if peak <= 1 else 255.0
    return float(20.0 * np.log10(max_value / np.sqrt(mse)))


def _blur(maps: torch.Tensor) -> torch.Tensor:
    """Edge-pad every axis but the first by 5, then the 11-tap window along
    each (the channel axis first: it shrinks the most)."""
    nd = maps.dim() - 1
    x = F.pad(maps.unsqueeze(1), [_PAD] * (2 * nd), mode="replicate").squeeze(1)
    for axis in range(nd, 0, -1):
        size = x.shape[axis] - 2 * _PAD
        acc = x.narrow(axis, 0, size) * _TAPS[0]
        for k in range(1, len(_TAPS)):
            acc.add_(x.narrow(axis, k, size), alpha=_TAPS[k])
        x = acc
    return x


def _ssim(img1: torch.Tensor, img2: torch.Tensor, max_value: float) -> float:
    """Mean SSIM map of two float32 volumes (or planes) on one device."""
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    mu1, mu2, e11, e22, e12 = _blur(torch.stack(
        [img1, img2, img1 ** 2, img2 ** 2, img1 * img2]))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq, sigma2_sq, sigma12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean(dtype=torch.float64))


def calculate_ssim(img1, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False,
                   device: Optional[torch.device] = None) -> float:
    """SSIM through upstream's 3-D Gaussian window, on ``device``."""
    device = _device_of(img1, img2, device)
    img1, img2 = _prepare(img1, img2, crop_border, input_order, device)
    if test_y_channel:
        img1, img2 = (torch.from_numpy(_y_channel(i)[..., 0]).to(device, torch.float32)
                      for i in (img1, img2))
        return _ssim(img1, img2, 255.0)
    max_value = 1 if float(img1.max()) <= 1 else 255
    return _ssim(img1.to(torch.float32), img2.to(torch.float32), max_value)
