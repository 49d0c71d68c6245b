"""NIQE, the Natural Image Quality Evaluator (no-reference), mirroring
``refid_tpu/eval/niqe.py`` (Mittal et al., 2013, with upstream BasicSR's
semantics): Y-channel input, 96 x 96 blocks, two scales, AGGD features, the
MVG distance to pristine statistics.

The pristine statistics (a BasicSR-style ``niqe_pris_params.npz``:
``mu_pris_param`` (1, 36), ``cov_pris_param`` (36, 36), the 7 x 7
``gaussian_window``) do not ship with the repo; pass ``params_path`` or set
``REFID_TPU_NIQE_PARAMS``.  Without them the metric raises.

Where the JAX package calls cv2 and scipy, this takes torch ops: the local
mean and deviation are a replicate-padded convolution in float64 (scipy's
``convolve(mode="nearest")``, cast to float32 as scipy does), the halving
between scales a 2 x 2 mean (cv2's INTER_LINEAR takes its area path for an
exact half) or, for an odd side, a half-pixel bilinear resize (its general
path), and the grey conversion cv2's BGR2GRAY weights.  The features are
numpy, as in the JAX package.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from refid_tpu_torch.eval.color import to_y_channel

__all__ = ["calculate_niqe"]

_gamma = np.vectorize(math.gamma, otypes=[np.float64])

# gamma-ratio lookup for the AGGD shape estimate
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma(2.0 / _GAM)) / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def _load_pris_params(params_path: Optional[str]):
    paths = [params_path] if params_path else [
        os.environ.get("REFID_TPU_NIQE_PARAMS", ""),
        os.path.join(os.path.dirname(__file__), "niqe_pris_params.npz")]
    for p in paths:
        if p and os.path.exists(p):
            d = np.load(p)
            return (d["mu_pris_param"], d["cov_pris_param"],
                    d["gaussian_window"])
    raise FileNotFoundError(
        "NIQE pristine params not found; set REFID_TPU_NIQE_PARAMS to a "
        "BasicSR-style niqe_pris_params.npz")


def _aggd_params(block: np.ndarray):
    block = block.ravel()
    left = block[block < 0]
    right = block[block > 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else np.nan
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else np.nan
    gammahat = left_std / right_std
    rhat = np.mean(np.abs(block)) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    ratio = np.sqrt(math.gamma(1 / alpha) / math.gamma(3 / alpha))
    return alpha, left_std * ratio, right_std * ratio


def _block_features(block: np.ndarray):
    feat = []
    alpha, bl, br = _aggd_params(block)
    feat.extend([alpha, (bl + br) / 2])
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = _aggd_params(prod)
        mean = (br - bl) * (math.gamma(2 / alpha) / math.gamma(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def _filter(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """scipy.ndimage.convolve(img, window, mode="nearest") of a float32
    plane with an odd-sized window: a correlation with the flipped window
    over a replicate-padded plane, in float64, returned as float32."""
    kh, kw = window.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"NIQE window must have odd sides, got {window.shape}")
    x = torch.from_numpy(np.asarray(img, np.float64))[None, None]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    w = torch.from_numpy(np.ascontiguousarray(window[::-1, ::-1], np.float64))
    return F.conv2d(x, w[None, None])[0, 0].to(torch.float32).numpy()


def _half_size(img: np.ndarray) -> np.ndarray:
    """cv2.resize of a float32 plane to (w // 2, h // 2), INTER_LINEAR."""
    h, w = img.shape
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None, None]
    if h % 2 == 0 and w % 2 == 0:
        out = F.avg_pool2d(x, 2)
    else:
        out = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear", align_corners=False)
    return out[0, 0].numpy()


def _bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of a float32 (h, w, 3) image."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return (x[..., 0] * 0.114 + x[..., 1] * 0.587 + x[..., 2] * 0.299).numpy()


def _niqe_score(img: np.ndarray, mu_pris, cov_pris, window,
                block: int = 96) -> float:
    h, w = img.shape
    nbh, nbw = math.floor(h / block), math.floor(w / block)
    img = img[: nbh * block, : nbw * block]

    per_scale = []
    for scale in (1, 2):
        mu = _filter(img, window)
        sigma = np.sqrt(np.abs(_filter(np.square(img), window) - np.square(mu)))
        normalized = (img - mu) / (sigma + 1)
        feats = []
        bs = block // scale
        for iw in range(nbw):
            for ih in range(nbh):
                feats.append(_block_features(
                    normalized[ih * bs:(ih + 1) * bs, iw * bs:(iw + 1) * bs]))
        per_scale.append(np.asarray(feats))
        if scale == 1:
            img = _half_size(img / 255.0) * 255.0

    feats = np.concatenate(per_scale, axis=1)
    valid = feats[~np.isnan(feats).any(axis=1)]
    if valid.shape[0] < 2:
        # degenerate input (constant blocks: the AGGD is undefined); upstream
        # crashes here
        return float("nan")
    mu_dist = np.nanmean(feats, axis=0)
    cov_dist = np.cov(valid, rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = np.ravel(mu_pris - mu_dist)       # mu_pris is stored (1, n)
    return float(np.sqrt(d @ invcov @ d))


def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y",
                   params_path: Optional[str] = None) -> float:
    """NIQE of an image in [0, 255] (BGR for 'HWC'/'CHW' orders)."""
    mu_pris, cov_pris, window = _load_pris_params(params_path)
    img = np.asarray(img, np.float32)
    if input_order != "HW":
        if input_order == "CHW":
            img = img.transpose(1, 2, 0)
        if convert_to == "y":
            img = to_y_channel(img)
        elif convert_to == "gray":
            img = _bgr_to_gray(img / 255.0) * 255.0
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return _niqe_score(img, mu_pris, cov_pris, window)
