"""FID, the Fréchet Inception Distance: the statistical core (a copy of
``refid_tpu/eval/fid.py``).  (mu, sigma) from feature activations and the
Fréchet distance between two Gaussians; the features come from
:mod:`refid_tpu_torch.eval.inception` or any other extractor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["calculate_fid", "extract_statistics"]


def extract_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu (D,), sigma (D, D))."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, sigma1) and N(mu2, sigma2) (upstream's
    ``_calculate_frechet_distance``)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component in matrix sqrt")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))
