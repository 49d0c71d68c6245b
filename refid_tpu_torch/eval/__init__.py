"""Evaluation: PSNR / SSIM (torch ops on the frames' device), tiled
inference, MATLAB-style resize, NIQE, FID and its InceptionV3."""

from refid_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim

__all__ = ["calculate_psnr", "calculate_ssim"]
