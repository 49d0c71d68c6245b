"""Training: losses, learning-rate schedules and the optimiser step."""

from refid_tpu_torch.train.losses import (
    build_loss, charbonnier_loss, l1_loss, mse_loss, psnr_loss,
)
from refid_tpu_torch.train.schedules import build_schedule
from refid_tpu_torch.train.trainer import Trainer, build_optimizer

__all__ = [
    "Trainer", "build_loss", "build_optimizer", "build_schedule",
    "charbonnier_loss", "l1_loss", "mse_loss", "psnr_loss",
]
