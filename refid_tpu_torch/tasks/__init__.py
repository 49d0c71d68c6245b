"""Task layer: network, train state, checkpoints and the train step."""

from refid_tpu_torch.tasks.base import build_task

__all__ = ["build_task"]
