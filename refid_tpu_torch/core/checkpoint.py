"""Checkpoints with ``torch.save`` and auto-resume (the port's counterpart
of ``refid_tpu/core/checkpoint.py``, which uses orbax).

One file per step, ``<directory>/<step>.pt``, holds the network's params
under upstream REFID's state_dict names, the optimiser state, the EMA
params, the epoch and the step.  ``latest_step`` scans the directory, as
the reference's auto-resume scans ``training_states/*.state``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, params: dict, opt_state: Any = None,
             ema_params: Optional[dict] = None, epoch: int = 0) -> str:
        payload = {"params": params, "step": int(step), "epoch": int(epoch)}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if ema_params is not None:
            payload["ema_params"] = ema_params
        path = self.path(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)      # a reader never sees half a file
        return path

    def _steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)
