"""Logging: root logger and the training ``MessageLogger`` with ETA
(mirrors ``get_root_logger`` and ``MessageLogger`` of
``refid_tpu/core/logging_util.py``; the TensorBoard and wandb loggers are
not ported yet)."""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

__all__ = ["get_root_logger", "MessageLogger"]

_initialized = set()


def get_root_logger(name: str = "refid_tpu_torch", log_level=logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger: a stream handler and the level on the first
    call, and a file handler for each ``log_file`` not yet attached (a CLI
    that runs after another in the same process still gets its log)."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    if name not in _initialized:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.setLevel(log_level)
        logger.propagate = False
        _initialized.add(name)
    if log_file and not any(isinstance(h, logging.FileHandler)
                            and h.baseFilename == os.path.abspath(log_file)
                            for h in logger.handlers):
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MessageLogger:
    """Periodic training log lines with lr / losses / ETA."""

    def __init__(self, opt: dict, start_iter: int = 1):
        self.exp_name = opt.get("name", "exp")
        self.interval = opt.get("logger", {}).get("print_freq", 100)
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict):
        log_vars = dict(log_vars)
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lr = log_vars.pop("lr", None)

        message = (f"[{self.exp_name[:28]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}")
        if lr is not None:
            message += f", lr:{lr:.3e}"
        message += ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = max(0.0, time_sec_avg * (self.max_iters - current_iter))
            eta = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta}, time: {iter_time:.3f}s] "
        for k, v in log_vars.items():
            message += f"{k}: {float(v):.4e} "
        self.logger.info(message)
