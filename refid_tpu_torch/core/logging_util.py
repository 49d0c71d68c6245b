"""Logging: root logger, the training ``MessageLogger`` with ETA, and the
TensorBoard and wandb sinks (mirrors ``refid_tpu/core/logging_util.py``;
upstream ``basicsr/utils/logger.py``).

``logger.use_tb_logger: true`` (every shipped recipe) writes scalars to
``<path.root>/tb_logger/<name>/events.out.tfevents.*`` through
``core/tb_writer.py``.  ``logger.wandb.project`` syncs those files to wandb
(tensorboard-sync mode, so it needs the tb logger); without the wandb
package it is a warning, not a failure."""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional

__all__ = ["get_root_logger", "MessageLogger", "init_tb_logger", "init_wandb_logger"]

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


def init_wandb_logger(opt: dict):
    """Start wandb in tensorboard-sync mode when ``logger.wandb.project`` is
    set (``logger.wandb.resume_id`` resumes a run); returns the run id, or
    None (no project, or no wandb package: a warning)."""
    wandb_opt = (opt.get("logger", {}) or {}).get("wandb") or {}
    if not wandb_opt.get("project"):
        return None
    logger = get_root_logger()
    try:
        import wandb
    except ImportError:
        logger.warning("logger.wandb.project is set but the wandb package is not "
                       "installed; skipping wandb sync (tb event files are unaffected)")
        return None
    resume_id = wandb_opt.get("resume_id")
    if resume_id:
        wandb_id, resume = resume_id, "allow"
        logger.warning(f"Resume wandb logger with id={wandb_id}.")
    else:
        wandb_id, resume = wandb.util.generate_id(), "never"
    wandb.init(id=wandb_id, resume=resume, name=opt.get("name"), config=opt,
               project=wandb_opt["project"], sync_tensorboard=True)
    logger.info(f"Use wandb logger with id={wandb_id}; project={wandb_opt['project']}.")
    return wandb_id


def init_tb_logger(opt: dict):
    """A ``TensorBoardWriter`` under ``<path.root>/tb_logger/<name>`` when
    ``logger.use_tb_logger`` is set, else None.  wandb starts first, so that
    its tensorboard sync sees the event file; wandb without the tb logger
    is a warning and no sync."""
    log_opt = opt.get("logger", {}) or {}
    if not log_opt.get("use_tb_logger"):
        if (log_opt.get("wandb") or {}).get("project"):
            get_root_logger().warning(
                "logger.wandb.project is set but use_tb_logger is false; wandb syncs "
                "the tensorboard files and needs the tb logger: wandb sync is DISABLED")
        return None
    if log_opt.get("wandb"):
        init_wandb_logger(opt)
    from refid_tpu_torch.core.tb_writer import TensorBoardWriter
    root = opt.get("path", {}).get("root", ".")
    return TensorBoardWriter(f"{root}/tb_logger/{opt.get('name', 'exp')}")


class MessageLogger:
    """Periodic training log lines with lr / losses / ETA; with a
    ``tb_logger``, each line's losses as ``losses/<name>`` and its lr as
    ``learning_rate`` at its iteration."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt.get("name", "exp")
        self.interval = opt.get("logger", {}).get("print_freq", 100)
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.start_time = time.time()
        self.logger = get_root_logger()
        self.tb_logger = tb_logger

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
        if self.tb_logger is not None:
            scalars = {f"losses/{k}": float(v) for k, v in log_vars.items()}
            if lr is not None:
                scalars["learning_rate"] = float(lr)
            self.tb_logger.add_scalars(scalars, current_iter)
