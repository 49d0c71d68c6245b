"""Task layer (mirrors ``refid_tpu/tasks/base.py``).

A task owns the network (from the ARCHS registry) on its device, the
:class:`~refid_tpu_torch.train.trainer.Trainer` (optimiser, step, EMA),
the checkpoint manager, the move of host batches to the card, and the
inference forward (:meth:`RestorationTaskBase.predict`) that validation
and the test CLI run.

Batches arrive from the datasets as NHWC numpy arrays and go to the
network as NCHW tensors: lq ``(b, h, w, 26)`` -> ``(b, 26, h, w)``, voxel
``(b, t, h, w, 2)`` -> ``(b, t, 2, h, w)``, gt ``(b, T, h, w, 3)`` ->
``(b, T, 3, h, w)``.

The JAX task trains the production config through a width-folded scan
forward (``refid_tpu/serve/fast_scan.py``), a TPU re-expression that is
exactly the plain network's math; the port trains the plain
:class:`FinalBidirectionAttenfusion`, whatever ``train.folded_apply`` says.
For the same reason it predicts with the plain network whatever
``val.folded_predict`` says.  ``val.int8`` (True or ``"scale0"``: dynamic
activation scales, ``serve/quant.py``) predicts through the int8 forward,
as the JAX task does, on frames whose sides are multiples of the network's
``int8_side`` (others run the float forward there too); the network's
``task_int8_mode`` maps ``val.int8`` to its mode (the flagship: ``"static"``
raises, since a task records no calibration; EVHINet: a truthy value means
dynamic scales, as the JAX task's ``int8=bool(int8)``).  EVHINet's batches are
``lq (b, h, w, 3)`` and ``voxel (b, h, w, bins)``.

Distribution: the task lays the process group's ranks out as ``(data,
spatial)`` with ``spatial = opt['mesh']['spatial']`` (default 1), as the JAX
task does (``refid_tpu/tasks/base.py``); :meth:`setup_train_state`
broadcasts the state from rank 0, and only rank 0 saves checkpoints.  With
``spatial > 1`` each training batch is cut to the rank's rows
(``parallel.mesh.shard_batch``) and the step runs under a spatial plan, for
every network, loss and int8 mode; so does every prediction (validation,
the test and demo CLIs, each tile of a tiled evaluation): the ranks of a
spatial group make the same call, each runs its rows of the frame, and the
output is gathered on every rank.  A frame (or tile) whose rows leave a
shard fewer than two rows at the network's deepest scale raises
``ValueError``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from refid_tpu_torch.core.checkpoint import CheckpointManager
from refid_tpu_torch.core.device import resolve_device
from refid_tpu_torch.core.registry import ARCHS, MODELS
from refid_tpu_torch.eval import metrics as metric_module
from refid_tpu_torch.models import archs as _archs  # noqa: F401 (registers archs)
from refid_tpu_torch.models.convert import known_unused_keys, load_state
from refid_tpu_torch.parallel.mesh import make_mesh, rank, replicate, shard_batch
from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
from refid_tpu_torch.serve.quant import QuantState, WeightCache
from refid_tpu_torch.train.losses import build_loss
from refid_tpu_torch.train.trainer import Trainer

__all__ = ["RestorationTaskBase", "build_task", "to_nchw", "compute_metric"]

_DEFAULT_LOSS = {"type": "CharbonnierLoss", "loss_weight": 1.0,
                 "reduction": "mean"}
_SPATIAL_AXES = {4: 1, 5: 2}      # the height axis of NHWC / NTHWC batch arrays


def build_task(opt: dict, device="cuda", mesh=None):
    from refid_tpu_torch.tasks import recurrent, single  # noqa: F401 (registers tasks)
    return MODELS.get(opt["model_type"])(opt, device, mesh)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Channels from the last axis to the third from last."""
    return x.movedim(-1, -3).contiguous()


def compute_metric(metric_opt: dict, sr_img, gt_img) -> float:
    """One ``val.metrics`` entry (``{"type": name, **kwargs}``) of
    ``eval/metrics.py`` on two uint8 images."""
    opt = dict(metric_opt)
    return getattr(metric_module, opt.pop("type"))(sr_img, gt_img, **opt)


class RestorationTaskBase:
    """Common wiring of the restoration tasks.  ``mesh`` is the process
    group's layout (``parallel.mesh.make_mesh``); None lays it out from
    ``opt['mesh']``."""

    def __init__(self, opt: dict, device="cuda", mesh=None):
        self.opt = opt
        val = opt.get("val") or {}
        self.device = resolve_device(device)
        self.is_train = opt.get("is_train", True)
        self.net = self._build_net().to(self.device)
        # the network maps val.int8 to its int8 mode and raises where it
        # cannot serve in int8
        self.int8 = self.net.task_int8_mode(val.get("int8", False))
        if self.int8 and val.get("folded_predict", True) is False:
            raise ValueError("val.int8 requires the folded predict path "
                             "(val.folded_predict: false given)")
        self._int8_weights = WeightCache()
        self.mesh = mesh or make_mesh(data=-1, spatial=(opt.get("mesh") or {}).get("spatial", 1))
        self.trainer: Optional[Trainer] = None
        self.start_iter = 0
        self.start_epoch = 0
        self.train_loader = None     # set by the train CLI, with val_loaders
        self.val_loaders = []
        self.history = []            # the CLI's logged iterations and validations
        self._copy_stream = None
        if self.is_train and "train" in opt:
            t = opt["train"]
            self.loss_fn = build_loss(t.get("pixel_opt", _DEFAULT_LOSS))
            self.total_iter = t.get("total_iter", 200000)
            self.ema_decay = t.get("ema_decay")
        models_dir = opt.get("path", {}).get("models")
        self.ckpt = CheckpointManager(models_dir) if models_dir else None

    def _build_net(self):
        return ARCHS.get(self.opt["network_g"]["type"])(self.opt["network_g"])

    # --- parameter lifecycle -------------------------------------------------

    def init_params(self, seed: int = 0):
        """Fresh parameters from ``seed`` (the modules' own inits: PyTorch's
        defaults, 0.1-scaled kaiming-normal in ``ResidualBlockNoBN``; drawn
        from a generator seeded here, whatever the global state)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = self._build_net()
        self.net.load_state_dict(fresh.state_dict())

    def load_pretrained(self, path: str, param_key: str = "params"):
        """Load an upstream ``.pth`` (``params``, else ``params_ema``,
        ``module.`` prefixes stripped), a port checkpoint file, or the
        latest checkpoint of a port checkpoint directory.  Only the
        known-unused parameters may be missing."""
        if os.path.isdir(path):
            state = CheckpointManager(path).restore()["params"]
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
            if param_key in state:
                state = state[param_key]
            elif "params_ema" in state:
                state = state["params_ema"]
        state = {k[len("module."):] if k.startswith("module.") else k: v
                 for k, v in state.items()}
        load_state(self.net, state)

    def setup_train_state(self) -> Trainer:
        t = self.opt["train"]
        self.trainer = Trainer(self.net, self.loss_fn, t, self.total_iter,
                               ema_decay=self.ema_decay,
                               frozen=known_unused_keys(self.net), mesh=self.mesh)
        replicate([self.net, self.trainer.optimizer.state_dict()["state"], self.trainer.ema])
        return self.trainer

    # --- checkpointing / resume ---------------------------------------------

    def save(self, current_iter: int, epoch: int = 0):
        if self.ckpt is None or rank() != 0:
            return
        tr = self.trainer
        self.ckpt.save(current_iter, self.net.state_dict(),
                       opt_state=tr.optimizer.state_dict() if tr else None,
                       ema_params=tr.ema if tr else None, epoch=epoch)

    def auto_resume(self) -> bool:
        """Resume from the latest checkpoint if one exists."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        if self.trainer is None:
            raise RuntimeError("setup_train_state before auto_resume")
        restored = self.ckpt.restore()
        load_state(self.net, restored["params"])
        self.trainer.load_state_dict({"step": restored["step"],
                                      "optimizer": restored["opt_state"],
                                      "ema": restored.get("ema_params")})
        self.start_iter = int(restored["step"])
        self.start_epoch = int(restored.get("epoch", 0))
        return True

    # --- steps ----------------------------------------------------------------

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's arrays as NCHW tensors on the device (on a spatial
        mesh this rank's rows, with their plan under ``"plan"``).  On CUDA
        the copies go from pinned memory, without blocking, on a side
        stream; :meth:`_ready` makes the compute stream wait for them."""
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        plan = None
        if self.mesh.spatial > 1:
            block = self.net.row_block
            plan = SpatialPlan(self.mesh, arrays["lq"].shape[1], block)
            arrays = shard_batch(arrays, self.mesh, _SPATIAL_AXES, block)
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        if self.device.type != "cuda":
            out = {k: to_nchw(v.to(self.device)) for k, v in arrays.items()}
        else:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                out = {k: to_nchw(v.pin_memory().to(self.device, non_blocking=True))
                       for k, v in arrays.items()}
        return dict(out, plan=plan)

    def _ready(self, dev_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self._copy_stream is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_stream(self._copy_stream)
            for v in dev_batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(compute)
        return dev_batch

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return self.train_step_device(self._ready(self._to_device(batch)))

    def train_step_device(self, dev_batch) -> Dict[str, torch.Tensor]:
        return self.trainer.train_step(dev_batch["lq"], dev_batch["voxel"],
                                       dev_batch["gt"], dev_batch.get("plan"))

    def device_prefetch(self, batch_iter: Iterable[dict]):
        """Yield device batches, the copy of batch k+1 issued before batch k
        is handed out (upstream's CUDAPrefetcher)."""
        it = iter(batch_iter)
        nxt = next(it, None)
        pending = self._to_device(nxt) if nxt is not None else None
        while pending is not None:
            nxt = next(it, None)
            following = self._to_device(nxt) if nxt is not None else None
            yield self._ready(pending)
            pending = following

    # --- inference --------------------------------------------------------------

    def predict_tensor(self, lq: np.ndarray, voxel: np.ndarray,
                       use_ema: bool = False) -> torch.Tensor:
        """The network's output on the task's device, NHWC: ``(b, t_out, h,
        w, 3)`` for the recurrent networks, ``(b, h, w, 3)`` for EVHINet; from
        NHWC numpy ``lq (b, h, w, C)`` and ``voxel (b, t, h, w, 2)`` (or the
        single-image ``(b, h, w, bins)``): in eval mode under
        ``torch.inference_mode`` (the options' compute dtype), the training
        mode restored afterwards.  ``use_ema`` runs the trainer's EMA weights
        when it keeps them; ``val.int8`` the int8 forward, where the frame's
        sides are multiples of the network's ``int8_side``.  With
        ``mesh.spatial > 1`` each rank of the spatial group runs its rows of
        the frame and every rank returns the whole output."""
        lq_t, vox_t = (to_nchw(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                               .to(self.device)) for a in (lq, voxel))
        q = None
        k = self.net.int8_side
        if self.int8 and lq_t.shape[-2] % k == 0 and lq_t.shape[-1] % k == 0:
            q = QuantState(self.int8, self._int8_weights)
        plan = None
        if self.mesh.spatial > 1:
            plan = SpatialPlan(self.mesh, lq_t.shape[-2], self.net.row_block)
            lq_t, vox_t = plan.shard(lq_t), plan.shard(vox_t)
        tr = self.trainer
        training = self.net.training
        self.net.eval()
        try:
            with torch.inference_mode(), spatial_scope(plan):
                if use_ema and tr is not None and tr.ema is not None:
                    out = torch.func.functional_call(self.net, tr.ema, (lq_t, vox_t, q))
                else:
                    out = self.net(lq_t, vox_t, q)
                if plan is not None:
                    out = plan.gather(out)
        finally:
            self.net.train(training)
        return out.movedim(-3, -1)

    def predict(self, lq: np.ndarray, voxel: np.ndarray,
                use_ema: bool = False) -> np.ndarray:
        """:meth:`predict_tensor` as NHWC numpy."""
        return self.predict_tensor(lq, voxel, use_ema).cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def current_lr(self) -> float:
        return self.trainer.current_lr() if self.trainer else 0.0
