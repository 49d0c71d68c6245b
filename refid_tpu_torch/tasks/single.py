"""Single-image restoration tasks, with and without events (mirrors
``refid_tpu/tasks/single.py``; upstream ``image_event_restoration_model.py``
and ``image_restoration_model.py``).

Validation predicts each item (whole frame, or ``val.crop_size`` tiles
through ``eval/tiling.py::tiled_apply``), turns the frame into a uint8 BGR
image with ``tensor2img``'s rounding on the task's device, and averages the
``val`` section's metrics over the items.  ``single_image_inference`` is the
demo's path, with the voxel that upstream's demo never builds; it tiles as
validation does (``trans_num`` included, where the JAX task's leaves it at 1).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from refid_tpu_torch.core.registry import MODELS
from refid_tpu_torch.data.img_util import imwrite, tensor2img
from refid_tpu_torch.eval.tiling import tiled_apply
from refid_tpu_torch.tasks.base import RestorationTaskBase, compute_metric

__all__ = ["ImageEventRestorationTask", "ImageRestorationTask"]


@MODELS.register("ImageEventRestorationModel")
@MODELS.register("TestImageEventRestorationModel")
class ImageEventRestorationTask(RestorationTaskBase):
    """lq ``(h, w, 3)`` + voxel ``(h, w, bins)`` -> sharp ``(h, w, 3)``.  The
    voxel goes to the network as it is; a recurrent network's output gives
    its middle frame."""

    def _forward(self, lq, voxel) -> torch.Tensor:
        pred = self.predict_tensor(lq, voxel)
        if pred.dim() == 5:      # recurrent net: (b, t, h, w, 3) -> middle frame
            pred = pred[:, pred.shape[1] // 2]
        return pred

    def _predict_item(self, lq, voxel) -> torch.Tensor:
        """One item's ``(h, w, 3)`` prediction on the task's device, tiled
        when ``val.crop_size`` is set."""
        val_opt = self.opt.get("val", {}) or {}
        crop_size = val_opt.get("crop_size")
        if not crop_size:
            return self._forward(lq[None], voxel[None])[0]
        pred = tiled_apply(lambda l, v: self._forward(l, v).cpu().numpy(), lq, voxel,
                           crop_size, max_minibatch=val_opt.get("max_minibatch", 2) or 2,
                           trans_num=val_opt.get("trans_num", 1))
        return torch.from_numpy(pred[0]).to(self.device)

    def validate(self, loader, dataset_opt: dict, current_iter: int = 0,
                 save_img: bool = False, logger=None,
                 max_items: Optional[int] = None) -> Dict[str, float]:
        """Metrics averaged over the items of ``loader`` (batch 1).
        ``val_timing`` then holds the items measured and the host
        milliseconds spent predicting them, measuring them (``tensor2img``
        and the metrics) and writing their images (``save_img``)."""
        metric_opts = dict((self.opt.get("val", {}) or {}).get("metrics", {}) or {})
        acc = defaultdict(float)
        cnt = 0
        self.val_timing = {"items": 0, "predict_ms": 0.0, "metric_ms": 0.0, "save_ms": 0.0}
        for item_idx, batch in enumerate(loader):
            if max_items is not None and item_idx >= max_items:
                break
            t0 = time.perf_counter()
            pred = self._predict_item(batch["lq"][0], batch["voxel"][0])
            self._sync()
            t1 = time.perf_counter()
            sr_img = tensor2img(pred)
            gt_img = tensor2img(torch.from_numpy(np.ascontiguousarray(batch["gt"][0]))
                                .to(self.device))
            save_s = 0.0
            if save_img:
                name = f"{batch['seq'][0]}/{batch['origin_index'][0]}.png"
                ts = time.perf_counter()
                imwrite(sr_img, os.path.join(
                    self.opt["path"].get("visualization", "vis"),
                    dataset_opt.get("name", "val"), name))
                save_s = time.perf_counter() - ts
            for mname, mopt in metric_opts.items():
                acc[mname] += compute_metric(mopt, sr_img, gt_img)
            cnt += 1
            self._sync()
            t2 = time.perf_counter()
            self.val_timing["items"] += 1
            self.val_timing["predict_ms"] += (t1 - t0) * 1e3
            self.val_timing["metric_ms"] += (t2 - t1 - save_s) * 1e3
            self.val_timing["save_ms"] += save_s * 1e3
        results = {k: v / cnt for k, v in acc.items()} if cnt else {}
        if logger:
            msg = ", ".join(f"{k}: {v:.4f}" for k, v in results.items())
            logger.info(f"Validation [{dataset_opt.get('name', '')}] "
                        f"iter {current_iter}: {msg}")
        return results

    def single_image_inference(self, img: np.ndarray, voxel: np.ndarray,
                               save_path: Optional[str]) -> torch.Tensor:
        """Restore ``img`` ``(h, w, 3)`` with ``voxel`` ``(h, w, bins)``
        (tiled when ``val.crop_size`` is set) and write the PNG to
        ``save_path`` (None: no file); returns the ``(h, w, 3)``
        prediction."""
        pred = self._predict_item(img, voxel)
        if save_path is not None:
            imwrite(tensor2img(pred), save_path)
        return pred


@MODELS.register("ImageRestorationModel")
@MODELS.register("TestImageRestorationModel")
class ImageRestorationTask(ImageEventRestorationTask):
    """Image-only deblurring: without a voxel the network gets a zero 2-bin
    one, so the same network and task machinery apply."""

    def _predict_item(self, lq, voxel) -> torch.Tensor:
        if voxel is None:
            voxel = np.zeros(lq.shape[:-1] + (2,), np.float32)
        return super()._predict_item(lq, voxel)
