"""Recurrent restoration tasks: blur VFI and sharp VFI (mirrors
``refid_tpu/tasks/recurrent.py``; upstream
``twoImage_event_recurrent_model.py`` and
``twoSharpImage_event_recurrent_model.py``).

Validation predicts each item (whole frame, or ``val.crop_size`` tiles
through ``eval/tiling.py::tiled_apply``), turns every frame into a uint8
BGR image with ``tensor2img``'s rounding, and measures it against its
ground truth with the ``val`` section's metrics.  The frames stay on the
task's device: ``tensor2img`` and the metrics run there as torch ops.
Blur VFI splits the frames into deblur (``frame < m or frame >= m + n``)
and interpolation buckets, each averaged over the frames that fed it
across all items, and logs the weighted total (2m*deblur + n*interpo) /
(2m + n); sharp VFI logs interpolation metrics only, without the bucket
prefix.
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

__all__ = ["TwoImageEventRecurrentRestorationTask",
           "TwoSharpImageEventRecurrentRestorationTask"]


class _RecurrentTaskBase(RestorationTaskBase):
    split_deblur_interpo = True  # False -> interpolation-only metrics

    def _mn(self, dataset_opt: dict):
        return (dataset_opt["num_end_interpolation"],
                dataset_opt["num_inter_interpolation"])

    def validate(self, loader, dataset_opt: dict, current_iter: int = 0,
                 save_img: bool = False, logger=None,
                 max_items: Optional[int] = None) -> Dict[str, float]:
        """Metrics over the items of ``loader`` (batch 1).  ``val_timing``
        then holds the items measured and the host milliseconds spent
        predicting them, measuring their frames (``tensor2img`` and the
        metrics) and writing their images (``save_img``)."""
        val_opt = self.opt.get("val", {}) or {}
        crop_size = val_opt.get("crop_size")
        max_minibatch = val_opt.get("max_minibatch", 2) or 2
        m, n = self._mn(dataset_opt)
        metrics_deblur = dict(val_opt.get("metrics_deblur", {}) or {})
        metrics_interpo = dict(val_opt.get("metrics_interpo", {}) or {})
        if not metrics_interpo:
            metrics_interpo = dict(val_opt.get("metrics", {}) or {})

        acc_deblur = defaultdict(float)
        acc_interpo = defaultdict(float)
        cnt = 0
        # each metric sum is divided by the frames that fed it, counted
        # across all items, so loaders of mixed t_out average correctly
        n_deblur_frames = n_interpo_frames = 0
        self.val_timing = {"items": 0, "predict_ms": 0.0, "metric_ms": 0.0, "save_ms": 0.0}

        for item_idx, batch in enumerate(loader):
            if max_items is not None and item_idx >= max_items:
                break
            lq, voxel, gt = batch["lq"][0], batch["voxel"][0], batch["gt"][0]
            t0 = time.perf_counter()
            if crop_size:
                pred = torch.from_numpy(tiled_apply(
                    self.predict, lq, voxel, crop_size, max_minibatch=max_minibatch,
                    trans_num=val_opt.get("trans_num", 1))).to(self.device)
            else:
                pred = self.predict_tensor(lq[None], voxel[None])[0]
            self._sync()
            t1 = time.perf_counter()
            gt = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
            save_s = 0.0

            t_out = pred.shape[0]
            for frame_idx in range(t_out):
                sr_img = tensor2img(pred[frame_idx])
                gt_img = tensor2img(gt[frame_idx])
                is_interpo = (m <= frame_idx < m + n) or \
                    not self.split_deblur_interpo
                if save_img:
                    name = (f"{batch['seq'][0]}/"
                            f"{batch['origin_index'][0]}_{frame_idx}.png")
                    path = os.path.join(
                        self.opt["path"].get("visualization", "vis"),
                        dataset_opt.get("name", "val"), name)
                    ts = time.perf_counter()
                    imwrite(sr_img, path)
                    save_s += time.perf_counter() - ts
                bucket = acc_interpo if is_interpo else acc_deblur
                opts = metrics_interpo if is_interpo else metrics_deblur
                if is_interpo:
                    n_interpo_frames += 1
                else:
                    n_deblur_frames += 1
                for mname, mopt in opts.items():
                    bucket[mname] += compute_metric(mopt, sr_img, gt_img)
            cnt += 1
            self._sync()
            t2 = time.perf_counter()
            self.val_timing["items"] += 1
            self.val_timing["predict_ms"] += (t1 - t0) * 1e3
            self.val_timing["metric_ms"] += (t2 - t1 - save_s) * 1e3
            self.val_timing["save_ms"] += save_s * 1e3

        results: Dict[str, float] = {}
        if cnt:
            for k in acc_deblur:
                results[f"deblur_{k}"] = acc_deblur[k] / max(n_deblur_frames, 1)
            for k in acc_interpo:
                results[f"interpo_{k}"] = acc_interpo[k] / max(n_interpo_frames, 1)
            # the weighted total: 2m deblur frames and n interpolated ones
            for k in set(acc_deblur) & set(acc_interpo):
                results[f"total_{k}"] = (
                    results[f"deblur_{k}"] * 2 * m +
                    results[f"interpo_{k}"] * n) / (2 * m + n)
        if logger:
            msg = ", ".join(f"{k}: {v:.4f}" for k, v in results.items())
            logger.info(f"Validation [{dataset_opt.get('name', '')}] "
                        f"iter {current_iter}: {msg}")
        return results


@MODELS.register("TwoImageEventRecurrentRestorationModel")
@MODELS.register("TestTwoImageEventRecurrentRestorationModel")
class TwoImageEventRecurrentRestorationTask(_RecurrentTaskBase):
    """Blur VFI: two blurred frames + events -> 2m+n sharp frames."""
    split_deblur_interpo = True


@MODELS.register("TwoSharpImageEventRecurrentRestorationModel")
@MODELS.register("TestTwoSharpImageEventRecurrentRestorationModel")
class TwoSharpImageEventRecurrentRestorationTask(_RecurrentTaskBase):
    """Sharp VFI: two sharp frames + events -> n middle frames."""
    split_deblur_interpo = False

    def validate(self, loader, dataset_opt, *args, **kw):
        # every output frame is an interpolation
        res = super().validate(loader, dataset_opt, *args, **kw)
        return {k.replace("interpo_", ""): v for k, v in res.items()
                if not k.startswith("total_")}
