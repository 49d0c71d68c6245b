"""Single-image deblurring datasets: one blurred frame and its event window
-> one sharp frame (mirrors ``refid_tpu/data/datasets/single_image.py``;
upstream ``Single_image_npy_dataset.py`` and
``Single_image_npy_Ruisi_dataset.py``).

Each blurred frame ``<split>/<video>/blur/<idx>.png`` pairs with
``gt/<idx>.png`` and the event windows ``idx - 5 .. idx + 4`` (those that
exist): ``<split>_event/<video>/`` for GoPro, ``<split>/<video>/event/``
with the x/y swap for HighREV.  Videos are the directory's, sorted, unless
``video_list`` names them.

An item voxelizes its events ``HWC`` on the dataset's ``device``: the CUDA
kernel K2 on a CUDA device, its plain version on the CPU.  Unlike the
recurrent datasets, ``voxel_norm`` is applied, unconditionally, after the
crop and flips (upstream calls it directly on the sample).  The train phase
crops ``gt_size`` with ``triple_random_crop`` and flips with ``augment``, both
from the dataset's seeded ``random.Random``.  Items are HWC numpy:
``lq`` and ``gt`` ``(h, w, 3)``, ``voxel`` ``(h, w, num_bins)``.

``timing`` sums, over the items loaded, host milliseconds spent reading
(``load_ms``), voxelizing (``voxelize_ms``) and cropping, flipping and
normalizing (``crop_ms``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import List

import numpy as np

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import load_event_quad, recursive_glob
from refid_tpu_torch.data.img_util import imread
from refid_tpu_torch.data.transforms import augment, triple_random_crop
from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np

__all__ = ["GoProSingleImageEventDataset", "RuisiSingleImageEventDataset"]


class _SingleImageEventDataset:
    layout = "gopro"     # or 'highrev'

    def __init__(self, opt: dict, device="cuda"):
        self.opt = opt
        self.device = device
        self.dataroot = str(opt["dataroot"])
        self.num_bins = opt["num_bins"]
        self.split = "train" if opt["phase"] == "train" else "test"
        self.scale = opt.get("scale", 1)
        self.gt_size = opt.get("gt_size")
        self.rng = random.Random(opt.get("seed"))
        self.window = opt.get("event_window", (-5, 5))
        self.timing = {"items": 0, "load_ms": 0.0, "voxelize_ms": 0.0, "crop_ms": 0.0}
        self._timing_lock = threading.Lock()

        videos = opt.get("video_list") or sorted(
            os.listdir(os.path.join(self.dataroot, self.split)))
        self.blur_paths: List[str] = []
        for video in videos:
            bdir = os.path.join(self.dataroot, self.split, video, "blur")
            self.blur_paths += [os.path.join(bdir, f) for f in recursive_glob(bdir, ".png")]
        self.blur_paths.sort()
        self.sharp_paths = [p.replace("blur/", "gt/") for p in self.blur_paths]
        self.event_seqs: List[List[str]] = []
        for blur_path in self.blur_paths:
            idx = int(os.path.basename(blur_path).split(".")[0])
            video_dir = os.path.dirname(os.path.dirname(blur_path))
            if self.layout == "highrev":
                ev_dir = os.path.join(video_dir, "event")
            else:
                ev_dir = os.path.join(self.dataroot, self.split + "_event",
                                      os.path.basename(video_dir))
            self.event_seqs.append([os.path.join(ev_dir, "%.6d.npz" % i)
                                    for i in range(idx + self.window[0], idx + self.window[1])])

    def __len__(self):
        return len(self.blur_paths)

    def __getitem__(self, index: int) -> dict:
        t0 = time.perf_counter()
        img_lq = imread(self.blur_paths[index])
        img_gt = imread(self.sharp_paths[index])
        h, w = img_lq.shape[:2]
        quads = [load_event_quad(p, self.layout == "highrev")
                 for p in self.event_seqs[index] if os.path.exists(p)]
        all_quad = np.concatenate(quads, 0) if quads else np.zeros((0, 4), np.float32)

        t1 = time.perf_counter()
        voxel = events_to_voxel_grid(all_quad, self.num_bins, w, h, "HWC", device=self.device)

        t2 = time.perf_counter()
        if self.gt_size is not None:
            img_gt, img_lq, voxel = triple_random_crop(img_gt, img_lq, voxel, self.gt_size,
                                                       self.scale, self.rng)
        img_gt, img_lq, voxel = augment([img_gt, img_lq, voxel],
                                        self.opt.get("use_hflip", False),
                                        self.opt.get("use_rot", False), self.rng)
        voxel = voxel_norm_np(voxel)

        blur_path = self.blur_paths[index]
        item = {"lq": img_lq.astype(np.float32), "gt": img_gt.astype(np.float32),
                "voxel": voxel.astype(np.float32),
                "seq": blur_path.split(f"{self.split}/")[1].split("/")[0],
                "origin_index": os.path.basename(blur_path).split(".")[0]}
        t3 = time.perf_counter()
        with self._timing_lock:
            self.timing["items"] += 1
            self.timing["load_ms"] += (t1 - t0) * 1e3
            self.timing["voxelize_ms"] += (t2 - t1) * 1e3
            self.timing["crop_ms"] += (t3 - t2) * 1e3
        return item


@DATASETS.register("GoProSingleImageEventDataset")
class GoProSingleImageEventDataset(_SingleImageEventDataset):
    """GoPro layout (upstream ``Single_image_npy_dataset.py``)."""
    layout = "gopro"


@DATASETS.register("RuisiSingleImageEventDataset")
class RuisiSingleImageEventDataset(_SingleImageEventDataset):
    """HighREV layout (upstream ``Single_image_npy_Ruisi_dataset.py``)."""
    layout = "highrev"
