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
crops ``gt_size`` and flips as ``triple_random_crop`` and ``augment`` do
(the frames in :meth:`load`, the grid in :meth:`finish`),
drawn from the dataset's seeded ``random.Random`` in their order.  Items are
HWC numpy: ``lq`` and ``gt`` ``(h, w, 3)``, ``voxel`` ``(h, w, num_bins)``.
An item is :meth:`draw`, :meth:`load` (host) and :meth:`finish` (device),
as in ``base.py``.

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
from refid_tpu_torch.data.img_util import imread, png_size, unit_float
from refid_tpu_torch.data.transforms import (
    apply_flips, crop_lq, draw_crop, draw_flips, paired_random_crop,
)
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

    def __getstate__(self):        # a worker process's copy (data/mp_loader.py)
        state = dict(self.__dict__)
        del state["_timing_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._timing_lock = threading.Lock()

    def __len__(self):
        return len(self.blur_paths)

    def draw(self, index: int) -> dict:
        """The item's crop (from the frame size in the PNG header) and flips,
        drawn from the dataset's ``rng`` in the JAX dataset's order."""
        draws = {}
        if self.gt_size is not None:
            h, w = png_size(self.blur_paths[index])
            draws["crop"] = draw_crop(h, w, self.gt_size, self.scale, self.rng)
        draws["flips"] = draw_flips(self.opt.get("use_hflip", False),
                                    self.opt.get("use_rot", False), self.rng)
        return draws

    def load(self, index: int, draws: dict) -> dict:
        """The host part: the two frames (uint8, cut to the crop), the full
        frame's size and the event arrays."""
        t0 = time.perf_counter()
        quads = [load_event_quad(p, self.layout == "highrev")
                 for p in self.event_seqs[index] if os.path.exists(p)]
        lq = imread(self.blur_paths[index], float32=False)
        gt = imread(self.sharp_paths[index], float32=False)
        size = lq.shape[:2]
        if self.gt_size is not None:
            gt, lq = paired_random_crop(gt, lq, self.gt_size, self.scale,
                                        top_left=draws["crop"])
        return {"index": index, "draws": draws, "size": size, "lq": lq, "gt": gt,
                "events": np.concatenate(quads, 0) if quads else np.zeros((0, 4), np.float32),
                "load_ms": (time.perf_counter() - t0) * 1e3}

    def __getitem__(self, index: int) -> dict:
        return self.finish(self.load(index, self.draw(index)))

    def finish(self, host: dict) -> dict:
        """The device part: the voxel grid (K2 on a CUDA device), the crop,
        the flips and ``voxel_norm``."""
        draws = host["draws"]
        t0 = time.perf_counter()
        img_lq, img_gt = unit_float(host["lq"]), unit_float(host["gt"])
        h, w = host["size"]

        t1 = time.perf_counter()
        voxel = events_to_voxel_grid(host["events"], self.num_bins, w, h, "HWC",
                                     device=self.device)

        t2 = time.perf_counter()
        if self.gt_size is not None:
            voxel, = crop_lq([voxel], draws["crop"], self.gt_size, self.scale)
        img_gt, img_lq, voxel = apply_flips([img_gt, img_lq, voxel], draws["flips"])
        voxel = voxel_norm_np(voxel)

        blur_path = self.blur_paths[host["index"]]
        item = {"lq": img_lq.astype(np.float32), "gt": img_gt.astype(np.float32),
                "voxel": voxel.astype(np.float32),
                "seq": blur_path.split(f"{self.split}/")[1].split("/")[0],
                "origin_index": os.path.basename(blur_path).split(".")[0]}
        t3 = time.perf_counter()
        with self._timing_lock:
            self.timing["items"] += 1
            self.timing["load_ms"] += host["load_ms"] + (t1 - t0) * 1e3
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
