"""Event-recurrent datasets (mirrors ``refid_tpu/data/datasets/base.py``).

One parameterized base with hooks:

  * layout   — 'gopro': events at ``<split>_event/<video>/*.npz`` with flat
               field arrays; 'highrev': events at ``<split>/<video>/event/``
               with (N,1) fields and swapped x/y.
  * kind     — 'blur'   : 2 blurred inputs -> 2m+n gts, bins 2m+n+1;
               'sharp'  : 2 sharp inputs -> n middles, bins n+1;
               'deblur1': 1 blurred input -> m gts, bins m+1.
  * bidir    — also voxelize the time-reversed stream and concat on t.

Samples are HWC / NHWC numpy, as in the JAX package:
  lq    (num_in, h, w, 3)  or packed (h, w, 26) with deblur voxels
  gt    (T, h, w, 3)
  voxel (t, h, w, 2)       adjacent-bin pairs (2t with bidir)

Each item voxelizes its full frames through
``events.voxel.events_to_voxel_grid`` on the dataset's ``device``: the CUDA
kernel K2 on a CUDA device, its plain version on the CPU.  The grid comes
back to the host for the crop.

Parity quirk kept: ``norm_voxel`` is accepted but NOT applied; the
reference's normalization loop rebinds a local without writing back, so
released checkpoints were trained on unnormalized voxels.
``apply_voxel_norm: true`` normalizes (a fix, not parity).

``timing`` sums, over the items loaded, host milliseconds spent reading
images and events (``load_ms``), voxelizing (``voxelize_ms``) and
cropping, flipping and packing (``crop_ms``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import List

import numpy as np

from refid_tpu_torch.data.img_util import imread
from refid_tpu_torch.data.transforms import augment, triple_random_crop
from refid_tpu_torch.events.voxel import (
    event_reverse, events_to_voxel_grid, voxel_norm_np,
)

__all__ = ["RecurrentEventDataset", "load_event_quad", "recursive_glob",
           "GOPRO_TRAIN_VIDEOS", "GOPRO_TEST_VIDEOS"]

GOPRO_TRAIN_VIDEOS = [
    "GOPR0372_07_00", "GOPR0374_11_01", "GOPR0378_13_00", "GOPR0384_11_01",
    "GOPR0384_11_04", "GOPR0477_11_00", "GOPR0868_11_02", "GOPR0884_11_00",
    "GOPR0372_07_01", "GOPR0374_11_02", "GOPR0379_11_00", "GOPR0384_11_02",
    "GOPR0385_11_00", "GOPR0857_11_00", "GOPR0871_11_01", "GOPR0374_11_00",
    "GOPR0374_11_03", "GOPR0380_11_00", "GOPR0384_11_03", "GOPR0386_11_00",
    "GOPR0868_11_01", "GOPR0881_11_00"]
GOPRO_TEST_VIDEOS = [
    "GOPR0384_11_00", "GOPR0385_11_01", "GOPR0410_11_00", "GOPR0862_11_00",
    "GOPR0869_11_00", "GOPR0881_11_01", "GOPR0384_11_05", "GOPR0396_11_00",
    "GOPR0854_11_00", "GOPR0868_11_00", "GOPR0871_11_00"]


def recursive_glob(rootdir: str, suffix: str) -> List[str]:
    """Names, relative to ``rootdir``, of the files under it ending in
    ``suffix`` (the caller sorts)."""
    out = []
    if not os.path.isdir(rootdir):
        return out
    for dirpath, _, files in os.walk(rootdir):
        for f in files:
            if f.endswith(suffix):
                out.append(os.path.join(os.path.relpath(dirpath, rootdir), f)
                           if dirpath != rootdir else f)
    return out


def load_event_quad(path: str, swap_xy: bool = False) -> np.ndarray:
    """Load one .npz event window as an (N, 4) float32 [t, x, y, p] array."""
    d = np.load(path)

    def col(key):
        return np.asarray(d[key], np.float32).reshape(-1, 1)

    t, x, y, p = col("timestamp"), col("x"), col("y"), col("polarity")
    if swap_xy:
        x, y = y, x
    return np.concatenate([t, x, y, p], axis=1)


class RecurrentEventDataset:
    """Blur-VFI / sharp-VFI / deblur recurrent dataset over a GoPro-style
    directory tree; ``device`` is where items are voxelized."""

    layout = "gopro"     # or 'highrev'
    kind = "blur"        # 'blur' | 'sharp' | 'deblur1'
    bidir = False

    def __init__(self, opt: dict, device="cuda"):
        self.opt = opt
        self.device = device
        self.dataroot = str(opt["dataroot"])
        self.m = opt["num_end_interpolation"]
        self.n = opt["num_inter_interpolation"]
        self.split = "train" if opt["phase"] == "train" else "test"
        self.norm_voxel = opt.get("norm_voxel", True)  # accepted; see module doc
        self.apply_voxel_norm = opt.get("apply_voxel_norm", False)
        self.one_voxel_flg = opt.get("one_voxel_flag", True)
        self.return_deblur_voxel = (opt.get("return_deblur_voxel", False)
                                    and self.one_voxel_flg)
        self.random_reverse = opt.get("random_reverse", False)
        self.scale = opt.get("scale", 1)
        self.gt_size = opt.get("gt_size")
        self.rng = random.Random(opt.get("seed"))
        self.timing = {"items": 0, "load_ms": 0.0, "voxelize_ms": 0.0,
                       "crop_ms": 0.0}
        self._timing_lock = threading.Lock()

        if self.kind == "sharp":
            if self.m != 1:
                raise ValueError("sharp interpolation requires m == 1")
            self.num_bins = self.n + 1
        elif self.kind == "deblur1":
            self.num_bins = self.m + 1
        else:
            self.num_bins = 2 * self.m + self.n + 1

        self.lq_paths: List[List[str]] = []
        self.gt_paths: List[List[str]] = []
        self.event_paths: List[List[str]] = []
        for video in self._video_list():
            self._index_video(video)

    # --- layout hooks ------------------------------------------------------

    def _video_list(self) -> List[str]:
        videos = self.opt.get("video_list")
        if videos:
            return list(videos)
        if self.layout == "gopro":
            return (GOPRO_TRAIN_VIDEOS if self.split == "train"
                    else GOPRO_TEST_VIDEOS)
        return sorted(os.listdir(os.path.join(self.dataroot, self.split)))

    def _event_dir(self, video: str) -> str:
        if self.layout == "highrev":
            return os.path.join(self.dataroot, self.split, video, "event")
        return os.path.join(self.dataroot, self.split + "_event", video)

    @property
    def _swap_xy(self) -> bool:
        return self.layout == "highrev"

    # --- index construction (the reference's window math) ------------------

    def _index_video(self, video: str):
        img_dir = os.path.join(self.dataroot, self.split, video)
        ev_dir = self._event_dir(video)
        gt_frames = sorted(recursive_glob(os.path.join(img_dir, "gt"), ".png"))
        event_frames = sorted(recursive_glob(ev_dir, ".npz"))
        m, n = self.m, self.n

        if self.kind == "sharp":
            set_len = n + 2
            n_sets = (len(gt_frames) - set_len) // (n + 1) + 1
            for i in range(max(n_sets, 0)):
                frames = gt_frames[(n + 1) * i:(n + 1) * i + set_len]
                evs = event_frames[(n + 1) * i:(n + 1) * i + set_len - 1]
                frames = [os.path.join(img_dir, "gt", f) for f in frames]
                self.lq_paths.append([frames[0], frames[-1]])
                self.gt_paths.append(frames[1:-1])
                self.event_paths.append([os.path.join(ev_dir, f) for f in evs])
            return

        blur_frames = sorted(recursive_glob(os.path.join(img_dir, "blur"),
                                            ".png"))
        n_sets = len(blur_frames) - 1
        for i in range(1, n_sets):
            if self.kind == "deblur1":
                blur = blur_frames[i:i + 1]
                gts = gt_frames[i * (m + n): i * (m + n) + m]
                evs = event_frames[i * (m + n) - 1: i * (m + n) + m]
            else:  # blur-VFI pair
                blur = blur_frames[i:i + 2]
                gts = gt_frames[i * (m + n): (i + 1) * (m + n) + m]
                evs = event_frames[i * (m + n) - 1: (i + 1) * (m + n) + m]
            self.lq_paths.append(
                [os.path.join(img_dir, "blur", f) for f in blur])
            self.gt_paths.append([os.path.join(img_dir, "gt", f) for f in gts])
            self.event_paths.append([os.path.join(ev_dir, f) for f in evs])

    # --- sample assembly ----------------------------------------------------

    def __len__(self):
        return len(self.lq_paths)

    def _expected_gts(self):
        return {"blur": 2 * self.m + self.n, "sharp": self.n,
                "deblur1": self.m}[self.kind]

    def _voxelize(self, events, bins, width, height):
        return events_to_voxel_grid(events, bins, width, height, "HWC",
                                    device=self.device)

    def __getitem__(self, index: int) -> dict:
        image_paths = list(self.lq_paths[index])
        gt_paths = list(self.gt_paths[index])
        event_paths = self.event_paths[index]
        if len(gt_paths) != self._expected_gts():
            raise ValueError(f"item {index}: {len(gt_paths)} gts != {self._expected_gts()}")
        if len(event_paths) != self.num_bins:
            raise ValueError(f"item {index}: {len(event_paths)} events != {self.num_bins}")

        if self.random_reverse and self.rng.random() < 0.5:
            image_paths.reverse()
            gt_paths.reverse()

        t0 = time.perf_counter()
        img_lqs = [imread(p) for p in image_paths]
        img_gts = [imread(p) for p in gt_paths]
        h_lq, w_lq = img_lqs[0].shape[:2]
        quads = [load_event_quad(p, self._swap_xy) for p in event_paths]

        t1 = time.perf_counter()
        voxels = []
        if self.one_voxel_flg:
            all_quad = np.concatenate(quads, axis=0)
            voxels.append(self._voxelize(all_quad, self.num_bins, w_lq, h_lq))
            if self.bidir:
                voxels.append(self._voxelize(event_reverse(all_quad),
                                             self.num_bins, w_lq, h_lq))
        else:
            for i in range(1, len(quads)):
                two = np.concatenate([quads[i - 1], quads[i]], axis=0)
                voxels.append(self._voxelize(two, 2, w_lq, h_lq))

        t2 = time.perf_counter()
        if self.gt_size is not None:
            img_gts, img_lqs, voxels = triple_random_crop(
                img_gts, img_lqs, voxels, self.gt_size, self.scale, self.rng)

        group = list(img_lqs) + list(img_gts) + list(voxels)
        group = augment(group, self.opt.get("use_hflip", False),
                        self.opt.get("use_rot", False), self.rng)
        n_lq, n_gt = len(img_lqs), len(img_gts)
        img_lqs = group[:n_lq]
        img_gts = group[n_lq:n_lq + n_gt]
        voxels = group[n_lq + n_gt:]

        if self.apply_voxel_norm:
            voxels = [voxel_norm_np(v) for v in voxels]

        lq = np.stack(img_lqs, axis=0)                      # (num_in,h,w,3)
        gt = np.stack(img_gts, axis=0)                      # (T,h,w,3)

        if self.return_deblur_voxel:
            lq = self._pack_deblur_voxel(img_lqs, voxels[0])

        if self.one_voxel_flg:
            vox_parts = []
            for v in voxels if self.bidir else voxels[:1]:
                # (h,w,bins) -> (t,h,w,2) adjacent-bin pairs
                pairs = np.stack([v[..., i:i + 2]
                                  for i in range(v.shape[-1] - 1)], axis=0)
                vox_parts.append(pairs)
            voxel = np.concatenate(vox_parts, axis=0) if len(vox_parts) > 1 \
                else vox_parts[0]
        else:
            voxel = np.stack(voxels, axis=0)                # (t,h,w,2)

        lq0 = image_paths[0]
        if f"{self.split}/" in lq0:
            seq = lq0.split(f"{self.split}/")[1].split("/")[0]
        else:
            d = os.path.dirname(lq0)
            if os.path.basename(d) in ("blur", "gt", "images"):
                d = os.path.dirname(d)
            seq = os.path.basename(d)
        origin_index = os.path.basename(lq0).split(".")[0]
        item = {"lq": lq.astype(np.float32), "gt": gt.astype(np.float32),
                "voxel": voxel.astype(np.float32), "seq": seq,
                "origin_index": origin_index}
        t3 = time.perf_counter()
        with self._timing_lock:
            self.timing["items"] += 1
            self.timing["load_ms"] += (t1 - t0) * 1e3
            self.timing["voxelize_ms"] += (t2 - t1) * 1e3
            self.timing["crop_ms"] += (t3 - t2) * 1e3
        return item

    def _pack_deblur_voxel(self, img_lqs, voxel_hwc) -> np.ndarray:
        """(h,w,26) packed input: [left img(3), left intra-exposure bins
        (m-1), right img(3), right bins (m-1)].  Sharp datasets pad zero
        bins instead."""
        if self.kind == "sharp":
            h, w = img_lqs[0].shape[:2]
            zeros = np.zeros((h, w, 10), np.float32)  # 10: reference hardcode
            left_vox, right_vox = zeros, zeros
        else:
            m, n = self.m, self.n
            left_vox = voxel_hwc[..., 1:m]
            right_vox = voxel_hwc[..., m + 2 + n:]
        return np.concatenate(
            [img_lqs[0], left_vox, img_lqs[1], right_vox],
            axis=-1).astype(np.float32)
