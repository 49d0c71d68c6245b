"""Tiled ("grids") full-resolution inference with overlap averaging, numpy
(a copy of ``refid_tpu/eval/tiling.py``; upstream
``image_event_restoration_model.py`` ``grids`` / ``grids_inverse`` and its
8-way transpose ensemble).

Overlapping ``crop_size`` tiles with an adaptive stride so the last tile is
flush with the border, an optional dihedral-group member per tile, and a
count-matrix average on reassembly.  Extraction and assembly run on the
host; the network runs over batches of ``max_minibatch`` equal tiles.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["tile_plan", "extract_tiles", "assemble_tiles", "tiled_apply",
           "dihedral", "dihedral_inverse"]


def dihedral(x: np.ndarray, trans_idx: int) -> np.ndarray:
    """Transpose-ensemble member on (..., h, w, c) arrays: flip W for
    idx >= 4, then rot90 k times (upstream ``transpose`` on NCHW dims
    [2, 3])."""
    if trans_idx >= 4:
        x = np.flip(x, axis=-2)
    return np.rot90(x, trans_idx % 4, axes=(-3, -2))


def dihedral_inverse(x: np.ndarray, trans_idx: int) -> np.ndarray:
    x = np.rot90(x, 4 - trans_idx % 4, axes=(-3, -2))
    if trans_idx >= 4:
        x = np.flip(x, axis=-2)
    return x


def tile_plan(h: int, w: int, crop_size: int) -> List[Tuple[int, int]]:
    """(i, j) origins of overlapping tiles with adaptive stride, the last
    tile flush with the border."""
    num_row = (h - 1) // crop_size + 1
    num_col = (w - 1) // crop_size + 1
    step_i = crop_size if num_row == 1 else math.ceil(
        (h - crop_size) / (num_row - 1) - 1e-8)
    step_j = crop_size if num_col == 1 else math.ceil(
        (w - crop_size) / (num_col - 1) - 1e-8)

    plan = []
    i, last_i = 0, False
    while i < h and not last_i:
        if i + crop_size >= h:
            i, last_i = h - crop_size, True
        j, last_j = 0, False
        while j < w and not last_j:
            if j + crop_size >= w:
                j, last_j = w - crop_size, True
            plan.append((i, j))
            j += step_j
        i += step_i
    return plan


def extract_tiles(img: np.ndarray, crop_size: int, trans_num: int = 1):
    """img: (..., h, w, c), leading dims kept per tile.  Returns (tiles
    stacked on a new axis 0, index list)."""
    h, w = img.shape[-3:-1]
    plan = tile_plan(h, w, crop_size)
    tiles, idxes = [], []
    for (i, j) in plan:
        for trans_idx in range(trans_num):
            t = img[..., i:i + crop_size, j:j + crop_size, :]
            if trans_idx:
                t = dihedral(t, trans_idx)
            tiles.append(np.ascontiguousarray(t))
            idxes.append({"i": i, "j": j, "trans_idx": trans_idx})
    return np.stack(tiles, axis=0), idxes


def assemble_tiles(outputs: np.ndarray, idxes, out_shape, crop_size: int):
    """Scatter-average tiles back.  outputs: (n_tiles, ..., crop, crop, c);
    out_shape: (..., h, w, c)."""
    preds = np.zeros(out_shape, np.float32)
    count = np.zeros(out_shape[:-3] + out_shape[-3:-1] + (1,), np.float32)
    for out, idx in zip(outputs, idxes):
        i, j, trans_idx = idx["i"], idx["j"], idx["trans_idx"]
        if trans_idx:
            out = dihedral_inverse(out, trans_idx)
        preds[..., i:i + crop_size, j:j + crop_size, :] += out
        count[..., i:i + crop_size, j:j + crop_size, :] += 1.0
    return preds / count


def tiled_apply(fn: Callable, lq: np.ndarray, voxel: np.ndarray,
                crop_size: int, max_minibatch: int = 2,
                trans_num: int = 1, out_frames: int = None) -> np.ndarray:
    """Run ``fn(lq_tiles, voxel_tiles) -> pred_tiles`` over aligned tiles.

    lq: (h, w, C) packed input; voxel: (t, h, w, 2).
    Returns (t_out, h, w, 3).
    """
    lq_tiles, idxes = extract_tiles(lq, crop_size, trans_num)
    vox_tiles, _ = extract_tiles(voxel, crop_size, trans_num)
    outs = []
    n = lq_tiles.shape[0]
    for s in range(0, n, max_minibatch):
        pred = fn(lq_tiles[s:s + max_minibatch], vox_tiles[s:s + max_minibatch])
        outs.append(np.asarray(pred))
    outputs = np.concatenate(outs, axis=0)  # (n, t_out, crop, crop, c)
    if outputs.ndim == 4:
        # a single-image fn gives (n, crop, crop, c): insert t = 1 rather
        # than read the tile height as a time axis
        outputs = outputs[:, None]
    t_out = outputs.shape[1]
    if out_frames is not None:
        assert t_out == out_frames, (t_out, out_frames)
    out_shape = (t_out,) + lq.shape[:-1] + (outputs.shape[-1],)
    return assemble_tiles(outputs, idxes, out_shape, crop_size)
