"""Aligned spatial transforms on HWC numpy arrays (mirrors
``refid_tpu/data/transforms.py``): one random draw is applied identically
to every array of a group (images, gts, voxels).  The ``rng`` calls come in
the JAX package's order, so a seed gives its crops and flips."""

from __future__ import annotations

import random

import numpy as np

__all__ = ["augment", "paired_random_crop", "triple_random_crop", "mod_crop"]


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]


def augment(imgs, hflip=True, rotation=True, rng: random.Random = random):
    """hflip / vflip / 90-degree rotation as a transpose, one draw for all
    arrays."""
    single = not isinstance(imgs, list)
    if single:
        imgs = [imgs]
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot90 = rotation and rng.random() < 0.5

    def _aug(img):
        img = np.ascontiguousarray(img, dtype=np.float32)
        if do_hflip:
            img = img[:, ::-1, :]
        if do_vflip:
            img = img[::-1, :, :]
        if do_rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    out = [_aug(i) for i in imgs]
    return out[0] if single else out


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale,
                       rng: random.Random = random):
    """Aligned random crop of gt (at scale) and lq lists."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]

    h_lq, w_lq = img_lqs[0].shape[:2]
    h_gt, w_gt = img_gts[0].shape[:2]
    lq_patch = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"Scale mismatch: GT ({h_gt},{w_gt}) vs "
                         f"LQ ({h_lq},{w_lq}) x{scale}")
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(f"LQ ({h_lq},{w_lq}) smaller than patch {lq_patch}")

    top = rng.randint(0, h_lq - lq_patch)
    left = rng.randint(0, w_lq - lq_patch)
    img_lqs = [v[top:top + lq_patch, left:left + lq_patch, ...]
               for v in img_lqs]
    tg, lg = top * scale, left * scale
    img_gts = [v[tg:tg + gt_patch_size, lg:lg + gt_patch_size, ...]
               for v in img_gts]
    if single_gt:
        img_gts = img_gts[0]
    if single_lq:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


def triple_random_crop(img_gts, img_lqs, voxels, gt_patch_size, scale,
                       rng: random.Random = random):
    """Aligned random crop of gt / lq / voxel groups."""
    def aslist(x):
        return x if isinstance(x, list) else [x]

    gts, lqs, vox = aslist(img_gts), aslist(img_lqs), aslist(voxels)
    h_lq, w_lq = lqs[0].shape[:2]
    h_v, w_v = vox[0].shape[:2]
    if (h_lq, w_lq) != (h_v, w_v):
        raise ValueError(f"lq ({h_lq},{w_lq}) / voxel ({h_v},{w_v}) size mismatch")
    h_gt, w_gt = gts[0].shape[:2]
    lq_patch = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError("Scale mismatch")
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(f"LQ ({h_lq},{w_lq}) smaller than patch {lq_patch}")

    top = rng.randint(0, h_lq - lq_patch)
    left = rng.randint(0, w_lq - lq_patch)
    lqs = [v[top:top + lq_patch, left:left + lq_patch, ...] for v in lqs]
    vox = [v[top:top + lq_patch, left:left + lq_patch, ...] for v in vox]
    tg, lg = top * scale, left * scale
    gts = [v[tg:tg + gt_patch_size, lg:lg + gt_patch_size, ...] for v in gts]

    def unwrap(x, orig):
        return x[0] if not isinstance(orig, list) else x

    return (unwrap(gts, img_gts), unwrap(lqs, img_lqs), unwrap(vox, voxels))
