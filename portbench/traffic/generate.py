"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and ``--seed`` -> a pool of requests as host numpy arrays.

Every seed gets the same sizes (frame shape, event count, time span); the
seed changes only the values.  Frames are coarse random fields upsampled
by ``block`` pixels plus fine noise, in [0, 1]; events are uniform over the
frame and the time span, sorted by time, polarity 0 or 1, as
``[t, x, y, p]`` float32 rows.  Streams: 0 the served pool, 1 the sample
the correctness check reads, 2 requests that set-up uses outside the pool
(an int8 calibration).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["load", "rng_for", "frame", "events", "make", "KINDS"]

POOL, SAMPLE, SETUP = 0, 1, 2


def load(root: Path, name: str) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([stream, seed % (1 << 64)])


def frame(rng, height: int, width: int, block: int = 40) -> np.ndarray:
    coarse = rng.random((-(-height // block), -(-width // block), 3), dtype=np.float32)
    field = np.repeat(np.repeat(coarse, block, 0), block, 1)[:height, :width]
    return (field * (200 / 255) + rng.random((height, width, 3), dtype=np.float32)
            * (55 / 255)).astype(np.float32)


def events(rng, n: int, height: int, width: int, t_span: float) -> np.ndarray:
    ev = np.empty((n, 4), np.float32)
    ev[:, 0] = np.sort(rng.uniform(0.0, t_span, n))
    ev[:, 1] = rng.integers(0, width, n)
    ev[:, 2] = rng.integers(0, height, n)
    ev[:, 3] = rng.integers(0, 2, n)
    return ev


def _vfi_window(rng, p):
    h, w = p["height"], p["width"]
    return (frame(rng, h, w), frame(rng, h, w), events(rng, p["events"], h, w, p["t_span"]))


def _deblur_image(rng, p):
    h, w = p["height"], p["width"]
    return frame(rng, h, w), events(rng, p["events"], h, w, p["t_span"])


def _train_batch(rng, p):
    """The recipe's batch as the loader hands it over: ``lq`` the two
    blurred frames each followed by its intra-exposure voxel bins, ``voxel``
    the adjacent bin pairs, ``gt`` the sharp frames; normalised voxel cells
    are nonzero with probability ``voxel_density``."""
    b, c, t, bins_each = p["batch"], p["crop"], p["frames"], p["lq_bins_each"]

    def voxel(*shape):
        mask = rng.random(shape, dtype=np.float32) < p["voxel_density"]
        return (rng.standard_normal(shape, dtype=np.float32) * mask).astype(np.float32)

    lq = np.concatenate([frame(rng, c, c)[None].repeat(b, 0), voxel(b, c, c, bins_each),
                         frame(rng, c, c)[None].repeat(b, 0), voxel(b, c, c, bins_each)], -1)
    gt = np.stack([np.stack([frame(rng, c, c) for _ in range(t)]) for _ in range(b)])
    return {"lq": lq, "voxel": voxel(b, t, c, c, 2), "gt": gt}


KINDS = {"vfi_window": _vfi_window, "deblur_image": _deblur_image, "train_batch": _train_batch}


def make(params: dict, seed: int, stream: int = POOL, count: int = 0) -> List:
    """``count`` requests (default: the mix's ``pool``) of stream ``stream``."""
    rng = rng_for(seed, stream)
    return [KINDS[params["kind"]](rng, params) for _ in range(count or params["pool"])]
