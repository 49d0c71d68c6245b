"""The voxelizers' tile design on the CPU: ``events/voxel.py::voxel_tile_plan``
(the kernels' tile plan) and ``tiled_voxelize_reference`` (the plain mirror
of ``csrc/voxelize.cu``: a stable counting sort by tile, each slab
accumulated and then placed), held bit for bit against
``voxelize_padded_reference`` and at 2e-6 against the JAX package's Pallas
kernels in interpret mode."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from refid_tpu.events import voxel_pallas
from refid_tpu_torch.events.voxel import (
    SLAB_BYTES, events_to_voxel_grid_reference, tiled_voxelize_reference,
    voxel_tile_plan, voxelize_padded_reference,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("bins,width,height,slab_bytes,want", [
    (24, 1280, 720, SLAB_BYTES, (1, 640, 2, 720)),      # the main paths: half rows
    (2, 1280, 720, SLAB_BYTES, (6, 1280, 1, 120)),      # one_voxel_flag: false
    (24, 2560, 64, SLAB_BYTES, (1, 640, 4, 64)),        # a row four slabs wide
    (24, 346, 260, SLAB_BYTES, (1, 346, 1, 260)),       # DAVIS346, width % 4 != 0
    (24, 2001, 10, SLAB_BYTES, (1, 501, 4, 10)),        # ragged last column tile
    (5, 48, 16, 400, (1, 16, 3, 16)),                   # the small shapes below
    (3, 30, 20, 1440, (4, 30, 1, 5)),
    (4, 34, 13, 5 * 34 * 16, (5, 34, 1, 3)),            # ragged last row tile
])
def test_tile_plan_covers_every_pixel_once(bins, width, height, slab_bytes, want):
    plan = voxel_tile_plan(bins, width, height, slab_bytes)
    assert tuple(plan) == want
    assert plan.tile_rows * plan.tile_cols * bins * 4 <= slab_bytes
    cover = np.zeros((height, width), np.int32)
    for k in range(plan.num_tiles):
        y0 = k // plan.tiles_x * plan.tile_rows
        x0 = k % plan.tiles_x * plan.tile_cols
        assert y0 < height and x0 < width
        cover[y0:y0 + plan.tile_rows, x0:x0 + plan.tile_cols] += 1
    assert (cover == 1).all()


def test_tile_plan_rejects_a_slab_without_a_pixel():
    with pytest.raises(ValueError, match="no pixel"):
        voxel_tile_plan(24, 64, 8, 64)


def _stream(kind, seed, cap, w, h):
    """``(events, n_valid)``: a (cap, 4) time-sorted buffer of one kind."""
    rng = np.random.RandomState(seed)
    n = 0 if kind == "empty" else cap - cap // 8
    ev = np.zeros((cap, 4), np.float32)
    ev[:n, 0] = np.sort(rng.uniform(0, 5e4, n))
    ev[:n, 1] = rng.randint(0, w, n)
    ev[:n, 2] = rng.randint(0, h, n)
    ev[:n, 3] = rng.choice([0.0, 1.0, -1.0], n)
    if kind == "skewed":               # crowded into two rows
        ev[:n, 2] = rng.randint(h // 2, h // 2 + 2, n)
    elif kind == "one_pixel":
        ev[:n, 1], ev[:n, 2] = w // 3, h - 1
    elif kind == "out_of_frame":
        ev[:n, 1] = rng.randint(-5, w + 5, n)
        ev[:n, 2] = rng.randint(-5, h + 5, n)
    elif kind == "equal_stamps":
        ev[:n, 0] = 42.0
    elif kind == "garbage_padding":
        ev[n:] = rng.uniform(-1e3, 1e3, (cap - n, 4))
    return ev, n


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "one_pixel", "out_of_frame",
                                  "equal_stamps", "empty", "garbage_padding"])
@pytest.mark.parametrize("bins,w,h,slab_bytes", [
    (5, 48, 16, 400),                  # column tiles
    (3, 30, 20, 1440),                 # four rows a tile
    (4, 34, 13, 5 * 34 * 16),          # ragged last row tile
])
def test_mirror_equals_plain_bit_for_bit(kind, fmt, bins, w, h, slab_bytes):
    ev, n = _stream(kind, bins + w, 2048, w, h)
    ev_t = torch.from_numpy(ev)
    got = tiled_voxelize_reference(ev_t, n, bins, w, h, fmt, slab_bytes).numpy()
    want = voxelize_padded_reference(ev_t, n, bins, w, h)
    want = (want.permute(1, 2, 0).contiguous() if fmt == "HWC" else want).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (kind == "empty") != bool(got.any())


def test_mirror_matches_pallas_k1_with_out_of_frame_events():
    """``voxelize_device`` (K1's TPU kernel) in interpret mode."""
    rng = np.random.RandomState(0)
    cap, n, bins, w, h = 2048, 1900, 5, 160, 48
    ev, _ = _stream("uniform", 1, cap, w, h)
    ev[:n, 1] = rng.randint(-4, w + 4, n)
    ev[:n, 2] = rng.randint(-4, h + 4, n)
    ev[n:] = 0.0
    want = np.asarray(voxel_pallas.voxelize_device(
        jnp.asarray(ev), jnp.int32(n), num_bins=bins, width=w, height=h, chunk=512,
        interpret=True))
    got = tiled_voxelize_reference(torch.from_numpy(ev), n, bins, w, h, "CHW", 4 * bins * 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_mirror_matches_pallas_k2(monkeypatch, fmt):
    """``events_to_voxel_grid_pallas`` (K2's TPU kernel) in interpret mode,
    out-of-frame x included."""
    monkeypatch.setattr(voxel_pallas.pl, "pallas_call",
                        functools.partial(voxel_pallas.pl.pallas_call, interpret=True))
    bins, w, h, n = 5, 48, 16, 1500
    ev, _ = _stream("uniform", 2, n + n // 7, w, h)     # n events, no padding
    ev = ev[:n].copy()
    ev[:, 1] = np.random.RandomState(7).randint(-4, w + 4, n)
    want = voxel_pallas.events_to_voxel_grid_pallas(ev, bins, w, h, fmt, chunk=256)
    got = tiled_voxelize_reference(torch.from_numpy(ev), n, bins, w, h, fmt, 400)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(
        got.numpy(), events_to_voxel_grid_reference(torch.from_numpy(ev), bins, w, h,
                                                    fmt).numpy())
