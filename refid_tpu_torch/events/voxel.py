"""Event stream -> temporal-bin voxel grid (mirrors ``refid_tpu/events/voxel.py``).

Contract (``refid_tpu/events/voxel.py::_voxelize_padded`` and
``refid_tpu/events/voxel_pallas.py::voxelize_device``): ``events`` is a
``(CAP, 4)`` float32 buffer of time-sorted ``[t, x, y, p]`` rows whose rows
``>= n_valid`` are padding.  Timestamps are rescaled to ``[0, bins-1]`` from
the first and last valid stamps (a zero span counts as 1), polarity 0 becomes
-1, and each event votes ``p*(1-dt)`` into bin ``floor(t)`` and ``p*dt`` into
bin ``floor(t)+1`` at pixel ``(y, x)``; a vote whose bin lies outside
``[0, bins)`` is dropped (``floor`` truncates toward zero, so a stamp at
least a bin before the first one, on an unsorted stream, keeps only its
right vote in bin 0, as ``native/voxelize.cc`` and the Pallas kernel do).
Returns a ``(bins, height, width)`` float32 grid.

Out-of-frame events (truncated x outside ``[0, width)`` or y outside
``[0, height)``) are DROPPED, as the Pallas kernel and the C++ host
voxelizer (``native/voxelize.cc``) drop them.  ``_voxelize_padded`` instead
lets the flat index of an x >= width event wrap into the next row; the two
agree on every in-frame stream.

Two implementations behind one dispatcher, :func:`voxelize_padded`:
  * :func:`voxelize_padded_reference` — plain PyTorch (``index_add_`` on a
    flat grid); runs for CPU tensors and is the yardstick of the kernel.
  * ``voxel_cuda.voxelize_cuda`` — the hand-written CUDA kernel K1
    (``csrc/voxelize.cu``); runs for CUDA tensors.
:func:`events_to_voxel_grid_padded` is its host-array entry: numpy events
padded on the device to a power-of-two capacity, the grid left there.

The host-array contract (``refid_tpu/events/voxel.py::events_to_voxel_grid``
and its Pallas twin ``voxel_pallas.py::events_to_voxel_grid_pallas``) is
:func:`events_to_voxel_grid`: numpy ``(N, 4)`` events in, a numpy grid out,
``CHW`` or ``HWC``.  On a CUDA device it runs the CUDA kernel K2
(``voxel_cuda.events_to_voxel_grid_cuda``); on the CPU its plain version
:func:`events_to_voxel_grid_reference`.  The datasets call it per item.

The JAX package's host path rescales timestamps in double in its C++
voxelizer (``native/voxelize.cc``) and in float32 in numpy; the port does it
in float32, like the numpy path and the TPU kernels.

Both kernels build the grid tile by tile in shared memory (``csrc/voxelize.cu``).
:func:`voxel_tile_plan` is their tile plan and :func:`tiled_voxelize_reference`
a plain mirror of the design (the same plan, a stable counting sort of the
kept events by tile, each slab accumulated and then placed); the CPU tests
hold it bit for bit against :func:`voxelize_padded_reference`.  The main
path never runs it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from refid_tpu_torch.core.device import resolve_device
from refid_tpu_torch.core.timer import span

__all__ = ["voxelize_padded", "voxelize_padded_reference", "voxel_norm",
           "pad_events", "next_capacity", "events_to_voxel_grid_padded",
           "events_to_voxel_grid", "events_to_voxel_grid_reference",
           "voxel_norm_np", "event_reverse", "filter_event", "SLAB_BYTES",
           "TilePlan", "voxel_tile_plan", "tiled_voxelize_reference"]

# A tile's shared-memory slab: 60 KB is half a 1280-px row of 24 bins, so
# three blocks share an SM (csrc/voxelize.cu)
SLAB_BYTES = 61440
MAX_SHARED_BYTES = 232448 - 1024   # dynamic shared memory a block may use on sm_90
SORT_CHUNK = 4096                  # events a sort block orders (kSortChunk)


def check_event_buffer(events: torch.Tensor, n_valid: int, bins: int,
                       width: int, height: int) -> None:
    """Raise on a buffer or geometry outside the voxelizer's contract."""
    if events.dtype != torch.float32:
        raise TypeError(f"events must be float32, got {events.dtype}")
    if events.dim() != 2 or events.shape[1] != 4 or events.shape[0] < 1:
        raise ValueError(f"events must be (CAP>=1, 4), got {tuple(events.shape)}")
    if not 0 <= n_valid <= events.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {events.shape[0]}]")
    if bins < 1 or width < 1 or height < 1:
        raise ValueError(f"bad grid geometry bins={bins} {width}x{height}")


def voxelize_padded_reference(events: torch.Tensor, n_valid: int, bins: int,
                              width: int, height: int) -> torch.Tensor:
    """Plain PyTorch voxelizer over a padded ``(CAP, 4)`` event buffer."""
    check_event_buffer(events, n_valid, bins, width, height)
    cap = events.shape[0]
    t = events[:, 0]
    first = t[0]
    last = t[max(n_valid - 1, 0)]
    delta = last - first
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    # same f32 operation order as refid_tpu/events/voxel.py:119
    ts = (bins - 1) * (t - first) / delta

    xs = events[:, 1].to(torch.int64)          # truncation toward zero
    ys = events[:, 2].to(torch.int64)
    pols = events[:, 3]
    pols = torch.where(pols == 0, torch.full_like(pols, -1.0), pols)
    tis = ts.to(torch.int64)
    dts = ts - tis.to(ts.dtype)

    # each vote is kept iff its own bin lies in [0, bins): at ti = -1 (a
    # stamp before the first one, on an unsorted stream) only the right vote
    ok = ((torch.arange(cap, device=events.device) < n_valid)
          & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height))
    left_ok = ok & (tis >= 0) & (tis < bins)
    right_ok = ok & (tis >= -1) & (tis + 1 < bins)

    plane = width * height
    size = bins * plane
    flat = xs + ys * width + tis * plane
    zero = torch.zeros_like(ts)
    # masked votes go to a spill slot past the grid, which is cut off below
    grid = torch.zeros(size + 1, dtype=torch.float32, device=events.device)
    grid.index_add_(0, torch.where(left_ok, flat, size),
                    torch.where(left_ok, pols * (1.0 - dts), zero))
    grid.index_add_(0, torch.where(right_ok, flat + plane, size),
                    torch.where(right_ok, pols * dts, zero))
    return grid[:size].view(bins, height, width)


class TilePlan(NamedTuple):
    """``tile_rows`` x ``tile_cols`` pixels a tile; ``tiles_x`` x
    ``tiles_y`` tiles, numbered row-major."""
    tile_rows: int
    tile_cols: int
    tiles_x: int
    tiles_y: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def voxel_tile_plan(bins: int, width: int, height: int,
                    slab_bytes: int = SLAB_BYTES) -> TilePlan:
    """The kernels' tile plan (``csrc/voxelize.cu::make_plan``), the same
    for CHW and HWC: the most whole rows whose ``bins`` float32 slab fits
    ``slab_bytes``, else one row split into the fewest equal column tiles
    that fit."""
    if bins < 1 or width < 1 or height < 1:
        raise ValueError(f"bad grid geometry bins={bins} {width}x{height}")
    if slab_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"slab of {slab_bytes} bytes > {MAX_SHARED_BYTES} of shared memory")
    max_px = slab_bytes // (4 * bins)
    if max_px < 1:
        raise ValueError(f"a {slab_bytes}-byte slab holds no pixel of {bins} bins")
    if width <= max_px:
        rows, cols = min(height, max_px // width), width
    else:
        parts = -(-width // max_px)
        rows, cols = 1, -(-width // parts)
    plan = TilePlan(rows, cols, -(-width // cols), -(-height // rows))
    # a sort block holds its chunk and a counter per tile, and one more
    if SORT_CHUNK * 16 + (plan.num_tiles + 1) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{plan.num_tiles} tiles: too many for the sort pass")
    return plan


def tiled_voxelize_reference(events: torch.Tensor, n_valid: int, bins: int,
                             width: int, height: int, return_format: str = "CHW",
                             slab_bytes: int = SLAB_BYTES) -> torch.Tensor:
    """Plain mirror of the kernels' design: the grid of
    :func:`voxelize_padded_reference` (``CHW``, or ``HWC`` as
    ``(height, width, bins)``), computed tile by tile.  The kept events are
    sorted stably by tile (the kernels sort each chunk of events by tile and
    the tile pass reads the tile's run of every chunk in chunk order: the
    same order when each chunk's sort is stable); each tile's slab, laid
    out like the grid, takes its events' left votes, then their right
    votes, in event order, and is then placed.  A cell's votes are
    therefore summed in the plain version's order."""
    check_event_buffer(events, n_valid, bins, width, height)
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    plan = voxel_tile_plan(bins, width, height, slab_bytes)
    t = events[:, 0]
    first = t[0]
    delta = t[max(n_valid - 1, 0)] - first
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    ev = events[:n_valid]
    ts = (bins - 1) * (ev[:, 0] - first) / delta
    xs = ev[:, 1].to(torch.int64)
    ys = ev[:, 2].to(torch.int64)
    pols = torch.where(ev[:, 3] == 0, torch.full_like(ev[:, 3], -1.0), ev[:, 3])
    tis = ts.to(torch.int64)
    dts = ts - tis.to(ts.dtype)
    left, right = pols * (1.0 - dts), pols * dts

    # the binning passes: a stable counting sort of the kept events by tile
    keep = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height) & (tis >= -1)
    kept = keep.nonzero().squeeze(1)
    tile = (ys[kept] // plan.tile_rows) * plan.tiles_x + xs[kept] // plan.tile_cols
    order = kept[torch.sort(tile, stable=True).indices]
    offsets = [0] + torch.bincount(tile, minlength=plan.num_tiles).cumsum(0).tolist()

    # the tile pass; a cell no tile writes would stay NaN
    hwc = return_format == "HWC"
    shape = (height, width, bins) if hwc else (bins, height, width)
    grid = torch.full(shape, float("nan"), dtype=torch.float32, device=events.device)
    for k in range(plan.num_tiles):
        y0 = k // plan.tiles_x * plan.tile_rows
        x0 = k % plan.tiles_x * plan.tile_cols
        rows, cols = min(plan.tile_rows, height - y0), min(plan.tile_cols, width - x0)
        seg = order[offsets[k]:offsets[k + 1]]
        px = (ys[seg] - y0) * cols + (xs[seg] - x0)
        ti = tis[seg]
        cell = px * bins + ti if hwc else ti * (rows * cols) + px
        step = 1 if hwc else rows * cols          # from bin ti to ti + 1
        slab = torch.zeros(rows * cols * bins, dtype=torch.float32, device=events.device)
        ok = (ti >= 0) & (ti < bins)         # ti = -1: no left vote
        slab.index_add_(0, cell[ok], left[seg][ok])
        ok = ti + 1 < bins
        slab.index_add_(0, cell[ok] + step, right[seg][ok])
        if hwc:
            grid[y0:y0 + rows, x0:x0 + cols] = slab.view(rows, cols, bins)
        else:
            grid[:, y0:y0 + rows, x0:x0 + cols] = slab.view(bins, rows, cols)
    return grid


def voxelize_padded(events: torch.Tensor, n_valid: int, bins: int,
                    width: int, height: int) -> torch.Tensor:
    """Voxelize on the events' device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if events.device.type == "cuda":
        from refid_tpu_torch.events.voxel_cuda import voxelize_cuda
        return voxelize_cuda(events, n_valid, bins, width, height)
    if events.device.type == "cpu":
        return voxelize_padded_reference(events, n_valid, bins, width, height)
    raise ValueError(f"no voxelizer for device {events.device}")


def pad_events(events, capacity: int, device) -> Tuple[torch.Tensor, int]:
    """``(N, 4)`` host events in a zeroed ``(capacity, 4)`` float32 buffer
    on ``device``, and N; only the events cross the bus."""
    events = np.ascontiguousarray(events, dtype=np.float32)
    if events.ndim != 2 or events.shape[1] != 4:
        raise ValueError(f"events must be (N, 4), got {events.shape}")
    n = events.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} events")
    padded = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    if n:
        padded[:n] = torch.from_numpy(events).to(device)
    return padded, n


def next_capacity(n: int, least: int) -> int:
    """The next power of two >= ``n``, and at least ``least``."""
    return max(least, 1 << int(np.ceil(np.log2(max(n, 1)))))


def events_to_voxel_grid_padded(events, num_bins: int, width: int, height: int,
                                return_format: str = "CHW",
                                capacity: Optional[int] = None,
                                device="cuda") -> torch.Tensor:
    """The padded-capacity device entry (``refid_tpu/events/voxel.py::
    events_to_voxel_grid_jax``): ``(N, 4)`` time-sorted host events, padded
    on ``device`` to ``capacity`` rows (default: the next power of two, at
    least 1024), voxelized there by :func:`voxelize_padded` (the CUDA
    kernel K1 on a CUDA device, the plain version on the CPU).  Returns the
    grid on ``device``: ``(bins, h, w)`` for ``CHW``, a ``(h, w, bins)``
    view of it for ``HWC``.  ``device`` defaults to ``'cuda'`` and raises
    when no CUDA device is present."""
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    device = resolve_device(device)
    if capacity is None:
        capacity = next_capacity(len(events), 1024)
    padded, n = pad_events(events, capacity, device)
    grid = voxelize_padded(padded, n, num_bins, width, height)
    return grid if return_format == "CHW" else grid.permute(1, 2, 0)


def voxel_norm(voxel: torch.Tensor) -> torch.Tensor:
    """Zero-mean / unit-std normalization over the NONZERO entries; an
    all-zero grid is returned unchanged (``refid_tpu/events/voxel.py::
    voxel_norm`` and the pipeline's ``norm_voxel`` branch)."""
    nonzero = voxel != 0
    count = nonzero.sum().clamp(min=1)
    mean = voxel.sum() / count
    std = torch.sqrt((voxel ** 2).sum() / count - mean ** 2)
    return torch.where(nonzero, (voxel - mean) / std, torch.zeros_like(voxel))


def check_host_events(events: np.ndarray, num_bins: int, width: int,
                      height: int, return_format: str) -> None:
    """Raise on host events or a geometry outside the host-array contract."""
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    if events.ndim != 2 or events.shape[1] != 4:
        raise ValueError(f"events must be (N, 4), got {events.shape}")
    if num_bins < 1 or width < 1 or height < 1:
        raise ValueError(f"bad grid geometry bins={num_bins} {width}x{height}")


def events_to_voxel_grid_reference(events: torch.Tensor, num_bins: int,
                                   width: int, height: int,
                                   return_format: str = "CHW") -> torch.Tensor:
    """Plain PyTorch version of the host-array voxelizer: ``(N, 4)`` float32
    events (any N, on any device) -> a ``(bins, h, w)`` or ``(h, w, bins)``
    grid on the same device."""
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    n = events.shape[0]
    if n == 0:
        grid = torch.zeros((num_bins, height, width), dtype=torch.float32,
                           device=events.device)
    else:
        grid = voxelize_padded_reference(events, n, num_bins, width, height)
    return grid if return_format == "CHW" else grid.permute(1, 2, 0).contiguous()


def events_to_voxel_grid(events, num_bins: int, width: int, height: int,
                         return_format: str = "CHW",
                         device="cuda") -> np.ndarray:
    """Voxelize an ``(N, 4)`` numpy array of time-sorted ``[t, x, y, p]``
    events into a float32 numpy grid, ``(bins, h, w)`` for ``CHW`` or
    ``(h, w, bins)`` for ``HWC``.  ``device`` ``'cuda'`` (the default) runs
    the CUDA kernel and raises without a CUDA device; ``'cpu'`` runs the
    plain version.  The voxelization, copy back included, is the profiler
    span ``refid.events.k2``."""
    events = np.ascontiguousarray(events, dtype=np.float32)
    check_host_events(events, num_bins, width, height, return_format)
    device = torch.device(device)
    with span("refid.events.k2"):
        if device.type == "cuda":
            from refid_tpu_torch.events.voxel_cuda import events_to_voxel_grid_cuda
            return events_to_voxel_grid_cuda(events, num_bins, width, height,
                                             return_format, device)
        if device.type == "cpu":
            return events_to_voxel_grid_reference(
                torch.from_numpy(events), num_bins, width, height,
                return_format).numpy()
    raise ValueError(f"no voxelizer for device {device}")


def voxel_norm_np(voxel: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`voxel_norm` for host pipelines (the JAX
    package's ``voxel_norm_np``); the profiler span
    ``refid.events.voxel_norm``.

    A C-contiguous float32 grid in page-locked host memory, as every grid
    K2 returns (:func:`events_to_voxel_grid` on a CUDA device), is
    normalised on the card (``voxel_cuda.voxel_norm_cuda``, inside the span
    ``refid.events.voxel_norm_card``): the grid was on the card a moment
    before, and the numpy chain's ten passes over fresh host memory take
    tens of milliseconds at 720p against two copies and two launches.  The
    card keeps numpy's float64 formula and sums in float64 (numpy sums in
    float32), so the two agree to about a float32 ulp; the result lies in
    page-locked memory too.  Every other input (pageable memory, a view,
    float64, no CUDA device) takes the numpy chain."""
    with span("refid.events.voxel_norm"):
        if (voxel.dtype == np.float32 and voxel.flags.c_contiguous
                and torch.cuda.is_available() and torch.from_numpy(voxel).is_pinned()):
            from refid_tpu_torch.events.voxel_cuda import voxel_norm_cuda
            with span("refid.events.voxel_norm_card"):
                return voxel_norm_cuda(voxel)
        nonzero = voxel != 0
        num_nonzeros = nonzero.sum()
        if num_nonzeros > 0:
            mean = voxel.sum() / num_nonzeros
            stddev = np.sqrt((voxel ** 2).sum() / num_nonzeros - mean ** 2)
            voxel = np.where(nonzero, (voxel - mean) / stddev, 0.0).astype(voxel.dtype)
        return voxel


def event_reverse(events: np.ndarray) -> np.ndarray:
    """Reverse the temporal direction of an ``[t, x, y, p]`` stream:
    timestamps become ``t_max - t`` (ascending again), polarities negate;
    the input is not changed."""
    events = np.asarray(events)
    out = np.empty_like(events)
    out[:, 0] = (events[-1, 0] - events[:, 0])[::-1]
    out[:, 1] = events[::-1, 1]
    out[:, 2] = events[::-1, 2]
    out[:, 3] = -events[::-1, 3]
    return out


def filter_event(x, y, p, t, s_e_index=(0, 6)):
    """Keep events whose discretized timestamp index lies in ``s_e_index``
    (both ends inclusive)."""
    t_1 = t.squeeze(1) if t.ndim == 2 else t
    _, inverse = np.unique(t_1, return_inverse=True)
    counts = np.bincount(inverse)
    start = int(np.sum(counts[: s_e_index[0]]))
    end = int(np.sum(counts[: s_e_index[1] + 1]))
    return x[start:end], y[start:end], p[start:end], t[start:end]
