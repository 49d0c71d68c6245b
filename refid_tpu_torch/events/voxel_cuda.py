"""Wrappers of the CUDA voxelizers in ``csrc/voxelize.cu``.

Both kernels share one design: a sort of the kept events by tile of the
grid, on the card (each block of ``SORT_CHUNK`` events counting-sorted in
shared memory and written back contiguous, with its per-tile offsets),
then one block per tile that gathers the tile's run from every chunk,
accumulates its votes in a shared-memory slab and writes the slab once,
zeros included.  The grid is allocated uninitialised: the tile pass writes
every float.  The tile plan is ``events/voxel.py::voxel_tile_plan`` with
``SLAB_BYTES``.  Each call allocates its scratch (the sorted rows and the
chunks' offsets) on the current stream, so concurrent callers on their own
streams share nothing.

* :func:`voxelize_cuda` (K1) is the Hopper counterpart of
  ``refid_tpu/events/voxel_pallas.py::voxelize_device``: a padded CUDA
  event buffer in, a CHW grid on the card out.  Plain version:
  ``events/voxel.py::voxelize_padded_reference``.  ``LAUNCHES`` counts its
  voxelizations (one a call, each two kernel launches), so a
  run can show that the serving path went through it.
* :func:`events_to_voxel_grid_cuda` (K2) is the counterpart of
  ``voxel_pallas.py::events_to_voxel_grid_pallas``: numpy events in, a
  numpy CHW or HWC grid out.  It copies the events up through pinned
  memory, voxelizes on the current stream, and copies the grid back into
  pinned memory that the returned array keeps alive.  Plain version:
  ``events/voxel.py::events_to_voxel_grid_reference``.  ``GRID_LAUNCHES``
  counts its voxelizations (the training datasets call it once per item).
  It records no timing events: the upload, kernel and copy-back split is
  read from the profiler's device activities.
* :func:`voxel_norm_cuda` (``csrc/voxel_norm.cu``, its own library) is the
  card path of ``events/voxel.py::voxel_norm_np``, which replaces no TPU
  kernel: a C-contiguous float32 grid in page-locked host memory (as K2
  returns it) is copied up, normalised over its nonzero cells in numpy's
  float64 formula by a statistics kernel and an apply kernel, and copied
  back into fresh pinned memory.  Plain version: ``voxel_norm_np``'s numpy
  chain.  ``NORM_LAUNCHES`` counts its normalisations.

Each plain version is held against its kernel on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  The counters are
safe to update from the data loader's threads.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from refid_tpu_torch.events.voxel import (
    MAX_SHARED_BYTES, SLAB_BYTES, SORT_CHUNK, TilePlan, check_event_buffer,
    check_host_events, voxel_tile_plan,
)
from refid_tpu_torch.ops.build import bind, current_stream, launch, load, raise_on_error

__all__ = ["LAUNCHES", "GRID_LAUNCHES", "NORM_LAUNCHES", "voxelize_cuda",
           "events_to_voxel_grid_cuda", "reset_grid_stats", "kernel_tile_plan",
           "voxel_norm_cuda", "reset_norm_stats"]

LAUNCHES = 0
GRID_LAUNCHES = 0
NORM_LAUNCHES = 0
_stats_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"refid_voxel_plan": [_I, _I, _I, _I, _P], "refid_voxel_sort_chunk": [],
               "refid_voxelize": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]}
_fns = {}        # C function name -> bound function, filled at first use
_norm_fns = {}   # the same for csrc/voxel_norm.cu


def _bound(fn: str):
    if not _fns:
        _fns.update(bind("voxelize", _SIGNATURES))
    return _fns[fn]


def kernel_tile_plan(bins: int, width: int, height: int,
                     slab_bytes: int = SLAB_BYTES) -> TilePlan:
    """The kernels' own tile plan (``make_plan`` in the library), which
    ``voxel_tile_plan`` mirrors."""
    plan = (ctypes.c_int * 4)()
    raise_on_error(load("voxelize"),
                   _bound("refid_voxel_plan")(bins, width, height, slab_bytes, plan),
                   "voxel_plan")
    return TilePlan(*plan)


def _voxelize(events: torch.Tensor, n: int, bins: int, width: int, height: int,
              hwc: bool = False, slab_bytes: int = SLAB_BYTES) -> torch.Tensor:
    """One voxelization of the first ``n`` rows of a 16-byte-aligned CUDA
    buffer on the current stream, not counted in ``LAUNCHES``; returns the
    ``(bins, h, w)`` grid, or ``(h, w, bins)`` for ``hwc``."""
    plan = voxel_tile_plan(bins, width, height, slab_bytes)
    chunks = -(-n // SORT_CHUNK)
    slab_floats = -(-plan.tile_rows * plan.tile_cols * bins // 32) * 32
    if 4 * slab_floats + 4 * (2 * chunks + 1) > MAX_SHARED_BYTES:
        raise ValueError(f"{n} events: too many chunks for the tile pass's shared memory")
    shape = (height, width, bins) if hwc else (bins, height, width)
    grid = torch.empty(shape, dtype=torch.float32, device=events.device)
    offsets = torch.empty(max(chunks, 1) * (plan.num_tiles + 1), dtype=torch.int32,
                          device=events.device)
    rows = torch.empty((max(chunks, 1) * SORT_CHUNK, 4), dtype=torch.float32,
                       device=events.device)
    index = events.get_device()
    fn = _fns.get("refid_voxelize") or _bound("refid_voxelize")
    err = launch(fn, index, events.data_ptr(), n, bins, width, height, int(hwc), slab_bytes,
                 offsets.data_ptr(), rows.data_ptr(), grid.data_ptr(), current_stream(index))
    if err:
        raise_on_error(load("voxelize"), err, "voxelize")
    return grid


def voxelize_cuda(events: torch.Tensor, n_valid: int, bins: int, width: int,
                  height: int) -> torch.Tensor:
    """Voxelize a padded ``(CAP, 4)`` CUDA event buffer with the CUDA kernel,
    on the current stream.  Returns a ``(bins, height, width)`` float32 grid
    on the events' device."""
    global LAUNCHES
    check_event_buffer(events, n_valid, bins, width, height)
    if events.device.type != "cuda":
        raise ValueError(f"voxelize_cuda needs a CUDA tensor, got {events.device}")
    if not events.is_contiguous():
        raise ValueError("events must be contiguous")
    if events.data_ptr() % 16:
        raise ValueError("events must be 16-byte aligned (rows read as float4)")
    if n_valid >= 2 ** 31:
        raise ValueError("n_valid must fit the kernel's 32-bit int")
    grid = _voxelize(events, n_valid, bins, width, height)
    LAUNCHES += 1
    return grid


def reset_grid_stats() -> None:
    """Set ``GRID_LAUNCHES`` to zero."""
    global GRID_LAUNCHES
    with _stats_lock:
        GRID_LAUNCHES = 0


def events_to_voxel_grid_cuda(events: np.ndarray, num_bins: int, width: int,
                              height: int, return_format: str = "CHW",
                              device="cuda") -> np.ndarray:
    """Voxelize an ``(N, 4)`` float32 numpy array of time-sorted
    ``[t, x, y, p]`` events on the card with K2; returns the float32 numpy
    grid, ``(bins, h, w)`` for ``CHW`` or ``(h, w, bins)`` for ``HWC``.
    Blocks until the grid is on the host."""
    global GRID_LAUNCHES
    if not isinstance(events, np.ndarray) or events.dtype != np.float32:
        raise TypeError("events must be a float32 numpy array")
    check_host_events(events, num_bins, width, height, return_format)
    n = events.shape[0]
    if n >= 2 ** 31:
        raise ValueError("N must fit the kernel's 32-bit int")
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"events_to_voxel_grid_cuda needs a CUDA device, got {device}")
    hwc = return_format == "HWC"
    shape = (height, width, num_bins) if hwc else (num_bins, height, width)
    if n == 0:   # as the TPU entry: no launch, an empty grid
        return np.zeros(shape, np.float32)
    with torch.cuda.device(device):
        # pinned staging rows (16-byte aligned), then a copy the host need
        # not wait for
        staged = torch.from_numpy(np.ascontiguousarray(events)).pin_memory()
        ev = staged.to(device, non_blocking=True)
        grid = _voxelize(ev, n, num_bins, width, height, hwc)
        host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        host.copy_(grid, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    with _stats_lock:
        GRID_LAUNCHES += 1
    return host.numpy()


def reset_norm_stats() -> None:
    """Set ``NORM_LAUNCHES`` to zero."""
    global NORM_LAUNCHES
    with _stats_lock:
        NORM_LAUNCHES = 0


def _voxel_norm(grid: torch.Tensor):
    """The two kernels on a contiguous float32 CUDA grid of at least one
    float, on the current stream, not counted in ``NORM_LAUNCHES``; returns
    the normalised grid and the float64 scratch, whose last three words get
    ``{count, mean, std}``."""
    if not _norm_fns:
        _norm_fns.update(bind("voxel_norm", {"refid_voxel_norm_scratch": [],
                                             "refid_voxel_norm": [_P, ctypes.c_longlong, _P,
                                                                  _P, _P]}))
    out = torch.empty_like(grid)
    scratch = torch.empty(_norm_fns["refid_voxel_norm_scratch"](), dtype=torch.float64,
                          device=grid.device)
    index = grid.get_device()
    err = launch(_norm_fns["refid_voxel_norm"], index, grid.data_ptr(), grid.numel(),
                 scratch.data_ptr(), out.data_ptr(), current_stream(index))
    if err:
        raise_on_error(load("voxel_norm"), err, "voxel_norm")
    return out, scratch


def voxel_norm_cuda(voxel: np.ndarray) -> np.ndarray:
    """``voxel_norm_np`` of a C-contiguous float32 grid in page-locked host
    memory, on the current CUDA device and stream: a new float32 array in
    page-locked memory, or ``voxel`` itself when it holds no nonzero cell.
    ``voxel`` is not modified.  Blocks until the result is on the host."""
    global NORM_LAUNCHES
    if not isinstance(voxel, np.ndarray) or voxel.dtype != np.float32:
        raise TypeError("voxel must be a float32 numpy array")
    if not voxel.flags.c_contiguous:
        raise ValueError("voxel must be C-contiguous")
    src = torch.from_numpy(voxel)
    if not src.is_pinned():
        raise ValueError("voxel must lie in page-locked host memory")
    out, scratch = _voxel_norm(src.to(torch.device("cuda", torch.cuda.current_device()),
                                      non_blocking=True))
    host = torch.empty(voxel.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(out, non_blocking=True)
    count = scratch[-3].item()      # a read on the same stream: waits for the copy too
    with _stats_lock:
        NORM_LAUNCHES += 1
    return host.numpy() if count else voxel
