"""Wrappers of the CUDA voxelizers in ``csrc/voxelize.cu``.

* :func:`voxelize_cuda` (K1) is the Hopper counterpart of
  ``refid_tpu/events/voxel_pallas.py::voxelize_device``: a padded CUDA
  event buffer in, a CHW grid on the card out.  Plain version:
  ``events/voxel.py::voxelize_padded_reference``.  ``LAUNCHES`` counts its
  launches, so a run can show that the serving path went through it.
* :func:`events_to_voxel_grid_cuda` (K2) is the counterpart of
  ``voxel_pallas.py::events_to_voxel_grid_pallas``: numpy events in, a
  numpy CHW or HWC grid out.  It copies the events up through pinned
  memory, launches on the current stream, and copies the grid back into
  pinned memory that the returned array keeps alive.  Plain version:
  ``events/voxel.py::events_to_voxel_grid_reference``.  ``GRID_LAUNCHES``
  counts its launches (the training datasets call it once per item), and
  ``GRID_TIMES`` sums, over those calls, the upload, the zeroing plus
  kernel, and the copy back, in milliseconds of CUDA events.

Each plain version is held against its kernel on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  The counters are
safe to update from the data loader's threads.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from refid_tpu_torch.events.voxel import check_event_buffer, check_host_events
from refid_tpu_torch.ops.build import load, raise_on_error

__all__ = ["LAUNCHES", "GRID_LAUNCHES", "GRID_TIMES", "voxelize_cuda",
           "events_to_voxel_grid_cuda", "reset_grid_stats"]

LAUNCHES = 0
GRID_LAUNCHES = 0
GRID_TIMES = {"upload_ms": 0.0, "kernel_ms": 0.0, "copy_ms": 0.0}
_stats_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("voxelize")
        lib.refid_voxelize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.refid_voxelize.restype = ctypes.c_int
        lib.refid_voxel_grid.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.refid_voxel_grid.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    lib = _library()
    grid = torch.zeros((bins, height, width), dtype=torch.float32,
                       device=events.device)
    with torch.cuda.device(events.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_voxelize(events.data_ptr(), n_valid, bins, width,
                                 height, grid.data_ptr(), stream)
    raise_on_error(lib, err, "voxelize")
    LAUNCHES += 1
    return grid


def reset_grid_stats() -> None:
    """Set ``GRID_LAUNCHES`` and ``GRID_TIMES`` to zero."""
    global GRID_LAUNCHES
    with _stats_lock:
        GRID_LAUNCHES = 0
        for key in GRID_TIMES:
            GRID_TIMES[key] = 0.0


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
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record(stream)
        # pinned staging rows (16-byte aligned), then a copy the host need
        # not wait for
        staged = torch.from_numpy(np.ascontiguousarray(events)).pin_memory()
        ev = staged.to(device, non_blocking=True)
        marks[1].record(stream)
        grid = torch.zeros(shape, dtype=torch.float32, device=device)
        err = lib.refid_voxel_grid(ev.data_ptr(), n, num_bins, width, height,
                                   int(hwc), grid.data_ptr(), stream.cuda_stream)
        raise_on_error(lib, err, "voxel_grid")
        marks[2].record(stream)
        host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        host.copy_(grid, non_blocking=True)
        marks[3].record(stream)
        marks[3].synchronize()
    with _stats_lock:
        GRID_LAUNCHES += 1
        GRID_TIMES["upload_ms"] += marks[0].elapsed_time(marks[1])
        GRID_TIMES["kernel_ms"] += marks[1].elapsed_time(marks[2])
        GRID_TIMES["copy_ms"] += marks[2].elapsed_time(marks[3])
    return host.numpy()
