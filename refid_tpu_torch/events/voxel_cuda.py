"""Wrapper of the CUDA voxelizer ``csrc/voxelize.cu``.

The Hopper counterpart of ``refid_tpu/events/voxel_pallas.py::voxelize_device``.
Its plain PyTorch version is ``events/voxel.py::voxelize_padded_reference``;
the two are held together on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  ``LAUNCHES`` counts kernel launches, so a run
can show that the serving path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from refid_tpu_torch.events.voxel import check_event_buffer

__all__ = ["LAUNCHES", "voxelize_cuda"]

LAUNCHES = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from refid_tpu_torch.ops.build import load
        lib = load("voxelize")
        lib.refid_voxelize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.refid_voxelize.restype = ctypes.c_int
        lib.refid_cuda_error_string.argtypes = [ctypes.c_int]
        lib.refid_cuda_error_string.restype = ctypes.c_char_p
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
    if err != 0:
        msg = lib.refid_cuda_error_string(err).decode()
        raise RuntimeError(f"voxelize kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return grid
