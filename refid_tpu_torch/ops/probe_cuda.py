"""Wrappers of the probe kernels in ``csrc/passthrough.cu`` and
``csrc/band_conv.cu``.

* :func:`passthrough_cuda` (P1) is the Hopper counterpart of
  ``scripts/probe_poison.py::pallas_op``: ``2x + 1`` over bands of rows.
* :func:`passthrough_slice_cuda` (P2), of ``probe_poison.py::tiny_pallas``:
  ``2x + 1`` in place on a strided 2-D view.
* :func:`band_conv_cuda` (P3 and P4), of ``scripts/probe_band_conv.py::
  band_conv`` and ``band_conv_int8``: the width-folded 3x3 conv of one band
  at a time as 9 tap products.

Each checks device, type, shape, contiguity and alignment, launches on the
current stream, raises if the launch failed, and counts its launches in
``PASSTHROUGH_LAUNCHES``, ``SLICE_LAUNCHES``, ``BAND_CONV_LAUNCHES`` or
``BAND_CONV_INT8_LAUNCHES``.  The plain versions, and the dispatchers that
choose between kernel and plain version by the tensor's device, are in
``refid_tpu_torch/probes/``.
"""

from __future__ import annotations

import ctypes

import torch

from refid_tpu_torch.ops.build import load, raise_on_error

__all__ = ["PASSTHROUGH_LAUNCHES", "SLICE_LAUNCHES", "BAND_CONV_LAUNCHES",
           "BAND_CONV_INT8_LAUNCHES", "reset_launches", "passthrough_cuda",
           "passthrough_slice_cuda", "band_conv_cuda"]

PASSTHROUGH_LAUNCHES = 0
SLICE_LAUNCHES = 0
BAND_CONV_LAUNCHES = 0
BAND_CONV_INT8_LAUNCHES = 0
_libs = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {      # library -> {function: argtypes}; each returns a CUDA error code
    "passthrough": {"refid_passthrough": [_P, _LL, _LL, _I, _I, _I, _P, _P],
                    "refid_passthrough_slice": [_P, _I, _I, _LL, _LL, _I, _P]},
    "band_conv": {"refid_band_conv": [_P, _P, _I, _I, _I, _I, _I, _P, _P]},
}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _libs[name] = lib
    return lib


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")


def reset_launches() -> None:
    """Set the four launch counts to zero."""
    global PASSTHROUGH_LAUNCHES, SLICE_LAUNCHES, BAND_CONV_LAUNCHES, BAND_CONV_INT8_LAUNCHES
    PASSTHROUGH_LAUNCHES = SLICE_LAUNCHES = BAND_CONV_LAUNCHES = BAND_CONV_INT8_LAUNCHES = 0


def passthrough_cuda(x: torch.Tensor, n_rows: int, band: int = 8) -> torch.Tensor:
    """P1: ``2x + 1`` of a dense float32 or bf16 CUDA tensor whose storage is
    ``n_rows`` rows of equal length, one CUDA block per ``band`` rows (a
    short last band included).  Returns a new tensor of ``x``'s shape,
    strides and type."""
    global PASSTHROUGH_LAUNCHES
    _require_cuda(x, "passthrough_cuda")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"passthrough_cuda takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("passthrough_cuda needs a contiguous or channels_last tensor")
    if band < 1 or n_rows < 1 or x.numel() % n_rows:
        raise ValueError(f"{x.numel()} elements do not split into {n_rows} rows, band {band}")
    y = torch.empty_like(x)                       # same strides: dense, same order
    if x.numel() == 0:
        return y
    row_elems = x.numel() // n_rows
    vec = (x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
           and band * row_elems * x.element_size() % 16 == 0)
    lib = _library("passthrough")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_passthrough(x.data_ptr(), n_rows, row_elems, band,
                                    _DTYPE_CODE[x.dtype], int(vec), y.data_ptr(), stream)
    raise_on_error(lib, err, "passthrough")
    PASSTHROUGH_LAUNCHES += 1
    return y


def passthrough_slice_cuda(view: torch.Tensor) -> torch.Tensor:
    """P2: ``view = 2 view + 1`` in place, for a 2-D float32 or bf16 CUDA
    view of any strides; returns ``view``."""
    global SLICE_LAUNCHES
    _require_cuda(view, "passthrough_slice_cuda")
    if view.dtype not in _DTYPE_CODE or view.dim() != 2:
        raise TypeError(f"passthrough_slice_cuda takes a 2-D float32 or bfloat16 view, "
                        f"got {view.dim()}-D {view.dtype}")
    rows, cols = view.shape
    if rows * cols == 0:
        return view
    lib = _library("passthrough")
    with torch.cuda.device(view.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_passthrough_slice(view.data_ptr(), rows, cols, view.stride(0),
                                          view.stride(1), _DTYPE_CODE[view.dtype], stream)
    raise_on_error(lib, err, "passthrough_slice")
    SLICE_LAUNCHES += 1
    return view


def band_conv_cuda(x: torch.Tensor, w: torch.Tensor, band: int = 8, rolls: bool = True,
                   int8: bool = False) -> torch.Tensor:
    """P3 (``int8`` False: x and w bf16) or P4 (``int8`` True: w int8, x bf16
    quantized in the kernel or int8 already).  x ``(H, WP, 128)`` HWC, w
    ``(3, 3, 128, 128)`` HWIO, both contiguous on the card; returns the
    ``(H, WP, 128)`` bf16 output."""
    global BAND_CONV_LAUNCHES, BAND_CONV_INT8_LAUNCHES
    _require_cuda(x, "band_conv_cuda")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dim() != 3 or x.shape[2] != 128 or tuple(w.shape) != (3, 3, 128, 128):
        raise ValueError(f"band_conv_cuda takes x (H, WP, 128) and w (3, 3, 128, 128), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    h, wp, _ = x.shape
    if band < 3 or h % band:
        raise ValueError(f"H = {h} must be a multiple of band = {band} >= 3")
    if int8:
        if w.dtype != torch.int8 or x.dtype not in (torch.bfloat16, torch.int8):
            raise TypeError(f"int8 taps take w int8 and x bf16 or int8, got {w.dtype}, {x.dtype}")
        mode = 1 if x.dtype == torch.bfloat16 else 2
    else:
        if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError(f"bf16 taps take bf16 x and w, got {x.dtype}, {w.dtype}")
        mode = 0
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (rows read as 16-byte vectors)")
    if h * wp * 128 >= 2 ** 31:
        raise ValueError("x must fit the kernel's 32-bit row index")
    out = torch.empty((h, wp, 128), dtype=torch.bfloat16, device=x.device)
    lib = _library("band_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_band_conv(x.data_ptr(), w.data_ptr(), h, wp, band, int(rolls),
                                  mode, out.data_ptr(), stream)
    raise_on_error(lib, err, "band_conv")
    if int8:
        BAND_CONV_INT8_LAUNCHES += 1
    else:
        BAND_CONV_LAUNCHES += 1
    return out
