"""Wrappers of the probe kernels in ``csrc/passthrough.cu`` and
``csrc/band_conv.cu``.

* :func:`passthrough_cuda` (P1) is the Hopper counterpart of
  ``scripts/probe_poison.py::pallas_op``: ``2x + 1`` over bands of rows.
* :func:`passthrough_slice_cuda` (P2), of ``probe_poison.py::tiny_pallas``:
  ``2x + 1`` in place on the :data:`WINDOW` ``d[0, 0, :8, :128]``, read
  from ``d``'s pointer and strides (no view is built: four indexing ops a
  call cost more host time than the launch).
* :func:`band_conv_cuda` (P3 and P4), of ``scripts/probe_band_conv.py::
  band_conv`` and ``band_conv_int8``: the width-folded 3x3 conv of one band
  at a time as 9 tap products.  Its host-side steps are plain functions the
  CPU tests reach: :func:`pack_taps` (the weights as ``(tap, out, in)``),
  :func:`tile_schedule` and :func:`tile_source_rows` (which rows each tile's
  TMA box reads, the roll's wrap rows patched), mirroring the kernel.

Each checks device, type, shape, contiguity and alignment, launches on the
current stream through the shared launch path of ``ops/build.py`` (the C
functions bound once, the raw stream handle, the device made current only
when another one is), raises if the launch failed, and counts its launches
in ``PASSTHROUGH_LAUNCHES``, ``SLICE_LAUNCHES``, ``BAND_CONV_LAUNCHES`` or
``BAND_CONV_INT8_LAUNCHES``.  The plain versions, and the dispatchers that
choose between kernel and plain version by the tensor's device, are in
``refid_tpu_torch/probes/``.
"""

from __future__ import annotations

import ctypes

import torch

from refid_tpu_torch.ops.build import bind, current_stream, launch, load, raise_on_error

__all__ = ["PASSTHROUGH_LAUNCHES", "SLICE_LAUNCHES", "BAND_CONV_LAUNCHES",
           "BAND_CONV_INT8_LAUNCHES", "TILE_ROWS", "WINDOW", "reset_launches", "passthrough_cuda",
           "passthrough_slice_cuda", "pack_taps", "tile_schedule", "tile_source_rows",
           "band_conv_cuda"]

PASSTHROUGH_LAUNCHES = 0
SLICE_LAUNCHES = 0
BAND_CONV_LAUNCHES = 0
BAND_CONV_INT8_LAUNCHES = 0
_fns = {}        # C function name -> bound function, filled at first launch
# interior rows per tile (kWindow - 8 of Cfg<mode> in csrc/band_conv.cu), by
# mode: 0 bf16, 1 bf16 x quantized in the kernel, 2 int8 x
TILE_ROWS = {0: 248, 1: 120, 2: 248}
# P2's window, rows x columns: the TPU script's d[0, :8, :128, 0]
WINDOW = (8, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {      # library -> {function: argtypes}; each returns a CUDA error code
    "passthrough": {"refid_passthrough": [_P, _LL, _LL, _I, _I, _I, _P, _P],
                    "refid_passthrough_slice": [_P, _I, _I, _LL, _LL, _I, _P]},
    "band_conv": {"refid_band_conv": [_P, _P, _I, _I, _I, _I, _I, _P, _P]},
}
_LIBRARY = {fn: lib for lib, fns in _SIGNATURES.items() for fn in fns}


def _bound(fn: str):
    """The C function ``fn``, bound at its first launch."""
    bound = _fns.get(fn)
    if bound is None:
        _fns.update(bind(_LIBRARY[fn], _SIGNATURES[_LIBRARY[fn]]))
        bound = _fns[fn]
    return bound


def _raise(err: int, fn: str) -> None:
    raise_on_error(load(_LIBRARY[fn]), err, fn[len("refid_"):])


def _device_index(t: torch.Tensor, what: str) -> int:
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")
    return t.get_device()


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
    index = _device_index(x, "passthrough_cuda")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"passthrough_cuda takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("passthrough_cuda needs a contiguous or channels_last tensor")
    if band < 1 or n_rows < 1 or x.numel() % n_rows:
        raise ValueError(f"{x.numel()} elements do not split into {n_rows} rows, band {band}")
    y = torch.empty_like(x)                       # same strides: dense, same order
    if x.numel() == 0:
        return y
    row_elems = x.numel() // n_rows
    x_ptr, y_ptr = x.data_ptr(), y.data_ptr()
    vec = x_ptr % 16 == 0 and y_ptr % 16 == 0 and band * row_elems * x.element_size() % 16 == 0
    fn = _fns.get("refid_passthrough") or _bound("refid_passthrough")
    err = launch(fn, index, x_ptr, n_rows, row_elems, band, code, int(vec), y_ptr,
                 current_stream(index))
    if err:
        _raise(err, "refid_passthrough")
    PASSTHROUGH_LAUNCHES += 1
    return y


def passthrough_slice_cuda(d: torch.Tensor) -> torch.Tensor:
    """P2: ``v = 2 v + 1`` in place on the window ``v = d[0, 0, :8, :128]``
    (:data:`WINDOW`) of a float32 or bf16 ``(N, C, H, W)`` CUDA tensor of
    any strides (the window clipped to H x W, as the slice is); returns
    ``d``."""
    global SLICE_LAUNCHES
    index = _device_index(d, "passthrough_slice_cuda")
    code = _DTYPE_CODE.get(d.dtype)
    if code is None or d.dim() != 4:
        raise TypeError(f"passthrough_slice_cuda takes a 4-D float32 or bfloat16 tensor, "
                        f"got {d.dim()}-D {d.dtype}")
    n, c, h, w = d.shape
    rows, cols = min(WINDOW[0], h), min(WINDOW[1], w)
    if n * c == 0 or rows < 1 or cols < 1:
        raise IndexError(f"no window d[0, 0, :{rows}, :{cols}] in {tuple(d.shape)}")
    _, _, row_stride, col_stride = d.stride()
    fn = _fns.get("refid_passthrough_slice") or _bound("refid_passthrough_slice")
    err = launch(fn, index, d.data_ptr(), rows, cols, row_stride, col_stride, code,
                 current_stream(index))
    if err:
        _raise(err, "refid_passthrough_slice")
    SLICE_LAUNCHES += 1
    return d


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO taps ``(3, 3, C, C)`` as ``(9 C, C)``: row ``tap C + out`` holds
    the input channels of output ``out`` for tap ``3 dy + dx``, so that the
    kernel's B operand is K-major, as wgmma needs for int8."""
    c = w.shape[-1]
    return w.permute(0, 1, 3, 2).reshape(9 * c, c).contiguous()


def tile_schedule(h: int, wp: int, band: int, tile_rows: int) -> list:
    """The kernel's tiles in order, ``(band index, m0)``: each band's
    ``m2 = (band - 2) wp`` interior rows cut into ``tile_rows`` (the
    mode's :data:`TILE_ROWS`) from ``m0``;
    CTA ``b`` of the persistent grid takes tiles ``b, b + grid, ...``."""
    m2 = (band - 2) * wp
    return [(b, m0) for b in range(h // band) for m0 in range(0, m2, tile_rows)]


def tile_source_rows(m0: int, tap: int, wp: int, band: int, tile_rows: int,
                     rolls: bool) -> torch.Tensor:
    """Rows of the band (flattened to ``(band wp, C)``; may lie outside it)
    that tile ``m0``'s A operand reads for ``tap``.  The kernel loads one TMA
    window per dy from row ``m0 - 1 + dy wp`` and reads it from ``dx`` rows in
    (rolls) or 1, so output row ``i`` reads ``m0 + i + dy wp (+ dx - 1)``;
    the roll's two wrap rows are put right: row 0 at ``dx = 0`` reads
    interior row ``m2 - 1``, row ``m2 - 1`` at ``dx = 2`` reads row 0 (each
    ``+ dy wp``)."""
    dy, dx = divmod(tap, 3)
    m2 = (band - 2) * wp
    rows = torch.arange(tile_rows) + m0 + dy * wp + (dx - 1 if rolls else 0)
    if rolls and dx == 0 and m0 == 0:
        rows[0] = m2 - 1 + dy * wp
    if rolls and dx == 2 and m2 - 1 - m0 < tile_rows:
        rows[m2 - 1 - m0] = dy * wp
    return rows


def band_conv_cuda(x: torch.Tensor, w: torch.Tensor, band: int = 8, rolls: bool = True,
                   int8: bool = False) -> torch.Tensor:
    """P3 (``int8`` False: x and w bf16) or P4 (``int8`` True: w int8, x bf16
    quantized in the kernel or int8 already).  x ``(H, WP, 128)`` HWC, w
    ``(3, 3, 128, 128)`` HWIO, both contiguous on the card; returns the
    ``(H, WP, 128)`` bf16 output.  Packs w with :func:`pack_taps` (one copy
    of 144 or 288 KB) and launches the TMA / wgmma kernel."""
    global BAND_CONV_LAUNCHES, BAND_CONV_INT8_LAUNCHES
    index = _device_index(x, "band_conv_cuda")
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
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (TMA reads it)")
    if h * wp * 128 >= 2 ** 31:
        raise ValueError("x must fit the kernel's 32-bit row index")
    wk = pack_taps(w)
    out = torch.empty((h, wp, 128), dtype=torch.bfloat16, device=x.device)
    fn = _fns.get("refid_band_conv") or _bound("refid_band_conv")
    err = launch(fn, index, x.data_ptr(), wk.data_ptr(), h, wp, band, int(rolls), mode,
                 out.data_ptr(), current_stream(index))
    if err:
        _raise(err, "refid_band_conv")
    if int8:
        BAND_CONV_INT8_LAUNCHES += 1
    else:
        BAND_CONV_LAUNCHES += 1
    return out
