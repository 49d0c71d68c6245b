"""Wrappers of the int8 serving kernels in ``csrc/conv_int8.cu``.

* :func:`quantize_int8_cuda`: an NCHW float32 or bf16 CUDA tensor -> its
  NHWC int8 quantization with the channels padded to ``serve.quant.K_DEPTH``,
  and the ``(1,)`` float32 scale, which stays on the card.  Without
  ``scale`` (dynamic) the amax is reduced on the card first (a second
  kernel launch of the same call).  Plain version:
  ``serve/quant.py::quantize_int8_reference``.
* :func:`conv_int8_cuda`: the implicit-GEMM int8 conv (s8 x s8 -> s32,
  ``mma.sync``) with the rescale, bias and activation fused, NCHW out in
  float32 or bf16.  Plain version: ``serve/quant.py::conv_int8_reference``.

Neither replaces a TPU kernel: the JAX package's int8 conv is XLA's
(``refid_tpu/serve/quant.py::conv_int8``).  Each wrapper checks device, type,
shape and contiguity, launches on the current stream, raises if the launch
failed, and counts its calls in ``QUANTIZE_LAUNCHES`` (one a quantization,
whether it took one kernel or two) or ``CONV_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from refid_tpu_torch.ops.build import load, raise_on_error
from refid_tpu_torch.serve.quant import K_DEPTH, padded_channels

__all__ = ["QUANTIZE_LAUNCHES", "CONV_LAUNCHES", "reset_launches", "quantize_int8_cuda",
           "conv_int8_cuda"]

QUANTIZE_LAUNCHES = 0
CONV_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("conv_int8")
        lib.refid_quantize_int8.argtypes = [_P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P]
        lib.refid_conv_int8.argtypes = [_P, _P, _P, _P, _P] + [_I] * 12 + [_F, _I, _P, _P]
        lib.refid_quantize_int8.restype = lib.refid_conv_int8.restype = _I
        _lib = lib
    return _lib


def reset_launches() -> None:
    """Set both launch counts to zero."""
    global QUANTIZE_LAUNCHES, CONV_LAUNCHES
    QUANTIZE_LAUNCHES = CONV_LAUNCHES = 0


def _check(t: torch.Tensor, what: str, dtypes, dim: int, device=None) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what} needs a CUDA tensor on {device or 'a card'}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {dtypes}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-D tensor, got {tuple(t.shape)}")


def quantize_int8_cuda(x: torch.Tensor, scale: Optional[float] = None):
    """NCHW ``x`` -> (int8 ``(n, h, w, c padded)``, ``(1,)`` float32 scale),
    dynamic when ``scale`` is None."""
    global QUANTIZE_LAUNCHES
    _check(x, "quantize_int8_cuda", tuple(_DTYPE_CODE), 4)
    n, c, h, w = x.shape
    if x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"quantize_int8_cuda takes 1 to 2**31 - 1 elements, got {x.numel()}")
    cp = padded_channels(c)
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    scale_out = torch.empty(1, dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device) if scale is None else None
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_quantize_int8(x.data_ptr(), _DTYPE_CODE[x.dtype], n, c, h * w, cp,
                                      int(scale is None), 0.0 if scale is None else scale,
                                      None if scratch is None else scratch.data_ptr(),
                                      scale_out.data_ptr(), xq.data_ptr(), stream)
    raise_on_error(lib, err, "quantize_int8")
    QUANTIZE_LAUNCHES += 1
    return xq, scale_out


def conv_int8_cuda(xq, wp, wscale, xscale, bias=None, stride=1, padding=0, slope=None,
                   relu=False, out_dtype=torch.float32) -> torch.Tensor:
    """``xq (n, h, w, cp)`` int8 and ``wp (co, kh, kw, cp)`` int8 ->
    ``(n, co, ho, wo)`` in ``out_dtype`` (float32 or bf16): the int32 sums
    times ``wscale[co] * xscale``, plus ``bias``, then relu or
    ``max(y, y * slope)``."""
    global CONV_LAUNCHES
    _check(xq, "conv_int8_cuda x", (torch.int8,), 4)
    _check(wp, "conv_int8_cuda w", (torch.int8,), 4, xq.device)
    n, h, w, cp = xq.shape
    co, kh, kw, cpw = wp.shape
    if cp != cpw or cp % K_DEPTH:
        raise ValueError(f"x has {cp} channels and w {cpw}: both must be one multiple of "
                         f"{K_DEPTH}")
    _check(wscale, "conv_int8_cuda wscale", (torch.float32,), 1, xq.device)
    _check(xscale, "conv_int8_cuda xscale", (torch.float32,), 1, xq.device)
    if bias is not None:
        _check(bias, "conv_int8_cuda bias", (torch.float32,), 1, xq.device)
    if wscale.numel() != co or xscale.numel() != 1 or (bias is not None and bias.numel() != co):
        raise ValueError("wscale and bias take one value per output channel, xscale one")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"conv_int8_cuda writes float32 or bf16, not {out_dtype}")
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho < 1 or wo < 1 or xq.numel() >= 2 ** 40 or n * co * ho * wo >= 2 ** 40:
        raise ValueError(f"no output for x {tuple(xq.shape)}, w {tuple(wp.shape)}, "
                         f"stride {stride}, padding {padding}")
    out = torch.empty((n, co, ho, wo), dtype=out_dtype, device=xq.device)
    act = 1 if relu else 2 if slope is not None else 0
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_conv_int8(xq.data_ptr(), wp.data_ptr(), wscale.data_ptr(),
                                  xscale.data_ptr(), None if bias is None else bias.data_ptr(),
                                  n, h, w, cp, co, kh, kw, stride, padding, ho, wo, act,
                                  0.0 if slope is None else slope, _DTYPE_CODE[out_dtype],
                                  out.data_ptr(), stream)
    raise_on_error(lib, err, "conv_int8")
    CONV_LAUNCHES += 1
    return out
