"""Wrappers of the int8 serving kernels in ``csrc/conv_int8.cu``.

* :func:`quantize_int8_cuda`: an NCHW float32 or bf16 CUDA tensor -> its
  NHWC int8 quantization with the channels padded to ``serve.quant.K_DEPTH``,
  and the ``(1,)`` float32 scale, which stays on the card.  Without
  ``scale`` (dynamic) the amax is reduced on the card first (a second
  kernel launch of the same call) into a two-word state kept per device and
  stream, which the quantize kernel leaves zero again.  Plain version:
  ``serve/quant.py::quantize_int8_reference``.
* :func:`conv_int8_cuda`: the implicit-GEMM int8 conv (TMA, ``wgmma`` s8 ->
  s32, a persistent grid) with the rescale, bias and activation fused, NCHW
  out in float32 or bf16.  :func:`conv_plan` picks its tile: N fit to Cout,
  the pixel tile's shape, the K chunk (and swizzle), the ring depth, whether
  the weights stay resident in shared memory, and the store path.  Plain
  version: ``serve/quant.py::conv_int8_reference``.

Neither replaces a TPU kernel: the JAX package's int8 conv is XLA's
(``refid_tpu/serve/quant.py::conv_int8``).  Each wrapper checks device, type,
shape and contiguity, launches on the current stream, raises if the launch
failed, and counts its calls in ``QUANTIZE_LAUNCHES`` (one a quantization,
whether it took one kernel or two) or ``CONV_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from refid_tpu_torch.ops.build import load, raise_on_error
from refid_tpu_torch.serve.quant import K_DEPTH, padded_channels

__all__ = ["QUANTIZE_LAUNCHES", "CONV_LAUNCHES", "reset_launches", "quantize_int8_cuda",
           "conv_int8_cuda", "ConvPlan", "conv_plan", "TILE_PIXELS", "SMEM_BYTES"]

QUANTIZE_LAUNCHES = 0
CONV_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None
# the dynamic quantization's {amax bits, blocks done}, zero between calls,
# one per (device, stream): two streams must not share one
_AMAX_STATE: Dict[Tuple[int, int], torch.Tensor] = {}

TILE_PIXELS = 128        # output pixels a conv tile: one warpgroup's, 2 m64 blocks
SMEM_BYTES = 232448      # dynamic shared memory a block may use (227 KB)
_N_TILES = (16, 32, 64, 128)
_MAX_STAGES = 12         # two rings, one a consumer warpgroup
_GROUP = 32              # output channels the epilogue stages at a time


class ConvPlan(NamedTuple):
    """The tile plan of one conv (``csrc/conv_int8.cu`` lays out shared
    memory from it the same way): ``bn`` output channels by ``bw`` x ``bh``
    output pixels a tile, a K chunk of ``chunk`` bytes (its swizzle),
    ``stages`` stages in two rings (one a consumer warpgroup), the weights
    ``resident`` in shared memory or streamed beside A, 16-byte stores
    (``vector_store``) or one element at a time, and ``shared``: one A box
    of ``bw + kw - 1`` pixels a tile row serves every ``kx`` of a kernel
    row; ``tiles`` and ``smem`` bytes follow."""
    bn: int
    bw: int
    bh: int
    chunk: int
    stages: int
    resident: bool
    vector_store: bool
    shared: bool
    tiles: int
    smem: int


def _round(n: int, to: int = 1024) -> int:
    return -(-n // to) * to


def conv_plan(n: int, ho: int, wo: int, cp: int, co: int, kh: int, kw: int, stride: int,
              out_bytes: int = 2) -> ConvPlan:
    """The tile plan of a conv with output ``(n, co, ho, wo)`` from ``cp``
    (padded) input channels, a ``kh`` x ``kw`` kernel and ``stride``.

    N is the narrowest of 16 / 32 / 64 / 128 that holds Cout, else 128-wide
    tiles; at N 64 the kernel swaps the operands (M = channels), so its
    pixel tile is one row of 128 where kx is shared; the K chunk is the widest of 128 / 64 / 32 bytes that ``cp``
    allows and that leaves room for two stages a ring.  A stride-1 conv
    wider than 1x1 shares each A box across ``kx`` (``kw`` times fewer A
    bytes), with tile rows of 128 or 64 pixels; other convs take a ``bw
    stride`` x ``bh stride`` box a tap (each at most 256).  Of the allowed
    shapes (``bw bh`` = 128, powers of two) the one that computes the fewest
    pixels past the image wins, the wider on a tie.
    The weights stay resident when they fit beside three or more stages a
    ring; each consumer warpgroup has a ring of ``stages / 2``."""
    bn = next((b for b in _N_TILES if b >= co), _N_TILES[-1])
    n_tiles = -(-co // bn)
    shared = stride == 1 and kw > 1
    swap = bn == 64       # M = the 64 channels, N = the tile's 128 pixels: one box row
    widths = ((128,) if swap else (128, 64)) if shared else (128, 64, 32, 16, 8)
    shapes = [(bw, TILE_PIXELS // bw) for bw in widths
              if bw * stride <= 256 and TILE_PIXELS // bw * stride <= 256]
    bw, bh = min(shapes, key=lambda s: (-(-wo // s[0]) * s[0] * -(-ho // s[1]) * s[1], -s[0]))
    taps = kw if shared else 1
    # alignment slack, each warpgroup's staged channels (all 64 when swapped)
    # and factor table, B's barrier
    staged = 64 if swap else _GROUP
    fixed = 1024 + 2 * staged * (TILE_PIXELS * out_bytes + 16) + 16 * bn + 8
    for chunk in (c for c in (128, 64, 32) if cp % c == 0):
        b_boxes = kh * kw * cp // chunk
        a_area = bh * _round((bw + kw - 1) * chunk) if shared else TILE_PIXELS * chunk
        b_box = _round(bn * chunk)
        free = SMEM_BYTES - fixed - n_tiles * b_boxes * b_box
        resident = free >= 6 * (a_area + 16)
        stage = a_area + (0 if resident else taps * b_box)
        pairs = (free if resident else SMEM_BYTES - fixed) // (2 * (stage + 16))
        stages = 2 * min(_MAX_STAGES // 2, pairs)
        if stages >= 4:
            break
    smem = fixed + stages * (stage + 16) + (n_tiles * b_boxes * b_box if resident else 0)
    m_tiles = n * -(-ho // bh) * -(-wo // bw)
    vec = 16 // out_bytes
    return ConvPlan(bn, bw, bh, chunk, stages, resident, wo % vec == 0 and bw % vec == 0,
                    shared, m_tiles * n_tiles, smem)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("conv_int8")
        lib.refid_quantize_int8.argtypes = [_P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P]
        lib.refid_conv_int8.argtypes = ([_P, _P, _P, _P, _P] + [_I] * 12 + [_F, _I, _P, _P]
                                        + [_I] * 8)
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
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        state = None
        if scale is None:
            key = (x.device.index, stream)
            state = _AMAX_STATE.get(key)
            if state is None:
                state = _AMAX_STATE[key] = torch.zeros(2, dtype=torch.int32, device=x.device)
        err = lib.refid_quantize_int8(x.data_ptr(), _DTYPE_CODE[x.dtype], n, c, h * w, cp,
                                      int(scale is None), 0.0 if scale is None else scale,
                                      None if state is None else state.data_ptr(),
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
    plan = conv_plan(n, ho, wo, cp, co, kh, kw, stride, out.element_size())
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.refid_conv_int8(xq.data_ptr(), wp.data_ptr(), wscale.data_ptr(),
                                  xscale.data_ptr(), None if bias is None else bias.data_ptr(),
                                  n, h, w, cp, co, kh, kw, stride, padding, ho, wo, act,
                                  0.0 if slope is None else slope, _DTYPE_CODE[out_dtype],
                                  out.data_ptr(), stream, plan.bn, plan.bw, plan.bh, plan.chunk,
                                  plan.stages, int(plan.resident), int(plan.vector_store),
                                  int(plan.shared))
    raise_on_error(lib, err, "conv_int8")
    CONV_LAUNCHES += 1
    return out
