"""Wrappers of the int8 serving kernels in ``csrc/conv_int8.cu``.

* :func:`quantize_int8_cuda`: an NCHW float32 or bf16 CUDA tensor -> its
  NHWC int8 quantization with the channels padded to ``serve.quant.K_DEPTH``,
  and the ``(1,)`` float32 scale, which stays on the card.  Without
  ``scale`` (dynamic) the amax is reduced on the card first (a second
  kernel launch of the same call) into a two-word state kept per device and
  stream, which the quantize kernel leaves zero again.  With ``amax`` (a
  ``(1,)`` float32 on the card, e.g. the max over a spatial group of
  :func:`amax_int8_cuda`'s results) the kernel derives the scale from it in
  device memory, as the dynamic path does from its own.  Plain version:
  ``serve/quant.py::quantize_int8_reference``.
* :func:`amax_int8_cuda`: the amax pass alone, ``max |x|`` as a ``(1,)``
  float32 on the card.  Plain version: ``serve/quant.py::amax_int8``'s CPU
  path.
* :func:`conv_int8_cuda`: the implicit-GEMM int8 conv (TMA, ``wgmma`` s8 ->
  s32, a persistent grid) with the rescale, bias and activation fused, NCHW
  out in float32 or bf16, the rows and the columns each with their own
  zero padding.  :func:`conv_plan` picks its tile: N fit to Cout,
  the pixel tile's shape, the K chunk (and swizzle), the ring depth, whether
  the weights stay resident in shared memory, and the store path.  Plain
  version: ``serve/quant.py::conv_int8_reference``.

Neither replaces a TPU kernel: the JAX package's int8 conv is XLA's
(``refid_tpu/serve/quant.py::conv_int8``).  Each wrapper checks device, type,
shape and contiguity, launches on the current stream through the shared
launch path of ``ops/build.py``, raises if the launch failed, and counts its
calls in ``QUANTIZE_LAUNCHES`` (one a quantization, whether it took one
kernel or two), ``AMAX_LAUNCHES`` or ``CONV_LAUNCHES``.  The conv's geometry
and plan go to the library as one :class:`ConvArgs`, built once per conv
shape (:func:`conv_args`, over the cached :func:`conv_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.nn.modules.utils import _pair

from refid_tpu_torch.ops.build import bind, current_stream, launch, load, raise_on_error
from refid_tpu_torch.serve.quant import K_DEPTH, padded_channels

__all__ = ["QUANTIZE_LAUNCHES", "AMAX_LAUNCHES", "CONV_LAUNCHES", "reset_launches",
           "quantize_int8_cuda", "amax_int8_cuda", "conv_int8_cuda", "ConvPlan", "conv_plan",
           "ConvArgs", "conv_args", "TILE_PIXELS", "SMEM_BYTES", "PLAN_CACHE_SIZE"]

QUANTIZE_LAUNCHES = 0
AMAX_LAUNCHES = 0
CONV_LAUNCHES = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLOATS, _INT8, _F32 = tuple(_DTYPE_CODE), (torch.int8,), (torch.float32,)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns = {}        # C function name -> bound function, filled at first launch
# the amax reduction's {amax bits, blocks done} (the dynamic quantization
# and the amax pass alone), zero between calls, one per (device, stream):
# two streams must not share one
_AMAX_STATE: Dict[Tuple[int, int], torch.Tensor] = {}
PLAN_CACHE_SIZE = 1024   # conv shapes whose plan and ConvArgs stay cached

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


class ConvArgs(ctypes.Structure):
    """The conv's geometry and tile plan as ``csrc/conv_int8.cu::ConvArgs``
    (23 4-byte fields in this order; the library's ``refid_conv_int8_abi``
    reports its size and offsets)."""
    _fields_ = [(name, _I) for name in ("n", "h", "w", "cp", "co", "kh", "kw", "stride",
                                        "pad_h", "pad_w", "ho", "wo", "act")]
    _fields_ += [("slope", _F)]
    _fields_ += [(name, _I) for name in ("out_dtype", "bn", "bw", "bh", "chunk", "stages",
                                         "resident", "vector_store", "shared")]


def _round(n: int, to: int = 1024) -> int:
    return -(-n // to) * to


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
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
    ring; each consumer warpgroup has a ring of ``stages / 2``.  A pure
    function of integers, cached (``PLAN_CACHE_SIZE`` shapes, least recently
    used out first; ``conv_plan.__wrapped__`` is the uncached function)."""
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


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
def conv_args(n: int, h: int, w: int, cp: int, co: int, kh: int, kw: int, stride: int,
              pad_h: int, pad_w: int, act: int, slope: float, out_dtype: int) -> ConvArgs:
    """The :class:`ConvArgs` of one conv (``out_dtype`` 0 float32, 1 bf16;
    ``act`` 0 none, 1 relu, 2 ``max(y, y slope)``), its plan from
    :func:`conv_plan`; cached like it.  The kernel only reads it."""
    ho = (h + 2 * pad_h - kh) // stride + 1
    wo = (w + 2 * pad_w - kw) // stride + 1
    plan = conv_plan(n, ho, wo, cp, co, kh, kw, stride, 4 if out_dtype == 0 else 2)
    return ConvArgs(n, h, w, cp, co, kh, kw, stride, pad_h, pad_w, ho, wo, act, slope,
                    out_dtype, plan.bn, plan.bw, plan.bh, plan.chunk, plan.stages,
                    int(plan.resident), int(plan.vector_store), int(plan.shared))


_SIGNATURES = {"refid_quantize_int8": [_P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
               "refid_amax_int8": [_P, _I, ctypes.c_longlong, _P, _P, _P],
               "refid_conv_int8": [_P, _P, _P, _P, _P, _P, ctypes.POINTER(ConvArgs), _P],
               "refid_conv_int8_abi": [ctypes.POINTER(ctypes.c_longlong), _I]}


def _bound(fn: str):
    """The C function ``fn``, bound at its first launch."""
    if not _fns:
        _fns.update(bind("conv_int8", _SIGNATURES))
    return _fns[fn]


def _raise(err: int, fn: str) -> None:
    raise_on_error(load("conv_int8"), err, fn[len("refid_"):])


def reset_launches() -> None:
    """Set the launch counts to zero."""
    global QUANTIZE_LAUNCHES, AMAX_LAUNCHES, CONV_LAUNCHES
    QUANTIZE_LAUNCHES = AMAX_LAUNCHES = CONV_LAUNCHES = 0


def _check(t: torch.Tensor, what: str, dtypes, dim: int, index: int = -1) -> int:
    """Raise unless ``t`` is a contiguous ``dim``-D CUDA tensor of one of
    ``dtypes`` (on device ``index`` where given); returns its device index."""
    if not t.is_cuda or (index >= 0 and t.get_device() != index):
        raise ValueError(f"{what} needs a CUDA tensor on "
                         f"{f'cuda:{index}' if index >= 0 else 'a card'}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {dtypes}, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-D tensor, got {tuple(t.shape)}")
    return t.get_device()


def _amax_state(index: int, stream: int) -> torch.Tensor:
    state = _AMAX_STATE.get((index, stream))
    if state is None:
        state = _AMAX_STATE[(index, stream)] = torch.zeros(2, dtype=torch.int32,
                                                           device=torch.device("cuda", index))
    return state


def quantize_int8_cuda(x: torch.Tensor, scale: Optional[float] = None,
                       amax: Optional[torch.Tensor] = None):
    """NCHW ``x`` -> (int8 ``(n, h, w, c padded)``, ``(1,)`` float32 scale),
    dynamic when ``scale`` is None: from ``x``'s amax, or from ``amax`` in
    device memory where given."""
    global QUANTIZE_LAUNCHES
    index = _check(x, "quantize_int8_cuda", _FLOATS, 4)
    n, c, h, w = x.shape
    numel = x.numel()
    if numel == 0 or numel >= 2 ** 31:
        raise ValueError(f"quantize_int8_cuda takes 1 to 2**31 - 1 elements, got {numel}")
    if amax is not None:
        _check(amax, "quantize_int8_cuda amax", (torch.float32,), 1, index)
        if scale is not None or amax.numel() != 1:
            raise ValueError("quantize_int8_cuda takes a scale or one device amax, not both")
    cp = padded_channels(c)
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    scale_out = torch.empty(1, dtype=torch.float32, device=x.device)
    stream = current_stream(index)
    if amax is not None:
        mode, state = 2, amax.data_ptr()
    elif scale is None:
        mode, state = 1, _amax_state(index, stream).data_ptr()
    else:
        mode, state = 0, None
    fn = _fns.get("refid_quantize_int8") or _bound("refid_quantize_int8")
    err = launch(fn, index, x.data_ptr(), _DTYPE_CODE[x.dtype], n, c, h * w, cp, mode,
                 0.0 if scale is None else scale, state, scale_out.data_ptr(), xq.data_ptr(),
                 stream)
    if err:
        _raise(err, "refid_quantize_int8")
    QUANTIZE_LAUNCHES += 1
    return xq, scale_out


def amax_int8_cuda(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` of a contiguous float32 or bf16 CUDA tensor as a new
    ``(1,)`` float32 on its card (the dynamic quantization's amax pass), in
    one launch: the kernel reduces into the stream's amax state and its last
    block moves the max into the result, leaving the state zero."""
    global AMAX_LAUNCHES
    index = _check(x, "amax_int8_cuda", _FLOATS, x.dim())
    numel = x.numel()
    if numel == 0:
        raise ValueError("amax_int8_cuda takes a non-empty tensor")
    amax = torch.empty(1, dtype=torch.float32, device=x.device)
    stream = current_stream(index)
    fn = _fns.get("refid_amax_int8") or _bound("refid_amax_int8")
    err = launch(fn, index, x.data_ptr(), _DTYPE_CODE[x.dtype], numel,
                 _amax_state(index, stream).data_ptr(), amax.data_ptr(), stream)
    if err:
        _raise(err, "refid_amax_int8")
    AMAX_LAUNCHES += 1
    return amax


def conv_int8_cuda(xq, wp, wscale, xscale, bias=None, stride=1, padding=0, slope=None,
                   relu=False, out_dtype=torch.float32) -> torch.Tensor:
    """``xq (n, h, w, cp)`` int8 and ``wp (co, kh, kw, cp)`` int8 ->
    ``(n, co, ho, wo)`` in ``out_dtype`` (float32 or bf16): the int32 sums
    times ``wscale[co] * xscale``, plus ``bias``, then relu or
    ``max(y, y * slope)``.  ``padding``: one int, or ``(rows, columns)``."""
    global CONV_LAUNCHES
    index = _check(xq, "conv_int8_cuda x", _INT8, 4)
    _check(wp, "conv_int8_cuda w", _INT8, 4, index)
    n, h, w, cp = xq.shape
    co, kh, kw, cpw = wp.shape
    if cp != cpw or cp % K_DEPTH:
        raise ValueError(f"x has {cp} channels and w {cpw}: both must be one multiple of "
                         f"{K_DEPTH}")
    _check(wscale, "conv_int8_cuda wscale", _F32, 1, index)
    _check(xscale, "conv_int8_cuda xscale", _F32, 1, index)
    if bias is not None:
        _check(bias, "conv_int8_cuda bias", _F32, 1, index)
    if wscale.numel() != co or xscale.numel() != 1 or (bias is not None and bias.numel() != co):
        raise ValueError("wscale and bias take one value per output channel, xscale one")
    out_code = _DTYPE_CODE.get(out_dtype)
    if out_code is None:
        raise TypeError(f"conv_int8_cuda writes float32 or bf16, not {out_dtype}")
    pad_h, pad_w = (padding, padding) if isinstance(padding, int) else _pair(padding)
    ho = (h + 2 * pad_h - kh) // stride + 1
    wo = (w + 2 * pad_w - kw) // stride + 1
    if ho < 1 or wo < 1 or xq.numel() >= 2 ** 40 or n * co * ho * wo >= 2 ** 40:
        raise ValueError(f"no output for x {tuple(xq.shape)}, w {tuple(wp.shape)}, "
                         f"stride {stride}, padding {padding}")
    act = 1 if relu else 2 if slope is not None else 0
    args = conv_args(n, h, w, cp, co, kh, kw, stride, pad_h, pad_w, act,
                     0.0 if slope is None else float(slope), out_code)
    out = torch.empty((n, co, ho, wo), dtype=out_dtype, device=xq.device)
    fn = _fns.get("refid_conv_int8") or _bound("refid_conv_int8")
    err = launch(fn, index, xq.data_ptr(), wp.data_ptr(), wscale.data_ptr(), xscale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), args,
                 current_stream(index))
    if err:
        _raise(err, "refid_conv_int8")
    CONV_LAUNCHES += 1
    return out
