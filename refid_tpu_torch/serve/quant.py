"""int8 serving: the quantization scheme of ``refid_tpu/serve/quant.py``.

Symmetric int8, accumulation in int32:
  * weights: a scale per output channel, ``max(amax, 1e-12) / 127`` in
    float32, and ``clamp(round(w / scale), -127, 127)``;
  * activations: one scale per tensor, DYNAMIC (the amax of the conv's input,
    computed on the device) or STATIC (a calibrated amax; the scale is
    ``max(amax, 1e-12) / 127.0`` in Python double, float32 where it meets
    the tensor, as XLA's weak typing does);
  * epilogue in the output dtype, in JAX's order: ``acc.to(rdt) *
    (wscale * xscale).to(rdt)``, ``+ bias.to(rdt)``, then relu or
    ``maximum(y, y * slope)``.
Rounding is half to even (``torch.round``, as ``jnp.round``) of a true
division by the scale, never a product with its reciprocal.

On a CUDA tensor the two steps run in the hand-written kernels of
``csrc/conv_int8.cu`` (``ops/int8_cuda.py``): :func:`quantize_int8` (NCHW
float32 / bf16 -> NHWC int8 with the channels padded to :data:`K_DEPTH`;
a dynamic scale stays in device memory) and :func:`conv_int8_packed` (an
implicit-GEMM conv, s8 x s8 -> s32, epilogue fused, NCHW out).  On a CPU
tensor they run their plain versions, :func:`quantize_int8_reference` and
:func:`conv_int8_reference`, which compute the same function on the same
layouts.

EVHINet serves in int8 too (``models/evhinet.py``: 25 sites, modes True,
``"calib"`` and ``"static"``), where its ``evhinet_int8_applicable`` holds.

On row shards (an active ``parallel/spatial.py`` plan) a site is the whole
frame's site: a dynamic scale comes from the group's amax (each rank's amax
by :func:`amax_int8`, the max over the group by ``SpatialPlan.group_max``,
then the quantization reads it from device memory), calibration reduces the
amax by max and the rms by a sum of squares, and a conv taller than one row
exchanges the halo rows of the quantized NHWC int8 tensor (1 byte an
element; a zero row past the frame's border is the conv's own zero padding,
since the quantization is symmetric) and runs with row padding 0 and its
column padding.  The integer sums and the scales are the whole frame's, so
a sharded site computes the whole site's rows bit for bit.

The per-call quant state :class:`QuantState` carries the mode, as the JAX
package's ``cache`` dict does: ``int8`` True (dynamic scales), ``"scale0"``
(True plus the scale-0 encoder trunks), ``"static"`` (calibrated scales for
the widest coverage, sites matched by call order, ``exclude`` served in
exact math) and ``"calib"`` (exact math, each site's amax and rms recorded
on the device).  :class:`WeightCache` quantizes and packs each weight once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.ops.conv_epilogue import activate
from refid_tpu_torch.parallel import spatial

__all__ = ["K_DEPTH", "PRODUCTION_SHAPE_DB", "PRODUCTION_DB_GATE", "PRODUCTION_DB_CARD",
           "EVHINET_PRODUCTION_SHAPE_DB", "INT8_MODES",
           "int8_quality_gated", "padded_channels", "quantize_kernel", "pack_kernel",
           "quantize_act", "static_scale", "quantize_int8", "quantize_int8_reference",
           "amax_int8",
           "conv_int8_packed", "conv_int8_reference", "conv_int8", "WeightCache",
           "QuantState", "calibration_stats"]

K_DEPTH = 32          # int8 channels per MMA step: channels pad to a multiple
INT8_MODES = (False, True, "scale0", "static")

# Measured production-shape quality of the port on the card: PSNR (dB,
# 20 log10(span / rmse)) of a 1280x720, m=11 n=1 window (t = 23, 2**20
# events; the network's own init, seed 0) served under bf16 autocast, against
# the same window in float32 (TF32 off); "static" calibrated on another
# window.  chip_smoke.py, phase int8_serve.  Keyed by the pipeline's
# ``int8=`` value; False is the bf16 window itself.  Every int8 mode sits at
# the bf16 rounding floor.
PRODUCTION_DB_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PRODUCTION_SHAPE_DB: Dict[Union[bool, str], float] = {
    False: 63.87,
    True: 63.87,
    "scale0": 63.86,
    "static": 64.07,
}

# The JAX package's own record for EVHINet (refid_tpu/serve/quant.py
# ``EVHINET_PRODUCTION_SHAPE_DB``: its folded serving forward on its TPU,
# 720p single image, 25 calibrated sites; PSNR vs its f32 forward), copied
# as it stands.  It is not a measurement of the port: the port's card
# figures are in PERF.md (chip_smoke.py, phase evhinet_serve).
EVHINET_PRODUCTION_SHAPE_DB: Dict[Union[bool, str], float] = {
    False: 73.93,
    True: 60.36,
    "static": 59.77,
}

# An int8 mode is quality-gated in when its production-shape dB clears this
# bar (the JAX package's rule: ~14 dB above the task's ~36 dB signal PSNR).
PRODUCTION_DB_GATE = 50.0


def int8_quality_gated(mode=True) -> bool:
    """True when ``mode`` names an int8 mode whose recorded production-shape
    dB is at least :data:`PRODUCTION_DB_GATE`.  Unmeasured modes, and
    ``False`` (not an int8 mode), are not gated in."""
    if not mode:
        return False
    db = PRODUCTION_SHAPE_DB.get(mode)
    return db is not None and db >= PRODUCTION_DB_GATE


def padded_channels(c: int) -> int:
    return -(-c // K_DEPTH) * K_DEPTH


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device: dividing by it is a true
    division on every device (a Python scalar divisor becomes a product
    with its reciprocal on CUDA)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(co, ci, kh, kw)`` weights -> (int8 weights, float32 per-``co``
    scales)."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp_min(amax, 1e-12) / _scalar(wf, 127.0)
    wq = torch.clamp(torch.round(wf / scale.view(-1, 1, 1, 1)), -127, 127)
    return wq.to(torch.int8), scale


def pack_kernel(wq: torch.Tensor) -> torch.Tensor:
    """int8 ``(co, ci, kh, kw)`` -> ``(co, kh, kw, ci padded)``: K-major rows,
    as the 8-bit MMA needs both operands."""
    co, ci, kh, kw = wq.shape
    packed = wq.new_zeros((co, kh, kw, padded_channels(ci)))
    packed[..., :ci] = wq.permute(0, 2, 3, 1)
    return packed


def static_scale(amax: float) -> float:
    """A calibrated site's scale, in Python double."""
    return max(float(amax), 1e-12) / 127.0


def quantize_act(x: torch.Tensor, scale: Optional[float] = None,
                 amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor quantization -> (int8 ``x``, 0-d float32 scale on ``x``'s
    device).  ``scale`` None: dynamic, from the tensor's amax, or from
    ``amax`` (a ``(1,)`` float32 on the device: the group's) where given."""
    xf = x.detach().float()
    if scale is None:
        a = xf.abs().amax() if amax is None else amax.reshape(())
        s = torch.clamp_min(a, 1e-12) / _scalar(xf, 127.0)
    else:
        s = _scalar(xf, scale)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def amax_int8(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` as a ``(1,)`` float32 on ``x``'s device: the amax pass of
    the ``quantize_int8`` kernel on a CUDA tensor, its plain version on the
    CPU."""
    if x.device.type == "cuda":
        from refid_tpu_torch.ops.int8_cuda import amax_int8_cuda
        return amax_int8_cuda(x.contiguous())
    return x.detach().float().abs().amax().reshape(1)


def quantize_int8_reference(x: torch.Tensor, scale: Optional[float] = None,
                            amax: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``quantize_int8`` kernel: NCHW ``x`` -> (int8
    ``(n, h, w, c padded)``, ``(1,)`` float32 scale)."""
    xq, s = quantize_act(x, scale, amax)
    n, c, h, w = x.shape
    out = xq.new_zeros((n, h, w, padded_channels(c)))
    out[..., :c] = xq.permute(0, 2, 3, 1)
    return out, s.reshape(1)


def quantize_int8(x: torch.Tensor, scale: Optional[float] = None,
                  amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW float32 / bf16 -> (NHWC int8 with padded channels, ``(1,)``
    float32 scale on the device): the CUDA kernel on a CUDA tensor, the plain
    version on the CPU.  ``scale`` None is dynamic: from ``x``'s own amax, or
    from ``amax`` (``(1,)`` float32 on the device) where given."""
    if x.device.type == "cuda":
        from refid_tpu_torch.ops.int8_cuda import quantize_int8_cuda
        return quantize_int8_cuda(x, scale, amax)
    return quantize_int8_reference(x, scale, amax)


def _epilogue(acc, wscale, xscale, bias, slope, relu, out_dtype):
    y = acc.to(out_dtype) * (wscale * xscale).to(out_dtype).view(1, -1, 1, 1)
    if bias is not None:
        y = y + bias.to(out_dtype).view(1, -1, 1, 1)
    if relu:
        return torch.relu(y)
    if slope is not None:
        return torch.maximum(y, y * slope)
    return y


def conv_int8_reference(xq, wp, wscale, xscale, bias=None, stride=1, padding=0,
                        slope=None, relu=False, out_dtype=torch.float32):
    """Plain version of the ``conv_int8`` kernel, on its layouts: ``xq``
    ``(n, h, w, cp)`` int8, ``wp`` ``(co, kh, kw, cp)`` int8, ``wscale``
    ``(co,)`` and ``xscale`` ``(1,)`` float32, ``bias`` ``(co,)`` or None ->
    ``(n, co, ho, wo)`` in ``out_dtype``; ``padding`` one int or ``(rows,
    columns)``.  The integer sums are a float64 conv rounded back to int32:
    exact, since ``|sum| < 127^2 K < 2^53``."""
    with torch.autocast(xq.device.type, enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wp.permute(0, 3, 1, 2).double(),
                       stride=stride, padding=_pair(padding))
        acc = torch.round(acc).to(torch.int32)
        return _epilogue(acc, wscale, xscale, bias, slope, relu, out_dtype)


def conv_int8_packed(xq, wp, wscale, xscale, bias=None, stride=1, padding=0,
                     slope=None, relu=False, out_dtype=torch.float32):
    """:func:`conv_int8_reference`'s function: the CUDA kernel on CUDA
    tensors, the plain version on the CPU."""
    if xq.device.type == "cuda":
        from refid_tpu_torch.ops.int8_cuda import conv_int8_cuda
        return conv_int8_cuda(xq, wp, wscale, xscale, bias, stride, padding, slope, relu,
                              out_dtype)
    return conv_int8_reference(xq, wp, wscale, xscale, bias, stride, padding, slope, relu,
                               out_dtype)


class WeightCache(dict):
    """Packed int8 weights, per-channel scales and float32 biases, computed
    once per weight: keyed by the weight tensor, its version counter and its
    bias's (an entry pins its tensors, so an id is never reused while it
    lives)."""

    def packed(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        versions = (weight._version, None if bias is None else bias._version)
        hit = self.get(id(weight))
        if hit is None or hit[0] is not weight or hit[1] is not bias or hit[2] != versions:
            wq, wscale = quantize_kernel(weight)
            b = None if bias is None else bias.detach().float().contiguous()
            hit = (weight, bias, versions, pack_kernel(wq), wscale, b)
            self[id(weight)] = hit
        return hit[3:]


def _params(p) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if isinstance(p, nn.Module):
        return p.weight, p.bias
    return p["weight"], p.get("bias")


def _output_dtype(x: torch.Tensor, out_dtype):
    if out_dtype is not None:
        return out_dtype
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return torch.float32


def _exact(p, x, stride, padding, slope, relu):
    act = "relu" if relu else slope
    if isinstance(p, spatial.HaloConv2d):     # through the conv layer's entry point
        return p(x, act=act)
    weight, bias = _params(p)
    return activate(spatial.halo_conv2d(x, weight, bias, stride, padding), act)


def conv_int8(p, x, stride=1, padding=0, slope=None, relu=False, out_dtype=None,
              q: Optional["QuantState"] = None, exact=None):
    """A conv with int8 arithmetic, the JAX package's ``conv_int8``: ``p``
    an ``nn.Conv2d`` or ``{"weight" (co, ci, kh, kw), "bias"}``, ``x`` NCHW.
    ``q`` resolves the site (dynamic when None); a calibrated or excluded
    site runs ``exact(x)`` (default: the float conv and its activation, the
    int8-off path).  ``out_dtype`` defaults to the autocast dtype where
    autocast is on, else float32: the dtype of the conv it replaces.  Under
    an active spatial plan ``x`` is this rank's rows (module docstring).
    Each call is the profiler span ``refid.int8.site``."""
    with span("refid.int8.site"):
        mode, xscale = ("dynamic", None) if q is None else q.resolve(x)
        if mode == "exact":
            return exact(x) if exact is not None else _exact(p, x, stride, padding, slope, relu)
        weight, bias = _params(p)
        cache = q.weights if q is not None else WeightCache()
        wp, wscale, b = cache.packed(weight, bias)
        plan = spatial.active()
        amax = None
        if plan is not None and xscale is None:
            amax = plan.group_max(amax_int8(x))
        xq, s = quantize_int8(x.contiguous(), xscale, amax)
        pad = _pair(padding)
        kh = weight.shape[2]
        if plan is not None and kh > 1:
            xq = plan.exchange_nhwc(xq, pad[0], kh - stride - pad[0])
            pad = (0, pad[1])
        return conv_int8_packed(xq, wp, wscale, s, b, stride, pad, slope, relu,
                                _output_dtype(x, out_dtype))


class QuantState:
    """The int8 mode of one forward (the JAX package's quant-state dict).

    ``int8``: True, ``"scale0"``, ``"static"`` (``amax``: calibrated amaxes
    in site order; ``exclude``: site indices served in exact math) or
    ``"calib"`` (exact math; each site's amax and rms appended, as device
    tensors, to ``calib_amax`` / ``calib_rms``).  ``scale0`` and
    ``last_decoders`` say which of the optional sites the mode quantizes:
    the scale-0 encoder trunks and the trunks of the last two decoders."""

    def __init__(self, int8, weights: Optional[WeightCache] = None,
                 amax: Sequence[float] = (), exclude=()):
        if int8 not in (True, "scale0", "static", "calib"):
            raise ValueError(f"int8 mode must be True, 'scale0', 'static' or 'calib'; "
                             f"got {int8!r}")
        self.int8 = int8
        self.weights = WeightCache() if weights is None else weights
        self.scale0 = int8 in ("scale0", "static", "calib")
        self.last_decoders = int8 in ("static", "calib")
        self.amax = list(amax)
        self.exclude = frozenset(exclude or ())
        self.sites = 0
        self.calib_amax, self.calib_rms = [], []

    def conv(self, module: nn.Conv2d, x, slope=None, relu=False, exact=None):
        """``module`` (its stride and padding) through :func:`conv_int8`."""
        return conv_int8(module, x, module.stride[0], module.padding[0], slope, relu, q=self,
                         exact=exact)

    def resolve(self, x: torch.Tensor):
        """("exact", None), ("static", scale) or ("dynamic", None) for the
        next site, recording it in ``calib`` mode."""
        i = self.sites
        self.sites += 1
        if self.int8 == "calib":
            xf = x.detach().float()
            plan = spatial.active()
            if plan is None:
                self.calib_amax.append(xf.abs().amax())
                self.calib_rms.append(torch.sqrt(torch.mean(xf * xf)))
            else:       # the whole frame's: max of the amaxes, sum of the squares
                count = xf.numel() // xf.shape[-2] * plan.frame_rows(xf.shape[-2])
                self.calib_amax.append(plan.group_max(xf.abs().amax().reshape(1))[0])
                self.calib_rms.append(torch.sqrt(plan.total((xf * xf).sum()) / count))
            return "exact", None
        if self.int8 == "static":
            if i >= len(self.amax):
                raise ValueError(f"calibration/serving site-count mismatch: site {i} has no "
                                 f"scale ({len(self.amax)} calibrated); calibrate with the "
                                 f"same config and t")
            if i in self.exclude:
                return "exact", None
            return "static", static_scale(self.amax[i])
        return "dynamic", None

    def finish(self) -> None:
        """Raise if a static forward did not consume every calibrated scale."""
        if self.int8 == "static" and self.sites != len(self.amax):
            raise ValueError(f"calibration/serving site-count mismatch: consumed "
                             f"{self.sites} of {len(self.amax)} scales; calibrate with "
                             f"the same config and t")


def calibration_stats(q: QuantState) -> Tuple[list, list]:
    """The recorded amaxes and rms of a ``calib`` forward as Python floats,
    read from the device once."""
    if not q.calib_amax:
        return [], []
    both = torch.stack([torch.stack(q.calib_amax), torch.stack(q.calib_rms)]).cpu()
    return both[0].tolist(), both[1].tolist()

