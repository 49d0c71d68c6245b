"""The pre-norm of Restormer's and Uformer's blocks: the residual add in
front of a transformer block's LayerNorm, then the LayerNorm over the
channels of each pixel, and the rule that decides how it runs (the models
call it through ``models/arch_util.py::pre_norm``).

:func:`engages` is the rule, decided from what the call can observe: a CUDA
input in bfloat16 (the stream under bf16 autocast) with gradients off, which
is every served call (``serve/network.py`` runs under ``inference_mode``).
There :func:`prenorm` (the add, where a residual is given, and the norm) and
:func:`residual_add` (the add alone) run one hand-written launch each on the
current stream (``csrc/prenorm.cu``, its own library); an engaged call whose
operands the kernel does not take raises, so none ends in PyTorch's ops
unseen.  Everything else (float32, the CPU, training) is the caller's eager
``x + residual`` and ``nn.LayerNorm``.

The kernel's ``s`` is the eager bf16 add bit for bit, in ``x``'s layout;
its statistics are float32, taken from that rounded ``s``; its ``y`` is
bf16 channels_last, rounded once, where the next conv's autocast rounds
today's float32 LayerNorm output.  :func:`prenorm_reference` is its plain
version, held against it by ``tests/test_torch_prenorm.py`` on the card.
``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from refid_tpu_torch.ops.build import bind, current_stream, launch, load, raise_on_error

__all__ = ["LAUNCHES", "engages", "prenorm_reference", "prenorm", "residual_add"]

LAUNCHES = 0
_count_lock = threading.Lock()
_fns = {}        # C function name -> bound function, filled at first launch
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = {"refid_prenorm": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _I, _LL, _F, _P]}


def engages(x: torch.Tensor) -> bool:
    """True where the pre-norm of the stream ``x`` runs on the kernel: a
    bfloat16 CUDA tensor with gradients off."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def prenorm_reference(x: torch.Tensor, residual: Optional[torch.Tensor], weight: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`prenorm`: the bf16 add, then
    ``F.layer_norm`` over the channels in float32, cast to bf16,
    channels_last."""
    s = x if residual is None else x + residual
    y = F.layer_norm(s.permute(0, 2, 3, 1).float(), (s.shape[1],), weight.float(), bias.float(),
                     eps)
    return s, y.to(torch.bfloat16).permute(0, 3, 1, 2)


def _layout(t: torch.Tensor) -> Optional[int]:
    """0 for an NCHW-dense tensor, 1 for a channels_last-dense one, None
    for any other layout."""
    if t.is_contiguous():
        return 0
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    return None


def _operand(t: torch.Tensor, like: torch.Tensor, what: str) -> int:
    """``t``'s layout code where the kernel takes it beside ``like``, else
    raises."""
    layout = _layout(t) if t.dim() == 4 else None
    if (layout is None or t.dtype != torch.bfloat16 or not t.is_cuda or t.device != like.device
            or t.shape != like.shape or t.data_ptr() % 16):
        raise ValueError(
            f"the pre-norm kernel takes 4-D bfloat16 CUDA tensors, NCHW or channels_last, "
            f"16-byte aligned, of one shape and device; {what} is {t.dtype} "
            f"{tuple(t.shape)} with strides {t.stride()} on {t.device}")
    return layout


def _launch(x: torch.Tensor, residual: Optional[torch.Tensor],
            params: Optional[Tuple[torch.Tensor, torch.Tensor]],
            eps: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch: ``s`` (``x`` itself without a residual) and, with
    ``params`` (weight, bias), ``y``."""
    global LAUNCHES
    x_cl = _operand(x, x, "x")
    n, c, h, w = x.shape
    r_cl, s = 0, x
    if residual is not None:
        r_cl = _operand(residual, x, "the residual")
        s = torch.empty_like(x)              # x's layout, as the eager add returns it
    y, wb = None, (None, None)
    if params is not None:
        wb = tuple(p.detach().to(device=x.device, dtype=torch.float32).contiguous()
                   for p in params)
        if any(p.shape != (c,) for p in wb):
            raise ValueError(f"weight {tuple(params[0].shape)} and bias {tuple(params[1].shape)} "
                             f"do not match {c} channels")
        y = torch.empty((n, c, h, w), device=x.device, dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
    if not _fns:
        _fns.update(bind("prenorm", _SIGNATURE))

    def ptr(t):
        return None if t is None else t.data_ptr()

    index = x.get_device()
    err = launch(_fns["refid_prenorm"], index, x.data_ptr(), x_cl, ptr(residual), r_cl,
                 None if residual is None else s.data_ptr(), ptr(y), ptr(wb[0]), ptr(wb[1]),
                 n, c, h * w, eps, current_stream(index))
    if err:
        raise_on_error(load("prenorm"), err, "prenorm")
    with _count_lock:
        LAUNCHES += 1
    return s, y


def prenorm(x: torch.Tensor, residual: Optional[torch.Tensor], weight: torch.Tensor,
            bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``prenorm_reference(x, residual, weight, bias, eps)`` in one launch
    on the current stream: ``s`` (``x + residual``, in ``x``'s layout, or
    ``x`` itself without a residual) and ``y`` (bf16, channels_last).  The
    operands are 4-D bfloat16 CUDA tensors of one shape, NCHW or
    channels_last, else ``ValueError``; a width the kernel does not take
    (Restormer's 48 to 384 channels and Uformer's 32 to 512 are taken,
    ``csrc/prenorm.cu`` says which) raises the launcher's ``cudaErrorInvalidValue`` as
    ``RuntimeError``."""
    return _launch(x, residual, (weight, bias), eps)


def residual_add(x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``x + residual``: where :func:`engages` holds, the kernel's add
    alone (the operands as :func:`prenorm` takes them), else PyTorch's
    add."""
    if not engages(x):
        return x + residual
    return _launch(x, residual, None, 0.0)[0]
