"""The end of a biased conv: its bias, then the activation that its module
applies next, and the conv layer's one entry point that decides how.

:func:`biased_conv` is what every conv module of the port calls
(``parallel/spatial.py::HaloConv2d``, ``models/layers.py::ConvTranspose2d``).
PyTorch's cuDNN backend does not hand a conv's bias to cuDNN:
``aten::_convolution`` runs the conv and then ``output.add_(bias)``, a
broadcast add that runs in TensorIterator's unvectorized kernel, and the
activation that follows is another pass over the output.  Where PyTorch's
own backend choice for the call is cuDNN's (``torch._C._select_conv_backend``:
``Cudnn`` or ``CudnnTranspose``), the input is a CUDA tensor and gradients
are off (every served call: ``serve/network.py`` runs under
``inference_mode``), the conv runs without its bias and
:func:`conv_epilogue_` finishes its output in place in one hand-written pass
(``csrc/conv_epilogue.cu``, its own library), inside the profiler span
``refid.conv.epilogue``; an engaged conv whose output the kernel does not
take raises, so none ends in the plain version unseen.  Everything else
(training, the CPU, other backends, whose bias is fused into the conv and
rounds differently) runs the conv with its bias and :func:`activate`, as
PyTorch alone would.  Each biased conv through the entry point is the span
``refid.conv``.

The kernel computes the eager chain step by step, rounded to the output
dtype after each step as PyTorch's opmath does, so its outputs are the
eager chain's bits: :func:`epilogue_reference` is its plain version, held
against it by ``tests/test_torch_conv_epilogue.py`` on the card.
``LAUNCHES`` counts its launches.

``act`` is None, ``"relu"``, a leaky ReLU's slope, or a tuple of slopes
applied in turn (the encoder stage's two stacked leaky ReLUs); the kernel
takes at most two.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.ops.build import bind, current_stream, launch, load, raise_on_error

__all__ = ["LAUNCHES", "Act", "activate", "epilogue_reference", "engages", "conv_epilogue_",
           "biased_conv"]

Act = Union[None, str, float, Tuple[float, ...]]
LAUNCHES = 0
_count_lock = threading.Lock()
_fns = {}        # C function name -> bound function, filled at first launch
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURE = {"refid_conv_epilogue": [_P, _I, _LL, _I, _LL, _P, _I, _F, _F, _P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CUDNN = (torch._C._ConvBackend.Cudnn, torch._C._ConvBackend.CudnnTranspose)


def _slopes(act: Act) -> Tuple[float, ...]:
    return (act,) if isinstance(act, (int, float)) else tuple(act)


def activate(y: torch.Tensor, act: Act) -> torch.Tensor:
    """``act`` applied to ``y`` by PyTorch's own ops."""
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    for slope in _slopes(act):
        y = F.leaky_relu(y, slope)
    return y


def epilogue_reference(y: torch.Tensor, bias: torch.Tensor, act: Act) -> torch.Tensor:
    """The plain version of :func:`conv_epilogue_`: what the cuDNN backend
    does after the conv (the bias, cast to ``y``'s dtype as autocast casts
    it, added in place), then :func:`activate`."""
    return activate(y.add_(bias.to(y.dtype).reshape(1, -1, 1, 1)), act)


def _act_args(act: Act) -> Optional[Tuple[int, float, float]]:
    """The kernel's (activation code, slope, second slope), or None where
    it cannot apply ``act``."""
    if act is None:
        return 0, 0.0, 0.0
    if act == "relu":
        return 1, 0.0, 0.0
    slopes = _slopes(act)
    if len(slopes) == 1:
        return 2, float(slopes[0]), 0.0
    if len(slopes) == 2:
        return 3, float(slopes[0]), float(slopes[1])
    return None


def _run(y: torch.Tensor) -> Optional[int]:
    """Elements of ``y`` that share a channel before the next one: its
    plane for a contiguous NCHW tensor, 1 for channels_last; None for any
    other layout."""
    if y.is_contiguous():
        return y.shape[2] * y.shape[3]
    if y.is_contiguous(memory_format=torch.channels_last):
        return 1
    return None


def _kernel_args(y: torch.Tensor, act: Act):
    """(dtype code, run, activation code, slope, second slope) where the
    kernel takes the conv output ``y`` and ``act``, else None: a 4-D CUDA
    tensor of float32 or bfloat16, contiguous NCHW or channels_last,
    16-byte aligned, of 1 to 2**31 - 1 elements, and an ``act`` of at most
    two steps."""
    if not (y.is_cuda and y.dim() == 4 and y.dtype in _DTYPE_CODE
            and 0 < y.numel() < 2 ** 31 and y.data_ptr() % 16 == 0):
        return None
    run, act_args = _run(y), _act_args(act)
    if run is None or act_args is None:
        return None
    return (_DTYPE_CODE[y.dtype], run) + act_args


def conv_epilogue_(y: torch.Tensor, bias: torch.Tensor, act: Act) -> torch.Tensor:
    """``epilogue_reference(y, bias, act)`` in one launch on the current
    stream, in place: ``y`` (a conv output the kernel takes, see
    :func:`_kernel_args`) gets ``bias`` (its channels' values, any float
    dtype) rounded to ``y``'s dtype, then ``act``.  Returns ``y``."""
    args = _kernel_args(y, act)
    if args is None:
        raise ValueError(f"the conv epilogue takes a 4-D float32 / bfloat16 CUDA tensor, "
                         f"contiguous or channels_last, and an act of at most two steps; "
                         f"got {y.dtype} {tuple(y.shape)} on {y.device}, act {act!r}")
    if bias.shape != (y.shape[1],) or bias.device != y.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device} does not match "
                         f"{y.shape[1]} channels on {y.device}")
    return _launch(y, bias, args)


def _launch(y: torch.Tensor, bias: torch.Tensor, args) -> torch.Tensor:
    global LAUNCHES
    if not _fns:
        _fns.update(bind("conv_epilogue", _SIGNATURE))
    dtype, run, code, slope, slope2 = args
    b = bias if bias.dtype == torch.float32 else bias.float()
    index = y.get_device()
    err = launch(_fns["refid_conv_epilogue"], index, y.data_ptr(), dtype, y.numel(),
                 y.shape[1], run, b.data_ptr(), code, slope, slope2, current_stream(index))
    if err:
        raise_on_error(load("conv_epilogue"), err, "conv_epilogue")
    with _count_lock:
        LAUNCHES += 1
    return y


def _backend_is_cudnn(module, x: torch.Tensor) -> bool:
    return torch._C._select_conv_backend(
        x, module.weight, module.bias, module.stride, module.padding, module.dilation,
        module.transposed, module.output_padding, module.groups, None) in _CUDNN


def _cudnn_adds_bias(module, x: torch.Tensor) -> bool:
    """Whether ``x`` is float32 or bfloat16 and PyTorch's backend for
    ``module``'s conv of it is cuDNN's (``torch._C._select_conv_backend``),
    kept in the module's ``cudnn_choice`` by what that choice reads of a
    call: the input's dtype and memory format, the weight's, and cuDNN's
    switches.  Asking costs ~8.5 us of host time on the card's machine,
    ~13 ms a VFI window.  False for an input of 2**31 elements or more."""
    if x.numel() >= 2 ** 31:
        return False
    weight = module.weight
    key = (x.dtype, x.is_contiguous(), weight.dtype, weight.is_contiguous(),
           torch._C._get_cudnn_enabled(), torch._C._get_cudnn_deterministic())
    adds = module.cudnn_choice.get(key)
    if adds is None:
        adds = module.cudnn_choice[key] = (x.dtype in _DTYPE_CODE
                                           and _backend_is_cudnn(module, x))
    return adds


def engages(module, x: torch.Tensor) -> bool:
    """True where the entry point runs ``module``'s conv without its bias
    and finishes it with the kernel: a float32 or bfloat16 CUDA input of
    fewer than 2**31 elements, gradients off, and PyTorch's backend for the
    call is cuDNN's, which adds the bias in a pass of its own (any other
    backend fuses it)."""
    return x.is_cuda and not torch.is_grad_enabled() and _cudnn_adds_bias(module, x)


def biased_conv(module, x: torch.Tensor, act: Act,
                conv: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]):
    """``act(conv(x, module.bias))``, the conv layer's entry point:
    ``conv(x, bias)`` is ``module``'s conv with the given bias (None: none).
    Where :func:`engages` holds, the conv runs without its bias and
    :func:`conv_epilogue_` finishes it, which raises where the kernel does
    not take the output (a float16 output under float16 autocast, one of
    2**31 elements or more); the outputs are the same bits.  ``module``
    keeps the rule's cache as ``cudnn_choice``, a dict."""
    bias = module.bias
    if bias is None:
        return activate(conv(x, None), act)
    with span("refid.conv"):
        if not engages(module, x):
            return activate(conv(x, bias), act)
        y = conv(x, None)
        with span("refid.conv.epilogue"):
            return conv_epilogue_(y, bias, act)
