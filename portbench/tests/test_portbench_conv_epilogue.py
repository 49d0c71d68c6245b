"""The readers ``conv_epilogue_share.vfi`` and ``conv_epilogue_ms.vfi`` on
synthetic traces.  The share: of the biased convs (spans ``refid.conv``)
inside the VFI network calls (``refid.vfi.network``), those that hold a span
``refid.conv.epilogue``; None where no conv span lies in a network call, so
the metric is left out on a program that opens none.  The ms: device ms a
window in the kernels of ``conv_epilogue_kernels.txt``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import ROOT, load_module
from portbench.trace import Trace

SHARE, MS = "conv_epilogue_share.vfi", "conv_epilogue_ms.vfi"
BIAS_ADD = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
            "at::native::CUDAFunctor_add<c10::BFloat16> >(at::TensorIteratorBase&, "
            "at::native::CUDAFunctor_add<c10::BFloat16> const&)::{lambda(int)#1}>(int, ...)")
LEAKY = ("void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
         "leaky_relu_kernel(at::TensorIteratorBase&, c10::Scalar const&)::{lambda()#1}>(...)")
RELU = ("void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
        "launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, "
        "at::native::detail::ClampLimits)::{lambda()#1}>(...)")
EPILOGUE = "void (anonymous namespace)::conv_epilogue_kernel<__nv_bfloat16, 0>(...)"
FLOAT_ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
             "c10::BFloat16>, std::array<char*, 3ul> >(...)")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32"


def _read(name, trace):
    return load_module(ROOT / "metrics" / f"{name}.py").read(SimpleNamespace(trace=trace))


def _window_spans(i, convs, finished):
    """Window ``i`` (3 s from 3i): a request, its network call over [3i + 1,
    3i + 2], ``convs`` conv spans in it, the first ``finished`` of them
    holding an epilogue span."""
    host = [("refid.vfi.request", 3 * i, 3 * i + 2.5),
            ("refid.vfi.network", 3 * i + 1, 3 * i + 2)]
    step = 1.0 / (convs + 1)
    for k in range(convs):
        a = 3 * i + 1 + (k + 0.5) * step
        host.append(("refid.conv", a, a + 0.5 * step))
        if k < finished:
            host.append(("refid.conv.epilogue", a + 0.3 * step, a + 0.4 * step))
    return host


@pytest.mark.parametrize("finished,share", [(4, 100.0), (1, 25.0), (0, 0.0)])
def test_share_of_the_convs_in_the_network(finished, share):
    """Three windows of four convs; the epilogue finishes the first
    ``finished`` of each (none: the eager path, which reads 0, not None).
    A conv span outside every network call counts in neither part, and an
    epilogue span outside every conv holds none."""
    host = [("portbench.pipeline", 0.0, 9.0), ("refid.conv", 9.1, 9.5),
            ("refid.conv.epilogue", 9.2, 9.3), ("refid.conv.epilogue", 9.6, 9.7)]
    for i in range(3):
        host += _window_spans(i, 4, finished)
    trace = Trace(0.0, 10.0, [("k", 0.5, 1.0)], sorted(host, key=lambda e: e[1]), 3)
    assert _read(SHARE, trace) == pytest.approx(share)


@pytest.mark.parametrize("host,calls", [
    ([("refid.task.upload", 0.0, 1.0), ("refid.task.network", 1.0, 8.0),
      ("refid.conv", 2.0, 3.0), ("refid.conv.epilogue", 2.1, 2.9)], 2),   # a deblur trace
    ([("refid.vfi.request", 0.0, 4.0), ("refid.vfi.network", 1.0, 2.0)], 1),   # no conv span
    ([("portbench.pipeline", 0.0, 4.0), ("aten::conv2d", 1.0, 2.0)], 1),
    ([("refid.vfi.network", 1.0, 2.0), ("refid.conv", 1.1, 1.9)], 0),
])
def test_share_none_without_convs_in_a_network_call(host, calls):
    assert _read(SHARE, Trace(0.0, 10.0, [("k", 1.0, 2.0)], host, calls)) is None


def test_device_ms_in_the_finishing_passes():
    """Two windows: the bias add, leaky ReLU, ReLU and epilogue kernels
    count (an overlap once), a conv and a vectorized add do not."""
    device = [(BIAS_ADD, 0.0, 0.010), (LEAKY, 0.010, 0.012), (RELU, 0.020, 0.021),
              (EPILOGUE, 0.030, 0.034), (EPILOGUE, 0.033, 0.035),
              (CONV, 0.040, 0.090), (FLOAT_ADD, 0.090, 0.095)]
    trace = Trace(0.0, 1.0, device, [], 2)
    assert _read(MS, trace) == pytest.approx((10 + 2 + 1 + 5) / 2)


@pytest.mark.parametrize("device,calls", [([(CONV, 0.0, 0.1), (FLOAT_ADD, 0.1, 0.2)], 2),
                                          ([(BIAS_ADD, 0.0, 0.1)], 0)])
def test_ms_none_without_finishing_passes(device, calls):
    assert _read(MS, Trace(0.0, 1.0, device, [], calls)) is None


@pytest.mark.parametrize("name", [SHARE, MS])
def test_none_without_a_trace(name):
    assert _read(name, None) is None
