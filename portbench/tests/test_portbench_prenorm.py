"""The readers ``norm_card_share.restormer`` and ``norm_ms.restormer`` on
synthetic traces.  The share: of Restormer's pre-norms (spans
``refid.restormer.norm``), those that hold a span
``refid.restormer.norm_card``; None where the trace holds no pre-norm span,
so the metric is left out on a program that opens none.  The ms: device ms
an image in the kernels of ``norm_kernels.txt``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import ROOT, load_module
from portbench.trace import Trace

SHARE, MS = "norm_card_share.restormer", "norm_ms.restormer"
LAYER_NORM = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, "
              "false>(int, float, float const*, float const*, float const*, float*, float*, "
              "float*)")
PRENORM = "(anonymous namespace)::prenorm_kernel((anonymous namespace)::Args)"
STRIDED_ADD = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
               "at::native::CUDAFunctor_add<c10::BFloat16> >(at::TensorIteratorBase&, "
               "at::native::CUDAFunctor_add<c10::BFloat16> const&)::{lambda(int)#1}>(int, ...)")
GROUP_NORM = "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(...)"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32"


def _read(name, trace):
    return load_module(ROOT / "metrics" / f"{name}.py").read(SimpleNamespace(trace=trace))


def _image_spans(i, norms, on_card):
    """Image ``i`` (3 s from 3i): its network call, ``norms`` pre-norm
    spans in it, the first ``on_card`` of them holding a card span."""
    host = [("refid.task.network", 3 * i + 1, 3 * i + 2)]
    step = 1.0 / (norms + 1)
    for k in range(norms):
        a = 3 * i + 1 + (k + 0.5) * step
        host.append(("refid.restormer.norm", a, a + 0.5 * step))
        if k < on_card:
            host.append(("refid.restormer.norm_card", a + 0.1 * step, a + 0.4 * step))
    return host


@pytest.mark.parametrize("on_card,share", [(4, 100.0), (1, 25.0), (0, 0.0)])
def test_share_of_the_pre_norms_on_the_card(on_card, share):
    """Three images of four pre-norms; the kernel runs the first ``on_card``
    of each (none: the eager path, which reads 0, not None).  A card span
    outside every pre-norm holds none."""
    host = [("portbench.pipeline", 0.0, 9.0), ("refid.restormer.norm_card", 9.6, 9.7)]
    for i in range(3):
        host += _image_spans(i, 4, on_card)
    trace = Trace(0.0, 10.0, [("k", 0.5, 1.0)], sorted(host, key=lambda e: e[1]), 3)
    assert _read(SHARE, trace) == pytest.approx(share)


@pytest.mark.parametrize("host,calls", [
    ([("refid.task.upload", 0.0, 1.0), ("refid.task.network", 1.0, 8.0),
      ("refid.restormer.block", 2.0, 3.0)], 2),                       # the parent: no norm span
    ([("portbench.pipeline", 0.0, 4.0), ("aten::layer_norm", 1.0, 2.0)], 1),
    ([("refid.restormer.norm", 1.0, 2.0), ("refid.restormer.norm_card", 1.1, 1.9)], 0),
])
def test_share_none_without_pre_norm_spans(host, calls):
    assert _read(SHARE, Trace(0.0, 10.0, [("k", 1.0, 2.0)], host, calls)) is None


def test_device_ms_in_the_pre_norm_kernels():
    """Two images: PyTorch's LayerNorm and the pre-norm kernel count (an
    overlap once); the strided add, another norm's kernel and a conv do
    not."""
    device = [(LAYER_NORM, 0.0, 0.010), (PRENORM, 0.020, 0.024), (PRENORM, 0.023, 0.026),
              (STRIDED_ADD, 0.030, 0.040), (GROUP_NORM, 0.040, 0.045), (CONV, 0.050, 0.090)]
    trace = Trace(0.0, 1.0, device, [], 2)
    assert _read(MS, trace) == pytest.approx((10 + 6) / 2)


@pytest.mark.parametrize("device,calls", [([(CONV, 0.0, 0.1), (STRIDED_ADD, 0.1, 0.2)], 2),
                                          ([(PRENORM, 0.0, 0.1)], 0)])
def test_ms_none_without_pre_norm_kernels(device, calls):
    assert _read(MS, Trace(0.0, 1.0, device, [], calls)) is None


@pytest.mark.parametrize("name", [SHARE, MS])
def test_none_without_a_trace(name):
    assert _read(name, None) is None
