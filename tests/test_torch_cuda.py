"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device.  On the GPU machine:
``python -m pytest tests/test_torch_cuda.py -m gpu``.
"""

import math

import numpy as np
import pytest
import torch

from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import voxelize_padded, voxelize_padded_reference

pytestmark = pytest.mark.gpu

# f32 atomics add in an order that varies; a cell sums a few votes of |v| <= 1
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _events(seed, cap, n_valid, w, h, margin=0):
    rng = np.random.RandomState(seed)
    ev = np.zeros((cap, 4), np.float32)
    ev[:n_valid, 0] = np.sort(rng.uniform(0, 5e4, n_valid))
    ev[:n_valid, 1] = rng.randint(-margin, w + margin, n_valid)
    ev[:n_valid, 2] = rng.randint(-margin, h + margin, n_valid)
    ev[:n_valid, 3] = rng.randint(0, 2, n_valid)
    return ev


@pytest.mark.parametrize("cap,n_valid,bins,w,h,margin", [
    (1 << 20, (1 << 20) - 1000, 24, 1280, 720, 0),   # the main path's shape
    (1 << 14, 0, 24, 1280, 720, 0),                   # empty stream
    (1 << 15, 20000, 24, 1280, 720, 8),               # out-of-frame events
    (2048, 1900, 5, 160, 48, 4),
])
def test_voxelize_kernel_matches_plain(cuda, cap, n_valid, bins, w, h, margin):
    ev = torch.from_numpy(_events(0, cap, n_valid, w, h, margin)).to(cuda)
    before = voxel_cuda.LAUNCHES
    got = voxelize_padded(ev, n_valid, bins, w, h)
    torch.cuda.synchronize()
    assert voxel_cuda.LAUNCHES == before + 1
    want = voxelize_padded_reference(ev, n_valid, bins, w, h)
    assert (got - want).abs().max().item() <= TOL


def test_voxelize_kernel_equal_stamps(cuda):
    ev = _events(1, 1 << 14, 5000, 64, 32)
    ev[:5000, 0] = 7.0
    ev = torch.from_numpy(ev).to(cuda)
    got = voxelize_padded(ev, 5000, 24, 64, 32)
    assert not got[1:].any()
    assert (got - voxelize_padded_reference(ev, 5000, 24, 64, 32)).abs().max().item() <= TOL


def test_voxelize_kernel_rejects_misaligned_buffer(cuda):
    ev = torch.zeros(65, device=cuda)[1:].view(16, 4)
    with pytest.raises(ValueError, match="aligned"):
        voxel_cuda.voxelize_cuda(ev, 4, 3, 8, 8)


def _stream(seed, n, w, h, margin=0):
    return _events(seed, n, n, w, h, margin)


@pytest.mark.parametrize("n,bins,w,h,margin,fmt", [
    (1 << 20, 24, 1280, 720, 0, "HWC"),    # the training datasets' shape
    (1 << 20, 24, 1280, 720, 0, "CHW"),
    (0, 24, 1280, 720, 0, "HWC"),          # empty stream: no launch
    (20000, 24, 1280, 720, 8, "HWC"),      # out-of-frame events
    (200000, 2, 1280, 720, 0, "HWC"),      # one_voxel_flag: false
    (1900, 5, 160, 48, 4, "CHW"),
])
def test_voxel_grid_kernel_matches_plain(cuda, n, bins, w, h, margin, fmt):
    from refid_tpu_torch.events.voxel import (
        events_to_voxel_grid, events_to_voxel_grid_reference,
    )
    ev = _stream(2, n, w, h, margin)
    before = voxel_cuda.GRID_LAUNCHES
    got = events_to_voxel_grid(ev, bins, w, h, fmt)
    assert voxel_cuda.GRID_LAUNCHES == before + (1 if n else 0)
    want = events_to_voxel_grid_reference(torch.from_numpy(ev).to(cuda), bins, w, h,
                                          fmt).cpu().numpy()
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_voxel_grid_kernel_equal_stamps(cuda):
    ev = _stream(3, 5000, 64, 32)
    ev[:, 0] = 7.0
    got = voxel_cuda.events_to_voxel_grid_cuda(ev, 24, 64, 32, "HWC")
    assert not got[..., 1:].any() and got[..., 0].any()


def test_voxel_grid_kernel_from_loader_threads(cuda):
    """The loader's threads each work on a stream of their own."""
    from concurrent.futures import ThreadPoolExecutor
    streams = [_stream(s, 50000, 320, 96) for s in range(8)]

    def work(ev):
        torch.cuda.set_stream(torch.cuda.Stream(cuda))
        return voxel_cuda.events_to_voxel_grid_cuda(ev, 24, 320, 96, "HWC")

    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(work, streams))
    for ev, g in zip(streams, got):
        from refid_tpu_torch.events.voxel import events_to_voxel_grid_reference
        want = events_to_voxel_grid_reference(torch.from_numpy(ev), 24, 320, 96, "HWC").numpy()
        assert np.abs(g - want).max() <= TOL


# ---- probe kernels P1-P4 (refid_tpu_torch/probes) ----

def _randn(seed, *shape, scale=1.0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)) * scale


@pytest.mark.parametrize("band", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_passthrough_kernel_matches_plain(cuda, dtype, band):
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import poison
    d = _randn(0, 1, 64, 360, 640, scale=50).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)                # the probe's d; 360 % 16 != 0
    before = probe_cuda.PASSTHROUGH_LAUNCHES
    got = poison.passthrough(d, band)
    assert probe_cuda.PASSTHROUGH_LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, poison.passthrough_reference(d))


def test_passthrough_kernel_unaligned_rows(cuda):
    """Rows whose bands do not start on 16 bytes take the scalar path."""
    from refid_tpu_torch.probes import poison
    d = _randn(1, 1, 3, 37, 5).to(cuda).contiguous(memory_format=torch.channels_last)
    assert torch.equal(poison.passthrough(d, 8), poison.passthrough_reference(d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tiny_passthrough_kernel_matches_plain(cuda, dtype):
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import poison
    d = _randn(2, 1, 64, 360, 640, scale=50).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    want = poison.tiny_passthrough_reference(d.clone())
    before = probe_cuda.SLICE_LAUNCHES
    got = poison.tiny_passthrough(d)
    assert probe_cuda.SLICE_LAUNCHES == before + 1 and got is d
    assert torch.equal(got, want)


def _conv_inputs(cuda, h, wp, seed=0):
    x = _randn(seed, h, wp, 128).to(cuda, torch.bfloat16)
    w = _randn(seed + 1, 3, 3, 128, 128, scale=0.05).to(cuda, torch.bfloat16)
    return x, w


@pytest.mark.parametrize("rolls", [True, False], ids=["roll", "noroll"])
@pytest.mark.parametrize("h,wp,band", [(720, 648, 8), (720, 648, 16), (48, 40, 8), (96, 40, 16)])
def test_band_conv_kernel_matches_plain(cuda, h, wp, band, rolls):
    """Within 2 bf16 steps (floored near zero, see ``bf16_steps``) and >= 60 dB:
    the float32 sums run in another order."""
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import band_conv as bc
    x, w = _conv_inputs(cuda, h, wp)
    before = probe_cuda.BAND_CONV_LAUNCHES
    got = bc.band_conv(x, w, band, rolls)
    torch.cuda.synchronize()
    assert probe_cuda.BAND_CONV_LAUNCHES == before + 1
    want = bc.band_conv_reference(x, w, band, rolls)
    steps = bc.bf16_steps(got, want, bc.STEP_FLOOR * float(want.float().abs().max()))
    assert float(steps.max()) <= 2
    span = float(want.float().max() - want.float().min())
    rmse = float(torch.sqrt(torch.mean((want.float() - got.float()) ** 2)))
    assert rmse == 0 or 20 * math.log10(span / rmse) >= 60.0


@pytest.mark.parametrize("kind,h,wp,band", [
    ("roll", 720, 648, 8), ("noroll", 720, 648, 8), ("pre", 720, 648, 8), ("roll", 96, 40, 16),
])
def test_band_conv_int8_kernel_matches_plain(cuda, kind, h, wp, band):
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import band_conv as bc
    x, w = _conv_inputs(cuda, h, wp, seed=5)
    wq = bc.quantize(w, 0.01)
    xi = bc.quantize(x, 0.05) if kind == "pre" else x
    before = probe_cuda.BAND_CONV_INT8_LAUNCHES
    got = bc.band_conv_int8(xi, wq, band, rolls=kind != "noroll", in_int8=kind == "pre")
    torch.cuda.synchronize()
    assert probe_cuda.BAND_CONV_INT8_LAUNCHES == before + 1
    want = bc.band_conv_int8_reference(xi, wq, band, rolls=kind != "noroll",
                                       in_int8=kind == "pre")
    assert torch.equal(got, want)


def test_band_conv_kernel_rejects_ragged_bands(cuda):
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import band_conv as bc
    x, w = _conv_inputs(cuda, 36, 40)
    with pytest.raises(ValueError, match="multiple of band"):
        bc.band_conv(x, w, 8)
    with pytest.raises(ValueError, match="multiple of band"):
        probe_cuda.band_conv_cuda(x, w, 8)


def test_library_conv_int8_on_the_card_matches_the_cpu(cuda):
    """The probe's int8 yardstick (nine ``torch._int_mm`` taps) is exact."""
    from refid_tpu_torch.probes import band_conv as bc
    x, w = _conv_inputs(cuda, 48, 40, seed=7)
    xq, wq = bc.quantize(x, 0.05), bc.quantize(w, 0.01)
    got = bc.library_conv_int8(xq, wq)
    assert torch.equal(got.cpu(), bc.library_conv_int8(xq.cpu(), wq.cpu()))
