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

# shared-memory f32 atomics add a tile's votes in an order that varies; a
# cell sums a few votes of |v| <= 1
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _events(seed, cap, n_valid, w, h, margin=0, kind="uniform"):
    """``kind``: ``uniform``, ``skew`` (every event in 8 rows) or ``pixel``
    (every event on one pixel, at whole-bin stamps 0 .. 23 of 24 bins: each
    vote is +-1 or +-0, so every cell's sum is exact in any order)."""
    rng = np.random.RandomState(seed)
    ev = np.zeros((cap, 4), np.float32)
    ev[:n_valid, 0] = np.sort(rng.uniform(0, 5e4, n_valid))
    ev[:n_valid, 1] = rng.randint(-margin, w + margin, n_valid)
    ev[:n_valid, 2] = rng.randint(-margin, h + margin, n_valid)
    ev[:n_valid, 3] = rng.randint(0, 2, n_valid)
    if kind == "skew":
        ev[:n_valid, 2] = rng.randint(h // 2 - 4, h // 2 + 4, n_valid)
    elif kind == "pixel":
        ev[:n_valid, 0] = np.sort(rng.randint(0, 24, n_valid))
        ev[0, 0], ev[n_valid - 1, 0] = 0, 23
        ev[:n_valid, 1], ev[:n_valid, 2] = w // 2, h // 2
    return ev


@pytest.mark.parametrize("cap,n_valid,bins,w,h,margin,kind", [
    (1 << 20, (1 << 20) - 1000, 24, 1280, 720, 0, "uniform"),   # the main path's shape
    (1 << 14, 0, 24, 1280, 720, 0, "uniform"),                   # empty stream
    (1 << 15, 20000, 24, 1280, 720, 8, "uniform"),               # out-of-frame events
    (2048, 1900, 5, 160, 48, 4, "uniform"),
    (1 << 20, (1 << 20) - 1000, 24, 1280, 720, 0, "skew"),
    (1 << 16, 1 << 16, 24, 1280, 720, 0, "pixel"),
    (1 << 16, 60000, 24, 346, 260, 2, "uniform"),               # DAVIS346: width % 4 != 0
    (1 << 18, 200000, 24, 2560, 64, 0, "uniform"),               # a row split in four tiles
])
def test_voxelize_kernel_matches_plain(cuda, cap, n_valid, bins, w, h, margin, kind):
    ev = torch.from_numpy(_events(0, cap, n_valid, w, h, margin, kind)).to(cuda)
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


@pytest.mark.parametrize("bins,w,h", [(24, 1280, 720), (2, 1280, 720), (24, 2560, 64),
                                      (24, 346, 260), (24, 2001, 10)])
def test_kernel_tile_plan_matches_python(cuda, bins, w, h):
    from refid_tpu_torch.events.voxel import SORT_CHUNK, voxel_tile_plan
    assert voxel_cuda.kernel_tile_plan(bins, w, h) == voxel_tile_plan(bins, w, h)
    assert voxel_cuda._library().refid_voxel_sort_chunk() == SORT_CHUNK


@pytest.mark.parametrize("fmt", [None, "CHW", "HWC"], ids=["k1", "k2_chw", "k2_hwc"])
def test_kernels_fill_a_grid_over_garbage(cuda, fmt):
    """The tile pass writes every grid float: a grid allocated in freed memory
    that held NaN comes out equal to the plain version."""
    from refid_tpu_torch.events.voxel import events_to_voxel_grid_reference
    bins, w, h, n = 24, 346, 260, 60000      # events and scratch < 1 MB: the small pool
    ev = _events(4, n, n, w, h)
    ev_d = torch.from_numpy(ev).to(cuda)
    garbage = torch.full((bins * h * w,), float("nan"), device=cuda)
    ptr = garbage.data_ptr()
    del garbage
    if fmt is None:
        got = voxel_cuda.voxelize_cuda(ev_d, n, bins, w, h)
        assert got.data_ptr() == ptr
        want = voxelize_padded_reference(ev_d, n, bins, w, h)
        assert (got - want).abs().max().item() <= TOL
    else:
        got = voxel_cuda.events_to_voxel_grid_cuda(ev, bins, w, h, fmt)
        want = events_to_voxel_grid_reference(ev_d, bins, w, h, fmt).cpu().numpy()
        assert np.abs(got - want).max() <= TOL


def _stream(seed, n, w, h, margin=0, kind="uniform"):
    return _events(seed, n, n, w, h, margin, kind)


@pytest.mark.parametrize("n,bins,w,h,margin,fmt,kind", [
    (1 << 20, 24, 1280, 720, 0, "HWC", "uniform"),    # the training datasets' shape
    (1 << 20, 24, 1280, 720, 0, "CHW", "uniform"),
    (0, 24, 1280, 720, 0, "HWC", "uniform"),          # empty stream: no launch
    (20000, 24, 1280, 720, 8, "HWC", "uniform"),      # out-of-frame events
    (200000, 2, 1280, 720, 0, "HWC", "uniform"),      # one_voxel_flag: false
    (1900, 5, 160, 48, 4, "CHW", "uniform"),
    *[(*case[:5], fmt, case[5]) for fmt in ("CHW", "HWC") for case in [
        (1 << 20, 24, 1280, 720, 0, "skew"),
        (1 << 16, 24, 1280, 720, 0, "pixel"),
        (60000, 24, 346, 260, 2, "uniform"),          # DAVIS346: width % 4 != 0
        (200000, 24, 2560, 64, 0, "uniform"),         # a row split in four tiles
        (200000, 2, 1280, 720, 0, "skew"),            # many rows a tile
    ]],
])
def test_voxel_grid_kernel_matches_plain(cuda, n, bins, w, h, margin, fmt, kind):
    from refid_tpu_torch.events.voxel import (
        events_to_voxel_grid, events_to_voxel_grid_reference,
    )
    ev = _stream(2, n, w, h, margin, kind)
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


# The kernel's edges (interior rows m2 = (band - 2) WP; tiles of 256 rows in
# bf16 / int8 x, 128 with x quantized in the kernel): the probe's shape; band
# 3 (m2 = WP, one short tile per band); m2 a whole number of tiles (384 =
# 3 x 128, 768 = 3 x 256); WP not a multiple of 8; both roll wraps in one
# tile (48, 40, 8) and in a band's first and last of several (96, 40, 16).
BAND_CONV_SHAPES = [(720, 648, 8), (720, 648, 16), (48, 40, 8), (96, 40, 16), (9, 40, 3),
                    (12, 648, 3), (64, 64, 8), (64, 128, 8), (48, 36, 8)]


@pytest.mark.parametrize("rolls", [True, False], ids=["roll", "noroll"])
@pytest.mark.parametrize("h,wp,band", BAND_CONV_SHAPES)
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


@pytest.mark.parametrize("h,wp,band", BAND_CONV_SHAPES)
@pytest.mark.parametrize("kind", ["roll", "noroll", "pre"])
def test_band_conv_int8_kernel_matches_plain(cuda, kind, h, wp, band):
    from refid_tpu_torch.ops import probe_cuda
    from refid_tpu_torch.probes import band_conv as bc
    x, w = _conv_inputs(cuda, h, wp, seed=5)
    x = x * 4            # spread the activations over the int8 range
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
