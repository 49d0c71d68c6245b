"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device.  On the GPU machine:
``python -m pytest tests/test_torch_cuda.py -m gpu --noconftest`` (the
suite's conftest sets up JAX, which these tests do not use).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import INT8_EDGE_SHAPES
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import (
    voxel_norm_np, voxelize_padded, voxelize_padded_reference,
)

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
    assert voxel_cuda._bound("refid_voxel_sort_chunk")() == SORT_CHUNK


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
    (1 << 19, 6, 1280, 720, 0, "HWC", "uniform"),     # single-image datasets and demo
    (1 << 19, 6, 1280, 720, 0, "HWC", "skew"),
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


def early_stamp_stream(seed, n, bins, w, h, early):
    """Stamps 10 .. 20 in order (the first 10, the last 20) with ``early``
    of them replaced by stamps in [0, 10): at least a bin before the first
    with 5 bins, so only the right vote of some lands (in bin 0) and none of
    others."""
    ev = _stream(seed, n, w, h)
    rng = np.random.RandomState(seed + 1)
    ev[:, 0] = np.sort(rng.uniform(10.0, 20.0, n))
    ev[0, 0], ev[-1, 0] = 10.0, 20.0
    ev[rng.choice(np.arange(1, n - 1), early, replace=False), 0] = rng.uniform(0, 10, early)
    return ev


@pytest.mark.parametrize("n,bins,w,h,early", [(400, 5, 16, 12, 2), (1 << 20, 5, 1280, 720, 5000),
                                              (1 << 20, 24, 1280, 720, 5000)])
def test_kernels_keep_early_stamp_votes(cuda, n, bins, w, h, early):
    from refid_tpu_torch.events.voxel import events_to_voxel_grid_reference
    ev = early_stamp_stream(4, n, bins, w, h, early)
    ev_d = torch.from_numpy(ev).to(cuda)
    want = voxelize_padded_reference(ev_d, n, bins, w, h)
    assert (voxel_cuda.voxelize_cuda(ev_d, n, bins, w, h) - want).abs().max().item() <= TOL
    for fmt in ("CHW", "HWC"):
        got = voxel_cuda.events_to_voxel_grid_cuda(ev, bins, w, h, fmt)
        plain = events_to_voxel_grid_reference(ev_d, bins, w, h, fmt).cpu().numpy()
        assert np.abs(got - plain).max() <= TOL


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_padded_entry_runs_k1(cuda, fmt):
    """``events_to_voxel_grid_padded`` at the serving shape (10**6 events,
    padded to 2**20) against the plain version, through K1 once."""
    from refid_tpu_torch.events.voxel import events_to_voxel_grid_padded
    n = (1 << 20) - 48576
    ev = _stream(5, n, 1280, 720)
    before = voxel_cuda.LAUNCHES
    got = events_to_voxel_grid_padded(ev, 24, 1280, 720, fmt)
    assert voxel_cuda.LAUNCHES == before + 1 and got.device.type == "cuda"
    want = events_to_voxel_grid_padded(ev, 24, 1280, 720, fmt, device="cpu")
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= TOL


# ---- the voxel grid's normalisation (csrc/voxel_norm.cu) ----

def _numpy_chain(v):
    """``voxel_norm_np``'s numpy chain, written out: the plain version."""
    nonzero = v != 0
    count = nonzero.sum()
    if count == 0:
        return v
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = v.sum() / count
        std = np.sqrt((v ** 2).sum() / count - mean ** 2)
        return np.where(nonzero, (v - mean) / std, 0.0).astype(v.dtype)


def _page_locked(array):
    host = torch.empty(array.shape, dtype=torch.from_numpy(array).dtype, pin_memory=True)
    host.copy_(torch.from_numpy(array))
    return host.numpy()


@pytest.mark.parametrize("fmt,bins,w,h", [("HWC", 6, 1280, 720), ("CHW", 6, 1280, 720),
                                          ("CHW", 5, 97, 31)])     # 15035 floats: a ragged tail
def test_voxel_norm_card_matches_numpy(cuda, fmt, bins, w, h):
    """K2's grid (page-locked) is normalised on the card, one launch a call,
    within ``test_voxel_helpers_match_jax``'s tolerance of the numpy chain
    (which sums in float32), the same bits on a second call, its input left
    as it was."""
    grid = voxel_cuda.events_to_voxel_grid_cuda(_stream(6, 1 << 19, w, h), bins, w, h, fmt)
    assert torch.from_numpy(grid).is_pinned()
    kept = grid.copy()
    want = _numpy_chain(grid)
    before = voxel_cuda.NORM_LAUNCHES
    got = voxel_norm_np(grid)
    again = voxel_norm_np(grid)
    assert voxel_cuda.NORM_LAUNCHES == before + 2
    assert got is not grid and got.dtype == np.float32 and got.shape == grid.shape
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(got.view(np.uint32), again.view(np.uint32))
    assert np.array_equal(grid.view(np.uint32), kept.view(np.uint32))


@pytest.mark.parametrize("case", ["zeros", "single"])
def test_voxel_norm_card_edge_cases(cuda, case):
    """An all-zero grid comes back as the same object (its count read from
    the card); a single nonzero cell gives numpy's NaN there (std 0, so 0 /
    0).  1.5 squares exactly in float32, so numpy's float32 sums are exact
    too and both chains see std == 0."""
    grid = _page_locked(np.zeros((720, 1280, 6), np.float32))
    if case == "single":
        grid[300, 700, 2] = 1.5
    want = _numpy_chain(grid)
    before = voxel_cuda.NORM_LAUNCHES
    got = voxel_norm_np(grid)
    assert voxel_cuda.NORM_LAUNCHES == before + 1
    assert (got is grid) == (case == "zeros")
    np.testing.assert_array_equal(got, want)          # NaN where numpy has NaN
    assert np.isnan(got).sum() == (case == "single")


def test_voxel_norm_card_only_for_page_locked_contiguous_float32(cuda):
    """A pageable copy, a cropped view of a page-locked grid and a
    page-locked float64 grid take the numpy chain; the wrapper refuses a
    pageable grid."""
    grid = voxel_cuda.events_to_voxel_grid_cuda(_stream(7, 1 << 16, 160, 48), 6, 160, 48, "HWC")
    assert torch.from_numpy(grid).is_pinned()
    assert not torch.from_numpy(np.zeros((48, 160, 6), np.float32)).is_pinned()
    for other in (grid.copy(), grid[4:40, 8:150], _page_locked(grid.astype(np.float64))):
        before = voxel_cuda.NORM_LAUNCHES
        got = voxel_norm_np(other)
        assert voxel_cuda.NORM_LAUNCHES == before
        np.testing.assert_array_equal(got, _numpy_chain(other))
    with pytest.raises(ValueError, match="page-locked"):
        voxel_cuda.voxel_norm_cuda(grid.copy())


def test_voxel_norm_card_from_loader_threads(cuda):
    """The loader's threads, each on a stream of its own: every grid comes
    back with the bits one thread alone gives, and every call is counted."""
    from concurrent.futures import ThreadPoolExecutor
    grids = [voxel_cuda.events_to_voxel_grid_cuda(_stream(s, 50000, 320, 96), 6, 320, 96, "HWC")
             for s in range(8)]
    want = [voxel_norm_np(g) for g in grids]

    def work(g):
        torch.cuda.set_stream(torch.cuda.Stream(cuda))
        return voxel_norm_np(g)

    before = voxel_cuda.NORM_LAUNCHES
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(work, grids * 4))
    assert voxel_cuda.NORM_LAUNCHES == before + 32
    for g, w in zip(got, want * 4):
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


def test_voxel_norm_card_span_inside_the_normalisation(cuda):
    from torch.profiler import ProfilerActivity, profile
    grid = voxel_cuda.events_to_voxel_grid_cuda(_stream(8, 1 << 16, 160, 48), 6, 160, 48, "HWC")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        voxel_norm_np(grid)
        voxel_norm_np(grid.copy())
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.events.voxel_norm")), key=lambda s: (s[1], -s[2]))
    assert [s[0] for s in spans] == ["refid.events.voxel_norm", "refid.events.voxel_norm_card",
                                     "refid.events.voxel_norm"]
    (_, a, b), (_, c, d) = spans[:2]
    assert a <= c and d <= b


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


# --- int8 serving: csrc/conv_int8.cu ------------------------------------------

def _act(seed, *shape, dtype=torch.float32):
    """Activations with exact ties: a 1/8 grid, amax 127/8 (scale 1/8)."""
    x = torch.round(_randn(seed, *shape, scale=40.0).clamp(-127, 127)) / 8
    x.view(-1)[0] = 127 / 8
    x.view(-1)[1::7] += 1 / 16       # x / scale lands on .5
    return x.to(dtype)


# (n, c, h, w): pixel counts off the 16-byte vector (63; 260 in bf16), a
# whole and a partial 256-pixel tile, channels past one 32-channel run, n = 3
QUANTIZE_INT8_EDGES = [(2, 33, 7, 9), (1, 32, 16, 20), (3, 100, 5, 52), (1, 8, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [None, 0.05, 1e-13], ids=["dynamic", "static", "tiny"])
@pytest.mark.parametrize("shape", [(1, 24, 17, 19), (2, 64, 9, 40), (1, 256, 45, 80)]
                         + QUANTIZE_INT8_EDGES)
def test_quantize_int8_kernel_matches_plain(cuda, shape, scale, dtype):
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(3, *shape, dtype=dtype).to(cuda)
    before = int8_cuda.QUANTIZE_LAUNCHES
    got, got_s = quant.quantize_int8(x, scale)
    torch.cuda.synchronize()
    assert int8_cuda.QUANTIZE_LAUNCHES == before + 1
    want, want_s = quant.quantize_int8_reference(x, scale)
    assert torch.equal(got_s, want_s) and torch.equal(got, want)


# (n, cin, cout, h, w, k, stride, pad): toy widths (channels not a multiple
# of 32, M not of 128), then production shapes (scale-2 trunk conv_in,
# scale-1 down), then chip_smoke.py's edges of the conv's tile plan (one
# for each tile variant and store path of ops/int8_cuda.py::conv_plan)
CONV_INT8_SHAPES = [(1, 24, 16, 9, 13, 3, 1, 1), (2, 40, 136, 12, 20, 4, 2, 1),
                    (1, 512, 256, 180, 320, 3, 1, 1), (1, 128, 128, 360, 640, 4, 2, 1)]
CONV_INT8_SHAPES += INT8_EDGE_SHAPES


@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,cin,cout,h,w,k,stride,pad", CONV_INT8_SHAPES)
def test_conv_int8_kernel_matches_plain(cuda, n, cin, cout, h, w, k, stride, pad, out_dtype,
                                        act):
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(5, n, cin, h, w, dtype=torch.bfloat16).to(cuda)
    weight = _randn(6, cout, cin, k, k, scale=1 / math.sqrt(cin * k * k)).to(cuda)
    bias = None if act == "none" else _randn(7, cout, scale=0.1).to(cuda)
    wp, wscale, b = quant.WeightCache().packed(weight, bias)
    xq, s = quant.quantize_int8(x)
    args = (xq, wp, wscale, s, b, stride, pad, 0.1 if act == "leaky" else None,
            act == "relu", out_dtype)
    before = int8_cuda.CONV_LAUNCHES
    got = quant.conv_int8_packed(*args)
    torch.cuda.synchronize()
    assert int8_cuda.CONV_LAUNCHES == before + 1
    want = quant.conv_int8_reference(*args)
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_quantize_int8_dynamic_state_resets(cuda):
    """The dynamic amax state is zero again after each call: a smaller
    tensor after a larger one, on two streams, gets its own scale."""
    from refid_tpu_torch.serve import quant
    xs = [_act(12 + i, 1, 40, 30, 50).to(cuda) * g for i, g in enumerate((4.0, 0.5, 0.25))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for x in xs:
        for stream in (torch.cuda.current_stream(), side):
            with torch.cuda.stream(stream):
                got, got_s = quant.quantize_int8(x)
            stream.synchronize()
            want, want_s = quant.quantize_int8_reference(x)
            assert torch.equal(got_s, want_s) and torch.equal(got, want)


# EVHINet's 25 int8 sites at 1280x720 (wf 64), by distinct (cin, cout, h, w,
# k): stride 1, padding k // 2, no fused activation
EVHINET_INT8_SHAPES = [
    (64, 64, 720, 1280, 3), (64, 64, 720, 1280, 1), (64, 128, 720, 1280, 1),
    (128, 64, 720, 1280, 3), (128, 64, 720, 1280, 1),
    (64, 128, 360, 640, 3), (128, 128, 360, 640, 3), (64, 128, 360, 640, 1),
    (128, 256, 360, 640, 1), (256, 128, 360, 640, 3), (256, 128, 360, 640, 1),
    (128, 256, 180, 320, 3), (256, 256, 180, 320, 3), (128, 256, 180, 320, 1)]


@pytest.mark.parametrize("scale", [None, 0.05], ids=["dynamic", "static"])
@pytest.mark.parametrize("cin,h,w", sorted({(c, h, w) for c, _, h, w, _ in EVHINET_INT8_SHAPES}))
def test_quantize_int8_kernel_at_evhinet_sites(cuda, cin, h, w, scale):
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(8, 1, cin, h, w, dtype=torch.bfloat16).to(cuda)
    before = int8_cuda.QUANTIZE_LAUNCHES
    got, got_s = quant.quantize_int8(x, scale)
    torch.cuda.synchronize()
    assert int8_cuda.QUANTIZE_LAUNCHES == before + 1
    want, want_s = quant.quantize_int8_reference(x, scale)
    assert torch.equal(got_s, want_s) and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w,k", EVHINET_INT8_SHAPES)
def test_conv_int8_kernel_at_evhinet_sites(cuda, cin, cout, h, w, k, out_dtype):
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(9, 1, cin, h, w, dtype=torch.bfloat16).to(cuda)
    weight = _randn(10, cout, cin, k, k, scale=1 / math.sqrt(cin * k * k)).to(cuda)
    bias = _randn(11, cout, scale=0.1).to(cuda)
    wp, wscale, b = quant.WeightCache().packed(weight, bias)
    xq, s = quant.quantize_int8(x)
    args = (xq, wp, wscale, s, b, 1, k // 2, None, False, out_dtype)
    before = int8_cuda.CONV_LAUNCHES
    got = quant.conv_int8_packed(*args)
    torch.cuda.synchronize()
    assert int8_cuda.CONV_LAUNCHES == before + 1
    assert torch.equal(got, quant.conv_int8_reference(*args))


def test_evhinet_int8_on_the_card_matches_the_cpu(cuda):
    """A toy EVHINet (wf 16) in int8 on the card against the CPU, TF32 off:
    every one of its 25 sites in the CUDA kernels, >= 60 dB."""
    from refid_tpu_torch.models.evhinet import EVHINet
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    torch.manual_seed(0)
    net = EVHINet(wf=16).eval()
    x, ev = torch.rand(1, 3, 48, 64), _randn(12, 1, 6, 48, 64)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            cpu = net(x, ev, quant.QuantState(True))
            net.to(cuda)
            int8_cuda.reset_launches()
            card = net(x.to(cuda), ev.to(cuda), quant.QuantState(True)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert int8_cuda.CONV_LAUNCHES == int8_cuda.QUANTIZE_LAUNCHES == 25
    rmse = float(torch.sqrt(torch.mean((card - cpu) ** 2)))
    assert rmse == 0 or 20 * math.log10(float(cpu.max() - cpu.min()) / rmse) >= 60.0


def _int8_toy_pipeline(seed, int8, device):
    from refid_tpu_torch import BlurVFIPipeline, RefidConfig
    from refid_tpu_torch.models import FinalBidirectionAttenfusion
    cfg = RefidConfig(img_chn=8, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        state = FinalBidirectionAttenfusion(cfg).state_dict()
    return BlurVFIPipeline(state, cfg, m=2, n=1, int8=int8, device=device)


@pytest.mark.parametrize("mode", [True, "scale0", "static"])
def test_int8_pipeline_on_the_card_matches_the_cpu(cuda, mode):
    """The toy int8 pipeline (tests/test_torch_quant.py's config) on the card
    against its plain version on the CPU, TF32 off: at least 10 dB above the
    card's own int8-vs-exact dB, every site in the CUDA kernels."""
    from refid_tpu_torch.ops import int8_cuda

    def parity_db(want, got):
        span, rmse = want.max() - want.min(), np.sqrt(np.mean((want - got) ** 2))
        return math.inf if rmse == 0 else 20 * math.log10(span / rmse)

    rng = np.random.RandomState(17)
    h = w = 32
    b0, b1 = rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32)
    ev = np.stack([np.sort(rng.rand(800)), rng.randint(0, w, 800), rng.randint(0, h, 800),
                   rng.randint(0, 2, 800)], 1).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cpu = _int8_toy_pipeline(0, mode, "cuda"), _int8_toy_pipeline(0, mode, "cpu")
        exact = _int8_toy_pipeline(0, False, "cuda")(b0, b1, ev).cpu().numpy()
        if mode == "static":
            card.calibrate(b0, b1, ev)
            cpu.calibrate(b0, b1, ev)
            np.testing.assert_allclose(card.served.raw_amax, cpu.served.raw_amax, rtol=1e-5)
        int8_cuda.reset_launches()
        got = card(b0, b1, ev).cpu().numpy()
        sites = int8_cuda.CONV_LAUNCHES
        assert sites == int8_cuda.QUANTIZE_LAUNCHES == {True: 50, "scale0": 80, "static": 110}[mode]
        want = cpu(b0, b1, ev).numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert parity_db(want, got) >= parity_db(exact, got) + 10.0


# --- the float VFI pipeline in channels_last ------------------------------

def _layout_kernels_in_the_network(pipe, request):
    """The names of the layout kernels (``portbench/metrics/
    layout_kernels.txt``) that ops inside the span ``refid.vfi.network``
    launch, in one profiled request."""
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = Path(__file__).resolve().parent.parent / "portbench/metrics/layout_kernels.txt"
    names = [ln.strip() for ln in path.read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(*request)
        torch.cuda.synchronize()
    events = prof.events()
    (span,) = [e for e in events if e.device_type == DeviceType.CPU
               and e.name == "refid.vfi.network"]
    inside = [k.name for e in events if e.device_type == DeviceType.CPU
              and e.thread == span.thread and span.time_range.start <= e.time_range.start
              and e.time_range.end <= span.time_range.end for k in e.kernels]
    assert inside, "the profiler attached no kernel to the network's ops"
    return [k for k in inside if any(n in k for n in names)]


def test_channels_last_vfi_pipeline_on_the_card(cuda):
    """The float bf16 pipeline at production widths on a 128x192 window (t =
    23) serves channels_last: every module of the network (the convs, the
    LayerNorms, EGACA, the recurrent stages and decoders, the residual
    blocks, ``pred``) returns channels_last where its output has more than
    one pixel; its answer is as close to the float32 NCHW answer (TF32 off)
    as the same weights served NCHW in bf16 are; and no cuDNN layout kernel
    runs inside its network span, where the NCHW network launches them."""
    from portbench.weights import seeded_state
    from refid_tpu_torch import BlurVFIPipeline, RefidConfig
    from refid_tpu_torch.models import FinalBidirectionAttenfusion

    def nchw(pipe):
        pipe.served.channels_last = False
        pipe.model.to(memory_format=torch.contiguous_format)
        return pipe

    h, w = 128, 192
    rng = np.random.RandomState(23)
    request = (rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32),
               np.stack([np.sort(rng.rand(1 << 15)), rng.randint(0, w, 1 << 15),
                         rng.randint(0, h, 1 << 15), rng.randint(0, 2, 1 << 15)],
                        1).astype(np.float32))
    with torch.device("meta"):
        meta = FinalBidirectionAttenfusion(RefidConfig())
    state = seeded_state(meta, 22, cuda)
    bf16 = RefidConfig(dtype=torch.bfloat16)
    cl = BlurVFIPipeline(state, bf16, device=cuda)
    nc = nchw(BlurVFIPipeline(state, bf16, device=cuda))
    assert cl.channels_last
    nchw_outputs = []

    def hook(name):
        def check(module, inputs, out):
            for y in out if isinstance(out, tuple) else (out,):
                if (isinstance(y, torch.Tensor) and y.dim() == 4 and y.shape[-1] * y.shape[-2] > 1
                        and not y.is_contiguous(memory_format=torch.channels_last)):
                    nchw_outputs.append(name)
        return check

    handles = [m.register_forward_hook(hook(name)) for name, m in cl.model.named_modules()
               if name]
    cl(*request)
    for handle in handles:
        handle.remove()
    assert len(handles) > 100 and nchw_outputs == []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = nchw(BlurVFIPipeline(state, RefidConfig(), device=cuda))(*request)
        got, plain = cl(*request), nc(*request)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.shape == (23, h, w, 3) and got.is_contiguous()

    def rms(x):
        return float(x.float().square().mean().sqrt())

    err, err_nchw = rms(got - want), rms(plain - want)
    assert err <= 1.5 * err_nchw and err_nchw <= 1.5 * err, (err, err_nchw)
    assert rms(got - plain) < 0.05 * rms(want), (rms(got - plain), rms(want))
    assert _layout_kernels_in_the_network(nc, request)
    assert _layout_kernels_in_the_network(cl, request) == []


# --- row shards (parallel/spatial.py): C8 with its own row padding, Q8 on a
# device amax ---------------------------------------------------------------

def _shard_sites():
    """(name, cin, cout, input rows, w, k, stride): the 360-row half of a 720p
    frame at every production int8 site of blurry VFI (chip_smoke.py's
    INT8_CONV_SHAPES, the rows at the site's input scale) and of EVHINet
    (EVHINET_INT8_SHAPES), each with its halo rows (padding above, k -
    stride - padding below) in the tensor."""
    from chip_smoke import INT8_CONV_SHAPES
    sites = []
    for name, (cin, cout, h, w, k, stride) in INT8_CONV_SHAPES.items():
        sites.append((name, cin, cout, h * stride // 2 + k - stride, w * stride, k, stride))
    for i, (cin, cout, h, w, k) in enumerate(EVHINET_INT8_SHAPES):
        sites.append((f"evhinet{i}", cin, cout, h // 2 + k - 1, w, k, 1))
    return sites


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cin,cout,h,w,k,stride", _shard_sites(),
                         ids=[s[0] for s in _shard_sites()])
def test_conv_int8_kernel_row_padding_at_shard_shapes(cuda, name, cin, cout, h, w, k, stride,
                                                      out_dtype):
    """A shard's site: the halo rows in the tensor, row padding 0, column
    padding k // 2 (1 for the 4x4/2), bit for bit against the plain version."""
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(13, 1, cin, h, w, dtype=torch.bfloat16).to(cuda)
    weight = _randn(14, cout, cin, k, k, scale=1 / math.sqrt(cin * k * k)).to(cuda)
    bias = _randn(15, cout, scale=0.1).to(cuda)
    wp, wscale, b = quant.WeightCache().packed(weight, bias)
    xq, s = quant.quantize_int8(x)
    args = (xq, wp, wscale, s, b, stride, (0, 1 if k == 4 else k // 2), 0.1, False, out_dtype)
    before = int8_cuda.CONV_LAUNCHES
    got = quant.conv_int8_packed(*args)
    torch.cuda.synchronize()
    assert int8_cuda.CONV_LAUNCHES == before + 1
    assert got.shape[2] == (h - k) // stride + 1
    assert torch.equal(got, quant.conv_int8_reference(*args))


@pytest.mark.parametrize("padding", [(0, 1), (1, 0), (2, 1), (0, 2)])
@pytest.mark.parametrize("n,cin,cout,h,w,k,stride", [(1, 24, 16, 9, 13, 3, 1),
                                                     (2, 40, 136, 12, 20, 4, 2),
                                                     (1, 64, 64, 10, 40, 5, 1),
                                                     (1, 96, 32, 11, 19, 3, 1)])
def test_conv_int8_kernel_row_and_column_padding_apart(cuda, n, cin, cout, h, w, k, stride,
                                                       padding):
    from refid_tpu_torch.serve import quant
    x = _act(16, n, cin, h, w, dtype=torch.bfloat16).to(cuda)
    weight = _randn(17, cout, cin, k, k, scale=1 / math.sqrt(cin * k * k)).to(cuda)
    wp, wscale, b = quant.WeightCache().packed(weight, None)
    xq, s = quant.quantize_int8(x)
    args = (xq, wp, wscale, s, b, stride, padding, None, False, torch.float32)
    got = quant.conv_int8_packed(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, quant.conv_int8_reference(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 24, 17, 19), (1, 256, 45, 80), (1, 64, 362, 1280)]
                         + QUANTIZE_INT8_EDGES)
def test_quantize_int8_device_amax_matches_plain(cuda, shape, dtype):
    """Q8's device-amax mode (a shard quantized with the group's amax, here
    a larger one than its own, and its own) against the plain version; the
    amax pass alone against ``max |x|``.  The amax in device memory is left
    as it was."""
    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(18, *shape, dtype=dtype).to(cuda)
    before = int8_cuda.AMAX_LAUNCHES
    own = quant.amax_int8(x)
    torch.cuda.synchronize()
    assert int8_cuda.AMAX_LAUNCHES == before + 1
    assert torch.equal(own, x.float().abs().amax().reshape(1))
    for amax in (own, own * 3.5):
        kept = amax.clone()
        before = int8_cuda.QUANTIZE_LAUNCHES
        got, got_s = quant.quantize_int8(x, amax=amax)
        torch.cuda.synchronize()
        assert int8_cuda.QUANTIZE_LAUNCHES == before + 1 and torch.equal(amax, kept)
        want, want_s = quant.quantize_int8_reference(x, amax=amax)
        assert torch.equal(got_s, want_s) and torch.equal(got, want)


# ---- the launch path: ABI, amax in one launch, P1's band pieces, threads --------------

def test_conv_int8_abi_matches_the_structure(cuda):
    """``refid_conv_int8_abi`` (the C struct as compiled) against the
    ctypes ``ConvArgs``: its size, then each field's offset."""
    import ctypes

    from refid_tpu_torch.ops import int8_cuda
    fields = [name for name, _ in int8_cuda.ConvArgs._fields_]
    out = (ctypes.c_longlong * 64)()
    count = int8_cuda._bound("refid_conv_int8_abi")(out, 64)
    assert list(out[:count]) == ([ctypes.sizeof(int8_cuda.ConvArgs)]
                                 + [getattr(int8_cuda.ConvArgs, f).offset for f in fields])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 256, 182, 640), (1, 3, 5, 7), (2, 32, 64, 64)])
def test_amax_pass_is_one_launch_and_leaves_its_state_zero(cuda, shape, dtype):
    """The amax pass alone: one kernel a call, a new result each call equal
    to ``max |x|``, the stream's state zero after it (so that a dynamic
    quantization on the same stream reads its own amax)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from refid_tpu_torch.ops import int8_cuda
    from refid_tpu_torch.serve import quant
    x = _act(19, *shape, dtype=dtype).to(cuda)
    small = x * 0.25
    int8_cuda.amax_int8_cuda(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = int8_cuda.amax_int8_cuda(x)
        second = int8_cuda.amax_int8_cuda(small)
        torch.cuda.synchronize()
    launches = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(launches) == 2 and all("amax_kernel" in n for n in launches), launches
    assert first is not second
    assert torch.equal(first, x.float().abs().amax().reshape(1))
    assert torch.equal(second, small.float().abs().amax().reshape(1))
    stream = torch.cuda.current_stream().cuda_stream
    assert not int8_cuda._AMAX_STATE[(x.get_device(), stream)].any()
    got, got_s = quant.quantize_int8(small)
    want, want_s = quant.quantize_int8_reference(small)
    assert torch.equal(got_s, want_s) and torch.equal(got, want)


@pytest.mark.parametrize("shape,band", [((1, 64, 360, 640), 8), ((1, 64, 360, 640), 16),
                                        ((2, 8, 9, 33), 8), ((1, 4, 3, 2), 8),
                                        ((1, 128, 720, 640), 8), ((1, 1, 1000, 8), 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_passthrough_band_pieces_match_plain(cuda, shape, band, dtype):
    """P1 with each band split over several blocks: short last bands, rows
    shorter than a block's share, fewer rows than a band, one row a band."""
    from refid_tpu_torch.probes import poison
    d = _randn(3, *shape, scale=50).to(cuda, dtype).contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(poison.passthrough(d, band), poison.passthrough_reference(d))


@pytest.mark.parametrize("shape,channels_last", [((1, 64, 360, 640), True),
                                                  ((2, 3, 5, 40), False),
                                                  ((1, 1, 8, 128), False),
                                                  ((1, 2, 9, 200), True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tiny_passthrough_window_from_strides(cuda, shape, channels_last, dtype):
    """P2 reads ``d[0, 0, :8, :128]`` from ``d``'s strides, the window
    clipped to H x W as the slice is, in either memory order."""
    from refid_tpu_torch.probes import poison
    d = _randn(4, *shape, scale=50).to(cuda, dtype)
    if channels_last:
        d = d.contiguous(memory_format=torch.channels_last)
    want = poison.tiny_passthrough_reference(d.clone())
    assert torch.equal(poison.tiny_passthrough(d), want)


_THREAD_SCRIPT = r"""
import sys, threading
import torch
from refid_tpu_torch.ops import int8_cuda, probe_cuda
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import voxelize_padded_reference
from refid_tpu_torch.probes import band_conv as bc, poison
from refid_tpu_torch.serve import quant

cuda = torch.device("cuda")
gen = torch.Generator().manual_seed(7)
def act(*shape):
    x = torch.randn(*shape, generator=gen)
    return torch.maximum(x, 0.1 * x).to(cuda, torch.bfloat16)
convs = []     # three instantiations, three shared-memory sizes
for cin, cout, h, w, k, stride in ((64, 16, 24, 40, 3, 1), (128, 64, 33, 72, 3, 1),
                                   (256, 128, 30, 64, 4, 2)):
    x = act(1, cin, h, w)
    weight = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to(cuda)
    wp, wscale, b = quant.WeightCache().packed(weight, None)
    xq, xs = quant.quantize_int8_reference(x)
    args = (xq, wp, wscale, xs, b, stride, 1, 0.1, False, torch.bfloat16)
    convs.append((args, quant.conv_int8_reference(*args)))
xa = act(1, 32, 50, 70)
d = act(1, 64, 40, 64).contiguous(memory_format=torch.channels_last)
x3 = torch.randn(48, 40, 128, generator=gen).to(cuda, torch.bfloat16)
w3 = (0.05 * torch.randn(3, 3, 128, 128, generator=gen)).to(cuda, torch.bfloat16)
ev = torch.zeros(4096, 4)
ev[:4000, 0] = torch.sort(torch.rand(4000, generator=gen) * 5e4).values
ev[:4000, 1] = torch.randint(0, 160, (4000,), generator=gen).float()
ev[:4000, 2] = torch.randint(0, 48, (4000,), generator=gen).float()
ev[:4000, 3] = torch.randint(0, 2, (4000,), generator=gen).float()
ev = ev.to(cuda)
wants = {"amax": xa.float().abs().amax().reshape(1), "p1": poison.passthrough_reference(d),
         "p3": bc.band_conv_reference(x3, w3, 8),
         "k1": voxelize_padded_reference(ev, 4000, 5, 160, 48)}
p3_floor = bc.STEP_FLOOR * float(wants["p3"].float().abs().max())
torch.cuda.synchronize()
faults = []
def work(i):
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for _ in range(3):
            for args, want in convs[i % 3:] + convs[:i % 3]:
                if not torch.equal(quant.conv_int8_packed(*args), want):
                    faults.append(("conv", i))
            got = {"amax": int8_cuda.amax_int8_cuda(xa), "p1": poison.passthrough(d),
                   "p3": bc.band_conv(x3, w3, 8),
                   "k1": voxel_cuda.voxelize_cuda(ev, 4000, 5, 160, 48)}
            stream.synchronize()
            for k, v in got.items():
                if k == "k1":      # shared-memory float atomics: order varies, TOL
                    same = (v - wants[k]).abs().max().item() <= 1e-4
                elif k == "p3":    # float32 sums in another order: 2 bf16 steps
                    same = bc.bf16_steps(v, wants[k], p3_floor).max().item() <= 2
                else:
                    same = torch.equal(v, wants[k])
                if not same:
                    faults.append((k, i))
threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
alive = [t for t in threads if t.is_alive()]
print("OK" if not faults and not alive else f"faults {faults} alive {len(alive)}")
"""


def test_first_launches_from_threads_and_streams_hit_the_caches(cuda):
    """In a fresh process, the first launch of every kernel comes from one
    of four threads, each on its own stream: the SM counts and shared-memory
    limits set once, the bound functions and the per-stream amax states
    serve every thread, and each result equals its plain version."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _THREAD_SCRIPT], cwd=repo,
                         env={**os.environ, "PYTHONPATH": str(repo)}, capture_output=True,
                         text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1:] == ["OK"], out.stdout + out.stderr
