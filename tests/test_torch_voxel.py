"""refid_tpu_torch.events.voxel against the JAX package's voxelizers (CPU).

The port drops out-of-frame events, as the Pallas kernel ``voxelize_device``
does; ``_voxelize_padded`` wraps an x >= width event into the next row, so it
is compared on in-frame streams only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from refid_tpu.events.voxel import _voxelize_padded, voxel_norm as jax_voxel_norm
from refid_tpu.events.voxel_pallas import voxelize_device
from refid_tpu_torch.events.voxel import (
    events_to_voxel_grid, events_to_voxel_grid_padded, next_capacity, voxel_norm,
    voxelize_padded, voxelize_padded_reference,
)
from refid_tpu_torch.events.voxel_cuda import voxelize_cuda

torch.set_num_threads(1)


def _events(rng, cap, n_valid, w, h, pols=(0.0, 1.0, -1.0), t_span=1.0):
    ev = np.zeros((cap, 4), np.float32)
    ev[:n_valid, 0] = np.sort(rng.uniform(0.0, t_span, n_valid))
    ev[:n_valid, 1] = rng.randint(0, w, n_valid)
    ev[:n_valid, 2] = rng.randint(0, h, n_valid)
    ev[:n_valid, 3] = rng.choice(pols, n_valid)
    return ev


def _jax_scatter(ev, n_valid, bins, w, h):
    return np.asarray(_voxelize_padded(jnp.asarray(ev), jnp.int32(n_valid),
                                       bins, w, h))


def _port(ev, n_valid, bins, w, h):
    return voxelize_padded_reference(torch.from_numpy(ev), n_valid, bins, w,
                                     h).numpy()


@pytest.mark.parametrize("bins,w,h,cap,n_valid,t_span", [
    (5, 16, 12, 1024, 500, 1.0),
    (24, 40, 30, 4096, 3000, 5e4),    # blur-VFI 11+1 bin count, us stamps
    (8, 33, 17, 2048, 2047, 1e3),     # odd geometry, one padding row
])
def test_reference_matches_xla_scatter(bins, w, h, cap, n_valid, t_span):
    ev = _events(np.random.RandomState(bins), cap, n_valid, w, h,
                 t_span=t_span)
    ev[n_valid:] = 7.0   # padding rows must be ignored whatever they hold
    got = _port(ev, n_valid, bins, w, h)
    assert got.shape == (bins, h, w)
    np.testing.assert_allclose(got, _jax_scatter(ev, n_valid, bins, w, h),
                               rtol=0, atol=2e-6)


def test_reference_matches_pallas_kernel_with_out_of_frame_events():
    """Same geometry as tests/test_voxel.py::test_voxelize_device_matches_scatter
    (Pallas interpret mode), plus events outside the frame on every side."""
    rng = np.random.RandomState(0)
    cap, n_valid, bins, w, h = 2048, 1900, 5, 160, 48
    ev = _events(rng, cap, n_valid, w, h, pols=(0.0, 1.0))
    ev[:n_valid, 1] = rng.randint(-4, w + 4, n_valid)
    ev[:n_valid, 2] = rng.randint(-4, h + 4, n_valid)
    outside = ((ev[:n_valid, 1] < 0) | (ev[:n_valid, 1] >= w)
               | (ev[:n_valid, 2] < 0) | (ev[:n_valid, 2] >= h))
    assert outside.sum() > 50
    want = np.asarray(voxelize_device(
        jnp.asarray(ev), jnp.int32(n_valid), num_bins=bins, width=w,
        height=h, chunk=512, interpret=True))
    np.testing.assert_allclose(_port(ev, n_valid, bins, w, h), want,
                               rtol=0, atol=2e-6)


def test_empty_stream_is_zero():
    ev = np.zeros((512, 4), np.float32)
    got = _port(ev, 0, 5, 16, 8)
    assert got.shape == (5, 8, 16) and not got.any()
    np.testing.assert_array_equal(got, _jax_scatter(ev, 0, 5, 16, 8))


def test_equal_stamps_vote_into_bin_zero():
    """Zero time span counts as 1: every event lands whole in bin 0."""
    rng = np.random.RandomState(3)
    ev = _events(rng, 1024, 600, 16, 8)
    ev[:600, 0] = 42.0
    got = _port(ev, 600, 4, 16, 8)
    np.testing.assert_allclose(got, _jax_scatter(ev, 600, 4, 16, 8), atol=2e-6)
    assert not got[1:].any()
    pols = np.where(ev[:600, 3] == 0, -1.0, ev[:600, 3])
    assert got.sum() == pytest.approx(pols.sum(), abs=1e-4)


def test_dispatcher_routes_cpu_tensors_to_reference():
    ev = torch.from_numpy(_events(np.random.RandomState(5), 256, 200, 10, 6))
    torch.testing.assert_close(voxelize_padded(ev, 200, 3, 10, 6),
                               voxelize_padded_reference(ev, 200, 3, 10, 6),
                               rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        voxelize_cuda(torch.zeros(16, 4), 4, 3, 8, 8)


@pytest.mark.parametrize("events,n_valid,err", [
    (torch.zeros(16, 4, dtype=torch.float64), 4, TypeError),
    (torch.zeros(16, 3), 4, ValueError),
    (torch.zeros(0, 4), 0, ValueError),
    (torch.zeros(16, 4), 17, ValueError),
])
def test_reference_rejects_bad_buffers(events, n_valid, err):
    with pytest.raises(err):
        voxelize_padded_reference(events, n_valid, 3, 8, 8)


@pytest.mark.parametrize("zero", [False, True])
def test_voxel_norm_matches_jax(zero):
    rng = np.random.RandomState(0)
    vox = rng.randn(5, 12, 10).astype(np.float32)
    vox[vox < 0.3] = 0.0
    if zero:
        vox[:] = 0.0
    got = voxel_norm(torch.from_numpy(vox)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_voxel_norm(vox)),
                               rtol=1e-5, atol=1e-6)


# --- stamps before the first stamp (unsorted streams) ---------------------------

def early_stamp_stream(n=400, w=16, h=12, seed=9):
    """5 bins over stamps 10 .. 20, with two stamps out of order: 7 (ts =
    -1.2, truncated bin -1: only its right vote, in bin 0) and 0 (ts = -4:
    no vote)."""
    rng = np.random.RandomState(seed)
    ev = _events(rng, n, n, w, h, pols=(0.0, 1.0, -1.0))
    ev[:, 0] = np.sort(rng.uniform(10.0, 20.0, n))
    ev[0, 0], ev[-1, 0] = 10.0, 20.0
    ev[n // 4, 0], ev[n // 2, 0] = 7.0, 0.0
    ev[n // 4, 3] = 1.0
    return ev, 5, w, h


def test_early_stamps_keep_the_votes_in_range():
    from refid_tpu_torch.events.voxel import tiled_voxelize_reference
    ev, bins, w, h = early_stamp_stream()
    n = len(ev)
    got = _port(ev, n, bins, w, h)
    want_pallas = np.asarray(voxelize_device(
        jnp.asarray(np.concatenate([ev, np.zeros((512 - n, 4), np.float32)])),
        jnp.int32(n), num_bins=bins, width=w, height=h, chunk=512, interpret=True))
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=2e-6)
    for fmt in ("CHW", "HWC"):
        mirror = tiled_voxelize_reference(torch.from_numpy(ev), n, bins, w, h, fmt, 4 * bins * 32)
        want = got if fmt == "CHW" else got.transpose(1, 2, 0)
        np.testing.assert_array_equal(mirror.numpy(), want)
    # alone: t = 7 at ts = -1.2 votes 1 * (ts - trunc(ts)) = -0.2 into bin 0
    three = np.array([[10.0, 1, 1, 1.0], [7.0, 5, 3, 1.0], [20.0, 2, 2, 1.0]], np.float32)
    alone = _port(three, 3, bins, w, h)
    assert alone[:, 3, 5].tolist() == pytest.approx([-0.2, 0, 0, 0, 0], abs=1e-6)


def test_early_stamps_match_the_cpp_host_path():
    from refid_tpu.events import voxel as jax_voxel
    from refid_tpu.ops.native import get_lib
    assert get_lib() is not None, "the JAX package's C++ voxelizer did not build"
    ev, bins, w, h = early_stamp_stream()
    for fmt in ("CHW", "HWC"):
        want = jax_voxel.events_to_voxel_grid(ev, bins, w, h, fmt)
        got = events_to_voxel_grid(ev, bins, w, h, fmt, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --- the padded-capacity entry ------------------------------------------------

@pytest.mark.parametrize("n,capacity,fmt,bins,w,h", [
    (1500, None, "CHW", 7, 20, 14),      # tests/test_voxel.py's shapes
    (100, 4096, "CHW", 3, 8, 8),
    (1500, None, "HWC", 7, 20, 14),
    (3000, 4096, "HWC", 24, 40, 30),
    (0, None, "CHW", 4, 10, 6),
])
def test_padded_entry_matches_jax(n, capacity, fmt, bins, w, h):
    from refid_tpu.events.voxel import events_to_voxel_grid_jax
    ev = _events(np.random.RandomState(n + bins), n, n, w, h, t_span=1e3)
    got = events_to_voxel_grid_padded(ev, bins, w, h, fmt, capacity=capacity, device="cpu")
    want = np.asarray(events_to_voxel_grid_jax(ev, bins, w, h, fmt, capacity=capacity))
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_padded_entry_checks_and_defaults_to_the_card():
    ev = _events(np.random.RandomState(0), 50, 50, 8, 8)
    with pytest.raises(ValueError, match="capacity"):
        events_to_voxel_grid_padded(ev, 3, 8, 8, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="return_format"):
        events_to_voxel_grid_padded(ev, 3, 8, 8, "WHC", device="cpu")
    assert next_capacity(50, 1024) == 1024 and next_capacity(1025, 1024) == 2048
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            events_to_voxel_grid_padded(ev, 3, 8, 8)
