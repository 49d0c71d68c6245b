"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device.  On the GPU machine:
``python -m pytest tests/test_torch_cuda.py -m gpu``.
"""

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
