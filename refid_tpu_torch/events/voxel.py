"""Event stream -> temporal-bin voxel grid (mirrors ``refid_tpu/events/voxel.py``).

Contract (``refid_tpu/events/voxel.py::_voxelize_padded`` and
``refid_tpu/events/voxel_pallas.py::voxelize_device``): ``events`` is a
``(CAP, 4)`` float32 buffer of time-sorted ``[t, x, y, p]`` rows whose rows
``>= n_valid`` are padding.  Timestamps are rescaled to ``[0, bins-1]`` from
the first and last valid stamps (a zero span counts as 1), polarity 0 becomes
-1, and each event votes ``p*(1-dt)`` into bin ``floor(t)`` and ``p*dt`` into
bin ``floor(t)+1`` at pixel ``(y, x)``; a vote whose bin is ``>= bins`` is
dropped.  Returns a ``(bins, height, width)`` float32 grid.

Out-of-frame events (truncated x outside ``[0, width)`` or y outside
``[0, height)``) are DROPPED, as the Pallas kernel and the C++ host
voxelizer (``native/voxelize.cc``) drop them.  ``_voxelize_padded`` instead
lets the flat index of an x >= width event wrap into the next row; the two
agree on every in-frame stream.

Two implementations behind one dispatcher, :func:`voxelize_padded`:
  * :func:`voxelize_padded_reference` — plain PyTorch (``index_add_`` on a
    flat grid); runs for CPU tensors and is the yardstick of the kernel.
  * ``voxel_cuda.voxelize_cuda`` — the hand-written CUDA kernel
    (``csrc/voxelize.cu``); runs for CUDA tensors.
"""

from __future__ import annotations

import torch

__all__ = ["voxelize_padded", "voxelize_padded_reference", "voxel_norm"]


def check_event_buffer(events: torch.Tensor, n_valid: int, bins: int,
                       width: int, height: int) -> None:
    """Raise on a buffer or geometry outside the voxelizer's contract."""
    if events.dtype != torch.float32:
        raise TypeError(f"events must be float32, got {events.dtype}")
    if events.dim() != 2 or events.shape[1] != 4 or events.shape[0] < 1:
        raise ValueError(f"events must be (CAP>=1, 4), got {tuple(events.shape)}")
    if not 0 <= n_valid <= events.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {events.shape[0]}]")
    if bins < 1 or width < 1 or height < 1:
        raise ValueError(f"bad grid geometry bins={bins} {width}x{height}")


def voxelize_padded_reference(events: torch.Tensor, n_valid: int, bins: int,
                              width: int, height: int) -> torch.Tensor:
    """Plain PyTorch voxelizer over a padded ``(CAP, 4)`` event buffer."""
    check_event_buffer(events, n_valid, bins, width, height)
    cap = events.shape[0]
    t = events[:, 0]
    first = t[0]
    last = t[max(n_valid - 1, 0)]
    delta = last - first
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    # same f32 operation order as refid_tpu/events/voxel.py:119
    ts = (bins - 1) * (t - first) / delta

    xs = events[:, 1].to(torch.int64)          # truncation toward zero
    ys = events[:, 2].to(torch.int64)
    pols = events[:, 3]
    pols = torch.where(pols == 0, torch.full_like(pols, -1.0), pols)
    tis = ts.to(torch.int64)
    dts = ts - tis.to(ts.dtype)

    ok = ((torch.arange(cap, device=events.device) < n_valid)
          & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
          & (tis >= 0))
    left_ok = ok & (tis < bins)
    right_ok = ok & (tis + 1 < bins)

    plane = width * height
    size = bins * plane
    flat = xs + ys * width + tis * plane
    zero = torch.zeros_like(ts)
    # masked votes go to a spill slot past the grid, which is cut off below
    grid = torch.zeros(size + 1, dtype=torch.float32, device=events.device)
    grid.index_add_(0, torch.where(left_ok, flat, size),
                    torch.where(left_ok, pols * (1.0 - dts), zero))
    grid.index_add_(0, torch.where(right_ok, flat + plane, size),
                    torch.where(right_ok, pols * dts, zero))
    return grid[:size].view(bins, height, width)


def voxelize_padded(events: torch.Tensor, n_valid: int, bins: int,
                    width: int, height: int) -> torch.Tensor:
    """Voxelize on the events' device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if events.device.type == "cuda":
        from refid_tpu_torch.events.voxel_cuda import voxelize_cuda
        return voxelize_cuda(events, n_valid, bins, width, height)
    if events.device.type == "cpu":
        return voxelize_padded_reference(events, n_valid, bins, width, height)
    raise ValueError(f"no voxelizer for device {events.device}")


def voxel_norm(voxel: torch.Tensor) -> torch.Tensor:
    """Zero-mean / unit-std normalization over the NONZERO entries; an
    all-zero grid is returned unchanged (``refid_tpu/events/voxel.py::
    voxel_norm`` and the pipeline's ``norm_voxel`` branch)."""
    nonzero = voxel != 0
    count = nonzero.sum().clamp(min=1)
    mean = voxel.sum() / count
    std = torch.sqrt((voxel ** 2).sum() / count - mean ** 2)
    return torch.where(nonzero, (voxel - mean) / std, torch.zeros_like(voxel))
