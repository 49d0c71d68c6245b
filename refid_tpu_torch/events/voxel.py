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
  * ``voxel_cuda.voxelize_cuda`` — the hand-written CUDA kernel K1
    (``csrc/voxelize.cu``); runs for CUDA tensors.

The host-array contract (``refid_tpu/events/voxel.py::events_to_voxel_grid``
and its Pallas twin ``voxel_pallas.py::events_to_voxel_grid_pallas``) is
:func:`events_to_voxel_grid`: numpy ``(N, 4)`` events in, a numpy grid out,
``CHW`` or ``HWC``.  On a CUDA device it runs the CUDA kernel K2
(``voxel_cuda.events_to_voxel_grid_cuda``); on the CPU its plain version
:func:`events_to_voxel_grid_reference`.  The datasets call it per item.

The JAX package's host path rescales timestamps in double in its C++
voxelizer (``native/voxelize.cc``) and in float32 in numpy; the port does it
in float32, like the numpy path and the TPU kernels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["voxelize_padded", "voxelize_padded_reference", "voxel_norm",
           "events_to_voxel_grid", "events_to_voxel_grid_reference",
           "voxel_norm_np", "event_reverse", "filter_event"]


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


def check_host_events(events: np.ndarray, num_bins: int, width: int,
                      height: int, return_format: str) -> None:
    """Raise on host events or a geometry outside the host-array contract."""
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    if events.ndim != 2 or events.shape[1] != 4:
        raise ValueError(f"events must be (N, 4), got {events.shape}")
    if num_bins < 1 or width < 1 or height < 1:
        raise ValueError(f"bad grid geometry bins={num_bins} {width}x{height}")


def events_to_voxel_grid_reference(events: torch.Tensor, num_bins: int,
                                   width: int, height: int,
                                   return_format: str = "CHW") -> torch.Tensor:
    """Plain PyTorch version of the host-array voxelizer: ``(N, 4)`` float32
    events (any N, on any device) -> a ``(bins, h, w)`` or ``(h, w, bins)``
    grid on the same device."""
    if return_format not in ("CHW", "HWC"):
        raise ValueError(f"unknown return_format {return_format!r}")
    n = events.shape[0]
    if n == 0:
        grid = torch.zeros((num_bins, height, width), dtype=torch.float32,
                           device=events.device)
    else:
        grid = voxelize_padded_reference(events, n, num_bins, width, height)
    return grid if return_format == "CHW" else grid.permute(1, 2, 0).contiguous()


def events_to_voxel_grid(events, num_bins: int, width: int, height: int,
                         return_format: str = "CHW",
                         device="cuda") -> np.ndarray:
    """Voxelize an ``(N, 4)`` numpy array of time-sorted ``[t, x, y, p]``
    events into a float32 numpy grid, ``(bins, h, w)`` for ``CHW`` or
    ``(h, w, bins)`` for ``HWC``.  ``device`` ``'cuda'`` (the default) runs
    the CUDA kernel and raises without a CUDA device; ``'cpu'`` runs the
    plain version."""
    events = np.ascontiguousarray(events, dtype=np.float32)
    check_host_events(events, num_bins, width, height, return_format)
    device = torch.device(device)
    if device.type == "cuda":
        from refid_tpu_torch.events.voxel_cuda import events_to_voxel_grid_cuda
        return events_to_voxel_grid_cuda(events, num_bins, width, height,
                                         return_format, device)
    if device.type == "cpu":
        return events_to_voxel_grid_reference(
            torch.from_numpy(events), num_bins, width, height,
            return_format).numpy()
    raise ValueError(f"no voxelizer for device {device}")


def voxel_norm_np(voxel: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`voxel_norm` for host pipelines."""
    nonzero = voxel != 0
    num_nonzeros = nonzero.sum()
    if num_nonzeros > 0:
        mean = voxel.sum() / num_nonzeros
        stddev = np.sqrt((voxel ** 2).sum() / num_nonzeros - mean ** 2)
        voxel = np.where(nonzero, (voxel - mean) / stddev, 0.0).astype(voxel.dtype)
    return voxel


def event_reverse(events: np.ndarray) -> np.ndarray:
    """Reverse the temporal direction of an ``[t, x, y, p]`` stream:
    timestamps become ``t_max - t`` (ascending again), polarities negate;
    the input is not changed."""
    events = np.asarray(events)
    out = np.empty_like(events)
    out[:, 0] = (events[-1, 0] - events[:, 0])[::-1]
    out[:, 1] = events[::-1, 1]
    out[:, 2] = events[::-1, 2]
    out[:, 3] = -events[::-1, 3]
    return out


def filter_event(x, y, p, t, s_e_index=(0, 6)):
    """Keep events whose discretized timestamp index lies in ``s_e_index``
    (both ends inclusive)."""
    t_1 = t.squeeze(1) if t.ndim == 2 else t
    _, inverse = np.unique(t_1, return_inverse=True)
    counts = np.bincount(inverse)
    start = int(np.sum(counts[: s_e_index[0]]))
    end = int(np.sum(counts[: s_e_index[1] + 1]))
    return x[start:end], y[start:end], p[start:end], t[start:end]
