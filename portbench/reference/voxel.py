"""Plain reference of the event voxel grid and its normalisation.

Each event ``[t, x, y, p]`` of a time-sorted stream votes into the two
temporal bins around its rescaled stamp ``(bins - 1) * (t - t_first) /
(t_last - t_first)`` (a zero span counts as 1): ``p * (1 - dt)`` into bin
``floor``, ``p * dt`` into the next, with polarity 0 read as -1.  Votes
outside the grid are dropped.  ``voxel_norm`` rescales the nonzero cells
to zero mean and unit deviation (biased), leaving zeros at zero.
"""

from __future__ import annotations

import torch

__all__ = ["voxel_grid", "voxel_norm"]


def voxel_grid(events: torch.Tensor, bins: int, width: int, height: int) -> torch.Tensor:
    """``(N, 4)`` float32 events -> ``(bins, height, width)`` float32."""
    t, x, y, p = events.unbind(1)
    first, last = t[0], t[-1]
    span = last - first
    span = torch.where(span == 0, torch.ones_like(span), span)
    ts = (bins - 1) * (t - first) / span
    ti = ts.long()
    dt = ts - ti.float()
    p = torch.where(p == 0, -torch.ones_like(p), p)
    xi, yi = x.long(), y.long()
    inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    grid = torch.zeros(bins * height * width + 1, dtype=torch.float32, device=events.device)
    spill = bins * height * width
    for b, vote in ((ti, p * (1 - dt)), (ti + 1, p * dt)):
        ok = inside & (b >= 0) & (b < bins)
        index = torch.where(ok, (b * height + yi) * width + xi, spill)
        grid.index_add_(0, index, torch.where(ok, vote, torch.zeros_like(vote)))
    return grid[:spill].view(bins, height, width)


def voxel_norm(voxel: torch.Tensor) -> torch.Tensor:
    nonzero = voxel != 0
    count = nonzero.sum()
    if count == 0:
        return voxel
    mean = voxel.sum() / count
    std = torch.sqrt((voxel * voxel).sum() / count - mean * mean)
    return torch.where(nonzero, (voxel - mean) / std, torch.zeros_like(voxel))
