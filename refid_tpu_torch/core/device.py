"""Device selection and timing shared by the port's entry points."""

from __future__ import annotations

import time
from typing import Union

import torch

__all__ = ["resolve_device", "time_ms"]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and no CUDA
    device is present (no silent fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return device


def time_ms(fn, iters: int, device: torch.device, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` over ``iters`` calls after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
