"""Serving pipelines: raw events + two frames -> sharp frames, mirroring
``refid_tpu/pipeline.py``.

Per request: the events are padded to a power-of-two capacity on the
device, voxelized there (the CUDA kernel on a CUDA device), packed into the
26-channel image input and the adjacent-bin pairs, and run through
:class:`FinalBidirectionAttenfusion` under ``torch.inference_mode``.  Only
the compact event list and the two frames cross the bus.

The public layout is the JAX package's: frames ``(h, w, 3)`` RGB in [0, 1],
events ``(N, 4)`` ``[t, x, y, p]`` sorted by t, output ``(t, h, w, 3)``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from refid_tpu_torch.core.device import resolve_device
from refid_tpu_torch.events.voxel import (
    next_capacity, pad_events, voxel_norm, voxelize_padded,
)
from refid_tpu_torch.models.convert import load_state
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig

__all__ = ["BlurVFIPipeline", "SharpVFIPipeline"]


class BlurVFIPipeline:
    """Blurry-VFI serving: (blur0, blur1, events) -> 2m+n sharp frames.

    ``model_or_state`` is a :class:`FinalBidirectionAttenfusion` built from
    ``cfg`` (moved to ``device``) or a state_dict with upstream names, such as
    ``models.convert.state_dict_from_jax`` returns.  ``voxelizer`` takes the
    JAX package's names, ``'scatter'`` and ``'pallas'``; both run the same
    voxelizer here: the CUDA kernel ``csrc/voxelize.cu`` on a CUDA device,
    its plain PyTorch version on the CPU.  The JAX package's ``fast`` and
    ``scan`` (TPU re-expressions of the same forward), ``int8`` and ``mesh``
    are not accepted: int8 serving and spatial sharding come with their own
    slices of the port.  ``device`` defaults to ``'cuda'`` and raises when no
    CUDA device is present.
    """

    def __init__(self, model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: RefidConfig = RefidConfig(), m: int = 11, n: int = 1,
                 norm_voxel: bool = False, voxelizer: str = "scatter",
                 device: Union[str, torch.device] = "cuda"):
        if voxelizer not in ("scatter", "pallas"):
            raise ValueError(f"voxelizer must be 'scatter' or 'pallas'; "
                             f"got {voxelizer!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.m, self.n = m, n
        self.num_bins = self._derive_num_bins(m, n)
        self.norm_voxel = norm_voxel
        self.voxelizer = voxelizer
        if isinstance(model_or_state, nn.Module):
            if getattr(model_or_state, "cfg", None) != cfg:
                raise ValueError("model was built from another RefidConfig")
            model = model_or_state
        else:
            model = FinalBidirectionAttenfusion(cfg)
            load_state(model, model_or_state)
        self.model = model.to(self.device).eval()

    # --- task-specific hooks (overridden by SharpVFIPipeline) --------------

    def _derive_num_bins(self, m: int, n: int) -> int:
        return 2 * m + n + 1

    def _make_lq(self, vox, frame0, frame1):
        """Blur-VFI packing: the two blurred frames, each followed by its
        intra-exposure voxel bins (channels-first)."""
        m, n = self.m, self.n
        return torch.cat([frame0, vox[1:m], frame1, vox[m + 2 + n:]], 0)

    def _pad_events(self, events, capacity: Optional[int]) -> Tuple[torch.Tensor, int]:
        """Pad to ``capacity`` rows (default: the next power of two, at least
        2**14) in a zeroed buffer on the device; only the events are copied."""
        if capacity is None:
            capacity = next_capacity(len(events), 1 << 14)
        return pad_events(events, capacity, self.device)

    def _frame(self, frame) -> torch.Tensor:
        """(h, w, 3) -> (3, h, w) float32 on the device."""
        frame = torch.as_tensor(np.asarray(frame, dtype=np.float32))
        return frame.to(self.device).permute(2, 0, 1)

    @torch.inference_mode()
    def __call__(self, blur0, blur1, events,
                 capacity: Optional[int] = None) -> torch.Tensor:
        """blur frames (h, w, 3) RGB [0, 1]; events (N, 4) [t, x, y, p]
        sorted by t.  Returns the (2m+n, h, w, 3) sharp frames on the
        pipeline's device."""
        h, w = blur0.shape[:2]
        ev, n_ev = self._pad_events(events, capacity)
        vox = voxelize_padded(ev, n_ev, self.num_bins, w, h)   # (bins, h, w)
        if self.norm_voxel:
            vox = voxel_norm(vox)
        lq = self._make_lq(vox, self._frame(blur0), self._frame(blur1))[None]
        pairs = torch.stack([vox[:-1], vox[1:]], 1)[None]     # (1, t, 2, h, w)
        return self.model(lq, pairs)[0].permute(0, 2, 3, 1)


class SharpVFIPipeline(BlurVFIPipeline):
    """Sharp-VFI serving: (sharp0, sharp1, events) -> n middle frames.

    The 26-channel input pads ZERO deblur bins around the two sharp frames,
    so the same checkpoints serve both tasks; ``n+1`` voxel bins over the
    inter-frame window give ``n`` bin pairs and ``n`` frames.
    """

    def __init__(self, model_or_state, cfg: RefidConfig = RefidConfig(),
                 n: int = 7, norm_voxel: bool = False,
                 voxelizer: str = "scatter",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(model_or_state, cfg, m=1, n=n, norm_voxel=norm_voxel,
                         voxelizer=voxelizer, device=device)

    def _derive_num_bins(self, m: int, n: int) -> int:
        return n + 1   # sharp stream: the window ends ARE the inputs

    def _make_lq(self, vox, frame0, frame1):
        zeros = vox.new_zeros((10,) + vox.shape[1:])
        return torch.cat([frame0, zeros, frame1, zeros], 0)
