"""Serving pipelines: raw events + two frames -> sharp frames, mirroring
``refid_tpu/pipeline.py``.

Per request: the events are padded to a power-of-two capacity on the
device, voxelized there (the CUDA kernel on a CUDA device), packed into the
26-channel image input and the adjacent-bin pairs, and run through
:class:`FinalBidirectionAttenfusion` under ``torch.inference_mode``.  Only
the compact event list and the two frames cross the bus.  A request is the
profiler span ``refid.vfi.request`` (``core/timer.py::span``) and its
stages ``refid.vfi.pad``, ``.voxelize``, ``.pack`` and ``.network``.

The network call is ``serve/network.py``'s; where it serves channels_last,
:meth:`BlurVFIPipeline._pack` packs the inputs NHWC straight from the HWC
frames and the bins.

The public layout is the JAX package's: frames ``(h, w, 3)`` RGB in [0, 1],
events ``(N, 4)`` ``[t, x, y, p]`` sorted by t, output ``(t, h, w, 3)``.

int8 serving (``serve/quant.py``) takes the JAX pipeline's ``int8`` values:
True (dynamic activation scales), ``"scale0"`` (also the scale-0 encoder
trunks) and ``"static"`` (calibrated scales, the widest coverage), which
needs :meth:`BlurVFIPipeline.calibrate` or :meth:`load_calibration` first.
Calibration files are the JAX package's JSON (``amax``, ``rms``,
``exclude``), so one calibration serves both packages.

Spatial serving (``mesh=``, ``parallel/mesh.py::make_mesh(data=1,
spatial=S)``): one stream split by image height over the S ranks of the
spatial group, as the JAX pipeline splits it over chips.  Every rank
voxelizes the whole frame (K1 takes ~0.07 ms at 720p on the card), keeps
its rows of the packed input, runs them through the network with the halo
exchanges of ``parallel/spatial.py``, and gathers the full ``(t, h, w, 3)``
output on every rank.  Every rank makes the same call with the same
request.  Every lineage and every int8 mode serves so: an int8 site
quantizes with the group's amax and exchanges int8 halo rows
(``serve/quant.py``), and :meth:`BlurVFIPipeline.calibrate` records the
whole frame's amax and rms on every rank, so ``"static"`` scales are equal
across the group.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from refid_tpu_torch.core.device import resolve_device
from refid_tpu_torch.core.timer import span
from refid_tpu_torch.events.voxel import (
    next_capacity, pad_events, voxel_norm, voxelize_padded,
)
from refid_tpu_torch.models.convert import load_state
from refid_tpu_torch.models.refid import (
    INT8_NEEDS, FinalBidirectionAttenfusion, RefidConfig, int8_applicable,
)
from refid_tpu_torch.serve.network import ServedNetwork
from refid_tpu_torch.serve.quant import INT8_MODES

__all__ = ["BlurVFIPipeline", "SharpVFIPipeline"]


class BlurVFIPipeline:
    """Blurry-VFI serving: (blur0, blur1, events) -> 2m+n sharp frames.

    ``model_or_state`` is a :class:`FinalBidirectionAttenfusion` built from
    ``cfg`` (moved to ``device``) or a state_dict with upstream names, such as
    ``models.convert.state_dict_from_jax`` returns.  ``voxelizer`` takes the
    JAX package's names, ``'scatter'`` and ``'pallas'``; both run the same
    voxelizer here: the CUDA kernel ``csrc/voxelize.cu`` on a CUDA device,
    its plain PyTorch version on the CPU.  ``int8`` is False, True,
    ``"scale0"`` or ``"static"`` (module docstring); its convs run the CUDA
    kernels of ``csrc/conv_int8.cu`` on a CUDA device, their plain versions
    on the CPU.  The JAX package's ``fast`` and ``scan`` (TPU
    re-expressions of the same forward) are not accepted.  ``mesh`` (a
    ``parallel.mesh.Mesh``) splits each window by height over its spatial
    group (module docstring); ``last_plan`` then holds the last window's
    :class:`~refid_tpu_torch.parallel.spatial.SpatialPlan`.  ``device``
    defaults to ``'cuda'`` and raises when no CUDA device is present.
    ``channels_last`` says whether the pipeline serves in that memory
    format.
    """

    def __init__(self, model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: RefidConfig = RefidConfig(), m: int = 11, n: int = 1,
                 norm_voxel: bool = False, voxelizer: str = "scatter",
                 int8: Union[bool, str] = False, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        if voxelizer not in ("scatter", "pallas"):
            raise ValueError(f"voxelizer must be 'scatter' or 'pallas'; "
                             f"got {voxelizer!r}")
        if int8 not in INT8_MODES:
            raise ValueError(f"int8 must be False, True, 'scale0', or 'static'; "
                             f"got {int8!r}")
        if int8 and not int8_applicable(cfg):
            raise ValueError(f"int8 serving needs {INT8_NEEDS}")
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
        self.served = ServedNetwork(model.eval(), int8, mesh, self.device, "refid.vfi",
                                    packs_nhwc=True)
        self.model = self.served.net

    channels_last = property(lambda self: self.served.channels_last)
    last_plan = property(lambda self: self.served.last_plan)

    # --- task-specific hooks (overridden by SharpVFIPipeline) --------------

    def _derive_num_bins(self, m: int, n: int) -> int:
        return 2 * m + n + 1

    def _lq_blocks(self, vox, frame0, frame1):
        """Blur-VFI packing: the two blurred frames, each followed by its
        intra-exposure voxel bins, as ``(c, h, w)`` blocks in channel
        order."""
        m, n = self.m, self.n
        return [frame0, vox[1:m], frame1, vox[m + 2 + n:]]

    def _pad_events(self, events, capacity: Optional[int]) -> Tuple[torch.Tensor, int]:
        """Pad to ``capacity`` rows (default: the next power of two, at least
        2**14) in a zeroed buffer on the device; only the events are copied."""
        if capacity is None:
            capacity = next_capacity(len(events), 1 << 14)
        return pad_events(events, capacity, self.device)

    def _frame(self, frame) -> torch.Tensor:
        """(h, w, 3) -> a (3, h, w) view, float32 on the device."""
        frame = torch.as_tensor(np.asarray(frame, dtype=np.float32))
        return frame.to(self.device).permute(2, 0, 1)

    def _pack(self, blur0, blur1, events, capacity, nhwc: bool):
        """The network's inputs ``lq (1, c, h, w)`` and ``pairs (1, t, 2, h,
        w)``; ``(h, w, c)`` and ``(t, h, w, 2)`` in memory where ``nhwc``, so
        that every ``pairs[:, k]`` is a channels_last view."""
        h, w = blur0.shape[:2]
        with span("refid.vfi.pad"):
            ev, n_ev = self._pad_events(events, capacity)
        with span("refid.vfi.voxelize"):
            vox = voxelize_padded(ev, n_ev, self.num_bins, w, h)   # (bins, h, w)
            if self.norm_voxel:
                vox = voxel_norm(vox)
        with span("refid.vfi.pack"):
            blocks = self._lq_blocks(vox, self._frame(blur0), self._frame(blur1))
            if nhwc:
                lq = torch.cat([b.permute(1, 2, 0) for b in blocks], -1).permute(2, 0, 1)
                pairs = torch.stack([vox[:-1], vox[1:]], -1).permute(0, 3, 1, 2)
            else:
                lq = torch.cat(blocks, 0)
                pairs = torch.stack([vox[:-1], vox[1:]], 1)
            return lq[None], pairs[None]

    @torch.inference_mode()
    def __call__(self, blur0, blur1, events,
                 capacity: Optional[int] = None) -> torch.Tensor:
        """blur frames (h, w, 3) RGB [0, 1]; events (N, 4) [t, x, y, p]
        sorted by t.  Returns the (2m+n, h, w, 3) sharp frames on the
        pipeline's device."""
        with span("refid.vfi.request"):
            lq, pairs = self._pack(blur0, blur1, events, capacity, self.channels_last)
            return self.served(lq, pairs)[0].permute(0, 2, 3, 1)

    @torch.inference_mode()
    def calibrate(self, blur0, blur1, events, capacity: Optional[int] = None,
                  crop: Optional[tuple] = None, headroom: float = 1.0,
                  accumulate: bool = False,
                  exclude_crest: Optional[float] = None) -> torch.Tensor:
        """Record each int8 site's activation amax (and rms) for
        ``int8='static'`` serving, as the JAX pipeline's ``calibrate``: one
        forward in exact math, whose output it returns; the amaxes are read
        from the device once, at the end.

        ``accumulate`` keeps the elementwise max with the amaxes recorded
        before (raw, headroom not applied); ``headroom`` scales the stored
        amaxes once; ``crop=(ch, cw)`` calibrates on the centre crop (its
        in-crop events, shifted); ``exclude_crest`` serves in exact math each
        site whose amax exceeds ``exclude_crest`` times its rms."""
        blur0, blur1 = np.asarray(blur0), np.asarray(blur1)
        events = np.asarray(events)
        if crop is not None:
            ch, cw = crop
            h, w = blur0.shape[:2]
            if not (0 < ch <= h and 0 < cw <= w):
                raise ValueError(f"calibrate crop {crop} exceeds the frame ({h}, {w})")
            y0, x0 = (h - ch) // 2, (w - cw) // 2
            blur0 = blur0[y0:y0 + ch, x0:x0 + cw]
            blur1 = blur1[y0:y0 + ch, x0:x0 + cw]
            keep = ((events[:, 1] >= x0) & (events[:, 1] < x0 + cw)
                    & (events[:, 2] >= y0) & (events[:, 2] < y0 + ch))
            events = events[keep].copy()
            events[:, 1] -= x0
            events[:, 2] -= y0
        lq, pairs = self._pack(blur0, blur1, events, capacity, nhwc=False)
        out = self.served.calibrate(lq, pairs, headroom, accumulate, exclude_crest)
        return out[0].permute(0, 2, 3, 1)

    def save_calibration(self, path: str) -> None:
        """Write the recorded scales as the JAX package's JSON."""
        self.served.save_calibration(path)

    def load_calibration(self, path: str) -> None:
        """Read scales that either package's ``save_calibration`` wrote; they
        already hold their headroom and are the floor of any later
        ``accumulate``."""
        self.served.load_calibration(path)


class SharpVFIPipeline(BlurVFIPipeline):
    """Sharp-VFI serving: (sharp0, sharp1, events) -> n middle frames.

    The 26-channel input pads ZERO deblur bins around the two sharp frames,
    so the same checkpoints serve both tasks; ``n+1`` voxel bins over the
    inter-frame window give ``n`` bin pairs and ``n`` frames.
    """

    def __init__(self, model_or_state, cfg: RefidConfig = RefidConfig(),
                 n: int = 7, norm_voxel: bool = False,
                 voxelizer: str = "scatter", int8: Union[bool, str] = False, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(model_or_state, cfg, m=1, n=n, norm_voxel=norm_voxel,
                         voxelizer=voxelizer, int8=int8, mesh=mesh, device=device)

    def _derive_num_bins(self, m: int, n: int) -> int:
        return n + 1   # sharp stream: the window ends ARE the inputs

    def _lq_blocks(self, vox, frame0, frame1):
        zeros = vox.new_zeros((10,) + vox.shape[1:])
        return [frame0, zeros, frame1, zeros]
