"""REFID flagship network — FinalBidirectionAttenfusion (NCHW), mirroring
``refid_tpu/models/refid.py``.

The two temporal loops are Python loops over the voxel-bin pairs (the JAX
package's ``nn.scan``s): first backward over t, then forward.  Module names
are upstream REFID's (``head``, ``head_img``, ``img_encoders``,
``encoders_backward``, ``encoders_forward``, ``resblocks``, ``decoders``,
``pred``).

Parity notes, as in the JAX package:
  * ``aliased_backward_states=True`` (default, upstream's quirk): every
    forward step fuses the FINAL backward state, the one computed at frame 0.
    ``False`` fuses each frame's own backward state.
  * The event head (5x5, leaky 0.2) is one module shared by both directions
    and applied per step.
  * Scale 0 gets no image feature; EGACA replaces the first conv at the
    scales in ``atten_fuse_at`` (scale 1).
  * The first bottleneck resblock adds the deepest image feature; the
    prediction conv runs on ``decoder output + image head`` with no output
    activation.

Training options, as in the JAX config: ``remat`` recomputes each
backward and forward recurrent step in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``nn.remat`` of
``_BackwardStep`` / ``_ForwardStep``); ``dtype=torch.bfloat16`` runs the
network under bf16 autocast with float32 parameters and returns float32.

int8 serving (``serve/quant.py``): ``forward(x, event, q)`` with a
``QuantState`` runs the convs that ``refid_tpu/serve/fast_forward.py`` routes
through ``conv_int8``, in its call order (backward scan k = t-1 .. 0, then
forward scan k = 0 .. t-1; in a step the encoder stages i = 0 .. n-1, each
stage conv, trunk conv_in / conv1 / conv2, down; the resblocks; the
decoders): for every mode the stage conv (not at stage 0, nor where EGACA
replaces it), the trunk and ``down`` of the stages i >= 1, the resblocks and
the trunks of the decoders before the last two; ``q.scale0`` adds the
stage-0 trunks and ``q.last_decoders`` the last two decoders' trunks.  It
needs the production architecture that the JAX serving forward replays
(:func:`int8_applicable`).  The head convs, the image encoder, EGACA,
``fuse_two_dir``, the transposed convs and ``pred`` never run in int8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from refid_tpu_torch.models.layers import (
    ConvLayer, ImageEncoderConvBlock, ResidualBlock,
)
from refid_tpu_torch.models.recurrent import (
    RecurrentEncoderStage, TransposeRecurrentConvLayer,
)

__all__ = ["RefidConfig", "FinalBidirectionAttenfusion", "int8_applicable"]


@dataclasses.dataclass(frozen=True)
class RefidConfig:
    """Hyperparameters; the defaults are the production blur-VFI 11+1 config
    (options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml).
    The ablation axes after ``aliased_backward_states`` keep the JAX
    config's names; only their production values are ported."""
    img_chn: int = 26
    ev_chn: int = 2
    out_chn: int = 3
    num_encoders: int = 3
    base_num_channels: int = 32
    num_block: int = 1            # blocks per SimpleRecurrentConv trunk
    num_residual_blocks: int = 2  # bottleneck resblocks
    atten_fuse_at: Tuple[int, ...] = (1,)
    aliased_backward_states: bool = True
    remat: bool = False           # recompute recurrent steps in the backward
    remat_policy: str = "all"     # only 'all' (recompute everything) is ported
    dtype: Optional[torch.dtype] = None   # compute dtype: None (f32) or bf16
    use_first_dcn: bool = False
    bidirectional: bool = True
    recurrent_cell: str = "simpleconv"
    encoder_stage: str = "then_down"
    decoder_type: str = "transpose_recurrent"
    bottleneck_img_add: bool = True
    apply_resblocks: bool = True
    bidir_decoder: bool = False
    siamese_fusion: Optional[str] = None

    @property
    def encoder_in_sizes(self) -> Tuple[int, ...]:
        return tuple(self.base_num_channels * 2 ** i
                     for i in range(self.num_encoders))

    @property
    def encoder_out_sizes(self) -> Tuple[int, ...]:
        return tuple(self.base_num_channels * 2 ** (i + 1)
                     for i in range(self.num_encoders))

    @property
    def max_num_channels(self) -> int:
        return self.base_num_channels * 2 ** self.num_encoders


# the production value of every ablation axis; only these are ported
_PORTED_AXES = {
    "use_first_dcn": False, "bidirectional": True,
    "recurrent_cell": "simpleconv", "encoder_stage": "then_down",
    "decoder_type": "transpose_recurrent", "bottleneck_img_add": True,
    "apply_resblocks": True, "bidir_decoder": False, "siamese_fusion": None,
}


def int8_applicable(cfg: Optional[RefidConfig]) -> bool:
    """True iff int8 serving applies: the configurations that the JAX
    serving forward replays (``refid_tpu/pipeline.py::
    _fast_serving_applicable``) among those the port builds."""
    return (cfg is not None and cfg.aliased_backward_states and cfg.num_block == 1
            and cfg.num_encoders >= 2)


class FinalBidirectionAttenfusion(nn.Module):
    """Bidirectional event-recurrent UNet for blurry VFI.

    Inputs (NCHW): ``x`` ``(b, img_chn, h, w)``, or ``(b, 2, c, h, w)``
    concatenated along channels; ``event`` ``(b, t, ev_chn, h, w)`` adjacent
    voxel-bin pairs.  Output ``(b, t, out_chn, h, w)``.  ``h`` and ``w`` must
    be multiples of ``2**num_encoders``.
    """

    def __init__(self, cfg: RefidConfig = RefidConfig()):
        super().__init__()
        for axis, value in _PORTED_AXES.items():
            if getattr(cfg, axis) != value:
                raise NotImplementedError(
                    f"RefidConfig.{axis}={getattr(cfg, axis)!r} is not ported "
                    f"(only {value!r})")
        if cfg.remat_policy != "all":
            raise NotImplementedError(
                f"RefidConfig.remat_policy={cfg.remat_policy!r} is not ported "
                "(only 'all')")
        if cfg.dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"RefidConfig.dtype must be None, float32 or "
                             f"bfloat16, got {cfg.dtype}")
        self.cfg = cfg
        base, ne = cfg.base_num_channels, cfg.num_encoders
        self.head = ConvLayer(cfg.ev_chn, base, 5, 1, 2, 0.2)
        self.head_img = ConvLayer(cfg.img_chn, base, 5, 1, 2, 0.2)
        self.img_encoders = nn.ModuleList(
            ImageEncoderConvBlock(cfg.encoder_in_sizes[i],
                                  cfg.encoder_out_sizes[i])
            for i in range(ne))

        def stages(fuse_two_direction):
            return nn.ModuleList(
                RecurrentEncoderStage(
                    cfg.encoder_in_sizes[i], cfg.encoder_out_sizes[i],
                    cfg.num_block,
                    use_atten_fuse=i in cfg.atten_fuse_at and i != 0,
                    fuse_two_direction=fuse_two_direction)
                for i in range(ne))

        self.encoders_backward = stages(False)
        self.encoders_forward = stages(True)
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            TransposeRecurrentConvLayer(cfg.encoder_out_sizes[ne - i - 1],
                                        cfg.encoder_out_sizes[ne - i - 1] // 2)
            for i in range(ne))
        self.pred = ConvLayer(base, cfg.out_chn, 3, 1, 1, relu_slope=None)

    def _zero_states(self, b, h, w, like):
        ne, out = self.cfg.num_encoders, self.cfg.encoder_out_sizes
        enc = tuple(like.new_zeros(b, out[i], h // 2 ** i, w // 2 ** i)
                    for i in range(ne))
        dec = tuple(like.new_zeros(b, out[ne - i - 1] // 2,
                                   h // 2 ** (ne - i - 1), w // 2 ** (ne - i - 1))
                    for i in range(ne))
        return enc, dec

    @staticmethod
    def _stage_q(i, q):
        """The quant states of encoder stage ``i``: its stage conv and down,
        and its trunk."""
        if q is None:
            return {}
        return {"q": q if i else None, "q_trunk": q if i or q.scale0 else None}

    def _backward_step(self, ev_k, y_of, states, q=None):
        """One backward-loop step over all encoder scales; returns the new
        states."""
        e = self.head(ev_k)
        new = []
        for i, stage in enumerate(self.encoders_backward):
            e, s = stage(e, y_of[i], states[i], **self._stage_q(i, q))
            new.append(s)
        return tuple(new)

    def _forward_step(self, ev_k, y_of, x_last, head, fwd_states, dec_states,
                      bwd, q=None):
        """One forward-loop step: encoders (fusing ``bwd``), bottleneck,
        recurrent decoders, prediction.  Returns (frame, fwd_states,
        dec_states)."""
        ne = self.cfg.num_encoders
        e = self.head(ev_k)
        e_blocks, new = [], []
        for i, stage in enumerate(self.encoders_forward):
            e, s = stage(e, y_of[i], fwd_states[i], bwd[i], **self._stage_q(i, q))
            e_blocks.append(e)
            new.append(s)
        for i, block in enumerate(self.resblocks):
            e = block(e + x_last if i == 0 else e, q)
        new_dec = []
        for i, dec in enumerate(self.decoders):
            dq = q if q is not None and (i < ne - 2 or q.last_decoders) else None
            e, s = dec(e + e_blocks[ne - i - 1], dec_states[i], dq)
            new_dec.append(s)
        return self.pred(e + head), tuple(new), tuple(new_dec)

    def _step(self, fn, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    int8_side = 8    # a task predicts in int8 where both frame sides are multiples of this

    def task_int8_mode(self, int8):
        """The int8 mode that a task's ``val.int8`` selects: True or
        ``"scale0"`` (dynamic scales), as the JAX task; ``"static"`` raises,
        since a task records no calibration."""
        if int8 not in (False, True, "scale0"):
            raise ValueError(f"val.int8 must be False, True or 'scale0' (dynamic scales; "
                             f"'static' requires calibration, which a task does not "
                             f"record); got {int8!r}")
        if int8 and not int8_applicable(self.cfg):
            raise ValueError("val.int8 requires the production architecture "
                             "(aliased backward states, num_block=1, num_encoders >= 2)")
        return int8

    def forward(self, x, event, q=None):
        if q is not None and not int8_applicable(self.cfg):
            raise ValueError("int8 serving needs aliased backward states, num_block=1 "
                             "and num_encoders >= 2 (the JAX serving forward's "
                             f"configurations); got {self.cfg}")
        if self.cfg.dtype != torch.bfloat16:
            return self._forward(x, event, q)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = self._forward(x, event, q)
        return out.float()

    def _forward(self, x, event, q=None):
        if x.dim() == 5:   # (b, 2, c, h, w) -> (b, 2c, h, w)
            x = torch.cat(x.unbind(1), 1)
        b, t, _, h, w = event.shape

        head = self.head_img(x)
        x_blocks = []
        cur = head
        for enc in self.img_encoders:
            cur = enc(cur)
            x_blocks.append(cur)
        y_of = tuple([None] + x_blocks[:-1])   # image feature fused at each scale

        enc_zero, dec_states = self._zero_states(b, h, w, head)

        bwd_states = enc_zero
        bwd_by_time = [None] * t
        for k in range(t - 1, -1, -1):
            bwd_states = self._step(self._backward_step, event[:, k], y_of,
                                    bwd_states, q)
            if not self.cfg.aliased_backward_states:
                bwd_by_time[k] = bwd_states

        fwd_states = enc_zero
        outs = []
        for k in range(t):
            bwd = (bwd_states if self.cfg.aliased_backward_states
                   else bwd_by_time[k])
            frame, fwd_states, dec_states = self._step(
                self._forward_step, event[:, k], y_of, x_blocks[-1], head,
                fwd_states, dec_states, bwd, q)
            outs.append(frame)
        if q is not None:
            q.finish()
        return torch.stack(outs, 1)
