"""REFID network — FinalBidirectionAttenfusion (NCHW) and its ablation
lineages, mirroring ``refid_tpu/models/refid.py``.

The two temporal loops are Python loops over the voxel-bin pairs (the JAX
package's ``nn.scan``s): first backward over t, then forward.  Module names
are upstream REFID's (``head``, ``head_img``, ``img_encoders``,
``encoders_backward``, ``encoders_forward`` or, unidirectional,
``encoders``, ``resblocks``, ``decoders``, ``pred``); the all-bidirection
lineage adds ``decoders_backward`` and the siamese lineage
``img_ev_fusions``.

Parity notes, as in the JAX package:
  * ``aliased_backward_states=True`` (default, upstream's quirk): every
    forward step fuses the FINAL backward state, the one computed at frame 0.
    ``False`` fuses each frame's own backward state.
  * The event head (5x5, leaky 0.2) is one module shared by both directions
    and applied per step.
  * Scale 0 gets no image feature; EGACA replaces the first conv at the
    scales in ``atten_fuse_at`` (scale 1 in the flagship, none in the
    ablations).
  * The first bottleneck resblock adds the deepest image feature
    (``bottleneck_img_add``, the flagship only); the prediction conv runs on
    ``decoder output + image head`` (the decoder output alone in the siamese
    lineage) with no output activation.

The ablation axes of ``RefidConfig`` are the JAX config's: ``bidirectional``
(False: no backward pass, zero backward states), ``encoder_stage`` and
``recurrent_cell`` (``models/recurrent.py``; the recurrent states live at
the pre-down resolution for ``then_down`` and the post-down one for the
k5/s2 stages), ``use_first_dcn``, ``decoder_type``, ``apply_resblocks``,
``bottleneck_img_add``, ``bidir_decoder`` (the backward pass also runs a
decoder stack, whose final states the forward decoders fuse) and
``siamese_fusion`` (the image encoder runs on each frame's half of ``x``
with shared weights; ``'se'`` or ``'add'`` fuses the two per-scale features
after each event stage).  A configuration the JAX network refuses raises
``ValueError`` with its reason.

Training options, as in the JAX config: ``remat`` recomputes each
backward and forward recurrent step in the backward pass
(``torch.utils.checkpoint``).  ``remat_policy='all'`` checkpoints the
whole step (the JAX package's ``nn.remat`` of ``_BackwardStep`` /
``_ForwardStep``); ``'stage_outputs'`` checkpoints each encoder stage (with
the event head at stage 0 and the siamese fusion after it), the bottleneck,
each decoder and the prediction conv separately, so that the step keeps
what enters them (the stage and decoder outputs, as the JAX policy
``save_only_these_names('stage_out', 'dec_out')`` keeps) and recomputes the
rest.  ``dtype=torch.bfloat16`` runs the network under bf16 autocast with
float32 parameters and returns float32.

Spatial sharding (``parallel/spatial.py``): under an active plan the
inputs are a rank's rows of the frame, in every lineage and int8 mode; the
convs with a halo (``HaloConv2d``, the ConvGRU / ConvLSTM gates and the k5/s2
stage convs among them), the SE pools (``SpatialAvgPool``), the bilinear
decoder's edge-row halo, the DCN's gathered input and the int8 sites' group
amax and int8 halos exchange with the neighbouring shards.  The rows split
in whole blocks of :attr:`FinalBidirectionAttenfusion.row_block`.

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

from refid_tpu_torch.models.fusion import ImgEvFusion
from refid_tpu_torch.models.layers import (
    ConvLayer, ImageEncoderConvBlock, ResidualBlock,
)
from refid_tpu_torch.models.recurrent import (
    PixelShuffleRecurrentConvLayer, RecurrentEncoderStage,
    TransposeRecurrentConvLayer, UpsampleConvLayer,
)
from refid_tpu_torch.parallel import spatial

__all__ = ["RefidConfig", "FinalBidirectionAttenfusion", "int8_applicable", "INT8_NEEDS"]


@dataclasses.dataclass(frozen=True)
class RefidConfig:
    """Hyperparameters; the defaults are the production blur-VFI 11+1 config
    (options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml).
    The ablation axes after ``use_first_dcn`` are the JAX config's
    (``refid_tpu/models/refid.py::RefidConfig``)."""
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
    remat_policy: str = "all"     # 'all' | 'stage_outputs' (module docstring)
    dtype: Optional[torch.dtype] = None   # compute dtype: None (f32) or bf16
    use_first_dcn: bool = False   # deformable first conv of each encoder stage
    bidirectional: bool = True
    recurrent_cell: str = "simpleconv"     # 'convgru' | 'convlstm'
    encoder_stage: str = "then_down"       # 'conv_down' | 'rec_conv'
    decoder_type: str = "transpose_recurrent"  # 'pixelshuffle_recurrent' |
                                               # 'upsample_conv'
    bottleneck_img_add: bool = True
    apply_resblocks: bool = True
    bidir_decoder: bool = False
    siamese_fusion: Optional[str] = None   # 'se' | 'add'

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


def _validate(cfg: RefidConfig) -> None:
    """The JAX network's assertions (and its lookups of the axes' names) as
    ``ValueError``s, with its reasons."""
    choices = {"remat_policy": ("all", "stage_outputs"),
               "recurrent_cell": ("simpleconv", "convgru", "convlstm"),
               "encoder_stage": ("then_down", "conv_down", "rec_conv"),
               "decoder_type": ("transpose_recurrent", "pixelshuffle_recurrent",
                                "upsample_conv"),
               "siamese_fusion": (None, "se", "add")}
    for axis, allowed in choices.items():
        if getattr(cfg, axis) not in allowed:
            raise ValueError(f"RefidConfig.{axis} must be one of {allowed}, "
                             f"got {getattr(cfg, axis)!r}")
    if cfg.dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"RefidConfig.dtype must be None, float32 or "
                         f"bfloat16, got {cfg.dtype}")
    if cfg.encoder_stage == "rec_conv":
        if cfg.recurrent_cell not in ("convgru", "convlstm"):
            raise ValueError("rec_conv stage is the ConvLSTM/ConvGRU lineage")
        if cfg.bidirectional:
            raise ValueError(
                "rec_conv has no bidirectional-state fuse — the reference "
                "RecurrentConvLayer takes no bi_direction_state and the "
                "bidirection archs crash with convlstm/convgru "
                "(models/archs.py breakage map)")
    if cfg.bidir_decoder and not (cfg.aliased_backward_states and cfg.bidirectional):
        raise ValueError("bidir_decoder replicates the aliased all-bidirection lineage")
    if cfg.siamese_fusion is not None and cfg.bidirectional:
        raise ValueError("the siamese lineage is unidirectional (siamese arch :140)")


def int8_applicable(cfg: Optional[RefidConfig]) -> bool:
    """True iff int8 serving applies: exactly the configurations that the
    JAX serving forward replays (``refid_tpu/pipeline.py::
    _fast_serving_applicable``)."""
    return (cfg is not None and cfg.bidirectional and cfg.aliased_backward_states
            and cfg.recurrent_cell == "simpleconv"
            and cfg.encoder_stage == "then_down"
            and cfg.num_block == 1 and cfg.siamese_fusion is None
            and cfg.decoder_type == "transpose_recurrent"
            and cfg.num_encoders >= 2
            and cfg.apply_resblocks and cfg.bottleneck_img_add
            and not cfg.bidir_decoder and not cfg.use_first_dcn)


INT8_NEEDS = ("the production architecture that the JAX serving forward replays: "
              "bidirectional with aliased backward states, then_down stages with "
              "simpleconv cells, num_block=1, num_encoders >= 2, the transposed-conv "
              "decoder, the bottleneck with the image add, no DCN, no bidirectional "
              "decoder, no siamese fusion")


class FinalBidirectionAttenfusion(nn.Module):
    """Event-recurrent UNet for blurry VFI, bidirectional in the flagship.

    Inputs (NCHW): ``x`` ``(b, img_chn, h, w)``, or ``(b, 2, c, h, w)``
    concatenated along channels; ``event`` ``(b, t, ev_chn, h, w)`` adjacent
    voxel-bin pairs.  Output ``(b, t, out_chn, h, w)``.  ``h`` and ``w`` must
    be multiples of ``2**num_encoders``.

    Under an active spatial plan (``parallel/spatial.py::spatial_scope``)
    ``x`` and ``event`` are this rank's rows of the frame and so is the
    output.
    """

    def __init__(self, cfg: RefidConfig = RefidConfig()):
        super().__init__()
        _validate(cfg)
        self.cfg = cfg
        base, ne = cfg.base_num_channels, cfg.num_encoders
        ins, outs = cfg.encoder_in_sizes, cfg.encoder_out_sizes
        siamese = cfg.siamese_fusion is not None
        self.head = ConvLayer(cfg.ev_chn, base, 5, 1, 2, 0.2)
        # siamese: the head reads one frame's half of the channels
        self.head_img = ConvLayer(cfg.img_chn // 2 if siamese else cfg.img_chn,
                                  base, 5, 1, 2, 0.2)
        self.img_encoders = nn.ModuleList(
            ImageEncoderConvBlock(ins[i], outs[i]) for i in range(ne))

        def stages(fuse_two_direction):
            return nn.ModuleList(
                RecurrentEncoderStage(
                    ins[i], outs[i], cfg.num_block,
                    use_atten_fuse=i in cfg.atten_fuse_at and i != 0,
                    fuse_two_direction=fuse_two_direction,
                    cell=cfg.recurrent_cell, stage_type=cfg.encoder_stage,
                    use_first_dcn=cfg.use_first_dcn)
                for i in range(ne))

        if cfg.bidirectional:
            self.encoders_backward = stages(False)
            self.encoders_forward = stages(True)
        else:
            self.encoders = stages(False)
        if cfg.siamese_fusion == "se":
            self.img_ev_fusions = nn.ModuleList(ImgEvFusion(outs[i]) for i in range(ne))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels)
            for _ in range(cfg.num_residual_blocks if cfg.apply_resblocks else 0))

        def decoder(i, fuse_two_direction=False):
            c = outs[ne - i - 1]
            if cfg.decoder_type == "pixelshuffle_recurrent":
                # the decoder input is cat([feature, skip]) (upstream
                # XXNet_ps_decoder_recurrent_arch.py hard-codes skip_concat)
                return PixelShuffleRecurrentConvLayer(2 * c, c // 2)
            if cfg.decoder_type == "upsample_conv":
                return UpsampleConvLayer(c, c // 2)
            return TransposeRecurrentConvLayer(c, c // 2, fuse_two_direction)

        self.decoders = nn.ModuleList(decoder(i, cfg.bidir_decoder) for i in range(ne))
        if cfg.bidir_decoder:
            # the backward pass's own decoder stack, transposed-conv always
            self.decoders_backward = nn.ModuleList(
                TransposeRecurrentConvLayer(outs[ne - i - 1], outs[ne - i - 1] // 2)
                for i in range(ne))
        self.pred = ConvLayer(base, cfg.out_chn, 3, 1, 1, relu_slope=None)

    def _zero_states(self, b, h, w, like):
        """Encoder states (at the pre-down resolution for ``then_down``, the
        post-down one for the k5/s2 stages; ConvLSTM's a (hidden, cell)
        pair) and decoder states (post-upsample)."""
        cfg = self.cfg
        ne, out = cfg.num_encoders, cfg.encoder_out_sizes
        shift = 0 if cfg.encoder_stage == "then_down" else 1

        def enc(i):
            z = like.new_zeros(b, out[i], h // 2 ** (i + shift), w // 2 ** (i + shift))
            return (z, z) if cfg.recurrent_cell == "convlstm" else z

        dec = tuple(like.new_zeros(b, out[ne - i - 1] // 2,
                                   h // 2 ** (ne - i - 1), w // 2 ** (ne - i - 1))
                    for i in range(ne))
        return tuple(enc(i) for i in range(ne)), dec

    @staticmethod
    def _stage_q(i, q):
        """The quant states of encoder stage ``i``: its stage conv and down,
        and its trunk."""
        if q is None:
            return {}
        return {"q": q if i else None, "q_trunk": q if i or q.scale0 else None}

    def _segment(self, fn, *args):
        """``fn(*args)``, checkpointed on its own under
        ``remat_policy='stage_outputs'`` while gradients are recorded."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy == "stage_outputs" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _encode(self, stages, ev_k, y_of, states, bwd, x_blocks, q):
        """The event head and the encoder stages of one step (each stage
        followed by the siamese fusion, if any): (stage outputs, new
        states)."""
        cfg = self.cfg
        fusions = getattr(self, "img_ev_fusions", None)
        e, e_blocks, new = ev_k, [], []
        for i, stage in enumerate(stages):
            def run(e, y, s, bd, i=i, stage=stage):
                if i == 0:
                    e = self.head(e)
                e, s = stage(e, y, s, bd, **self._stage_q(i, q))
                if cfg.siamese_fusion == "se":
                    e = fusions[i](e, *x_blocks[i])
                elif cfg.siamese_fusion == "add":
                    e = e + x_blocks[i][0] + x_blocks[i][1]
                return e, s

            e, s = self._segment(run, e, y_of[i], states[i], None if bwd is None else bwd[i])
            e_blocks.append(e)
            new.append(s)
        return e_blocks, tuple(new)

    def _decode(self, decoders, e, e_blocks, dec_states, bwd_dec=None, q=None):
        """The decoder stack of one step, each stage's input its skip sum
        (concatenation for the pixel-shuffle decoder): (output, new
        states)."""
        ne = self.cfg.num_encoders
        new = []
        for i, dec in enumerate(decoders):
            dq = q if q is not None and (i < ne - 2 or q.last_decoders) else None

            def run(e, skip, s, bd, dec=dec, dq=dq):
                if isinstance(dec, PixelShuffleRecurrentConvLayer):
                    return dec(torch.cat([e, skip], 1), s)
                if isinstance(dec, UpsampleConvLayer):
                    return dec(e + skip, s)
                return dec(e + skip, s, bd, q=dq)

            e, s = self._segment(run, e, e_blocks[ne - i - 1], dec_states[i],
                                 None if bwd_dec is None else bwd_dec[i])
            new.append(s)
        return e, tuple(new)

    def _backward_step(self, ev_k, y_of, carry, q=None):
        """One backward-loop step over all encoder scales (and, in the
        all-bidirection lineage, the backward decoders); returns the new
        carry."""
        states, dec_states = carry if self.cfg.bidir_decoder else (carry, None)
        e_blocks, new = self._encode(self.encoders_backward, ev_k, y_of, states,
                                     None, None, q)
        if not self.cfg.bidir_decoder:
            return new
        _, new_dec = self._decode(self.decoders_backward, e_blocks[-1], e_blocks,
                                  dec_states)
        return new, new_dec

    def _forward_step(self, ev_k, y_of, x_blocks, head, fwd_states, dec_states,
                      bwd, q=None):
        """One forward-loop step: encoders (fusing ``bwd``), bottleneck,
        recurrent decoders, prediction.  Returns (frame, fwd_states,
        dec_states)."""
        cfg = self.cfg
        bwd_dec = None
        if cfg.bidir_decoder:
            bwd, bwd_dec = bwd
        stages = self.encoders_forward if cfg.bidirectional else self.encoders
        e_blocks, new = self._encode(stages, ev_k, y_of, fwd_states, bwd, x_blocks, q)
        e = e_blocks[-1]
        if len(self.resblocks):
            img_add = cfg.bottleneck_img_add and head is not None

            def bottleneck(e, x_last):
                for i, block in enumerate(self.resblocks):
                    e = block(e + x_last if i == 0 and img_add else e, q)
                return e

            e = self._segment(bottleneck, e, x_blocks[-1] if img_add else None)
        e, new_dec = self._decode(self.decoders, e, e_blocks, dec_states, bwd_dec, q)
        # the siamese lineage predicts from the decoder output alone
        frame = self._segment(lambda e, head: self.pred(e if head is None else e + head),
                              e, head)
        return frame, new, new_dec

    def _step(self, fn, *args):
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy == "all" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    int8_side = 8    # a task predicts in int8 where both frame sides are multiples of this

    @property
    def row_block(self) -> int:
        """The rows of a spatial shard come in whole blocks of this many:
        every scale splits at the same place."""
        return 2 ** self.cfg.num_encoders

    def task_int8_mode(self, int8):
        """The int8 mode that a task's ``val.int8`` selects: True or
        ``"scale0"`` (dynamic scales), as the JAX task; ``"static"`` raises,
        since a task records no calibration."""
        if int8 not in (False, True, "scale0"):
            raise ValueError(f"val.int8 must be False, True or 'scale0' (dynamic scales; "
                             f"'static' requires calibration, which a task does not "
                             f"record); got {int8!r}")
        if int8 and not int8_applicable(self.cfg):
            raise ValueError(f"val.int8 requires {INT8_NEEDS}")
        return int8

    def forward(self, x, event, q=None):
        if q is not None and not int8_applicable(self.cfg):
            raise ValueError(f"int8 serving needs {INT8_NEEDS}; got {self.cfg}")
        plan = spatial.active()
        if plan is not None:
            plan.check_rows(x.shape[-2])
        if self.cfg.dtype != torch.bfloat16:
            return self._forward(x, event, q)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = self._forward(x, event, q)
        return out.float()

    def _forward(self, x, event, q=None):
        cfg = self.cfg
        if x.dim() == 5:   # (b, 2, c, h, w) -> (b, 2c, h, w)
            x = torch.cat(x.unbind(1), 1)
        b, t, _, h, w = event.shape
        siamese = cfg.siamese_fusion is not None
        if siamese:        # each frame's half of the channels, stacked on the batch
            c2 = x.shape[1] // 2
            x = torch.cat([x[:, :c2], x[:, c2:]], 0)

        head = self.head_img(x)
        x_blocks = []
        cur = head
        for enc in self.img_encoders:
            cur = enc(cur)
            x_blocks.append((cur[:b], cur[b:]) if siamese else cur)
        enc_zero, dec_zero = self._zero_states(b, h, w, head)
        if siamese:        # no input-side image fuse, no image head at the prediction
            y_of, head = (None,) * cfg.num_encoders, None
        else:              # the image feature fused at each scale
            y_of = tuple([None] + x_blocks[:-1])

        bwd_states, bwd_by_time = None, [None] * t
        if cfg.bidirectional:
            bwd_states = (enc_zero, dec_zero) if cfg.bidir_decoder else enc_zero
            for k in range(t - 1, -1, -1):
                bwd_states = self._step(self._backward_step, event[:, k], y_of,
                                        bwd_states, q)
                if not cfg.aliased_backward_states:
                    bwd_by_time[k] = bwd_states

        fwd_states, dec_states = enc_zero, dec_zero
        outs = []
        for k in range(t):
            bwd = (bwd_states if cfg.aliased_backward_states else bwd_by_time[k])
            frame, fwd_states, dec_states = self._step(
                self._forward_step, event[:, k], y_of, x_blocks, head,
                fwd_states, dec_states, bwd, q)
            outs.append(frame)
        if q is not None:
            q.finish()
        return torch.stack(outs, 1)
