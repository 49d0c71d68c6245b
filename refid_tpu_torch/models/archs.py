"""Arch registry entries: reference ``network_g.type`` -> network constructor
(mirrors ``refid_tpu/models/archs.py``: every name it registers, with its
``_refid_cfg``, ``_ablation_cfg`` and ``_STAGE_BY_RBT``).

The paper's ablation lineages (upstream's XXNet_*_arch.py files) are flag
combinations of ``FinalBidirectionAttenfusion``; the YAML
``recurrent_block_type`` selects the encoder stage and cell as upstream's
if/elif chains do.  Where the upstream arch is broken the JAX analog
implements the intended semantics, and so does this one (the breakage map in
``refid_tpu/models/archs.py``):

* ``UNetRecurrent`` / ``UNetPSDecoderRecurrent``: upstream runs only with
  convlstm / convgru; the other block types build here as the flags say.
* ``BidirUNetRecurrent``: upstream runs only with ``simpleconv``;
  convlstm / convgru raise (the rec_conv stage has no bidirectional fuse).
* ``UNetDecoderRecurrentBidirection`` / ``AllBidirection``: upstream's
  bottleneck resblocks are built and never called; here they are absent.
  ``AllBidirection`` never runs upstream (the backward pass feeds decoder
  outputs to the encoders) and discards its decoder fuse; here the backward
  decoder states are fused into the forward decoders.
* ``UNetDecoderRecurrentSiameseImg{,NoAtten}``: upstream's ``head_img``
  reads ``img_chn`` channels but is fed one frame's half; here it reads the
  half.  NoAtten's unused SE fusions are absent.

``EFNet`` (upstream EFNet_arch.py) has no JAX counterpart; it is held to
the benchmark's plain reference (``models/efnet.py``).  Nor has
``Restormer`` (upstream restormer_arch.py, ``models/restormer.py``), fed the
photo and the event voxel concatenated (``inp_channels`` 9 by default), nor
``Uformer`` (upstream Uformer's model.py, ``models/uformer.py``; ``dd_in`` 9
by default).

``compute_dtype: bfloat16`` maps to bf16 autocast with float32 parameters.
"""

from __future__ import annotations

import torch

from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models.efnet import EFNet
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig
from refid_tpu_torch.models.restormer import Restormer
from refid_tpu_torch.models.uformer import Uformer

__all__ = ["final_bidirection_attenfusion", "final_bidirection", "single_multiconnect_evhinet",
           "efnet", "restormer", "uformer",
           "unet_recurrent", "unet_decoder_recurrent", "bidir_unet_recurrent",
           "unet_decoder_recurrent_bidir", "unet_decoder_recurrent_allbidir",
           "unet_ps_decoder_recurrent", "unet_decoder_recurrent_siamese",
           "unet_decoder_recurrent_siamese_noatten"]

# upstream recurrent_block_type -> (encoder_stage, recurrent_cell)
_STAGE_BY_RBT = {
    "simpleconvThendown": ("then_down", "simpleconv"),
    "simpleconv": ("conv_down", "simpleconv"),
    "convlstm": ("rec_conv", "convlstm"),
    "convgru": ("rec_conv", "convgru"),
}


def _refid_cfg(opt: dict, **overrides) -> RefidConfig:
    kw = dict(
        img_chn=opt["img_chn"],
        ev_chn=opt["ev_chn"],
        out_chn=opt.get("out_chn", 3),
        num_encoders=opt.get("num_encoders", 3),
        base_num_channels=opt.get("base_num_channels", 32),
        num_block=opt.get("num_block", 1),
        num_residual_blocks=opt.get("num_residual_blocks", 2),
        use_first_dcn=opt.get("use_first_dcn", False),
        aliased_backward_states=opt.get("aliased_backward_states", True),
        remat=opt.get("remat", False),
        remat_policy=opt.get("remat_policy", "all"),
        siamese_fusion=opt.get("siamese_fusion"),
    )
    kw.update(overrides)
    return RefidConfig(dtype=_compute_dtype(opt), **kw)


def _ablation_cfg(opt: dict, default_rbt: str, **overrides) -> RefidConfig:
    """The ablation lineages' wiring: the encoder stage and cell follow the
    YAML ``recurrent_block_type`` (default ``default_rbt``), no EGACA, and no
    image add at the bottleneck (a flagship-only behaviour)."""
    rbt = opt.get("recurrent_block_type", default_rbt)
    if rbt not in _STAGE_BY_RBT:
        raise ValueError(f"recurrent_block_type must be one of {sorted(_STAGE_BY_RBT)}, "
                         f"got {rbt!r}")
    stage, cell = _STAGE_BY_RBT[rbt]
    base = dict(atten_fuse_at=(), encoder_stage=stage, recurrent_cell=cell,
                bottleneck_img_add=False)
    base.update(overrides)
    return _refid_cfg(opt, **base)


def _compute_dtype(opt: dict):
    dtype = opt.get("compute_dtype")
    if dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"compute_dtype {dtype!r}: only float32 and bfloat16")
    return torch.bfloat16 if dtype == "bfloat16" else None


@ARCHS.register("FinalBidirectionAttenfusion")
def final_bidirection_attenfusion(opt: dict) -> FinalBidirectionAttenfusion:
    """The production network (upstream XXNet_final_attenfusion_arch.py)."""
    return FinalBidirectionAttenfusion(_refid_cfg(opt))


@ARCHS.register("FinalBidirection")
def final_bidirection(opt: dict) -> FinalBidirectionAttenfusion:
    """The flagship without EGACA (additive fusion at every scale): the JAX
    package's own variant, with the flagship's bottleneck."""
    return FinalBidirectionAttenfusion(_refid_cfg(opt, atten_fuse_at=()))


@ARCHS.register("SingleMultiConnectEVHINet")
def single_multiconnect_evhinet(opt: dict) -> EVHINet:
    """Event-guided HINet for single-image deblurring (upstream
    single_multiconnect_evhinet_arch.py)."""
    return EVHINet(in_chn=opt.get("in_chn", 3), ev_chn=opt.get("ev_chn", 6),
                   wf=opt.get("wf", 64), depth=opt.get("depth", 3),
                   fac_place=opt.get("fac_place", 2),
                   hin_left=opt.get("hin_position_left", 0),
                   hin_right=opt.get("hin_position_right", 4),
                   dtype=_compute_dtype(opt))


@ARCHS.register("EFNet")
def efnet(opt: dict) -> EFNet:
    """Event-image fusion with cross-modal attention, two stages
    (upstream EFNet_arch.py)."""
    return EFNet(in_chn=opt.get("in_chn", 3), ev_chn=opt.get("ev_chn", 6),
                 wf=opt.get("wf", 64), depth=opt.get("depth", 3),
                 num_heads=tuple(opt.get("num_heads", (1, 2, 4))),
                 ffn_expansion_factor=opt.get("ffn_expansion_factor", 4),
                 fuse_before_downsample=opt.get("fuse_before_downsample", True),
                 relu_slope=opt.get("relu_slope", 0.2), dtype=_compute_dtype(opt))


@ARCHS.register("Restormer")
def restormer(opt: dict) -> Restormer:
    """Transposed channel attention and gated depthwise FFNs in a four-level
    U-Net (upstream restormer_arch.py), on the photo and its events."""
    return Restormer(inp_channels=opt.get("inp_channels", 9),
                     out_channels=opt.get("out_channels", 3), dim=opt.get("dim", 48),
                     num_blocks=tuple(opt.get("num_blocks", (4, 6, 6, 8))),
                     num_refinement_blocks=opt.get("num_refinement_blocks", 4),
                     heads=tuple(opt.get("heads", (1, 2, 4, 8))),
                     ffn_expansion_factor=opt.get("ffn_expansion_factor", 2.66),
                     bias=opt.get("bias", False),
                     layer_norm_type=opt.get("LayerNorm_type", "WithBias"),
                     dual_pixel_task=opt.get("dual_pixel_task", False),
                     dtype=_compute_dtype(opt))


@ARCHS.register("Uformer")
def uformer(opt: dict) -> Uformer:
    """Shifted-window self-attention and LeFF in a five-level U-Net (upstream
    Uformer's model.py; the defaults are ``get_arch``'s ``Uformer_B``), on
    the photo and its events."""
    return Uformer(dd_in=opt.get("dd_in", 9), embed_dim=opt.get("embed_dim", 32),
                   depths=tuple(opt.get("depths", (1, 2, 8, 8, 2, 8, 8, 2, 1))),
                   num_heads=tuple(opt.get("num_heads", (1, 2, 4, 8, 16, 16, 8, 4, 2))),
                   win_size=opt.get("win_size", 8), mlp_ratio=opt.get("mlp_ratio", 4.0),
                   modulator=opt.get("modulator", True), shift_flag=opt.get("shift_flag", True),
                   token_projection=opt.get("token_projection", "linear"),
                   token_mlp=opt.get("token_mlp", "leff"), qkv_bias=opt.get("qkv_bias", True),
                   dtype=_compute_dtype(opt))


# --- the ablation lineages ----------------------------------------------------

@ARCHS.register("UNetRecurrent")
def unet_recurrent(opt: dict) -> FinalBidirectionAttenfusion:
    """Unidirectional encoder, bilinear-k5 decoder without recurrence
    (upstream XXNet_arch.py)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "convlstm", bidirectional=False, decoder_type="upsample_conv"))


@ARCHS.register("UNetDecoderRecurrent")
def unet_decoder_recurrent(opt: dict) -> FinalBidirectionAttenfusion:
    """Unidirectional encoder, recurrent decoder
    (upstream XXNet_decoder_recurrent_arch.py)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(opt, "convlstm", bidirectional=False))


@ARCHS.register("BidirUNetRecurrent")
def bidir_unet_recurrent(opt: dict) -> FinalBidirectionAttenfusion:
    """Bidirectional encoder, decoder without recurrence
    (upstream XXNet_bidirection_arch.py)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "simpleconv", decoder_type="upsample_conv"))


@ARCHS.register("UNetDecoderRecurrentBidirection")
def unet_decoder_recurrent_bidir(opt: dict) -> FinalBidirectionAttenfusion:
    """Bidirectional encoder, recurrent decoder, additive fusion, no
    bottleneck (upstream XXNet_decoder_recurrent_bidirection_arch.py)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "simpleconvThendown", apply_resblocks=False))


@ARCHS.register("UNetDecoderRecurrentAllBidirection")
def unet_decoder_recurrent_allbidir(opt: dict) -> FinalBidirectionAttenfusion:
    """Bidirectional encoder and decoder
    (upstream XXNet_decoder_recurrent_allbidirection_arch.py, as intended)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "simpleconvThendown", apply_resblocks=False, bidir_decoder=True))


@ARCHS.register("UNetPSDecoderRecurrent")
def unet_ps_decoder_recurrent(opt: dict) -> FinalBidirectionAttenfusion:
    """Unidirectional encoder, pixel-shuffle recurrent decoder
    (upstream XXNet_ps_decoder_recurrent_arch.py)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "convlstm", bidirectional=False, decoder_type="pixelshuffle_recurrent"))


@ARCHS.register("UNetDecoderRecurrentSiameseImg")
def unet_decoder_recurrent_siamese(opt: dict) -> FinalBidirectionAttenfusion:
    """Siamese image encoder with per-scale SE fusion
    (upstream XXNet_decoder_recurrent_siamese_arch.py, head fixed)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "simpleconvThendown", bidirectional=False, siamese_fusion="se"))


@ARCHS.register("UNetDecoderRecurrentSiameseImgNoAtten")
def unet_decoder_recurrent_siamese_noatten(opt: dict) -> FinalBidirectionAttenfusion:
    """Siamese image encoder with additive fusion
    (upstream XXNet_decoder_recurrent_siamese_noatten_arch.py, head fixed)."""
    return FinalBidirectionAttenfusion(_ablation_cfg(
        opt, "simpleconvThendown", bidirectional=False, siamese_fusion="add"))
