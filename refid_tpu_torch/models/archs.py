"""Arch registry entries: reference ``network_g.type`` -> network constructor
(mirrors ``_refid_cfg`` and the ``FinalBidirectionAttenfusion`` and
``SingleMultiConnectEVHINet`` entries of ``refid_tpu/models/archs.py``; the
ablation lineages come later).

``compute_dtype: bfloat16`` maps to bf16 autocast with float32 parameters.
"""

from __future__ import annotations

import torch

from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig

__all__ = ["final_bidirection_attenfusion", "single_multiconnect_evhinet"]


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


def _compute_dtype(opt: dict):
    dtype = opt.get("compute_dtype")
    if dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"compute_dtype {dtype!r}: only float32 and bfloat16")
    return torch.bfloat16 if dtype == "bfloat16" else None


@ARCHS.register("FinalBidirectionAttenfusion")
def final_bidirection_attenfusion(opt: dict) -> FinalBidirectionAttenfusion:
    """The production network (upstream XXNet_final_attenfusion_arch.py)."""
    return FinalBidirectionAttenfusion(_refid_cfg(opt))


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
