"""Arch registry entries: reference ``network_g.type`` -> network constructor
(mirrors ``_refid_cfg`` and the ``FinalBidirectionAttenfusion`` entry of
``refid_tpu/models/archs.py``; the ablation lineages come later).

``compute_dtype: bfloat16`` maps to bf16 autocast with float32 parameters.
"""

from __future__ import annotations

import torch

from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig

__all__ = ["final_bidirection_attenfusion"]


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
    dtype = opt.get("compute_dtype")
    if dtype == "bfloat16":
        kw["dtype"] = torch.bfloat16
    elif dtype not in (None, "float32"):
        raise ValueError(f"compute_dtype {dtype!r}: only float32 and bfloat16")
    return RefidConfig(**kw)


@ARCHS.register("FinalBidirectionAttenfusion")
def final_bidirection_attenfusion(opt: dict) -> FinalBidirectionAttenfusion:
    """The production network (upstream XXNet_final_attenfusion_arch.py)."""
    return FinalBidirectionAttenfusion(_refid_cfg(opt))
