"""Weights from the JAX package's param tree into the port's state_dict.

:func:`state_dict_from_jax` is the exact inverse of
``refid_tpu/models/convert.py::convert_state_dict`` (upstream torch names ->
flax tree):
  * Conv2d           (kh, kw, I, O) -> (O, I, kh, kw)
  * ConvTranspose2d  (kh, kw, O, I) -> (I, O, kh, kw)
  * LayerNorm2d      scale / bias   -> weight / bias
  * beta / gamma     (1, 1, 1, C)   -> (1, C, 1, 1)
It takes the nested ``{'params': ...}`` tree with numpy (or array-like)
leaves and raises if any leaf has no counterpart.  The port keys it leaves
unfilled are upstream's known-unused parameters (``convert.py``'s list):
EGACA's ``se_2`` and the bypassed ``conv`` of attention-fused encoder
stages; :func:`load_state` accepts exactly those as missing.  An upstream
checkpoint of the bidirection lineages also carries the bottleneck
``resblocks`` that upstream builds and never calls; a network without
resblocks ignores them, as the JAX converter does.

:func:`evhinet_state_dict_from_jax` is the exact inverse of
``convert_evhinet_state_dict`` for EVHINet.  An upstream EVHINet checkpoint
(recognised by its ``conv_ev1.`` keys) also carries the stage-2 modules that
upstream builds and never runs; :func:`load_state` ignores keys outside the
port's EVHINet, naming them in the log, as the JAX converter reads only the
stage-1 keys.

An upstream EFNet checkpoint (recognised by its ``image_event_transformer``
keys) loads into the port's :class:`EFNet` under upstream's names, but for
EICA's: its ``WithBias`` LayerNorms' ``norm1_*.body.`` and its MLP's
``ffn.fc1`` / ``ffn.fc2`` are the port block's ``norm1_*.`` and ``fc1`` /
``fc2``.

An upstream Restormer checkpoint (recognised by its ``patch_embed.proj``
keys) loads into the port's :class:`Restormer` unchanged: its module names
are upstream's, the ``WithBias`` LayerNorms' ``norm*.body.`` included.

An upstream Uformer checkpoint (recognised by its ``input_proj.proj`` keys)
loads into the port's :class:`Uformer` under its own names.  Upstream saves
each block's ``attn.relative_position_index`` buffer, which the port
computes: each must equal the port's, and is then dropped.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from refid_tpu_torch.models.efnet import EFNet
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.models.recurrent import RecurrentEncoderStage
from refid_tpu_torch.models.refid import RefidConfig
from refid_tpu_torch.models.restormer import Restormer
from refid_tpu_torch.models.uformer import Uformer

__all__ = ["state_dict_from_jax", "evhinet_state_dict_from_jax", "known_unused_keys",
           "load_state"]

_EICA_NAMES = ((".norm1_image.body.", ".norm1_image."), (".norm1_event.body.", ".norm1_event."),
               (".ffn.fc", ".fc"))
_ATTEN_CONVS = ("conv1", "conv2", "conv1_e", "conv2_e", "conv3", "conv4",
                "conv5", "conv_y_side")


def flatten_params(params: Mapping) -> Dict[str, np.ndarray]:
    """``{'params': {'a': {'b': leaf}}}`` -> ``{'a/b': float32 array}``."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}/", value)
            else:
                out[prefix + key] = np.asarray(value, np.float32)

    walk("", params.get("params", params))
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))   # a writable copy


def _conv(dst, src, t, f, bias=True):
    """Conv (kh,kw,I,O) or transposed conv (kh,kw,O,I) -> torch's layout:
    the same axis permutation inverts both of convert.py's."""
    dst[t + "weight"] = _tensor(np.transpose(src.pop(f + "kernel"), (3, 2, 0, 1)))
    if bias:
        dst[t + "bias"] = _tensor(src.pop(f + "bias"))


def _norm(dst, src, t, f):
    dst[t + "weight"] = _tensor(src.pop(f + "scale"))
    dst[t + "bias"] = _tensor(src.pop(f + "bias"))


def _trunk(dst, src, t, f):
    """ConvResidualBlocks: conv_in -> main.0, block_j -> main.2.j."""
    _conv(dst, src, t + "main.0.", f + "conv_in/")
    j = 0
    while f"{f}block_{j}/conv1/kernel" in src:
        for c in ("conv1", "conv2"):
            _conv(dst, src, f"{t}main.2.{j}.{c}.", f"{f}block_{j}/{c}/")
        j += 1


def _atten(dst, src, t, f):
    for c in _ATTEN_CONVS:
        _conv(dst, src, f"{t}{c}.", f"{f}{c}/")
    _conv(dst, src, t + "se_1.1.", f + "se_1/fc1/")
    _conv(dst, src, t + "se_1.3.", f + "se_1/fc2/")
    for n in ("norm1", "norm1_e", "norm2"):
        _norm(dst, src, f"{t}{n}.", f"{f}{n}/")
    for p in ("beta", "gamma"):
        dst[t + p] = _tensor(np.transpose(src.pop(f + p), (0, 3, 1, 2)))


def _img_block(dst, src, t, f):
    for tn, fn in (("conv_1", "conv1"), ("conv_2", "conv2"),
                   ("identity", "identity")):
        _conv(dst, src, f"{t}{tn}.", f"{f}{fn}/")
    _conv(dst, src, t + "down.", f + "down/", bias=False)


def _cell(dst, src, t, f):
    """A recurrent cell: SimpleRecurrentConv's trunk, ConvLSTM's ``gates``
    or ConvGRU's three gate convs."""
    if f + "gates/kernel" in src:
        _conv(dst, src, t + "Gates.", f + "gates/")
    elif f + "update_gate/kernel" in src:
        for g in ("reset_gate", "update_gate", "out_gate"):
            _conv(dst, src, f"{t}{g}.", f"{f}{g}/")
    else:
        _trunk(dst, src, t + "forward_trunk.", f + "trunk/")


def _stage(dst, src, t, f):
    """RecurrentEncoderStage, any lineage: EGACA or the first conv (a
    ConvLayer, the rec_conv stage's plain conv or a DCN), the cell, the
    bidirectional fuse and ``down`` where the stage has them."""
    if f + "atten/beta" in src:
        _atten(dst, src, t + "atten_fuse.", f + "atten/")
    elif f + "conv/conv_offset/kernel" in src:          # ModulatedDeformConvPack
        _conv(dst, src, t + "conv.conv_offset.", f + "conv/conv_offset/")
        _conv(dst, src, t + "conv.", f + "conv/")
    elif f + "conv/kernel" in src:                      # rec_conv's plain conv
        _conv(dst, src, t + "conv.conv2d.", f + "conv/")
    else:
        _conv(dst, src, t + "conv.conv2d.", f + "conv/conv/")
    _cell(dst, src, t + "recurrent_block.", f + "rec/")
    if f + "down/kernel" in src:
        _conv(dst, src, t + "down.", f + "down/", bias=False)
    if f + "fuse_bidir/conv/kernel" in src:
        _conv(dst, src, t + "fuse_two_dir.conv2d.", f + "fuse_bidir/conv/")


def _decoder(dst, src, t, f):
    """Any decoder: the transposed conv (with the bidirectional fuse) or the
    upsampling conv, and the trunk where the decoder has them."""
    if f + "up/kernel" in src:
        _conv(dst, src, t + "transposed_conv2d.", f + "up/")
    if f + "fuse_bidir/conv/kernel" in src:
        _conv(dst, src, t + "fuse_two_dir.conv2d.", f + "fuse_bidir/conv/")
    if f + "conv/kernel" in src:                        # UpsampleConvLayer
        _conv(dst, src, t + "conv2d.", f + "conv/")
    else:
        _trunk(dst, src, t + "forward_trunk.", f + "trunk/")


def state_dict_from_jax(params: Mapping, cfg: RefidConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's ``FinalBidirectionAttenfusion`` params, any
    lineage -> the port's state_dict (upstream names)."""
    src = flatten_params(params)
    dst: Dict[str, torch.Tensor] = {}
    _conv(dst, src, "head.conv2d.", "head/")
    _conv(dst, src, "head_img.conv2d.", "head_img/conv/")
    for i in range(cfg.num_encoders):
        _img_block(dst, src, f"img_encoders.{i}.", f"img_enc_{i}/")
    directions = ((("bwd", "encoders_backward"), ("fwd", "encoders_forward"))
                  if cfg.bidirectional else (("fwd", "encoders"),))
    for direction, name in directions:
        for i in range(cfg.num_encoders):
            _stage(dst, src, f"{name}.{i}.", f"{direction}/enc_{i}/")
    for i in range(cfg.num_encoders):
        if f"fwd/img_ev_fusion_{i}/se_0/kernel" in src:
            for g in ("se_0", "se_1"):
                _conv(dst, src, f"img_ev_fusions.{i}.{g}.1.", f"fwd/img_ev_fusion_{i}/{g}/")
    for i in range(cfg.num_residual_blocks if cfg.apply_resblocks else 0):
        for c in ("conv1", "conv2"):
            _conv(dst, src, f"resblocks.{i}.{c}.", f"fwd/res_{i}/{c}/")
    for direction, name in (("fwd", "decoders"), ("bwd", "decoders_backward")):
        for i in range(cfg.num_encoders):
            if any(k.startswith(f"{direction}/dec_{i}/") for k in src):
                _decoder(dst, src, f"{name}.{i}.", f"{direction}/dec_{i}/")
    _conv(dst, src, "pred.conv2d.", "fwd/pred/conv/")
    if src:
        raise KeyError(f"JAX params with no port counterpart: {sorted(src)}")
    return dst


def _hin_block(dst, src, t, f):
    """EVHINet's HIN / event block: conv1/conv2/identity -> conv_1/conv_2/
    identity, hin_scale/hin_bias -> norm, merge -> conv_before_merge and
    down -> downsample where the block has them."""
    for tn, fn in (("conv_1", "conv1"), ("conv_2", "conv2"), ("identity", "identity")):
        _conv(dst, src, f"{t}{tn}.", f"{f}{fn}/")
    if f + "hin_scale" in src:
        dst[t + "norm.weight"] = _tensor(src.pop(f + "hin_scale"))
        dst[t + "norm.bias"] = _tensor(src.pop(f + "hin_bias"))
    if f + "merge/kernel" in src:
        _conv(dst, src, t + "conv_before_merge.", f + "merge/")
    if f + "down/kernel" in src:
        _conv(dst, src, t + "downsample.", f + "down/", bias=False)


def evhinet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EVHINet`` params -> the port's state_dict
    (upstream names); the geometry is read off the tree's keys."""
    src = flatten_params(params)
    dst: Dict[str, torch.Tensor] = {}
    for name in ("conv_ev1", "conv_01"):
        _conv(dst, src, f"{name}.", f"{name}/")
    for prefix, tname in (("ev_", "down_path_ev"), ("down_", "down_path_1")):
        i = 0
        while f"{prefix}{i}/conv1/kernel" in src:
            _hin_block(dst, src, f"{tname}.{i}.", f"{prefix}{i}/")
            i += 1
    idx = 0
    while f"up_{idx}/kernel" in src:
        _conv(dst, src, f"up_path_1.{idx}.up.", f"up_{idx}/")
        _hin_block(dst, src, f"up_path_1.{idx}.conv_block.", f"upblk_{idx}/")
        _conv(dst, src, f"skip_conv_1.{idx}.", f"skip_{idx}/")
        idx += 1
    for c in ("conv1", "conv2", "conv3"):
        _conv(dst, src, f"sam12.{c}.", f"sam12/{c}/")
    if src:
        raise KeyError(f"JAX params with no port counterpart: {sorted(src)}")
    return dst


def known_unused_keys(model: nn.Module) -> set:
    """State_dict keys of ``model`` that its forward never reads: EGACA's
    ``se_2`` and the bypassed ``conv`` of attention-fused stages."""
    keys = set()
    for name, module in model.named_modules():
        if isinstance(module, RecurrentEncoderStage) and module.atten_fuse is not None:
            prefix = f"{name}." if name else ""
            keys |= {f"{prefix}conv.{k}" for k in module.conv.state_dict()}
            keys |= {f"{prefix}atten_fuse.se_2.{k}"
                     for k in module.atten_fuse.se_2.state_dict()}
    return keys


def _efnet_port_name(key: str) -> str:
    for upstream, port in _EICA_NAMES:
        key = key.replace(upstream, port)
    return key


def _drop_uformer_indices(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """``state_dict`` without upstream's saved ``relative_position_index``
    buffers, each of which must equal the port's."""
    buffers = dict(model.named_buffers())
    out = {}
    for key, value in state_dict.items():
        if key.endswith(".attn.relative_position_index"):
            mine = buffers.get(key)
            if mine is None or not torch.equal(torch.as_tensor(value).to(mine.device).long(),
                                               mine):
                raise ValueError(f"{key}: not the port's relative position index")
            continue
        out[key] = value
    return out


def load_state(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load ``state_dict`` into ``model``; only known-unused keys may be
    missing.  No key may be unexpected, except upstream's dead bottleneck
    ``resblocks.*`` where the network has none, and in an EVHINet checkpoint
    (``conv_ev1.`` keys) the keys outside the port's EVHINet (upstream's
    stage-2 modules); both are ignored and named in the log.  An EFNet
    checkpoint (``image_event_transformer`` keys) loads whole, EICA's keys
    renamed to the port block's; a Restormer checkpoint (``patch_embed.proj``
    keys) loads whole under its own names, and so does a Uformer checkpoint
    (``input_proj.proj`` keys), its saved relative position indices checked
    against the port's and dropped."""
    is_restormer = any(k.startswith("patch_embed.proj.") for k in state_dict)
    if is_restormer != isinstance(model, Restormer):
        raise ValueError(f"{'a' if is_restormer else 'no'} Restormer checkpoint "
                         f"(patch_embed.proj keys) for a {type(model).__name__} network")
    is_uformer = any(k.startswith("input_proj.proj.") for k in state_dict)
    if is_uformer != isinstance(model, Uformer):
        raise ValueError(f"{'a' if is_uformer else 'no'} Uformer checkpoint "
                         f"(input_proj.proj keys) for a {type(model).__name__} network")
    if is_uformer:
        state_dict = _drop_uformer_indices(model, state_dict)
    is_efnet = any(".image_event_transformer." in k for k in state_dict)
    if is_efnet != isinstance(model, EFNet):
        raise ValueError(f"{'an' if is_efnet else 'no'} EFNet checkpoint "
                         f"(image_event_transformer keys) for a {type(model).__name__} network")
    if is_efnet:
        state_dict = {_efnet_port_name(k): v for k, v in state_dict.items()}
    is_evhinet = not is_efnet and any(k.startswith("conv_ev1.") for k in state_dict)
    if is_evhinet != isinstance(model, EVHINet):
        raise ValueError(f"{'an' if is_evhinet else 'no'} EVHINet checkpoint (conv_ev1.* "
                         f"keys) for a {type(model).__name__} network")
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = set(missing) - known_unused_keys(model)
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, RefidConfig) and not cfg.apply_resblocks:
        dead = [k for k in unexpected if k.startswith("resblocks.")]
        if dead:
            logging.getLogger("refid_tpu_torch").info(
                "ignored upstream's %d dead bottleneck keys: %s", len(dead), sorted(dead))
            unexpected = [k for k in unexpected if k not in dead]
    if is_evhinet and unexpected and not missing:
        logging.getLogger("refid_tpu_torch").info(
            "EVHINet checkpoint: ignored %d keys outside the stage-1 network: %s",
            len(unexpected), sorted(unexpected))
        unexpected = []
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
