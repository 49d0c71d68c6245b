"""Which convs of the blurry-VFI network an int8 serving mode quantizes,
and the int4 control that rounds those sites one step further down.

Sites (the serving forward's selection): in every mode each encoder stage
i >= 1 quantizes its 3x3 stage conv (where EGACA does not replace it), its
trunk (``main.0`` and the residual block's two convs) and its 4x4/2
``down``; the bottleneck's residual blocks; the trunks of the decoders
before the last two.  ``"scale0"`` adds the stage-0 trunks, ``"static"``
also the last two decoders' trunks.  The head convs, the image encoder,
EGACA, the bidirectional fuse, the transposed convs and the prediction conv
never run in int8.

``int4_sites(net, mode)`` makes each site read its input rounded to 4-bit
integers on one scale a tensor (its largest magnitude at 7) and its
weights on one scale an output channel.
"""

from __future__ import annotations

import re
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["is_site", "int4_sites"]

_ENC = re.compile(r"encoders_(backward|forward)\.(\d+)\.(conv\.conv2d|down|"
                  r"recurrent_block\.forward_trunk\.main\.(0|2\.0\.conv[12]))$")
_DEC = re.compile(r"decoders\.(\d+)\.forward_trunk\.main\.(0|2\.0\.conv[12])$")
_RES = re.compile(r"resblocks\.\d+\.conv[12]$")


def is_site(name: str, mode, num_encoders: int) -> bool:
    """Whether the conv module ``name`` runs in int8 in ``mode``."""
    scale0 = mode in ("scale0", "static")
    last_decoders = mode == "static"
    m = _ENC.match(name)
    if m:
        stage = int(m.group(2))
        if m.group(3).startswith("recurrent_block"):
            return stage >= 1 or scale0
        return stage >= 1
    m = _DEC.match(name)
    if m:
        return int(m.group(1)) < num_encoders - 2 or last_decoders
    return bool(_RES.match(name))


def _int4(x: torch.Tensor, dims) -> torch.Tensor:
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(x / scale), -8, 7) * scale


def _int4_conv(self, x):
    return F.conv2d(_int4(x, None), _int4(self.weight, (1, 2, 3)), self.bias, self.stride,
                    self.padding, self.dilation, self.groups)


def int4_sites(net: nn.Module, mode, num_encoders: int = 3) -> nn.Module:
    for name, mod in net.named_modules():
        if isinstance(mod, nn.Conv2d) and is_site(name, mode, num_encoders):
            mod.forward = types.MethodType(_int4_conv, mod)
    return net
