"""Plain PyTorch reference of EVHINet (upstream REFID
``single_multiconnect_evhinet_arch.py::SingleMultiConnectEVHINet``, stage 1
as its forward runs it): an event encoder whose blocks emit per-pixel
(weight, bias) filters for the image encoder's stages ``0 .. fac_place``,
HIN blocks (instance norm over half the channels), a UNet decoder and SAM's
``conv2(x) + x_img``.  Module names are upstream's; float32, NCHW.

Modules whose output reaches nothing (the last event block, SAM's
``conv1`` / ``conv3``) are built so that an upstream state_dict loads, and
are not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["EVHINetRef", "evhinet_args"]


class HINBlock(nn.Module):
    def __init__(self, cin, cout, downsample, hin, merge=False):
        super().__init__()
        self.conv_1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv_2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.identity = nn.Conv2d(cin, cout, 1)
        self.norm = nn.InstanceNorm2d(cout // 2, affine=True) if hin else None
        self.downsample = nn.Conv2d(cout, cout, 4, 2, 1, bias=False) if downsample else None
        if merge:
            self.conv_before_merge = nn.Conv2d(cout, 2 * cout, 1)

    def forward(self, x, filt=None):
        out = self.conv_1(x)
        if self.norm is not None:
            half = out.shape[1] // 2
            a = out[:, :half]
            mu = a.mean((2, 3), keepdim=True)
            var = (a - mu).pow(2).mean((2, 3), keepdim=True)
            a = ((a - mu) / torch.sqrt(var + 1e-5) * self.norm.weight[:, None, None]
                 + self.norm.bias[:, None, None])
            out = torch.cat([a, out[:, half:]], 1)
        out = F.leaky_relu(out, 0.2)
        out = F.leaky_relu(self.conv_2(out), 0.2) + self.identity(x)
        if filt is not None:
            weight, bias = filt.chunk(2, 1)
            out = out * weight + bias
        return out


class UpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv_block = HINBlock(cin, cout, False, False)


class SAM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv2 = nn.Conv2d(c, 3, 3, 1, 1)
        self.conv3 = nn.Conv2d(3, c, 3, 1, 1)


class EVHINetRef(nn.Module):
    """``x (b, 3, h, w)``, ``event (b, ev_chn, h, w)`` -> ``(b, 3, h, w)``."""

    def __init__(self, in_chn=3, ev_chn=6, wf=64, depth=3, fac_place=2, hin_left=0,
                 hin_right=4):
        super().__init__()
        self.depth, self.fac_place = depth, fac_place
        hin = [hin_left <= i <= hin_right for i in range(depth)]
        self.conv_ev1 = nn.Conv2d(ev_chn, wf, 3, 1, 1)
        self.down_path_ev = nn.ModuleList()
        prev = wf
        for i in range(min(fac_place + 1, depth)):
            self.down_path_ev.append(HINBlock(prev, 2 ** i * wf, i + 1 < depth, hin[i], True))
            prev = 2 ** i * wf
        self.conv_01 = nn.Conv2d(in_chn, wf, 3, 1, 1)
        self.down_path_1 = nn.ModuleList()
        prev = wf
        for i in range(depth):
            self.down_path_1.append(HINBlock(prev, 2 ** i * wf, i + 1 < depth, hin[i]))
            prev = 2 ** i * wf
        self.up_path_1, self.skip_conv_1 = nn.ModuleList(), nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path_1.append(UpBlock(prev, 2 ** i * wf))
            self.skip_conv_1.append(nn.Conv2d(2 ** i * wf, 2 ** i * wf, 3, 1, 1))
            prev = 2 ** i * wf
        self.sam12 = SAM(prev)

    def forward(self, x, event):
        used = min(self.fac_place + 1, self.depth - 1)
        e, filters = self.conv_ev1(event), []
        for i in range(used):
            blk = self.down_path_ev[i]
            out = blk(e)
            filters.append(blk.conv_before_merge(out))
            e = blk.downsample(out) if i + 1 < used else e
        x1, skips = self.conv_01(x), []
        for i, blk in enumerate(self.down_path_1):
            out = blk(x1, filters[i] if i < used else None)
            if blk.downsample is None:
                x1 = out
            else:
                skips.append(out)
                x1 = blk.downsample(out)
        for i, (up, skip) in enumerate(zip(self.up_path_1, self.skip_conv_1)):
            x1 = up.conv_block(torch.cat([up.up(x1), skip(skips[-i - 1])], 1))
        return self.sam12.conv2(x1) + x


def evhinet_args(network_g: dict) -> dict:
    """:class:`EVHINetRef`'s arguments from an option file's ``network_g``."""
    return {"in_chn": network_g["in_chn"], "ev_chn": network_g["ev_chn"], "wf": network_g["wf"],
            "depth": network_g["depth"], "fac_place": network_g["fac_place"],
            "hin_left": network_g["hin_position_left"],
            "hin_right": network_g["hin_position_right"]}
