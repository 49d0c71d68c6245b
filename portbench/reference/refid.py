"""Plain PyTorch reference of REFID's blurry-VFI network, the production
path of ``FinalBidirectionAttenfusion`` (upstream
``options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml``):
img_chn 26, ev_chn 2, 3 encoders, base 32, one block a trunk, 2 bottleneck
residual blocks, EGACA at scale 1, bidirectional with the backward states
aliased (every forward step fuses the backward state computed at frame 0,
upstream's quirk), the transposed-conv recurrent decoders.

Module names are upstream's, so one upstream-names state_dict loads into
this tree and into the program alike.  Float32, NCHW, no kernels, no
caches: the benchmark's yardstick.  It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["RefidNet", "refid_args", "blur_vfi_window"]


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, s, p, slope=0.2):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, s, p)
        self.slope = slope

    def forward(self, x):
        y = self.conv2d(x)
        return y if self.slope is None else F.leaky_relu(y, self.slope)


class ImageEncoderBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv_1 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.conv_2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.identity = nn.Conv2d(cin, cout, 1)
        self.down = nn.Conv2d(cout, cout, 4, 2, 1, bias=False)

    def forward(self, x):
        y = F.leaky_relu(self.conv_2(F.leaky_relu(self.conv_1(x), 0.2)), 0.2)
        return self.down(y + self.identity(x))


class ResidualBlockNoBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ConvResidualBlocks(nn.Module):
    """3x3 conv, leaky 0.1, one ResidualBlockNoBN (``main.0``, ``main.2.0``)."""

    def __init__(self, cin, c):
        super().__init__()
        self.main = nn.Sequential(nn.Conv2d(cin, c, 3, 1, 1), nn.LeakyReLU(0.1),
                                  nn.Sequential(ResidualBlockNoBN(c)))

    def forward(self, x):
        return self.main(x)


class LayerNorm2d(nn.Module):
    """Over channels, biased variance, eps 1e-6."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        return ((x - mu) / torch.sqrt(var + 1e-6) * self.weight[:, None, None]
                + self.bias[:, None, None])


class SELayer(nn.Sequential):
    def __init__(self, c, mid):
        super().__init__(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, mid, 1), nn.ReLU(),
                         nn.Conv2d(mid, c, 1), nn.Sigmoid())


class CrossmodalAtten(nn.Module):
    """EGACA (upstream ``CrossmodalAtten_imgeventalladd``): the event
    branch's SE gate gates both branches; ``se_2`` is built, never used."""

    def __init__(self, c, cout):
        super().__init__()
        self.norm1, self.norm1_e, self.norm2 = LayerNorm2d(c), LayerNorm2d(c), LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, c, 1)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, groups=c)
        self.conv1_e = nn.Conv2d(c, c, 1)
        self.conv2_e = nn.Conv2d(c, c, 3, 1, 1, groups=c)
        self.se_1 = SELayer(c, c // 2)
        self.se_2 = SELayer(c, c // 2)
        self.conv3 = nn.Conv2d(2 * c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.conv4 = nn.Conv2d(c, 2 * c, 1)
        self.conv5 = nn.Conv2d(2 * c, cout, 1)
        self.gamma = nn.Parameter(torch.zeros(1, cout, 1, 1))
        self.conv_y_side = nn.Conv2d(c, cout, 1)

    def forward(self, ev, img):
        x = F.gelu(self.conv2(self.conv1(self.norm1(img))))
        x_e = F.gelu(self.conv2_e(self.conv1_e(self.norm1_e(ev))))
        gate = self.se_1(x_e)
        fused = self.conv3(torch.cat([x * gate, x_e * gate], 1))
        y = ev + img + fused * self.beta
        return self.conv_y_side(y) + self.conv5(F.gelu(self.conv4(self.norm2(y)))) * self.gamma


class EncoderStage(nn.Module):
    """[3x3 conv (leaky 0.2, twice) of x (+ y) | EGACA(x, y)] -> trunk of
    cat([x, state]) (the new state) -> [1x1 fuse with the backward state]
    -> 4x4/2 down.  ``conv`` is built where EGACA replaces it, as upstream."""

    def __init__(self, cin, cout, atten, fuse):
        super().__init__()
        self.conv = ConvLayer(cin, cout, 3, 1, 1)
        self.atten_fuse = CrossmodalAtten(cin, cout) if atten else None
        self.recurrent_block = nn.Module()
        self.recurrent_block.forward_trunk = ConvResidualBlocks(2 * cout, cout)
        self.fuse_two_dir = ConvLayer(2 * cout, cout, 1, 1, 0) if fuse else None
        self.down = nn.Conv2d(cout, cout, 4, 2, 1, bias=False)

    def forward(self, x, y, state, bwd=None):
        if y is not None and self.atten_fuse is not None:
            x = self.atten_fuse(x, y)
        else:
            x = F.leaky_relu(self.conv(x if y is None else x + y), 0.2)
        x = self.recurrent_block.forward_trunk(torch.cat([x, state], 1))
        state = x
        if bwd is not None:
            x = self.fuse_two_dir(torch.cat([x, bwd], 1))
        return self.down(x), state


class DecoderStage(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transposed_conv2d = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.forward_trunk = ConvResidualBlocks(2 * cout, cout)

    def forward(self, x, state):
        out = self.forward_trunk(torch.cat([self.transposed_conv2d(x), state], 1))
        return out, out


class ResidualBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))) + x)


class RefidNet(nn.Module):
    """``x (b, img_chn, h, w)``, ``event (b, t, ev_chn, h, w)`` adjacent
    voxel-bin pairs -> ``(b, t, 3, h, w)``."""

    def __init__(self, img_chn=26, ev_chn=2, num_encoders=3, base=32, num_residual_blocks=2,
                 atten_fuse_at=(1,)):
        super().__init__()
        ins = [base * 2 ** i for i in range(num_encoders)]
        outs = [base * 2 ** (i + 1) for i in range(num_encoders)]
        self.ne, self.outs = num_encoders, outs
        self.head = ConvLayer(ev_chn, base, 5, 1, 2)
        self.head_img = ConvLayer(img_chn, base, 5, 1, 2)
        self.img_encoders = nn.ModuleList(ImageEncoderBlock(ins[i], outs[i])
                                          for i in range(num_encoders))

        def stages(fuse):
            return nn.ModuleList(EncoderStage(ins[i], outs[i], i in atten_fuse_at and i != 0,
                                              fuse) for i in range(num_encoders))

        self.encoders_backward = stages(False)
        self.encoders_forward = stages(True)
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1])
                                       for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList(DecoderStage(outs[-i - 1], outs[-i - 1] // 2)
                                      for i in range(num_encoders))
        self.pred = ConvLayer(base, 3, 3, 1, 1, None)

    def _encode(self, stages, ev, y_of, states, bwd):
        e, blocks, new = self.head(ev), [], []
        for i, stage in enumerate(stages):
            e, s = stage(e, y_of[i], states[i], None if bwd is None else bwd[i])
            blocks.append(e)
            new.append(s)
        return blocks, new

    def forward(self, x, event):
        b, t, _, h, w = event.shape
        ne, outs = self.ne, self.outs
        head = self.head_img(x)
        x_blocks, cur = [], head
        for enc in self.img_encoders:
            cur = enc(cur)
            x_blocks.append(cur)
        y_of = [None] + x_blocks[:-1]
        zeros_enc = [x.new_zeros(b, outs[i], h >> i, w >> i) for i in range(ne)]
        dec = [x.new_zeros(b, outs[ne - i - 1] // 2, h >> (ne - i - 1), w >> (ne - i - 1))
               for i in range(ne)]
        bwd = zeros_enc
        for k in range(t - 1, -1, -1):
            _, bwd = self._encode(self.encoders_backward, event[:, k], y_of, bwd, None)
        fwd, frames = zeros_enc, []
        for k in range(t):
            blocks, fwd = self._encode(self.encoders_forward, event[:, k], y_of, fwd, bwd)
            e = blocks[-1]
            for i, block in enumerate(self.resblocks):
                e = block(e + x_blocks[-1] if i == 0 else e)
            new_dec = []
            for i, decoder in enumerate(self.decoders):
                e, s = decoder(e + blocks[ne - i - 1], dec[i])
                new_dec.append(s)
            dec = new_dec
            frames.append(self.pred(e + head))
        return torch.stack(frames, 1)


def refid_args(network_g: dict) -> dict:
    """:class:`RefidNet`'s arguments from an option file's ``network_g``."""
    return {"img_chn": network_g["img_chn"], "ev_chn": network_g["ev_chn"],
            "num_encoders": network_g["num_encoders"], "base": network_g["base_num_channels"],
            "num_residual_blocks": network_g["num_residual_blocks"]}


def blur_vfi_window(net: RefidNet, blur0, blur1, voxel, m: int = 11, n: int = 1):
    """One blurry-VFI request as the program serves it: ``blur0``, ``blur1``
    ``(h, w, 3)`` float tensors, ``voxel`` the ``(2m+n+1, h, w)`` grid; the
    two frames each followed by their intra-exposure bins make the
    26-channel input, adjacent bin pairs the events.  Returns
    ``(2m+n, h, w, 3)``."""
    f0, f1 = blur0.permute(2, 0, 1), blur1.permute(2, 0, 1)
    lq = torch.cat([f0, voxel[1:m], f1, voxel[m + 2 + n:]], 0)[None]
    pairs = torch.stack([voxel[:-1], voxel[1:]], 1)[None]
    return net(lq, pairs)[0].permute(0, 2, 3, 1)
