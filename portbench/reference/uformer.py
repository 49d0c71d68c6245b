"""Plain PyTorch reference of Uformer-B (Wang et al., "Uformer: A General
U-Shaped Transformer for Image Restoration", CVPR 2022; upstream
github.com/ZhendongWang6/Uformer, ``model.py``: ``Uformer``,
``BasicUformerLayer``, ``LeWinTransformerBlock``, ``WindowAttention``,
``LinearProjection``, ``LeFF``, ``Downsample``, ``Upsample``,
``InputProj``, ``OutputProj``; the configuration is
``utils/model_utils.py::get_arch``'s ``'Uformer_B'``).  Module names are
upstream's, float32, activations as tokens ``(B, H W, C)``; it imports
nothing of the program.

``x`` is the photo ``(b, 3, H, W)``, ``e`` the normalised voxel ``(b,
dd_in - 3, H, W)``.  Read from the published ``model.py``:

* ``input_proj.proj``: a 3x3 conv ``dd_in -> C`` (C = ``embed_dim``, bias),
  then LeakyReLU (slope 0.01); its output flattened to tokens;
* encoder level i = 0-3: ``encoderlayer_i`` (a ``BasicUformerLayer`` at
  ``C 2^i`` channels), then ``dowsample_i.conv`` (a 4x4 conv, stride 2,
  padding 1, bias, ``C 2^i -> C 2^(i+1)``) of the tokens seen as an image;
* ``conv``, the bottleneck: a layer at ``16 C``;
* decoder level j = 0-3: ``upsample_j.deconv`` (a 2x2 transposed conv,
  stride 2, bias; 16C -> 8C, 16C -> 4C, 8C -> 2C, 4C -> C), then
  ``cat([up, skip], -1)``, then ``decoderlayer_j`` at 16C, 8C, 4C, 2C;
* ``output_proj.proj``: a 3x3 conv ``2C -> 3`` (bias), then ``+ x``;
* a layer's block i is shifted by ``win_size // 2`` where i is odd
  (``shift_flag``); decoder blocks hold a ``modulator``
  (``nn.Embedding(win_size^2, C)``) whose weight is added to every
  window's tokens before W-MSA;
* LeWinTransformerBlock: ``t = norm1(x)`` (``nn.LayerNorm``, eps 1e-5) seen
  as ``(B, H, W, C)``; ``roll(t, (-s, -s), (1, 2))`` where shifted;
  ``window_partition`` into ``(nW B, win^2, C)``; ``+ modulator.weight``;
  W-MSA; ``window_reverse``; ``roll(., (s, s))``; ``x = x + that``; then
  ``x = x + mlp(norm2(x))``;
* W-MSA (``attn``): ``q = qkv.to_q(t)``, ``k, v = qkv.to_kv(t)`` split as
  ``(N, 2, heads, d)`` (Linear ``C -> C`` and ``C -> 2C``, bias), ``A =
  softmax(q k^T d^-1/2 + B_rel + M)``, ``proj(A v)`` (Linear ``C -> C``);
  ``B_rel`` is ``relative_position_bias_table`` (``(2 win - 1)^2, heads``)
  gathered by Swin's ``relative_position_index``; ``M`` is 0 between two
  tokens of one region of the shifted frame and -100.0 across regions
  (Swin's three-by-three slices), present only in shifted blocks;
* LeFF (``mlp``): ``linear1`` (``C -> 4C``, then GELU), the tokens seen as
  a ``4C``-channel image through ``dwconv`` (3x3 depthwise, bias, then
  GELU), back to tokens through ``linear2`` (``4C -> C``).  GELU is exact.

Departures from the published file, each marked here:

* the input is the photo and the event voxel concatenated (``dd_in`` 9,
  which the published class takes as an argument); upstream's forward
  returns ``y`` alone when ``dd_in != 3``, here the photo's 3 channels are
  added as the published ``dd_in = 3`` model adds its input;
* the frame: upstream's blocks take a square (``H = int(sqrt(L))``), and its
  test scripts paste a photo into a zeroed square of a multiple of 128
  (``expand2square(..., factor=128)``: 1280x720 into 1280x1280).  Here H
  and W are passed on, and the forward pads the bottom and the right of the
  input with zeros to the next multiple of ``win_size * 16`` (every level
  whole windows: 1280x720 to 1280x768) and crops the answer back;
* upstream's block sets the shift to 0 where its construction-time
  ``img_size`` makes a level no wider than a window; at the published
  training size (256) no level is, and the shift is kept at every level
  here;
* ``relative_position_index`` is computed in the forward here (upstream
  saves it as a buffer in its state_dict); the seeded weights hold
  parameters only.

Upstream state_dict names, as read from ``model.py``: ``input_proj.proj.0.*``,
``output_proj.proj.0.*``, ``encoderlayer_{0..3}`` / ``conv`` /
``decoderlayer_{0..3}`` ``.blocks.k.`` ``modulator.weight`` (decoders),
``norm1.*``, ``attn.relative_position_bias_table``, ``attn.qkv.to_q.*``,
``attn.qkv.to_kv.*``, ``attn.proj.*``, ``norm2.*``, ``mlp.linear1.0.*``,
``mlp.dwconv.0.*``, ``mlp.linear2.0.*``; ``dowsample_{0..3}.conv.0.*``,
``upsample_{0..3}.deconv.0.*``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["UformerRef", "uformer_args", "window_partition", "window_reverse",
           "relative_position_index", "shift_region_mask"]


def window_partition(x, win):
    """``(B, H, W, C)`` -> ``(B nh nw, win, win, C)``, windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c)


def window_reverse(windows, win, h, w):
    """The inverse of :func:`window_partition`."""
    b = int(windows.shape[0] / (h * w / win / win))
    x = windows.view(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(win):
    """Swin's ``(win^2, win^2)`` index into the bias table."""
    coords = torch.stack(torch.meshgrid([torch.arange(win), torch.arange(win)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


def shift_region_mask(h, w, win, shift, device=None):
    """The shifted frame's ``(nW, win^2, win^2)`` mask, as upstream builds
    it in every forward: regions numbered by three-by-three slices, 0 within
    a region and -100.0 across."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = window_partition(img, win).view(-1, win * win)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(mask == 0, float(0.0))


class LinearProjection(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, dim * 2)

    def forward(self, x):
        b, n, c = x.shape
        q = self.to_q(x).reshape(b, n, 1, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        kv = self.to_kv(x).reshape(b, n, 2, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        return q[0], kv[0], kv[1]


class WindowAttention(nn.Module):
    def __init__(self, dim, win, heads):
        super().__init__()
        self.win, self.heads = win, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * win - 1) ** 2, heads))
        self.qkv = LinearProjection(dim, heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        q, k, v = self.qkv(x)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        index = relative_position_index(self.win).to(x.device)
        bias = self.relative_position_bias_table[index.view(-1)]
        bias = bias.view(n, n, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = torch.softmax(attn, -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))


class LeFF(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden), nn.GELU())
        self.dwconv = nn.Sequential(nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden), nn.GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x, h, w):
        b, hw, _ = x.shape
        x = self.linear1(x)
        x = x.transpose(1, 2).reshape(b, -1, h, w)          # b (h w) c -> b c h w
        x = self.dwconv(x)
        x = x.flatten(2).transpose(1, 2)                    # b c h w -> b (h w) c
        return self.linear2(x)


class LeWinTransformerBlock(nn.Module):
    def __init__(self, dim, heads, win, shift, mlp_ratio, modulator):
        super().__init__()
        self.win, self.shift = win, shift
        self.modulator = nn.Embedding(win * win, dim) if modulator else None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, win, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))

    def forward(self, x, h, w):
        b, _, c = x.shape
        mask = shift_region_mask(h, w, self.win, self.shift, x.device) if self.shift else None
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        if self.shift:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
        windows = window_partition(x, self.win).view(-1, self.win * self.win, c)
        if self.modulator is not None:
            windows = windows + self.modulator.weight
        windows = self.attn(windows, mask).view(-1, self.win, self.win, c)
        x = window_reverse(windows, self.win, h, w)
        if self.shift:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        x = shortcut + x.view(b, h * w, c)
        return x + self.mlp(self.norm2(x), h, w)


class BasicUformerLayer(nn.Module):
    def __init__(self, dim, depth, heads, win, mlp_ratio, shift_flag, modulator):
        super().__init__()
        self.blocks = nn.ModuleList([
            LeWinTransformerBlock(dim, heads, win, win // 2 if shift_flag and i % 2 else 0,
                                  mlp_ratio, modulator) for i in range(depth)])

    def forward(self, x, h, w):
        for block in self.blocks:
            x = block(x, h, w)
        return x


def _image(x, h, w):
    """Tokens ``(B, H W, C)`` as ``(B, C, H, W)``, as upstream's
    ``x.transpose(1, 2).contiguous().view(B, C, H, W)``."""
    b, _, c = x.shape
    return x.transpose(1, 2).contiguous().view(b, c, h, w)


def _tokens(x):
    """``(B, C, H, W)`` as tokens, as upstream's ``flatten(2).transpose(1, 2)``."""
    return x.flatten(2).transpose(1, 2).contiguous()


class InputProj(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1), nn.LeakyReLU(inplace=True))

    def forward(self, x):
        return _tokens(self.proj(x))


class OutputProj(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1))

    def forward(self, x, h, w):
        return self.proj(_image(x, h, w))


class Downsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 4, 2, 1))

    def forward(self, x, h, w):
        return _tokens(self.conv(_image(x, h, w)))


class Upsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.deconv = nn.Sequential(nn.ConvTranspose2d(cin, cout, 2, stride=2))

    def forward(self, x, h, w):
        return _tokens(self.deconv(_image(x, h, w)))


class UformerRef(nn.Module):
    """``x (b, 3, H, W)``, ``event (b, dd_in - 3, H, W)`` -> ``(b, 3, H, W)``."""

    def __init__(self, dd_in=9, embed_dim=32, depths=(1, 2, 8, 8, 2, 8, 8, 2, 1),
                 num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8, mlp_ratio=4.0,
                 modulator=True, shift_flag=True, in_chans=3):
        super().__init__()
        c, win = embed_dim, win_size
        self.win_size = win

        def layer(i, dim, mod):
            return BasicUformerLayer(dim, depths[i], num_heads[i], win, mlp_ratio, shift_flag,
                                     mod)

        self.input_proj = InputProj(dd_in, c)
        self.output_proj = OutputProj(2 * c, in_chans)
        self.encoderlayer_0 = layer(0, c, False)
        self.dowsample_0 = Downsample(c, 2 * c)
        self.encoderlayer_1 = layer(1, 2 * c, False)
        self.dowsample_1 = Downsample(2 * c, 4 * c)
        self.encoderlayer_2 = layer(2, 4 * c, False)
        self.dowsample_2 = Downsample(4 * c, 8 * c)
        self.encoderlayer_3 = layer(3, 8 * c, False)
        self.dowsample_3 = Downsample(8 * c, 16 * c)
        self.conv = layer(4, 16 * c, False)
        self.upsample_0 = Upsample(16 * c, 8 * c)
        self.decoderlayer_0 = layer(5, 16 * c, modulator)
        self.upsample_1 = Upsample(16 * c, 4 * c)
        self.decoderlayer_1 = layer(6, 8 * c, modulator)
        self.upsample_2 = Upsample(8 * c, 2 * c)
        self.decoderlayer_2 = layer(7, 4 * c, modulator)
        self.upsample_3 = Upsample(4 * c, c)
        self.decoderlayer_3 = layer(8, 2 * c, modulator)

    def forward(self, x, event):
        h, w = x.shape[-2:]
        m = self.win_size * 16
        hp, wp = -(-h // m) * m, -(-w // m) * m
        y = self.input_proj(F.pad(torch.cat([x, event], 1), (0, wp - w, 0, hp - h)))
        conv0 = self.encoderlayer_0(y, hp, wp)
        pool0 = self.dowsample_0(conv0, hp, wp)
        conv1 = self.encoderlayer_1(pool0, hp // 2, wp // 2)
        pool1 = self.dowsample_1(conv1, hp // 2, wp // 2)
        conv2 = self.encoderlayer_2(pool1, hp // 4, wp // 4)
        pool2 = self.dowsample_2(conv2, hp // 4, wp // 4)
        conv3 = self.encoderlayer_3(pool2, hp // 8, wp // 8)
        pool3 = self.dowsample_3(conv3, hp // 8, wp // 8)
        conv4 = self.conv(pool3, hp // 16, wp // 16)
        up0 = self.upsample_0(conv4, hp // 16, wp // 16)
        deconv0 = self.decoderlayer_0(torch.cat([up0, conv3], -1), hp // 8, wp // 8)
        up1 = self.upsample_1(deconv0, hp // 8, wp // 8)
        deconv1 = self.decoderlayer_1(torch.cat([up1, conv2], -1), hp // 4, wp // 4)
        up2 = self.upsample_2(deconv1, hp // 4, wp // 4)
        deconv2 = self.decoderlayer_2(torch.cat([up2, conv1], -1), hp // 2, wp // 2)
        up3 = self.upsample_3(deconv2, hp // 2, wp // 2)
        deconv3 = self.decoderlayer_3(torch.cat([up3, conv0], -1), hp, wp)
        return x + self.output_proj(deconv3, hp, wp)[:, :, :h, :w]


def uformer_args(network_g: dict) -> dict:
    """:class:`UformerRef`'s arguments from an option file's ``network_g``."""
    return {"dd_in": network_g["dd_in"], "embed_dim": network_g["embed_dim"],
            "depths": tuple(network_g["depths"]), "num_heads": tuple(network_g["num_heads"]),
            "win_size": network_g["win_size"], "mlp_ratio": network_g["mlp_ratio"],
            "modulator": network_g["modulator"], "shift_flag": network_g["shift_flag"]}
