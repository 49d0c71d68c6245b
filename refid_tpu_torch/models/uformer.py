"""Uformer, a U-shaped transformer of shifted-window self-attention for
image restoration (Wang et al., CVPR 2022; upstream ``model.py``, class
``Uformer``), served through the single-image task as ``network_g.type:
Uformer``, with the photo and the event voxel concatenated at its input.

The JAX package has no Uformer: this network is held to the benchmark's
plain reference ``portbench/reference/uformer.py``
(``tests/test_torch_uformer.py``), whose docstring gives the equations, the
state_dict names and where they depart from the published file.  In short,
a five-level U-Net of LeWin blocks at widths ``embed_dim * 2**i``:

* ``input_proj`` (3x3 conv, leaky ReLU 0.01) of ``cat([x, event])``, the
  frame zero-padded at the bottom and the right to whole windows at every
  level (a multiple of ``win_size * 16``; 1280x720 to 1280x768), the answer
  cropped back and the photo added;
* four encoder layers, each followed by ``dowsample_i`` (4x4 conv, stride
  2), the bottleneck ``conv``, and four decoder layers, each fed
  ``cat([upsample_j(y), skip], -1)`` (2x2 transposed conv, stride 2), then
  ``output_proj`` (3x3 conv);
* each :class:`LeWinTransformerBlock` is ``x + W-MSA(norm1(x))``, then ``x
  + LeFF(norm2(x))``; odd blocks of a layer shift the frame by ``win_size
  // 2``; decoder blocks add their ``modulator`` to every window's tokens.

Layout.  The stream is tokens ``(B, H W, C)``, which is an NHWC image: the
convs (``input_proj``, the down and transposed convs, LeFF's depthwise
conv, ``output_proj``) take and return it as a channels_last
``(B, C, H, W)`` view, with no transposing copy.  Every conv is the port's
conv layer (``HaloConv2d``, ``layers.ConvTranspose2d``), which finishes a
biased conv with the conv epilogue on the card.

Pre-norms.  As Restormer's stages do, a :class:`BasicUformerLayer` hands
each block's LeFF output on, not yet added, as the next block's residual,
and ``arch_util.pre_norm`` takes the add in front of each of the 80 norms:
on a bf16 CUDA stream with gradients off one launch of the pre-norm kernel
(``ops/prenorm.py``), else PyTorch's add and ``nn.LayerNorm``.  A layer's
last LeFF output is added by ``prenorm.residual_add``.

Window attention.  ``arch_util.window_attention`` with one additive bias a
block: ``B_rel`` (the relative position bias gathered from its table) and,
in shifted blocks, the region mask ``M`` (0 within a region, -100.0
across).  Where ``arch_util.window_engages`` holds it is one
``F.scaled_dot_product_attention`` call with the bias in bf16; elsewhere
the explicit products in float32.  The bias is built on the device once
per block, frame shape and dtype, kept, and built again when the table
changes (weights loaded, another device); ``WINDOW_MASKS_BUILT`` counts the
builds.  No call of the served path copies a mask from the host.

Spans and counters: each block runs inside ``refid.uformer.block``, its
attention half (norm1, shift, partition, attention, reverse) inside
``refid.uformer.wmsa``, each pre-norm inside ``refid.uformer.norm`` (and,
on the kernel, ``refid.uformer.norm_card``); ``LEWIN_BLOCKS`` counts the
blocks run (40 a forward at the published depths).  ``dtype=torch.bfloat16``
runs under bf16 autocast with float32 parameters and returns float32.

Neither int8 serving nor spatial sharding applies: the cyclic shift wraps
around the whole frame, and no int8 replay of the network exists.
``val.int8``, an int8 state and a spatial plan raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.models import arch_util
from refid_tpu_torch.models.arch_util import pre_norm, window_attention
from refid_tpu_torch.models.layers import ConvTranspose2d
from refid_tpu_torch.ops import prenorm
from refid_tpu_torch.parallel import spatial
from refid_tpu_torch.parallel.spatial import HaloConv2d

__all__ = ["Uformer", "LeWinTransformerBlock", "BasicUformerLayer", "LEWIN_BLOCKS",
           "WINDOW_MASKS_BUILT", "window_partition", "window_reverse", "relative_position_index",
           "region_mask"]

LEWIN_BLOCKS = 0            # LeWin blocks run, over the process's life
WINDOW_MASKS_BUILT = 0      # window-attention biases built, over the process's life

LEAKY_SLOPE = 0.01          # nn.LeakyReLU's default, upstream's InputProj
_NORM_SPANS = ("refid.uformer.norm", "refid.uformer.norm_card")
_NO_INT8 = ("Uformer has no int8 path: no int8 replay of the network exists, and the "
            "cyclic shift wraps around the whole frame")
_NO_SPATIAL = ("Uformer cannot run under a spatial plan: its shifted windows wrap "
               "around the whole frame")


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B nh nw, win * win, C)``, windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(windows: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    """``(B nh nw, win * win, C)`` -> ``(B, H, W, C)``, the inverse of
    :func:`window_partition`."""
    c = windows.shape[-1]
    x = windows.view(-1, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def relative_position_index(win: int, device=None) -> torch.Tensor:
    """``(win^2, win^2)``: for tokens ``i``, ``j`` of a window, the row of
    the bias table for their offset, ``(dy + win - 1) (2 win - 1) + dx +
    win - 1`` with ``(dy, dx)`` the position of ``i`` less that of ``j``."""
    y, x = torch.meshgrid(torch.arange(win, device=device), torch.arange(win, device=device),
                          indexing="ij")
    y, x = y.flatten(), x.flatten()
    return (y[:, None] - y[None, :] + win - 1) * (2 * win - 1) + x[:, None] - x[None, :] + win - 1


def region_mask(h: int, w: int, win: int, shift: int, device=None) -> torch.Tensor:
    """The shifted frame's ``(nW, win^2, win^2)`` float32 mask, built on
    ``device``: the frame split by rows and columns at ``-win`` and
    ``-shift`` into nine regions, 0 between tokens of one region and -100.0
    across."""
    def bands(n):
        idx = torch.arange(n, device=device)
        return (idx >= n - win).long() + (idx >= n - shift).long()

    labels = bands(h)[:, None] * 3 + bands(w)[None, :]
    windows = window_partition(labels[None, :, :, None], win)[..., 0]
    same = windows[:, :, None] == windows[:, None, :]
    return torch.where(same, 0.0, -100.0).float()


def _image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tokens ``(B, H W, C)`` as a channels_last ``(B, C, H, W)`` view."""
    return x.view(x.shape[0], h, w, x.shape[2]).permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W)`` as tokens ``(B, H W, C)``: a view of a channels_last
    image (a copy of any other)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class LinearProjection(nn.Module):
    """Upstream's ``LinearProjection``: ``to_q`` and ``to_kv``, split into
    heads ``(windows, head, n, d)`` as views."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, dim * 2)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.heads
        q = self.to_q(x).view(b, n, self.heads, d).transpose(1, 2)
        kv = self.to_kv(x).view(b, n, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        return q, kv[0], kv[1]


class WindowAttention(nn.Module):
    """W-MSA over the windows of one block (upstream's ``WindowAttention``
    with ``token_projection='linear'``); ``shift`` is the block's, for the
    region mask."""

    def __init__(self, dim: int, win: int, heads: int, shift: int):
        super().__init__()
        self.win, self.heads, self.shift = win, heads, shift
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * win - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(win),
                             persistent=False)
        self.qkv = LinearProjection(dim, heads)
        self.proj = nn.Linear(dim, dim)
        self._bias = {}     # (h, w, dtype, device) -> (the table's stamp, the bias)

    def bias(self, h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
        """``B_rel`` ``(1, head, n, n)``, plus ``M`` ``(nW, 1, n, n)`` in a
        shifted block, in ``dtype``: kept per frame shape while the table
        is the same tensor at the same version (built anew each call where
        the table takes gradients)."""
        global WINDOW_MASKS_BUILT
        table = self.relative_position_bias_table
        key = (h, w, dtype, table.device)
        stamp = (table.data_ptr(), table._version)
        kept = self._bias.get(key)
        if kept is not None and kept[0] == stamp and not (torch.is_grad_enabled()
                                                          and table.requires_grad):
            return kept[1]
        n = self.win * self.win
        bias = table[self.relative_position_index.view(-1)].view(n, n, -1).permute(2, 0, 1)[None]
        if self.shift:
            bias = bias + region_mask(h, w, self.win, self.shift, table.device)[:, None]
        bias = bias.to(dtype).contiguous()
        WINDOW_MASKS_BUILT += 1
        if not (torch.is_grad_enabled() and table.requires_grad):
            self._bias[key] = (stamp, bias)
        return bias

    def forward(self, x, h: int, w: int):
        """``x`` ``(B nW, n, C)``, the windows of a ``h`` x ``w`` frame."""
        b_, n, c = x.shape
        q, k, v = self.qkv(x)
        bias = self.bias(h, w, q.dtype if arch_util.window_engages(q) else torch.float32)
        if self.shift and b_ > bias.shape[0]:       # more than one image
            bias = bias.repeat(b_ // bias.shape[0], 1, 1, 1)
        out = window_attention(q, k, v, bias)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class LeFF(nn.Module):
    """Locally-enhanced feed-forward: ``linear1`` and GELU, a 3x3 depthwise
    conv and GELU on the tokens seen as a channels_last image, ``linear2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden), nn.GELU())
        self.dwconv = nn.Sequential(HaloConv2d(hidden, hidden, 3, 1, 1, groups=hidden),
                                    nn.GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x, h: int, w: int):
        x = self.dwconv[1](self.dwconv[0](_image(self.linear1(x), h, w)))
        return self.linear2(_tokens(x))


class LeWinTransformerBlock(nn.Module):
    """``forward(pair, h, w)``: ``pair`` is ``(stream, residual)`` tokens,
    whose sum is the block's input (``residual`` None: the stream alone);
    returns ``(stream after the attention residual, LeFF output)``, whose
    sum is the block's output."""

    def __init__(self, dim: int, heads: int, win: int, shift: int, mlp_ratio: float,
                 modulator: bool):
        super().__init__()
        self.win, self.shift = win, shift
        self.modulator = nn.Embedding(win * win, dim) if modulator else None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, win, heads, shift)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = LeFF(dim, int(dim * mlp_ratio))

    def _wmsa(self, t, h: int, w: int):
        b, _, c = t.shape
        t = t.view(b, h, w, c)
        if self.shift:
            t = torch.roll(t, (-self.shift, -self.shift), (1, 2))
        windows = window_partition(t, self.win)
        if self.modulator is not None:
            windows = windows + self.modulator.weight.to(windows.dtype)
        t = window_reverse(self.attn(windows, h, w), self.win, h, w)
        if self.shift:
            t = torch.roll(t, (self.shift, self.shift), (1, 2))
        return t.reshape(b, h * w, c)

    def forward(self, pair, h: int, w: int):
        global LEWIN_BLOCKS
        x, residual = pair
        with span("refid.uformer.block"):
            with span("refid.uformer.wmsa"):
                x, t = _norm(self.norm1, x, residual, h, w)
                residual = self._wmsa(t, h, w)
            x, t = _norm(self.norm2, x, residual, h, w)
            residual = self.mlp(t, h, w)
        LEWIN_BLOCKS += 1
        return x, residual


def _norm(norm: nn.LayerNorm, x, residual, h: int, w: int):
    """``arch_util.pre_norm`` on tokens: ``(x + residual, its norm)``."""
    s, y = pre_norm(_image(x, h, w), None if residual is None else _image(residual, h, w),
                    norm, _NORM_SPANS)
    return _tokens(s), _tokens(y)


class BasicUformerLayer(nn.Module):
    """LeWin blocks in turn (upstream's ``blocks`` list, its state names
    kept), odd ones shifted where ``shift_flag``: each block's LeFF output
    goes on as the next block's residual, the last one added by
    ``prenorm.residual_add``."""

    def __init__(self, dim: int, depth: int, heads: int, win: int, mlp_ratio: float,
                 shift_flag: bool, modulator: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            LeWinTransformerBlock(dim, heads, win, win // 2 if shift_flag and i % 2 else 0,
                                  mlp_ratio, modulator) for i in range(depth)])

    def forward(self, x, h: int, w: int):
        pair = (x, None)
        for block in self.blocks:
            pair = block(pair, h, w)
        x, residual = pair          # residual None: no block added to the stream
        if residual is None:
            return x
        return _tokens(prenorm.residual_add(_image(x, h, w), _image(residual, h, w)))


class InputProj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(HaloConv2d(cin, cout, 3, 1, 1))

    def forward(self, x):
        return _tokens(self.proj[0](x, LEAKY_SLOPE))


class OutputProj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Sequential(HaloConv2d(cin, cout, 3, 1, 1))

    def forward(self, x, h: int, w: int):
        return self.proj[0](_image(x, h, w))


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(HaloConv2d(cin, cout, 4, 2, 1))

    def forward(self, x, h: int, w: int):
        return _tokens(self.conv[0](_image(x, h, w)))


class Upsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = nn.Sequential(ConvTranspose2d(cin, cout, 2, stride=2))

    def forward(self, x, h: int, w: int):
        return _tokens(self.deconv[0](_image(x, h, w)))


class Uformer(nn.Module):
    """``x`` ``(b, 3, h, w)`` and ``event`` ``(b, dd_in - 3, h, w)`` ->
    ``(b, 3, h, w)``, any ``h`` and ``w``."""

    def __init__(self, dd_in: int = 9, embed_dim: int = 32,
                 depths: Sequence[int] = (1, 2, 8, 8, 2, 8, 8, 2, 1),
                 num_heads: Sequence[int] = (1, 2, 4, 8, 16, 16, 8, 4, 2), win_size: int = 8,
                 mlp_ratio: float = 4.0, modulator: bool = True, shift_flag: bool = True,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 qkv_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: only float32 and bfloat16")
        if len(depths) != 9 or len(num_heads) != 9:
            raise ValueError(f"Uformer needs nine layers: depths {list(depths)}, "
                             f"num_heads {list(num_heads)}")
        if token_projection != "linear" or token_mlp != "leff" or not qkv_bias:
            raise ValueError("Uformer is ported with token_projection: linear, token_mlp: leff "
                             "and qkv_bias: true (the published settings) only")
        self.dd_in, self.win_size, self.dtype = dd_in, win_size, dtype
        c = embed_dim

        def layer(i, dim, mod):
            return BasicUformerLayer(dim, depths[i], num_heads[i], win_size, mlp_ratio,
                                     shift_flag, mod)

        self.input_proj = InputProj(dd_in, c)
        self.output_proj = OutputProj(2 * c, 3)
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

    @property
    def row_block(self) -> int:
        raise ValueError(_NO_SPATIAL)

    def task_int8_mode(self, int8) -> bool:
        if int8:
            raise ValueError(f"val.int8: {_NO_INT8}")
        return False

    def padded(self, h: int, w: int):
        """The frame the layers run on: ``h`` x ``w`` rounded up to whole
        windows at the bottleneck (``win_size * 16``)."""
        m = self.win_size * 16
        return -(-h // m) * m, -(-w // m) * m

    def forward(self, x, event, q=None):
        if q is not None:
            raise ValueError(_NO_INT8)
        if spatial.active() is not None:
            raise ValueError(_NO_SPATIAL)
        if x.shape[1] != 3 or x.shape[1] + event.shape[1] != self.dd_in:
            raise ValueError(f"Uformer(dd_in {self.dd_in}) fed an image of {x.shape[1]} and "
                             f"an event of {event.shape[1]} channels")
        if self.dtype != torch.bfloat16:
            return self._forward(x, event)
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = self._forward(x, event)
        return out.float()

    def _forward(self, x, event):
        h, w = x.shape[-2:]
        hp, wp = self.padded(h, w)
        inp = F.pad(torch.cat([x, event], 1), (0, wp - w, 0, hp - h))
        y = self.input_proj(inp.contiguous(memory_format=torch.channels_last))
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
        return self.output_proj(deconv3, hp, wp)[:, :, :h, :w] + x
