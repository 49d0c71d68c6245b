"""The counts kept with the benchmark: the conv FLOPs of the frozen
reference (hooks on the ``meta`` device) against hand counts, PERF.md's
54.04 TFLOP for a 720p t=23 window, and the int8 sites of each mode."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

from portbench.flops.count import conv_flops, evhinet_image_flops, refid_window_flops
from portbench.flops.int8_sites import int8_sites


def test_conv_flops_hand_count():
    with torch.device("meta"):
        net = nn.Sequential(nn.Conv2d(3, 8, 3, 1, 1), nn.Conv2d(8, 8, 3, 1, 1, groups=8),
                            nn.ConvTranspose2d(8, 4, 2, stride=2))
        x = torch.empty(2, 3, 10, 12)
    want = (2 * 2 * 8 * 10 * 12 * 3 * 9          # 3 -> 8, 3x3
            + 2 * 2 * 8 * 10 * 12 * 1 * 9        # depthwise
            + 2 * (2 * 8 * 10 * 12) * 4 * 4)     # transposed: each input pixel, 4 taps
    assert conv_flops(net, x) == want


def test_refid_toy_hand_count():
    # base 8, 3 encoders, 16 x 16, t = 1: every conv the forward runs, by hand
    h = w = 16
    px = [h * w >> (2 * i) for i in range(4)]          # pixels at scales 0..3

    def conv(cin, cout, k, p):
        return 2 * cin * cout * k * k * p

    head = 2 * conv(2, 8, 5, px[0]) + conv(26, 8, 5, px[0])   # the event head: both passes
    img = sum(conv(ci, co, 3, px[i]) + conv(co, co, 3, px[i]) + conv(ci, co, 1, px[i])
              + conv(co, co, 4, px[i + 1]) for i, (ci, co) in enumerate([(8, 16), (16, 32),
                                                                          (32, 64)]))

    def stage(i, ci, co, fuse):
        c = px[i]
        first = (conv(ci, ci, 1, c) * 2 + 2 * ci * 9 * c * 2 + conv(ci, ci // 2, 1, 1)
                 + conv(ci // 2, ci, 1, 1) + conv(2 * ci, ci, 1, c) + conv(ci, 2 * ci, 1, c)
                 + conv(2 * ci, co, 1, c) + conv(ci, co, 1, c)) if i == 1 else conv(ci, co, 3, c)
        trunk = conv(2 * co, co, 3, c) + 2 * conv(co, co, 3, c)
        return first + trunk + (conv(2 * co, co, 1, c) if fuse else 0) + conv(co, co, 4, px[i + 1])

    sizes = [(8, 16), (16, 32), (32, 64)]
    enc = sum(stage(i, ci, co, False) + stage(i, ci, co, True) for i, (ci, co) in enumerate(sizes))
    res = 2 * 2 * conv(64, 64, 3, px[3])
    dec = sum(2 * (ci * px[3 - i]) * (ci // 2) * 4 + conv(ci, ci // 2, 3, px[2 - i])
              + 2 * conv(ci // 2, ci // 2, 3, px[2 - i]) for i, ci in enumerate([64, 32, 16]))
    pred = conv(8, 3, 3, px[0])
    assert refid_window_flops(h, w, frames=1, base=8) == head + img + enc + res + dec + pred


def test_refid_720p_window_is_perf_md_count():
    assert refid_window_flops(720, 1280) / 1e12 == pytest.approx(54.04, abs=0.005)


def test_evhinet_scales_with_pixels():
    assert evhinet_image_flops(64, 64) * 4 == evhinet_image_flops(128, 128)


@pytest.mark.parametrize("mode,sites", [(True, 575), ("scale0", 713), ("static", 851)])
def test_int8_sites_per_window(mode, sites):
    n, ops, nbytes = int8_sites(mode, 64, 96)
    assert n == sites
    assert 0 < ops < refid_window_flops(64, 96) and nbytes > 0


def test_int8_site_bytes_and_ops_hand_count():
    # t = 1, scale 3 of a 64 x 64 frame: each bottleneck residual conv is a
    # 256 -> 256 3x3 site on 8 x 8 pixels
    n_true, ops_true, bytes_true = int8_sites(True, 64, 64, frames=1)
    n_base, ops_base, bytes_base = int8_sites(True, 64, 64, frames=1, base=32)
    assert (n_true, ops_true, bytes_true) == (n_base, ops_base, bytes_base)
    site_ops = 2 * 8 * 8 * 256 * 256 * 9
    site_bytes = 2 * 256 * 8 * 8 + 256 * 256 * 9 + 2 * 256 * 8 * 8
    assert ops_true > 4 * site_ops and bytes_true > 4 * site_bytes
