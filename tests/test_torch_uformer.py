"""Uformer in the port (``models/uformer.py``) against the benchmark's plain
PyTorch reference (``portbench/reference/uformer.py``; the JAX package has
no Uformer), on seeded weights with the linears and bias tables redrawn as
``portbench/drivers/uformer_serve.py`` draws them, at a small preset
(embed_dim 16, 4x4 windows, two blocks a layer but the outermost) and
72x136, which pads to 128x192 so that padding, shifted windows and
modulators run at every level: the network in float32 and under bf16
autocast, the single-image task's served path, the window partition, the
shift mask, the relative index, the parameter counts at the published
widths, the loader, the refusals of int8 and spatial plans, the bias kept
per frame shape, the token layout of every conv, and the spans and
counters."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn

from portbench.drivers.uformer_serve import blocks_per_call, uformer_state
from portbench.harness import ROOT
from portbench.reference import uformer as ref_module
from portbench.reference.uformer import UformerRef, uformer_args
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models import arch_util
from refid_tpu_torch.models import uformer as uformer_module
from refid_tpu_torch.models.convert import load_state
from refid_tpu_torch.models.layers import ConvTranspose2d
from refid_tpu_torch.models.uformer import Uformer
from refid_tpu_torch.ops import prenorm
from refid_tpu_torch.parallel.spatial import HaloConv2d
from refid_tpu_torch.tasks.base import build_task

SEED = 2 ** 33 + 27
CONFIG = json.loads((ROOT / "configs" / "uformer_b.json").read_text())
NET = dict(CONFIG["network_g"], embed_dim=16, win_size=4, depths=[1, 2, 2, 2, 2, 2, 2, 2, 1],
           num_heads=[1, 2, 2, 4, 4, 4, 4, 2, 2])
PUBLISHED_DEPTHS = {"depths": CONFIG["network_g"]["depths"]}
H, W = 72, 136


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net_g(**kw):
    return dict(NET, **kw)


def _state(seed=SEED, **kw):
    return uformer_state({"network_g": _net_g(**kw), "weights": CONFIG["weights"]}, seed, "cpu")


def _request(seed=SEED):
    img, ev = generate.make({"kind": "deblur_image", "height": H, "width": W, "events": 3000,
                             "t_span": 5e4, "pool": 1}, seed)[0]
    return img, ev, voxel_norm(voxel_grid(torch.from_numpy(ev), 6, W, H))


def _inputs(seed=SEED):
    img, _, vox = _request(seed)
    return torch.from_numpy(img).permute(2, 0, 1)[None], vox[None]


def _ref(state, **kw):
    net = UformerRef(**uformer_args(_net_g(**kw)))
    net.load_state_dict(state)
    return net


def _port(state, **kw):
    net = ARCHS.get("Uformer")(_net_g(**kw))
    load_state(net, state)
    return net


def _rel(got, want):
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


def test_uformer_matches_the_reference():
    # float32 through 16 blocks: the port adds B_rel and M as one tensor
    # and folds the residual adds in another order; measured 4.8-6.0e-7 of
    # the answer's largest value on four seeds; 5e-6 holds that with room
    # and fails any wrong equation, which moves the answer by its own size
    state = _state()
    x, vox = _inputs()
    with torch.no_grad():
        got = _port(state)(x, vox)
        want = _ref(state)(x, vox)
    assert got.shape == want.shape == (1, 3, H, W)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-6


def test_uformer_in_bf16_is_near_the_reference():
    # bf16 autocast (8 bits of mantissa) through 16 blocks of token linears,
    # window products and depthwise convs: measured 0.31-0.38 % RMS of the
    # answer on four seeds; 3 % holds the rounding with room and fails a
    # wrong equation
    state = _state()
    x, vox = _inputs()
    with torch.no_grad():
        got = _port(state, compute_dtype="bfloat16")(x, vox)
        want = _ref(state)(x, vox)
    assert got.dtype == torch.float32
    assert 0 < _rel(got, want) < 0.03


def test_the_served_path_matches_the_reference():
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np

    state = _state()
    img, ev, vox = _request()
    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {}, "network_g": _net_g()}, "cpu")
    load_state(task.net, state)
    voxel = voxel_norm_np(events_to_voxel_grid(ev, 6, W, H, "HWC", device="cpu"))
    got = task.single_image_inference(img, voxel, None)
    with torch.no_grad():
        want = _ref(state)(torch.from_numpy(img).permute(2, 0, 1)[None], vox[None])
    assert got.shape == (H, W, 3)
    assert float((got - want[0].permute(1, 2, 0)).abs().max() / want.abs().max()) < 5e-6


def test_window_partition_round_trips():
    x = torch.randn(2, 8, 12, 5)
    windows = uformer_module.window_partition(x, 4)
    assert windows.shape == (2 * 2 * 3, 16, 5)
    assert torch.equal(windows, ref_module.window_partition(x, 4).view(-1, 16, 5))
    # window (b, i, j) holds rows 4i.. and columns 4j.., row-major
    assert torch.equal(windows[1 * 6 + 1 * 3 + 2].view(4, 4, 5), x[1, 4:8, 8:12])
    assert torch.equal(uformer_module.window_reverse(windows, 4, 8, 12), x)


def _regions_by_count(h, w, win, shift):
    """The shifted frame's region of each pixel, by explicit comparison:
    rows (and columns) below ``n - win``, then below ``n - shift``, then
    the rest, numbered row band * 3 + column band."""
    labels = torch.empty(h, w, dtype=torch.long)
    for i in range(h):
        for j in range(w):
            bi = 0 if i < h - win else (1 if i < h - shift else 2)
            bj = 0 if j < w - win else (1 if j < w - shift else 2)
            labels[i, j] = bi * 3 + bj
    return labels


@pytest.mark.parametrize("h,w,win,shift", [(8, 12, 4, 2), (16, 16, 8, 4), (24, 40, 8, 4)])
def test_the_shift_mask_is_minus_100_across_regions(h, w, win, shift):
    labels = _regions_by_count(h, w, win, shift)
    n = win * win
    want = torch.empty(h // win * (w // win), n, n)
    k = 0
    for wi in range(h // win):
        for wj in range(w // win):
            tile = labels[wi * win:(wi + 1) * win, wj * win:(wj + 1) * win].reshape(-1)
            want[k] = torch.where(tile[:, None] == tile[None, :], 0.0, -100.0)
            k += 1
    assert torch.equal(uformer_module.region_mask(h, w, win, shift), want)
    assert torch.equal(ref_module.shift_region_mask(h, w, win, shift)[..., :, :], want)
    assert len(labels.unique()) == 9
    # only the last row and column of windows straddle regions
    crossing = (want != 0).flatten(1).any(1).view(h // win, w // win)
    assert crossing[-1].all() and crossing[:, -1].all() and not crossing[:-1, :-1].any()


@pytest.mark.parametrize("win", [2, 4, 8])
def test_the_relative_index_is_the_offset_of_two_tokens(win):
    want = torch.empty(win * win, win * win, dtype=torch.long)
    for i in range(win * win):
        for j in range(win * win):
            dy, dx = i // win - j // win, i % win - j % win
            want[i, j] = (dy + win - 1) * (2 * win - 1) + dx + win - 1
    assert torch.equal(uformer_module.relative_position_index(win), want)
    assert torch.equal(ref_module.relative_position_index(win), want)


def test_window_attention_on_sdpa_is_the_explicit_product(monkeypatch):
    """The rule's SDPA call (here forced on the CPU in float32) and the
    explicit path compute one function: scale 1/sqrt(d), the additive bias
    broadcast over windows or per window."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(6, 2, 16, 8, generator=gen) for _ in range(3))
    for bias in (torch.randn(1, 2, 16, 16, generator=gen),
                 torch.randn(6, 2, 16, 16, generator=gen)):
        explicit = arch_util.window_attention(q, k, v, bias)
        want = torch.softmax(q @ k.transpose(-2, -1) / 8 ** 0.5 + bias, -1) @ v
        assert torch.allclose(explicit, want, atol=1e-6)
        monkeypatch.setattr(arch_util, "window_engages", lambda q: True)
        assert torch.allclose(arch_util.window_attention(q, k, v, bias), want, atol=1e-5)
        monkeypatch.setattr(arch_util, "window_engages", lambda q: False)


def test_the_rule_engages_only_a_bf16_cuda_query_without_gradients():
    card = SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    with torch.no_grad():
        assert arch_util.window_engages(card)
        assert not arch_util.window_engages(SimpleNamespace(is_cuda=True, dtype=torch.float32))
        assert not arch_util.window_engages(torch.zeros(1, dtype=torch.bfloat16))
    with torch.enable_grad():
        assert not arch_util.window_engages(card)


@pytest.mark.parametrize("dd_in, count", [(3, 50880946), (9, 50882674)])
def test_parameter_counts_at_the_published_widths(dd_in, count):
    with torch.device("meta"):
        net = ARCHS.get("Uformer")({"dd_in": dd_in, "compute_dtype": "bfloat16"})
        ref = UformerRef(dd_in=dd_in)
    assert isinstance(net, Uformer) and net.dtype == torch.bfloat16
    assert sum(p.numel() for p in net.parameters()) == count
    assert sum(p.numel() for p in ref.parameters()) == count
    blocks = [m for m in net.modules() if isinstance(m, uformer_module.LeWinTransformerBlock)]
    assert len(blocks) == 40
    assert sum(b.shift == 4 for b in blocks) == 19 and sum(b.shift == 0 for b in blocks) == 21
    assert sum(b.modulator is not None for b in blocks) == 19
    assert {b.attn.qkv.to_q.out_features // b.attn.heads for b in blocks} == {32}
    assert all(m.bias is not None for m in net.modules() if isinstance(m, (nn.Conv2d,
                                                                           nn.ConvTranspose2d)))


def test_upstream_names_round_trip_and_indices_are_checked():
    state = _state()
    net = _port(state)
    assert list(net.state_dict()) == list(state)
    assert all(torch.equal(net.state_dict()[k], v) for k, v in state.items())
    for name in ("input_proj.proj.0.weight", "dowsample_0.conv.0.bias",
                 "upsample_3.deconv.0.weight", "output_proj.proj.0.bias",
                 "encoderlayer_0.blocks.0.norm1.weight", "conv.blocks.1.norm2.bias",
                 "encoderlayer_2.blocks.1.attn.relative_position_bias_table",
                 "encoderlayer_2.blocks.1.attn.qkv.to_q.weight",
                 "encoderlayer_2.blocks.1.attn.qkv.to_kv.bias", "decoderlayer_1.blocks.0.attn.proj.weight",
                 "decoderlayer_3.blocks.0.mlp.linear1.0.weight",
                 "decoderlayer_3.blocks.0.mlp.dwconv.0.weight",
                 "decoderlayer_3.blocks.0.mlp.linear2.0.bias",
                 "decoderlayer_0.blocks.1.modulator.weight"):
        assert name in state
    assert not any(k.startswith("encoderlayer_") and "modulator" in k for k in state)
    # upstream saves each block's relative_position_index: checked, then dropped
    saved = dict(state)
    for name, _ in net.named_buffers():
        saved[name] = uformer_module.relative_position_index(4)
    load_state(net, saved)
    saved["conv.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="conv.blocks.0.attn.relative_position_index"):
        load_state(net, saved)


def test_load_state_tells_uformer_from_other_checkpoints():
    from portbench.reference.efnet import EFNetRef

    with torch.device("meta"):
        efnet_state = EFNetRef(wf=16).state_dict()
    with pytest.raises(ValueError, match="no Uformer checkpoint"):
        load_state(ARCHS.get("Uformer")(_net_g()), efnet_state)
    with pytest.raises(ValueError, match="a Uformer checkpoint"):
        load_state(ARCHS.get("EFNet")({"wf": 16}), _state())
    state = _state()
    state.pop("conv.blocks.1.mlp.dwconv.0.weight")
    with pytest.raises(KeyError, match="conv.blocks.1.mlp.dwconv"):
        load_state(ARCHS.get("Uformer")(_net_g()), state)


def test_int8_and_spatial_plans_raise():
    opt = {"name": "t", "model_type": "TestImageEventRestorationModel", "is_train": False,
           "network_g": _net_g()}
    with pytest.raises(ValueError, match="Uformer has no int8 path"):
        build_task(dict(opt, val={"int8": True}), "cpu")
    task = build_task(dict(opt, val={}), "cpu")
    with pytest.raises(ValueError, match="Uformer has no int8 path"):
        task.net(torch.zeros(1, 3, H, W), torch.zeros(1, 6, H, W), object())
    with pytest.raises(ValueError, match="Uformer cannot run under a spatial plan"):
        task.net.row_block
    task.served.mesh = SimpleNamespace(spatial=2)
    img, _, vox = _request()
    with pytest.raises(ValueError, match="Uformer cannot run under a spatial plan"):
        task.predict(img[None], vox.permute(1, 2, 0).numpy()[None])


def test_unpublished_settings_and_inputs_raise():
    for opt in ({"token_projection": "conv"}, {"token_mlp": "mlp"}, {"qkv_bias": False}):
        with pytest.raises(ValueError, match="published settings"):
            ARCHS.get("Uformer")(_net_g(**opt))
    with pytest.raises(ValueError, match="nine layers"):
        ARCHS.get("Uformer")(_net_g(depths=[1, 2, 2]))
    net = ARCHS.get("Uformer")(_net_g())
    with pytest.raises(ValueError, match="fed an image of 3 and an event of 2"):
        net(torch.zeros(1, 3, H, W), torch.zeros(1, 2, H, W))


def test_the_frame_is_padded_to_whole_windows_and_cropped():
    net = ARCHS.get("Uformer")(_net_g())
    assert net.padded(H, W) == (128, 192)
    assert ARCHS.get("Uformer")({}).padded(720, 1280) == (768, 1280)
    shapes = []
    net.encoderlayer_0.register_forward_pre_hook(lambda m, args: shapes.append(args[1:]))
    net.conv.register_forward_pre_hook(lambda m, args: shapes.append(args[1:]))
    load_state(net, _state())
    x, vox = _inputs()
    with torch.no_grad():
        out = net(x, vox)
    assert shapes == [(128, 192), (8, 12)] and out.shape == (1, 3, H, W)


def test_two_images_are_two_single_images():
    state = _state()
    net = _port(state)
    x1, v1 = _inputs(1)
    x2, v2 = _inputs(2)
    with torch.no_grad():
        both = net(torch.cat([x1, x2]), torch.cat([v1, v2]))
        one = torch.cat([net(x1, v1), net(x2, v2)])
    assert float((both - one).abs().max()) < 1e-5


def test_the_bias_is_built_once_per_frame_shape_and_again_after_a_load():
    state = _state()
    net = _port(state)
    x, vox = _inputs()
    blocks = blocks_per_call(_net_g())
    assert blocks == 16
    before = uformer_module.WINDOW_MASKS_BUILT
    with torch.no_grad():
        first = net(x, vox)
        assert uformer_module.WINDOW_MASKS_BUILT - before == blocks
        assert torch.equal(net(x, vox), first)
        assert uformer_module.WINDOW_MASKS_BUILT - before == blocks      # kept
        net(x[..., :64], vox[..., :64])                                  # pads to 128x128
        assert uformer_module.WINDOW_MASKS_BUILT - before == 2 * blocks
        other = _state(seed=3)
        load_state(net, other)                                            # tables change
        again = net(x, vox)
        assert uformer_module.WINDOW_MASKS_BUILT - before == 3 * blocks
        assert torch.equal(again, _port(other)(x, vox))
    bias = net.decoderlayer_1.blocks[1].attn.bias(128 // 4, 192 // 4, torch.float32)
    assert bias.shape == (8 * 12, 4, 16, 16)       # windows of the shifted 32x48 level, heads
    assert net.decoderlayer_1.blocks[0].attn.bias(32, 48, torch.float32).shape == (1, 4, 16, 16)


def test_convs_read_and_write_the_tokens_as_channels_last_views():
    """Every conv but ``input_proj`` takes the token stream as a
    channels_last view (no transposing copy), and every conv returns a
    channels_last image that the tokens view again."""
    net = _port(_state())
    seen = []

    def pre(module, args):
        seen.append(("in", module, args[0].is_contiguous(memory_format=torch.channels_last),
                     args[0]._base is not None))

    def post(module, args, out):
        seen.append(("out", module, out.is_contiguous(memory_format=torch.channels_last), True))

    convs = [m for m in net.modules() if isinstance(m, (HaloConv2d, ConvTranspose2d))]
    assert len(convs) == 10 + 16
    for m in convs:
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)
    with torch.no_grad():
        net(*_inputs())
    assert len(seen) == 2 * len(convs)
    assert all(laid for _, _, laid, _ in seen)
    assert all(view for kind, m, _, view in seen if kind == "in" and m is not
               net.input_proj.proj[0])


def test_each_block_is_a_span_and_counted():
    from torch.profiler import ProfilerActivity, profile

    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {}, "network_g": _net_g()}, "cpu")
    load_state(task.net, _state())
    img, _, vox = _request()
    voxel = vox.permute(1, 2, 0).numpy()
    blocks = blocks_per_call(_net_g())
    before = uformer_module.LEWIN_BLOCKS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        task.predict_tensor(img[None], voxel[None])
    assert uformer_module.LEWIN_BLOCKS - before == blocks
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.uformer.")), key=lambda s: (s[1], -s[2]))
    # each block: its attention half holding norm1, then norm2; on the CPU
    # no pre-norm runs on the card
    assert [s[0] for s in spans] == ["refid.uformer.block", "refid.uformer.wmsa",
                                     "refid.uformer.norm", "refid.uformer.norm"] * blocks
    for block, wmsa, norm1, norm2 in zip(*(spans[k::4] for k in range(4))):
        assert block[1] <= wmsa[1] and wmsa[2] <= block[2]
        assert wmsa[1] <= norm1[1] and norm1[2] <= wmsa[2]
        assert wmsa[2] <= norm2[1] and norm2[2] <= block[2]
    network = [e for e in prof.events() if e.name == "refid.task.network"]
    assert len(network) == 1
    net_span = network[0].time_range
    assert all(net_span.start <= a and b <= net_span.end for _, a, b in spans)


def _stand_in(calls):
    """The pre-norm kernel's launch done by its plain version on the CPU."""
    def launch(x, residual, params, eps):
        calls.append("norm" if params is not None else "add")
        if params is None:
            return x + residual, None
        return prenorm.prenorm_reference(x, residual, *params, eps)
    return launch


def test_the_kernel_path_runs_80_pre_norms_and_9_layer_ends(monkeypatch):
    """At the published depths (small widths), with the pre-norm rule
    engaged and the kernel's launch replaced by its plain version: 80
    pre-norms, each ``refid.uformer.norm`` holding one
    ``refid.uformer.norm_card``, and 9 layer ends through the add alone; the
    answer is the eager bf16 network's within bf16 rounding."""
    from torch.profiler import ProfilerActivity, profile

    state = _state(**PUBLISHED_DEPTHS)
    net = _port(state, compute_dtype="bfloat16", **PUBLISHED_DEPTHS)
    x, vox = _inputs()
    with torch.no_grad():
        want = net(x, vox)
    calls = []
    monkeypatch.setattr(prenorm, "engages", lambda x: x.dtype == torch.bfloat16
                        and not torch.is_grad_enabled())
    monkeypatch.setattr(prenorm, "_launch", _stand_in(calls))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        got = net(x, vox)
    assert calls.count("norm") == 80 and calls.count("add") == 9
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.uformer.norm")), key=lambda s: (s[1], -s[2]))
    assert [s[0] for s in spans] == ["refid.uformer.norm", "refid.uformer.norm_card"] * 80
    for norm, card in zip(spans[::2], spans[1::2]):
        assert norm[1] <= card[1] and card[2] <= norm[2]
    # the plain norm takes the bf16 stream where CPU autocast's LayerNorm
    # takes it in float32: a bf16 step of each norm's output, through 40 blocks
    assert _rel(got, want) < 0.03


def test_the_eager_layer_adds_each_leff_output_in_turn():
    """Off the card a layer's blocks, handing each LeFF output on as the
    next block's residual, are the unfused blocks ``x + W-MSA(norm1(x))``
    then ``+ LeFF(norm2(.))`` bit for bit."""
    net = _port(_state())
    layer = net.encoderlayer_2
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(1, 32 * 48, 64, generator=gen)
    with torch.no_grad():
        got = layer(x, 32, 48)
        want = x
        for block in layer.blocks:
            want = want + block._wmsa(block.norm1(want), 32, 48)
            want = want + block.mlp(block.norm2(want), 32, 48)
    assert torch.equal(got, want)


def test_the_modulator_reaches_q_k_and_v():
    """A decoder block's modulator is added to each window's tokens before
    W-MSA: zeroing it moves the answer; the encoders hold none."""
    state = _state()
    x, vox = _inputs()
    with torch.no_grad():
        base = _port(state)(x, vox)
        zeroed = {k: (torch.zeros_like(v) if "modulator" in k else v) for k, v in state.items()}
        moved = _port(zeroed)(x, vox)
        want = _ref(zeroed)(x, vox)
    assert _rel(moved, base) > 1e-3
    assert float((moved - want).abs().max() / want.abs().max()) < 5e-6


# ---- on the card (the ``gpu`` marker: PN and SDPA's kernels have no CPU
# mode, so these skip without a CUDA device; on the GPU machine:
# ``python -m pytest tests/test_torch_uformer.py -m gpu --noconftest``) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# PN at Uformer's widths, the stream and the residual both tokens
# (channels_last): full resolution at 32 and 64 channels, the bottleneck
UFORMER_PN_SHAPES = [(1, 32, 768, 1280), (1, 64, 768, 1280), (1, 512, 48, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["none", "cl", "add"])
@pytest.mark.parametrize("shape", UFORMER_PN_SHAPES, ids=["32x768p", "64x768p", "512x48p"])
def test_the_pre_norm_kernel_at_uformers_widths(cuda, shape, mode, record_property):
    """``tests/test_torch_prenorm.py``'s check (``s`` the eager add bit for
    bit, ``y`` within one bf16 step of ``prenorm_reference``)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "prenorm_cases", Path(__file__).with_name("test_torch_prenorm.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    x = cases._bf16(shape, 11, cuda, "cl", scale=2.0, shift=0.5)
    r = None if mode == "none" else cases._bf16(shape, 12, cuda, "cl")
    cases._check(x, r, mode, *cases._params(shape[1], cuda, 9), record_property)


def _card_task(cuda, seed=27):
    import numpy as np

    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {},
                       "network_g": dict(CONFIG["network_g"], compute_dtype="bfloat16")}, cuda)
    load_state(task.net, uformer_state(CONFIG, seed, cuda))
    rng = np.random.RandomState(seed)
    img = rng.rand(1, 720, 1280, 3).astype(np.float32)
    voxel = rng.randn(1, 720, 1280, 6).astype(np.float32)
    return task, img, voxel


@pytest.mark.gpu
def test_a_720p_task_call_on_the_card(cuda, monkeypatch):
    """The benchmark's Uformer-B (published widths, seeded weights) on one
    720p image through the task: 40 LeWin blocks, 89 pre-norm launches (80
    norms, 9 layer ends), 40 biases built on the first call and none on the
    next, no transposing conv-layout kernel, and an answer within 2 % RMS of
    the network's part (the answer less the photo) of the eager path, where
    PN and SDPA are off (both round at the same points from float32
    statistics and accumulators)."""
    from torch.profiler import ProfilerActivity, profile

    task, img, voxel = _card_task(cuda)
    blocks, masks, launches = (uformer_module.LEWIN_BLOCKS, uformer_module.WINDOW_MASKS_BUILT,
                               prenorm.LAUNCHES)
    got = task.predict_tensor(img, voxel)
    assert uformer_module.LEWIN_BLOCKS - blocks == 40
    assert prenorm.LAUNCHES - launches == 89
    assert uformer_module.WINDOW_MASKS_BUILT - masks == 40
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = task.predict_tensor(img, voxel)
        torch.cuda.synchronize()
    assert uformer_module.WINDOW_MASKS_BUILT - masks == 40
    names = {e.key for e in prof.key_averages()}
    assert not any("nchwToNhwc" in n or "nhwcToNchw" in n for n in names), sorted(names)
    assert float((again - got).abs().max()) < 1e-3
    with monkeypatch.context() as m:
        m.setattr(prenorm, "engages", lambda x: False)
        m.setattr(arch_util, "window_engages", lambda q: False)
        want = task.predict_tensor(img, voxel)
    assert prenorm.LAUNCHES - launches == 2 * 89
    network = want - torch.from_numpy(img).to(cuda)
    rel = float((got - want).square().mean().sqrt() / network.square().mean().sqrt())
    assert rel < 0.02, rel
