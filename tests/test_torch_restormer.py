"""Restormer in the port (``models/restormer.py``) against the benchmark's
plain PyTorch reference (``portbench/reference/restormer.py``; the JAX
package has no Restormer), on seeded weights with the temperatures redrawn
as ``portbench/drivers/restormer_serve.py`` draws them, at dim 8 and 32x48
in float32 and under bf16 autocast: the network and the single-image task's
served path, the softmax the redrawn temperatures sharpen, the parameter
counts at the published widths, torch's pixel-shuffle order, the loader,
the refusals of int8 and spatial plans, and the block spans and counter."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.drivers.efnet_serve import redraw
from portbench.drivers.restormer_serve import blocks_per_call
from portbench.harness import ROOT
from portbench.reference.restormer import RestormerRef
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models import arch_util
from refid_tpu_torch.models import restormer as restormer_module
from refid_tpu_torch.models.convert import load_state
from refid_tpu_torch.models.restormer import Restormer, Stage
from refid_tpu_torch.ops import prenorm
from refid_tpu_torch.tasks.base import build_task

SEED = 2 ** 33 + 25
SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 2), "num_refinement_blocks": 1}
NET = {"type": "Restormer", "inp_channels": 9, "out_channels": 3, "dim": 8,
       "num_blocks": [1, 1, 1, 2], "num_refinement_blocks": 1, "heads": [1, 2, 4, 8],
       "ffn_expansion_factor": 2.66, "bias": False, "LayerNorm_type": "WithBias",
       "dual_pixel_task": False}
PUBLISHED_DEPTHS = {"num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4}
H, W = 32, 48
WEIGHTS = json.loads((ROOT / "configs" / "restormer_dim48.json").read_text())["weights"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=SEED, **depths):
    with torch.device("meta"):
        meta = RestormerRef(**dict(SMALL, **depths))
    state = seeded_state(meta, seed, "cpu", WEIGHTS["gain"])
    return redraw(meta, state, seed, "cpu", WEIGHTS["gain"], WEIGHTS["temperature"])


def _request(seed=SEED):
    img, ev = generate.make({"kind": "deblur_image", "height": H, "width": W, "events": 800,
                             "t_span": 5e4, "pool": 1}, seed)[0]
    return img, ev, voxel_norm(voxel_grid(torch.from_numpy(ev), 6, W, H))


def _ref(state, **depths):
    net = RestormerRef(**dict(SMALL, **depths))
    net.load_state_dict(state)
    return net


def _port(state, **kw):
    net = ARCHS.get("Restormer")(dict(NET, **kw))
    load_state(net, state)
    return net


def _inputs(seed=SEED):
    img, _, vox = _request(seed)
    return torch.from_numpy(img).permute(2, 0, 1)[None], vox[None]


def test_restormer_matches_the_reference():
    state = _state()
    x, vox = _inputs()
    with torch.no_grad():
        got = _port(state)(x, vox)
        want = _ref(state)(x, vox)
    assert got.shape == want.shape == (1, 3, H, W)
    assert float((got - want).abs().max()) < 2e-4


def test_restormer_in_bf16_is_near_the_reference():
    # bf16 autocast (8 bits of mantissa) through 6 blocks of 1x1 and
    # depthwise convs, Gram products and gates: measured 0.17-0.27 % RMS on
    # five seeds; 3 % holds the rounding with room and fails a wrong
    # equation, which moves the answer by its own size
    state = _state()
    x, vox = _inputs()
    with torch.no_grad():
        got = _port(state, compute_dtype="bfloat16")(x, vox)
        want = _ref(state)(x, vox)
    assert got.dtype == torch.float32
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert 0 < rel < 0.03


def test_the_served_path_matches_the_reference():
    from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np

    state = _state()
    img, ev, vox = _request()
    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {}, "network_g": dict(NET)}, "cpu")
    load_state(task.net, state)
    voxel = voxel_norm_np(events_to_voxel_grid(ev, 6, W, H, "HWC", device="cpu"))
    got = task.single_image_inference(img, voxel, None)
    with torch.no_grad():
        want = _ref(state)(torch.from_numpy(img).permute(2, 0, 1)[None], vox[None])
    assert got.shape == (H, W, 3)
    assert float((got - want[0].permute(1, 2, 0)).abs().max()) < 2e-4


def _softmax_row_peaks(monkeypatch, state, seed):
    """Each MDTA's softmax rows' median largest entry over the uniform one."""
    peaks, core = [], restormer_module.channel_attention

    def recording(q, k, v, temperature, heads):
        b, c = q.shape[:2]
        q_hat = F.normalize(q.reshape(b, heads, c // heads, -1), dim=-1)
        k_hat = F.normalize(k.reshape(b, heads, c // heads, -1), dim=-1)
        p = torch.softmax(q_hat @ k_hat.transpose(-2, -1) * temperature, -1)
        peaks.append(float((p.max(-1).values * p.shape[-1]).median()))
        return core(q, k, v, temperature, heads)

    monkeypatch.setattr(restormer_module, "channel_attention", recording)
    with torch.no_grad():
        _port(state)(*_inputs(seed))
    monkeypatch.setattr(restormer_module, "channel_attention", core)
    return peaks


@pytest.mark.parametrize("seed", [1, 2, SEED])
def test_redrawn_temperatures_sharpen_the_softmax(monkeypatch, seed):
    with torch.device("meta"):
        meta = RestormerRef(**SMALL)
    seeded = seeded_state(meta, seed, "cpu", WEIGHTS["gain"])
    redrawn = _state(seed)
    changed = {k for k in seeded if not torch.equal(seeded[k], redrawn[k])}
    assert changed == {k for k in seeded if k.endswith("temperature")} and len(changed) == 9
    flat = _softmax_row_peaks(monkeypatch, seeded, seed)
    sharp = _softmax_row_peaks(monkeypatch, redrawn, seed)
    assert len(sharp) == 9
    assert all(p < 1.2 for p in flat)       # 0.1 N: nearly uniform
    assert all(p >= 2.0 for p in sharp)     # the typical row, 2x uniform or more


@pytest.mark.parametrize("channels, count", [(3, 26126644), (9, 26129236)])
def test_parameter_counts_at_the_published_widths(channels, count):
    with torch.device("meta"):
        net = ARCHS.get("Restormer")({"inp_channels": channels, "compute_dtype": "bfloat16"})
        ref = RestormerRef(inp_channels=channels)
    assert isinstance(net, Restormer) and net.dtype == torch.bfloat16
    assert sum(p.numel() for p in net.parameters()) == count
    assert sum(p.numel() for p in ref.parameters()) == count
    assert net.refinement[0].ffn.project_in.out_channels == 510       # 2 int(2.66 * 96)
    assert [b.attn.num_heads for b in (net.encoder_level1[0], net.encoder_level2[0],
                                       net.encoder_level3[0], net.latent[0])] == [1, 2, 4, 8]
    assert all(m.bias is None for m in net.modules() if isinstance(m, nn.Conv2d))


def test_upstream_names_round_trip():
    state = _state()
    net = _port(state)
    assert list(net.state_dict()) == list(state)
    assert all(torch.equal(net.state_dict()[k], v) for k, v in state.items())
    assert "encoder_level1.0.norm1.body.weight" in state
    assert "down1_2.body.0.weight" in state and "up2_1.body.0.weight" in state


def test_load_state_tells_restormer_from_other_checkpoints():
    from portbench.reference.efnet import EFNetRef

    with torch.device("meta"):
        efnet_state = EFNetRef(wf=16).state_dict()
    with pytest.raises(ValueError, match="no Restormer checkpoint"):
        load_state(ARCHS.get("Restormer")(dict(NET)), efnet_state)
    with pytest.raises(ValueError, match="a Restormer checkpoint"):
        load_state(ARCHS.get("EFNet")({"wf": 16}), _state())
    state = _state()
    state.pop("latent.1.ffn.dwconv.weight")
    with pytest.raises(KeyError, match="latent.1.ffn.dwconv"):
        load_state(ARCHS.get("Restormer")(dict(NET)), state)


class _JaxOrderUnshuffle(nn.Module):
    def forward(self, x):
        return arch_util.pixel_unshuffle(x, 2)


class _JaxOrderShuffle(nn.Module):
    def forward(self, x):
        return arch_util.pixel_shuffle(x, 2)


def test_sampling_uses_torchs_pixel_shuffle_order():
    state = _state()
    x, vox = _inputs()
    net = _port(state)
    assert isinstance(net.down1_2.body[1], nn.PixelUnshuffle)
    assert isinstance(net.up2_1.body[1], nn.PixelShuffle)
    with torch.no_grad():
        want = _ref(state)(x, vox)
        for name in ("down1_2", "down2_3", "down3_4"):
            getattr(net, name).body[1] = _JaxOrderUnshuffle()
        for name in ("up4_3", "up3_2", "up2_1"):
            getattr(net, name).body[1] = _JaxOrderShuffle()
        jax_order = net(x, vox)
    # the JAX helpers' channel order is another network
    assert float((jax_order - want).abs().max()) > 100 * 2e-4


def test_int8_and_spatial_plans_raise():
    opt = {"name": "t", "model_type": "TestImageEventRestorationModel", "is_train": False,
           "network_g": dict(NET)}
    with pytest.raises(ValueError, match="Restormer"):
        build_task(dict(opt, val={"int8": True}), "cpu")
    task = build_task(dict(opt, val={}), "cpu")
    with pytest.raises(ValueError, match="Restormer"):
        task.net(torch.zeros(1, 3, H, W), torch.zeros(1, 6, H, W), object())
    with pytest.raises(ValueError, match="Restormer"):
        task.net.row_block
    task.served.mesh = SimpleNamespace(spatial=2)
    img, _, vox = _request()
    with pytest.raises(ValueError, match="Restormer"):
        task.predict(img[None], vox.permute(1, 2, 0).numpy()[None])


def test_unpublished_settings_and_shapes_raise():
    for opt in ({"bias": True}, {"LayerNorm_type": "BiasFree"}, {"dual_pixel_task": True}):
        with pytest.raises(ValueError, match="motion-deblurring settings"):
            ARCHS.get("Restormer")(dict(NET, **opt))
    with pytest.raises(ValueError, match="four levels"):
        ARCHS.get("Restormer")(dict(NET, heads=[1, 2, 4]))
    net = ARCHS.get("Restormer")(dict(NET))
    with pytest.raises(ValueError, match="multiples of 8"):
        net(torch.zeros(1, 3, 36, 48), torch.zeros(1, 6, 36, 48))
    with pytest.raises(ValueError, match="fed an image of 3 and an event of 2"):
        net(torch.zeros(1, 3, H, W), torch.zeros(1, 2, H, W))


def test_each_block_is_a_span_and_counted():
    from torch.profiler import ProfilerActivity, profile

    opt = dict(NET, **PUBLISHED_DEPTHS)
    blocks = blocks_per_call(opt)
    assert blocks == 44
    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {}, "network_g": opt}, "cpu")
    load_state(task.net, _state(**PUBLISHED_DEPTHS))
    img, _, vox = _request()
    voxel = vox.permute(1, 2, 0).numpy()
    before = restormer_module.TRANSFORMER_BLOCKS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = task.predict_tensor(img[None], voxel[None])
    assert restormer_module.TRANSFORMER_BLOCKS - before == blocks
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.restormer.")), key=lambda s: (s[1], -s[2]))
    # each block: its attention half holding norm1, then norm2 (88 pre-norms
    # a forward); on the CPU no pre-norm runs on the card
    assert [s[0] for s in spans] == ["refid.restormer.block", "refid.restormer.mdta",
                                     "refid.restormer.norm", "refid.restormer.norm"] * blocks
    assert sum(s[0] == "refid.restormer.norm" for s in spans) == 88
    for block, mdta, norm1, norm2 in zip(*(spans[k::4] for k in range(4))):
        assert block[1] <= mdta[1] and mdta[2] <= block[2]
        assert mdta[1] <= norm1[1] and norm1[2] <= mdta[2]
        assert mdta[2] <= norm2[1] and norm2[2] <= block[2]
    network = [e for e in prof.events() if e.name == "refid.task.network"]
    assert len(network) == 1
    net_span = network[0].time_range
    assert all(net_span.start <= a and b <= net_span.end for _, a, b in spans)
    assert torch.equal(out, task.predict_tensor(img[None], voxel[None]))
    assert restormer_module.TRANSFORMER_BLOCKS - before == 2 * blocks


# ---- the pre-norm (ops/prenorm.py): the eager path off the card ----

STAGES = ("encoder_level1", "encoder_level2", "encoder_level3", "latent", "decoder_level3",
          "decoder_level2", "decoder_level1", "refinement")


def _unfused_norm(norm, x):
    return norm.body(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _unfused_stage(stage, x):
    for block in stage:
        x = x + block.attn(_unfused_norm(block.norm1, x))
        x = x + block.ffn(_unfused_norm(block.norm2, x))
    return x


def _unfused_forward(net, x, event):
    """The forward before the pre-norm took the residual adds: each block
    ``x + attn(norm1(x))``, then ``x + ffn(norm2(x))``, each norm
    ``nn.LayerNorm`` on a channels-last view, each stage an
    ``nn.Sequential``."""
    def run(x, event):
        enc1 = _unfused_stage(net.encoder_level1, net.patch_embed(torch.cat([x, event], 1)))
        enc2 = _unfused_stage(net.encoder_level2, net.down1_2(enc1))
        enc3 = _unfused_stage(net.encoder_level3, net.down2_3(enc2))
        latent = _unfused_stage(net.latent, net.down3_4(enc3))
        dec3 = _unfused_stage(net.decoder_level3, net.reduce_chan_level3(
            torch.cat([net.up4_3(latent), enc3], 1)))
        dec2 = _unfused_stage(net.decoder_level2, net.reduce_chan_level2(
            torch.cat([net.up3_2(dec3), enc2], 1)))
        dec1 = _unfused_stage(net.decoder_level1, torch.cat([net.up2_1(dec2), enc1], 1))
        return net.output(_unfused_stage(net.refinement, dec1)) + x

    if net.dtype != torch.bfloat16:
        return run(x, event)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        return run(x, event).float()


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_eager_path_is_the_unfused_forward_bit_for_bit(dtype, grad):
    """Off the card (and in float32 anywhere) the stages, blocks and norms
    run PyTorch's adds and ``nn.LayerNorm`` in the unfused forward's order:
    the same bits, and no launch."""
    net = _port(_state(), compute_dtype=dtype)
    x, vox = _inputs()
    before = prenorm.LAUNCHES
    with torch.set_grad_enabled(grad):
        got = net(x, vox)
        want = _unfused_forward(net, x, vox)
    assert prenorm.LAUNCHES == before
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_stages_keep_the_sequential_state_names():
    net = _port(_state())
    for name in STAGES:
        stage = getattr(net, name)
        assert isinstance(stage, Stage)
        assert list(stage.state_dict()) == list(nn.Sequential(*stage).state_dict())
    assert "encoder_level1.0.norm1.body.weight" in net.state_dict()
    assert "refinement.0.norm2.body.bias" in net.state_dict()


def test_the_rule_engages_only_a_bf16_cuda_stream_without_gradients():
    card = SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    with torch.no_grad():
        assert prenorm.engages(card)
        assert not prenorm.engages(SimpleNamespace(is_cuda=True, dtype=torch.float32))
        assert not prenorm.engages(torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16))
    with torch.enable_grad():
        assert not prenorm.engages(card)
    with torch.inference_mode():
        assert prenorm.engages(card)


def test_an_engaged_call_the_kernel_cannot_take_raises(monkeypatch):
    """Where the rule engages, the kernel runs or the call raises: a CPU
    stream (here) is not handed to PyTorch's ops unseen."""
    net = _port(_state(), compute_dtype="bfloat16")
    monkeypatch.setattr(prenorm, "engages", lambda x: True)
    with torch.no_grad(), pytest.raises(ValueError, match="pre-norm kernel takes"):
        net(*_inputs())
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pre-norm kernel takes"):
        prenorm.residual_add(x, x)


def test_the_plain_version_is_the_bf16_add_then_a_float32_norm():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 16, 5, 6, generator=gen).bfloat16()
    r = torch.randn(1, 16, 5, 6, generator=gen).bfloat16().contiguous(
        memory_format=torch.channels_last)
    w, b = torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    s, y = prenorm.prenorm_reference(x, r, w, b, 1e-5)
    assert torch.equal(s, x + r) and s.dtype == torch.bfloat16
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    norm = nn.LayerNorm(16, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        want = norm(s.float().permute(0, 2, 3, 1)).permute(0, 3, 1, 2).bfloat16()
    assert torch.equal(y, want)
    assert prenorm.prenorm_reference(x, None, w, b, 1e-5)[0] is x


@pytest.mark.parametrize("r_layout", ["none", "nchw", "channels_last"])
@pytest.mark.parametrize("x_layout", ["nchw", "channels_last"])
def test_the_plain_version_does_not_depend_on_the_layouts(x_layout, r_layout):
    """``s`` is the eager add in the stream's layout (the stream itself
    without a residual); ``y`` is channels_last and the float32 norm of a
    contiguous NHWC copy of ``s``, bit for bit, whatever the layouts."""
    def laid(t, layout):
        return t.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else t

    gen = torch.Generator().manual_seed(4)
    x = laid(torch.randn(2, 24, 5, 7, generator=gen).bfloat16(), x_layout)
    r = None if r_layout == "none" else laid(
        torch.randn(2, 24, 5, 7, generator=gen).bfloat16(), r_layout)
    w, b = 1 + 0.1 * torch.randn(24, generator=gen), 0.1 * torch.randn(24, generator=gen)
    s, y = prenorm.prenorm_reference(x, r, w, b, 1e-5)
    if r is None:
        assert s is x
    else:
        want = x + r
        assert s.stride() == want.stride() == x.stride() and torch.equal(s, want)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    flat = s.float().permute(0, 2, 3, 1).contiguous()
    assert torch.equal(y.permute(0, 2, 3, 1), F.layer_norm(flat, (24,), w, b, 1e-5).bfloat16())


@pytest.mark.parametrize("residual", ["none", "nchw", "channels_last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_block_takes_and_returns_a_stream_residual_pair(dtype, residual):
    """A block's input is the sum of the pair it takes and its output the
    sum of the pair it returns: off the card, ``x + attn(norm1(x))`` then
    ``+ ffn(norm2(.))`` on the sum, bit for bit, as the unfused block."""
    net = _port(_state(), compute_dtype=dtype)
    block = net.encoder_level2[0]
    gen = torch.Generator().manual_seed(5)
    cast = getattr(torch, dtype)
    x = torch.randn(1, 16, 6, 10, generator=gen).to(cast)
    r = None if residual == "none" else torch.randn(1, 16, 6, 10, generator=gen).to(cast)
    if residual == "channels_last":
        r = r.contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=dtype == "bfloat16"):
        stream, out = block((x, r))
        want = x if r is None else x + r
        want = want + block.attn(_unfused_norm(block.norm1, want))
        want = want + block.ffn(_unfused_norm(block.norm2, want))
    assert torch.equal(stream + out, want)

def _stand_in(calls):
    """The kernel's launch done by the plain version on the CPU."""
    def launch(x, residual, params, eps):
        calls.append("norm" if params is not None else "add")
        if params is None:
            return x + residual, None
        return prenorm.prenorm_reference(x, residual, *params, eps)
    return launch


def test_the_kernel_path_nests_its_spans_and_launches_96_times(monkeypatch):
    """At the published depths, with the rule engaged and the kernel's
    launch replaced by its plain version: 88 pre-norms, each
    ``refid.restormer.norm`` holding one ``refid.restormer.norm_card``, and
    8 stage ends through the add alone; the answer is the eager bf16
    network's within bf16 rounding (the plain norm takes a bf16 input where
    CPU autocast's LayerNorm may not)."""
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
    assert calls.count("norm") == 88 and calls.count("add") == 8
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.restormer.norm")), key=lambda s: (s[1], -s[2]))
    assert [s[0] for s in spans] == ["refid.restormer.norm", "refid.restormer.norm_card"] * 88
    for norm, card in zip(spans[::2], spans[1::2]):
        assert norm[1] <= card[1] and card[2] <= norm[2]
    rel = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    assert rel < 0.03
