"""EFNet in the port (``models/efnet.py``) against the benchmark's plain
PyTorch reference (``portbench/reference/efnet.py``; the JAX package has no
EFNet), on seeded weights at wf 16 and 32x48 in float32: the network and
the single-image task's served path, EICA's LayerNorm form, the weights'
temperatures, the EICA counter, the registry and loader, the refusals of
int8 and spatial plans, EVHINet unchanged by the blocks EFNet shares, and
EICA's attention unchanged by the channel-attention core Restormer shares."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn

from portbench.drivers.efnet_serve import redraw
from portbench.reference.efnet import EICA as EICARef
from portbench.reference.efnet import EFNetRef
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.models import efnet as efnet_module
from refid_tpu_torch.models import evhinet as evhinet_module
from refid_tpu_torch.models.arch_util import (EventImageChannelAttentionTransformerBlock,
                                              MutualAttention)
from refid_tpu_torch.models.convert import load_state
from refid_tpu_torch.models.efnet import EFNet
from refid_tpu_torch.tasks.base import build_task

SEED = 2 ** 33 + 21
NET = {"type": "EFNet", "in_chn": 3, "ev_chn": 6, "wf": 16, "depth": 3, "num_heads": [1, 2, 4],
       "ffn_expansion_factor": 4, "fuse_before_downsample": True, "relu_slope": 0.2}
H, W = 32, 48


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=SEED, temperature=5.0):
    with torch.device("meta"):
        meta = EFNetRef(wf=16)
    return redraw(meta, seeded_state(meta, seed, "cpu"), seed, "cpu", 1.0, temperature)


def _request(seed=SEED):
    img, ev = generate.make({"kind": "deblur_image", "height": H, "width": W, "events": 800,
                             "t_span": 5e4, "pool": 1}, seed)[0]
    return img, ev, voxel_norm(voxel_grid(torch.from_numpy(ev), 6, W, H))


def _ref(state):
    net = EFNetRef(wf=16)
    net.load_state_dict(state)
    return net


def _port(state, **kw):
    net = ARCHS.get("EFNet")(dict(NET, **kw))
    load_state(net, state)
    return net


def test_efnet_matches_the_reference():
    state = _state()
    img, _, vox = _request()
    mask = (vox != 0).any(0).float().mean()
    assert 0.2 < float(mask) < 0.8                  # the mask holds both regions
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    with torch.no_grad():
        got = _port(state)(x, vox[None])
        want = _ref(state)(x, vox[None])
    assert got.shape == want.shape == (1, 3, H, W)
    assert float((got - want).abs().max()) < 2e-4


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
    assert float((got - want[0].permute(1, 2, 0)).abs().max()) < 2e-4


def test_eica_layer_norm_is_the_published_form():
    gen = torch.Generator().manual_seed(3)
    block = EventImageChannelAttentionTransformerBlock(8, 2, 4, bias=False, eps=1e-5)
    ref = EICARef(8, 2, 4)
    state = {k: torch.randn(v.shape, generator=gen) for k, v in ref.state_dict().items()}
    ref.load_state_dict(state)
    block.load_state_dict({k.replace(".body.", ".").replace("ffn.", ""): v
                           for k, v in state.items()})
    assert all(m.eps == 1e-5 for m in block.modules() if isinstance(m, nn.LayerNorm))
    assert block.fc1.out_features == 32
    x = torch.randn(2, 5, 6, 8, generator=gen) * 3 + 1
    w, b = state["norm1_image.body.weight"], state["norm1_image.body.bias"]
    mu, sigma = x.mean(-1, keepdim=True), x.var(-1, keepdim=True, unbiased=False)
    two_line = (x - mu) / torch.sqrt(sigma + 1e-5) * w + b
    torch.testing.assert_close(block.norm1_image(x), two_line, rtol=0, atol=1e-5)
    image, event = torch.randn(2, 8, 6, 5, generator=gen), torch.randn(2, 8, 6, 5, generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(block(image, event), ref(image, event), rtol=1e-5, atol=1e-5)


def _softmax_row_peaks(net, vox, img):
    """Each attention's softmax rows' largest entry over the uniform one."""
    peaks = []

    def hook(mod, inp, out):
        x, y = inp
        b, c, h, w = x.shape

        def heads(z):
            return z.reshape(b, mod.num_heads, c // mod.num_heads, h * w)

        q = nn.functional.normalize(heads(mod.q(x)), dim=-1)
        k = nn.functional.normalize(heads(mod.k(y)), dim=-1)
        p = torch.softmax(q @ k.transpose(-2, -1) * mod.temperature, -1)
        peaks.append((p.max(-1).values * p.shape[-1]).flatten())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, MutualAttention)]
    with torch.no_grad():
        net(torch.from_numpy(img).permute(2, 0, 1)[None], vox[None])
    for handle in handles:
        handle.remove()
    return peaks


@pytest.mark.parametrize("seed", [1, 2, SEED])
def test_redrawn_temperatures_sharpen_the_softmax(seed):
    img, _, vox = _request(seed)
    with torch.device("meta"):
        meta = EFNetRef(wf=16)
    seeded = seeded_state(meta, seed, "cpu")
    redrawn = redraw(meta, seeded, seed, "cpu", 1.0, 5.0)
    assert set(redrawn) == set(seeded)
    changed = {k for k in seeded if not torch.equal(seeded[k], redrawn[k])}
    assert changed == {k for k in seeded if k.endswith(("temperature", "fc1.weight", "fc2.weight"))}
    assert len(changed) == 9
    flat = _softmax_row_peaks(_port(seeded), vox, img)
    sharp = _softmax_row_peaks(_port(redrawn), vox, img)
    assert len(sharp) == 3
    assert all(float(p.median()) < 1.2 for p in flat)       # 0.1 N: nearly uniform
    assert all(float(p.median()) >= 2.0 for p in sharp)     # the typical row, 2x uniform


def test_eica_blocks_counts_three_an_image():
    net = _port(_state())
    _, _, vox = _request()
    before = efnet_module.EICA_BLOCKS
    with torch.no_grad():
        net(torch.zeros(2, 3, H, W), vox[None].expand(2, -1, -1, -1))
        assert efnet_module.EICA_BLOCKS - before == 3
        net(torch.zeros(1, 3, H, W), vox[None])
    assert efnet_module.EICA_BLOCKS - before == 6


def test_each_eica_block_is_a_span_inside_the_network():
    from torch.profiler import ProfilerActivity, profile

    task = build_task({"name": "t", "model_type": "TestImageEventRestorationModel",
                       "is_train": False, "val": {}, "network_g": dict(NET)}, "cpu")
    load_state(task.net, _state())
    img, _, vox = _request()
    voxel = vox.permute(1, 2, 0).numpy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = task.predict_tensor(img[None], voxel[None])
    every = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("refid.")), key=lambda s: (s[1], -s[2]))
    spans = [s for s in every if not s[0].startswith("refid.conv")]   # the conv layer's apart
    assert [s[0] for s in spans] == (["refid.task.upload", "refid.task.network"]
                                     + ["refid.efnet.eica"] * 3)
    network = spans[1]
    assert all(network[1] <= a and b <= network[2] for _, a, b in spans[2:])
    convs = [s for s in every if s[0] == "refid.conv"]
    assert convs and all(network[1] <= a and b <= network[2] for _, a, b in convs)
    torch.testing.assert_close(out, task.predict_tensor(img[None], voxel[None]), rtol=0, atol=0)


def test_int8_and_spatial_plans_raise():
    opt = {"name": "t", "model_type": "TestImageEventRestorationModel", "is_train": False,
           "network_g": dict(NET)}
    with pytest.raises(ValueError, match="EFNet"):
        build_task(dict(opt, val={"int8": True}), "cpu")
    task = build_task(dict(opt, val={}), "cpu")
    with pytest.raises(ValueError, match="EFNet"):
        task.net(torch.zeros(1, 3, H, W), torch.zeros(1, 6, H, W), object())
    task.served.mesh = SimpleNamespace(spatial=2)
    img, _, vox = _request()
    with pytest.raises(ValueError, match="EFNet"):
        task.predict(img[None], vox.permute(1, 2, 0).numpy()[None])


def test_archs_builds_efnet_from_network_g():
    with torch.device("meta"):
        net = ARCHS.get("EFNet")({"type": "EFNet", "wf": 64, "num_heads": [1, 2, 4],
                                  "compute_dtype": "bfloat16"})
        ref = EFNetRef()
    assert isinstance(net, EFNet) and net.dtype == torch.bfloat16
    assert [b.image_event_transformer.attn.num_heads for b in net.down_path_1] == [1, 2, 4]
    assert net.down_path_1[2].image_event_transformer.fc1.out_features == 1024
    count = sum(p.numel() for p in net.parameters())
    assert count == sum(p.numel() for p in ref.parameters()) == 8467789
    with pytest.raises(ValueError, match="head count"):
        ARCHS.get("EFNet")({"num_heads": [1, 2]})
    with pytest.raises(ValueError, match="fuse_before_downsample"):
        ARCHS.get("EFNet")({"fuse_before_downsample": False})


def test_load_state_tells_efnet_from_evhinet_checkpoints():
    from portbench.reference.evhinet import EVHINetRef

    with torch.device("meta"):
        evhinet_state = EVHINetRef(wf=16).state_dict()
    with pytest.raises(ValueError, match="no EFNet checkpoint"):
        load_state(ARCHS.get("EFNet")(dict(NET)), evhinet_state)
    with pytest.raises(ValueError, match="an EFNet checkpoint"):
        load_state(ARCHS.get("SingleMultiConnectEVHINet")({"wf": 16}), _state())
    state = _state()
    state.pop("down_path_2.0.emgc_dec_mask.bias")
    with pytest.raises(KeyError, match="emgc_dec_mask"):
        load_state(ARCHS.get("EFNet")(dict(NET)), state)


class _ParentEVConvBlock(evhinet_module.HINConvBlock):
    """EVHINet's event block as it was before EFNet shared it."""

    def __init__(self, in_size, out_size, downsample, relu_slope=0.2, use_hin=True):
        super().__init__(in_size, out_size, downsample, relu_slope, use_hin)
        self.conv_before_merge = nn.Conv2d(out_size, 2 * out_size, 1, 1, 0)

    def forward(self, x, q=None):
        out = super().forward(x, q=q)
        return out, self.conv_before_merge(out)


class _ParentSAM(nn.Module):
    """EVHINet's SAM as it was before EFNet shared it."""

    def __init__(self, n_feat):
        super().__init__()
        self.conv1 = nn.Conv2d(n_feat, n_feat, 3, 1, 1)
        self.conv2 = evhinet_module.HaloConv2d(n_feat, 3, 3, 1, 1)
        self.conv3 = nn.Conv2d(3, n_feat, 3, 1, 1)

    def forward(self, x, x_img):
        return self.conv2(x) + x_img


def test_evhinet_is_bit_identical_with_the_shared_blocks(monkeypatch):
    from portbench.reference.evhinet import EVHINetRef

    with torch.device("meta"):
        meta = EVHINetRef(wf=16)
    state = seeded_state(meta, SEED, "cpu")
    img, _, vox = _request()
    img = torch.from_numpy(img).permute(2, 0, 1)[None]

    def run():
        net = ARCHS.get("SingleMultiConnectEVHINet")({"wf": 16})
        load_state(net, state)
        with torch.no_grad():
            return net(img, vox[None])

    now = run()
    monkeypatch.setattr(evhinet_module, "EVConvBlock", _ParentEVConvBlock)
    monkeypatch.setattr(evhinet_module, "SAM", _ParentSAM)
    parent = run()
    assert torch.equal(now, parent)
    assert np.isfinite(now.numpy()).all()


class _ParentMutualAttention(MutualAttention):
    """EICA's attention as it was before Restormer shared its core."""

    def forward(self, x, y):
        b, c, h, w = x.shape

        def heads(z):
            return z.reshape(b, self.num_heads, c // self.num_heads, h * w)

        q = nn.functional.normalize(heads(self.q(x)), dim=-1, eps=1e-12)
        k = nn.functional.normalize(heads(self.k(y)), dim=-1, eps=1e-12)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, dim=-1)
        return self.project_out((attn @ heads(self.v(y))).reshape(b, c, h, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mutual_attention_is_bit_identical_with_the_shared_core(dtype):
    gen = torch.Generator().manual_seed(SEED)
    now, parent = MutualAttention(16, 4), _ParentMutualAttention(16, 4)
    state = {k: torch.randn(v.shape, generator=gen) for k, v in now.state_dict().items()}
    now.load_state_dict(state)
    parent.load_state_dict(state)
    x, y = torch.randn(2, 16, 12, 20, generator=gen), torch.randn(2, 16, 12, 20, generator=gen)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=dtype == torch.bfloat16):
        got, want = now(x, y), parent(x, y)
    assert got.dtype == dtype
    assert torch.equal(got, want)
