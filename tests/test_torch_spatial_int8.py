"""int8 serving of refid_tpu_torch on row shards (CPU, plain versions of the
kernels) against the unsharded port and refid_tpu.

Four gloo ranks split each frame by height (tests/torch_dist.py::int8_job):
an int8 site quantizes with the group's amax, exchanges the int8 halo rows
and convolves with row padding 0, so every integer sum and every scale is
the whole frame's.  Held here:

* single int8 convs (3x3, 4x4/2, 1x1, 5x5/2; dynamic and static scales):
  the gathered shards equal the whole conv bit for bit;
* the toy blurry-VFI pipeline of tests/test_torch_quant.py (img_chn 8, 2
  encoders, base 8, 32x32, m=2, n=1, the flax init of PRNGKey 17) in every
  int8 mode, "static" calibrated on the shards (amax and rms within 1e-5 of
  the whole frame's): within tests/test_torch_quant.py's bars (120 / 110 /
  80 dB) of the unsharded port serving the same scales and of the JAX int8
  pipeline;
* EVHINet (wf 16, 48x64) in int8 True and "static", at the same bars
  (tests/test_torch_evhinet.py's 60 dB against the JAX serving forward).

The float math between the int8 sites rounds differently on a shard than
on the whole frame on the CPU: mkldnn's convs choose their algorithm by
shape (the float pipeline on shards is not bit-equal to the whole with
mkldnn on, and is with it off), and the SE pools' group sums add in
another order.  An activation moved across a rounding boundary moves the
later int8 sites, so the pipelines are held at the dB bars above, and bit
for bit where neither enters: in float and in int8 True with mkldnn off
("scale0" and "static" quantize the SE-gated stage-0 trunks, which the
pools' rounding reaches).  On the card, chip_smoke.py's ``spatial_int8``
requires every mode bit-equal to the whole int8 window.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.models.evhinet import EVHINet as JaxEVHINet
from refid_tpu.pipeline import BlurVFIPipeline as JaxBlur
from refid_tpu.serve.evhinet_fast import evhinet_fast_forward
from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.models.convert import evhinet_state_dict_from_jax, state_dict_from_jax
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.serve import quant
from tests import torch_dist
from tests.test_torch_helpers import parity_db, random_params

torch.set_num_threads(1)

H = W = 32
M, N = 2, 1
TOY = dict(img_chn=8, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
PACKAGE_DB = {True: 120.0, "scale0": 110.0, "static": 80.0}    # tests/test_torch_quant.py
SITES = {True: 50, "scale0": 80, "static": 110}
EV_WF, EV_H, EV_W = 16, 48, 64
EVHINET_DB = 60.0                                                # tests/test_torch_evhinet.py
# single int8 sites on a (2, 24, 32, 20) input, 8 rows a shard: cin, cout, k, stride, pad
SITE_CONVS = {"3x3": (24, 16, 3, 1, 1), "4x4s2": (24, 40, 4, 2, 1), "1x1": (24, 8, 1, 1, 0),
              "5x5s2": (24, 16, 5, 2, 2)}


def _window(seed):
    rng = np.random.RandomState(seed)
    b0, b1 = rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32)
    ev = np.stack([np.sort(rng.rand(800)), rng.randint(0, W, 800), rng.randint(0, H, 800),
                   rng.randint(0, 2, 800)], 1).astype(np.float32)
    return b0, b1, ev


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = JaxConfig(**TOY), RefidConfig(**TOY)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(17), jnp.zeros((1, H, W, jcfg.img_chn)),
                               jnp.zeros((1, 3, H, W, jcfg.ev_chn)))
    request = _window(17)
    jax_out = {}
    for mode in (True, "scale0", "static"):
        pipe = JaxBlur(params, jcfg, m=M, n=N, int8=mode)
        if mode == "static":
            pipe.calibrate(*request)
        jax_out[mode] = np.asarray(pipe(*request))
    state = state_dict_from_jax(params, tcfg)

    rng = np.random.RandomState(5)
    x = rng.rand(1, EV_H, EV_W, 3).astype(np.float32)
    ev = rng.randn(1, EV_H, EV_W, 6).astype(np.float32)
    jnet = JaxEVHINet(wf=EV_WF)
    flat = flax.traverse_util.flatten_dict(
        random_params(jnet, jnp.asarray(x), jnp.asarray(ev), seed=5), sep="/")
    eparams = flax.traverse_util.unflatten_dict(     # HIN scales near 1
        {k: (1.0 + v if k.endswith("hin_scale") else v) for k, v in flat.items()}, sep="/")
    estate = evhinet_state_dict_from_jax(eparams)

    gen = torch.Generator().manual_seed(9)
    site_x = torch.randn(2, 24, H, 20, generator=gen)
    convs = {}
    for key, (cin, cout, k, s, p) in SITE_CONVS.items():
        torch.manual_seed(len(convs))
        conv = torch.nn.Conv2d(cin, cout, k, s, p)
        for scale in (None, 0.03):
            convs[(key, scale)] = (conv, scale)
    work = str(tmp_path_factory.mktemp("int8"))
    torch.save({"cfg": TOY, "state": state, "request": request, "wf": EV_WF,
                "sites": (site_x, convs),
                "evhinet_state": estate, "evhinet_input": (_nchw(x), _nchw(ev))},
               f"{work}/int8.pt")
    torch_dist.run_ranks(torch_dist.int8_job, 4, work)
    return {"tcfg": tcfg, "state": state, "request": request, "jax": jax_out,
            "evhinet": (jnet, eparams, estate, x, ev),
            "sites": (site_x, convs),
            "sharded": torch.load(f"{work}/int8_out.pt", weights_only=False)}


@pytest.mark.parametrize("scale", [None, 0.03], ids=["dynamic", "static"])
@pytest.mark.parametrize("key", list(SITE_CONVS))
def test_sharded_int8_site_equals_whole(setup, key, scale):
    x, convs = setup["sites"]
    conv, _ = convs[(key, scale)]
    q = None if scale is None else quant.QuantState("static", amax=[scale * 127.0])
    with torch.no_grad():
        whole = quant.conv_int8(conv, x, conv.stride[0], conv.padding[0], slope=0.1, q=q)
    assert torch.equal(setup["sharded"][(key, scale)], whole)


@pytest.mark.parametrize("mode", [True, "scale0", "static"])
def test_sharded_int8_pipeline_equals_unsharded_and_matches_jax(setup, mode, tmp_path):
    out, amax, rms, exchanges, reductions = setup["sharded"][mode]
    pipe = BlurVFIPipeline(setup["state"], setup["tcfg"], m=M, n=N, int8=mode, device="cpu")
    if mode == "static":
        pipe.calibrate(*setup["request"])
        assert len(amax) == SITES[mode]
        np.testing.assert_allclose(amax, pipe._int8_raw_amax, rtol=1e-5)
        np.testing.assert_allclose(rms, pipe._int8_rms, rtol=1e-5)
        with open(tmp_path / "shards.json", "w") as f:     # serve the shards' scales
            json.dump({"amax": list(amax)}, f)
        pipe.load_calibration(str(tmp_path / "shards.json"))
    whole = pipe(*setup["request"])
    assert parity_db(whole.numpy(), out.numpy()) >= PACKAGE_DB[mode]
    assert parity_db(setup["jax"][mode], out.numpy()) >= PACKAGE_DB[mode]
    # the dynamic modes reduce one amax a site over the group
    assert exchanges > 0 and reductions >= (0 if mode == "static" else SITES[mode])


@pytest.mark.parametrize("mode", [True, "static"])
def test_sharded_evhinet_int8_equals_unsharded_and_matches_jax(setup, mode):
    jnet, eparams, estate, x, ev = setup["evhinet"]
    out, amax, rms, sites = setup["sharded"][f"evhinet_{mode}"]
    net = EVHINet(wf=EV_WF)
    net.load_state_dict(estate)
    with torch.no_grad():
        calib = quant.QuantState("calib")
        net(_nchw(x), _nchw(ev), calib)
        whole_amax, whole_rms = quant.calibration_stats(calib)
        # the shards' calibration: the float activations round differently
        q = quant.QuantState(mode, amax=amax if mode == "static" else ())
        whole = net(_nchw(x), _nchw(ev), q)
    assert sites == 25
    np.testing.assert_allclose(amax, whole_amax, rtol=1e-5)
    np.testing.assert_allclose(rms, whole_rms, rtol=1e-5)
    assert parity_db(whole.numpy(), out.numpy()) >= EVHINET_DB
    jkw = {"int8": True} if mode is True else {"int8": "static", "qstate": {"amax": amax}}
    jout = np.asarray(evhinet_fast_forward(eparams, jnp.asarray(x), jnp.asarray(ev), **jkw))
    assert parity_db(jout, out.permute(0, 2, 3, 1).numpy()) >= EVHINET_DB


def _whole(setup, mode):
    pipe = BlurVFIPipeline(setup["state"], setup["tcfg"], m=M, n=N, int8=mode, device="cpu")
    return pipe(*setup["request"])


@pytest.mark.parametrize("mode", [False, True], ids=["float", "int8"])
def test_sharded_pipeline_equals_whole_bit_for_bit_without_mkldnn(setup, mode):
    """With mkldnn's convs off, the float pipeline and the dynamic int8 one
    on 4 row shards equal the whole frame's bit for bit: the halos, the
    group amax and the int8 halo rows add no rounding of their own."""
    with torch.backends.mkldnn.flags(enabled=False):
        whole = _whole(setup, mode)
    assert torch.equal(setup["sharded"][("mkldnn", False, mode)], whole)


def test_float_pipeline_on_shards_rounds_apart_with_mkldnn(setup):
    """The cause the dB bars above allow for: with mkldnn on (the default),
    the float pipeline on shards differs from the whole by rounding only."""
    got, whole = setup["sharded"][("mkldnn", True, False)], _whole(setup, False)
    assert not torch.equal(got, whole)
    assert float((got - whole).abs().max()) < 1e-6
