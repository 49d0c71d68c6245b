"""refid_tpu_torch serving pipelines against the JAX pipelines (CPU, f32), at the
geometry of tests/test_e2e.py's serving tests, on in-frame events."""

import numpy as np
import pytest
import torch

from refid_tpu.models import FinalBidirectionAttenfusion as JaxNet
from refid_tpu.models import RefidConfig as JaxConfig
from refid_tpu.pipeline import BlurVFIPipeline as JaxBlur
from refid_tpu.pipeline import SharpVFIPipeline as JaxSharp
from refid_tpu_torch import BlurVFIPipeline, RefidConfig, SharpVFIPipeline
from refid_tpu_torch.models import FinalBidirectionAttenfusion
from refid_tpu_torch.models.convert import state_dict_from_jax
from tests.test_torch_helpers import max_diff, random_params, to_nhwc

torch.set_num_threads(1)
H, W = 16, 24


def _request(seed, n_events):
    rng = np.random.RandomState(seed)
    f0 = rng.rand(H, W, 3).astype(np.float32)
    f1 = rng.rand(H, W, 3).astype(np.float32)
    ev = np.stack([np.sort(rng.rand(n_events)), rng.randint(0, W, n_events),
                   rng.randint(0, H, n_events), rng.choice([-1., 0., 1.], n_events)],
                  1).astype(np.float32)
    return f0, f1, ev


def _weights(kw, t):
    jcfg, tcfg = JaxConfig(**kw), RefidConfig(**kw)
    params = random_params(JaxNet(jcfg),
                           to_nhwc(np.zeros((1, jcfg.img_chn, H, W), np.float32)),
                           to_nhwc(np.zeros((1, t, 2, H, W), np.float32)))
    return jcfg, tcfg, params


@pytest.mark.parametrize("norm_voxel,voxelizer", [
    (False, "scatter"), (True, "scatter"), (False, "pallas")])
def test_blur_vfi_pipeline_matches_jax(norm_voxel, voxelizer):
    m, n = 2, 1
    kw = dict(img_chn=2 * m + 4, ev_chn=2, num_encoders=2, base_num_channels=4,
              num_residual_blocks=1)
    jcfg, tcfg, params = _weights(kw, 2 * m + n)
    f0, f1, ev = _request(0, 500)
    want = np.asarray(JaxBlur(params, jcfg, m=m, n=n, norm_voxel=norm_voxel,
                              fast=False, voxelizer="scatter")(f0, f1, ev))
    pipe = BlurVFIPipeline(state_dict_from_jax(params, tcfg), tcfg, m=m, n=n,
                           norm_voxel=norm_voxel, voxelizer=voxelizer,
                           device="cpu")
    got = pipe(f0, f1, ev)
    assert got.shape == (2 * m + n, H, W, 3) and got.device.type == "cpu"
    assert max_diff(got.numpy(), want) < 2e-4


def test_sharp_vfi_pipeline_matches_jax():
    n = 3
    kw = dict(img_chn=26, ev_chn=2, num_encoders=2, base_num_channels=4,
              num_residual_blocks=1)
    jcfg, tcfg, params = _weights(kw, n)
    s0, s1, ev = _request(1, 400)
    want = np.asarray(JaxSharp(params, jcfg, n=n, fast=False,
                               voxelizer="scatter")(s0, s1, ev))
    got = SharpVFIPipeline(state_dict_from_jax(params, tcfg), tcfg, n=n,
                           device="cpu")(s0, s1, ev)
    assert got.shape == (n, H, W, 3)
    assert max_diff(got.numpy(), want) < 2e-4


def test_pipeline_pads_to_power_of_two_capacity():
    cfg = RefidConfig(num_encoders=2, base_num_channels=4, num_residual_blocks=1)
    pipe = BlurVFIPipeline(FinalBidirectionAttenfusion(cfg), cfg, device="cpu")
    _, _, ev = _request(2, 20000)
    padded, n_ev = pipe._pad_events(ev, None)
    assert padded.shape == (1 << 15, 4) and n_ev == 20000
    assert torch.equal(padded[:n_ev], torch.from_numpy(ev))
    assert not padded[n_ev:].any()
    assert pipe._pad_events(ev[:10], None)[0].shape == (1 << 14, 4)
    with pytest.raises(ValueError):
        pipe._pad_events(ev, 1 << 14)


@pytest.mark.parametrize("kwargs,err", [
    (dict(voxelizer="xla"), ValueError),
    (dict(cfg=RefidConfig(base_num_channels=8)), ValueError),
])
def test_pipeline_rejects_bad_arguments(kwargs, err):
    cfg = RefidConfig(num_encoders=2, base_num_channels=4, num_residual_blocks=1)
    kwargs = {"cfg": cfg, "device": "cpu", **kwargs}
    with pytest.raises(err):
        BlurVFIPipeline(FinalBidirectionAttenfusion(cfg), **kwargs)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = RefidConfig(num_encoders=2, base_num_channels=4, num_residual_blocks=1)
    with pytest.raises(RuntimeError, match="cuda"):
        BlurVFIPipeline(FinalBidirectionAttenfusion(cfg), cfg)
