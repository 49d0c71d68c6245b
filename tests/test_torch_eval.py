"""refid_tpu_torch.eval against refid_tpu.eval on the CPU: PSNR, SSIM,
colour, tiling, MATLAB imresize, NIQE, FID and the FID InceptionV3, on the
same seeded inputs."""

import numpy as np
import pytest
import torch

from refid_tpu.data.img_util import tensor2img as jax_tensor2img
from refid_tpu.eval import color as jax_color
from refid_tpu.eval import fid as jax_fid
from refid_tpu.eval import matlab as jax_matlab
from refid_tpu.eval import metrics as jax_metrics
from refid_tpu.eval import niqe as jax_niqe
from refid_tpu.eval import tiling as jax_tiling
from refid_tpu_torch.data.img_util import tensor2img
from refid_tpu_torch.eval import color, fid, matlab, metrics, niqe, tiling

torch.set_num_threads(1)


def _pair(seed, shape, kind):
    """Two images: uint8 [0, 255] or float32 [0, 1], the second a noisy copy."""
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.08 * rng.randn(*shape).astype(np.float32), 0, 1)
    if kind == "uint8":
        return (a * 255).round().astype(np.uint8), (b * 255).round().astype(np.uint8)
    return a, b


_CASES = [("uint8", "HWC", 0), ("uint8", "CHW", 0), ("float", "HWC", 0),
          ("float", "CHW", 3), ("uint8", "HWC", 4)]


@pytest.mark.parametrize("y", [False, True], ids=["rgb", "y"])
@pytest.mark.parametrize("kind,order,crop", _CASES)
def test_psnr_matches_jax(kind, order, crop, y):
    shape = (3, 24, 32) if order == "CHW" else (24, 32, 3)
    a, b = _pair(1, shape, kind)
    kw = dict(crop_border=crop, input_order=order, test_y_channel=y)
    want = jax_metrics.calculate_psnr(a, b, **kw)
    assert abs(metrics.calculate_psnr(a, b, **kw) - want) < 1e-9
    # tensors are measured with torch ops on their device
    got = metrics.calculate_psnr(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert isinstance(got, float) and abs(got - want) < 1e-9


@pytest.mark.parametrize("y", [False, True], ids=["rgb", "y"])
@pytest.mark.parametrize("kind,order,crop", _CASES)
def test_ssim_matches_jax(kind, order, crop, y):
    shape = (3, 30, 26) if order == "CHW" else (30, 26, 3)
    a, b = _pair(2, shape, kind)
    kw = dict(crop_border=crop, input_order=order, test_y_channel=y)
    want = jax_metrics.calculate_ssim(a, b, **kw)
    got = metrics.calculate_ssim(a, b, **kw)
    assert isinstance(got, float) and abs(got - want) < 1e-5
    assert abs(metrics.calculate_ssim(torch.from_numpy(a), torch.from_numpy(b), **kw)
               - got) < 1e-12


def test_identical_images():
    a, _ = _pair(3, (16, 16, 3), "uint8")
    assert metrics.calculate_psnr(a, a) == float("inf")
    assert metrics.calculate_ssim(a, a) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="input_order"):
        metrics.calculate_psnr(a, a, input_order="WHC")


def test_gaussian_kernel_and_colour_are_bit_exact():
    np.testing.assert_array_equal(metrics.gaussian_kernel_1d(), jax_metrics.gaussian_kernel_1d())
    np.testing.assert_array_equal(metrics.gaussian_kernel_1d(13, 1.6),
                                  jax_metrics.gaussian_kernel_1d(13, 1.6))
    u8, f = _pair(4, (12, 10, 3), "uint8")[0], _pair(4, (12, 10, 3), "float")[0]
    for img in (u8, f):
        for y_only in (False, True):
            np.testing.assert_array_equal(color.rgb2ycbcr(img, y_only),
                                          jax_color.rgb2ycbcr(img, y_only))
            np.testing.assert_array_equal(color.bgr2ycbcr(img, y_only),
                                          jax_color.bgr2ycbcr(img, y_only))
        np.testing.assert_array_equal(color.to_y_channel(img), jax_color.to_y_channel(img))


@pytest.mark.parametrize("shape", [(7, 9, 3), (5, 7, 9, 3), (9, 3)])
def test_tensor2img_on_tensors_equals_numpy(shape):
    rng = np.random.RandomState(5)
    x = (rng.rand(*shape) * 1.4 - 0.2).astype(np.float32)
    x.flat[:8] = np.arange(8) / 255.0 + 0.5 / 255.0     # ties: round half to even
    want = jax_tensor2img(x)                             # the JAX package's numpy
    got = tensor2img(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    host = tensor2img(x)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, want)


# --- tiling ------------------------------------------------------------------

@pytest.mark.parametrize("h,w,crop", [(40, 56, 16), (32, 32, 16), (17, 23, 8), (16, 16, 16)])
def test_tile_plan_equals_jax(h, w, crop):
    assert tiling.tile_plan(h, w, crop) == jax_tiling.tile_plan(h, w, crop)


@pytest.mark.parametrize("trans_num", [1, 8])
def test_tiling_bit_exact(trans_num):
    rng = np.random.RandomState(6)
    lq = rng.rand(40, 56, 3).astype(np.float32)
    vox = rng.rand(4, 40, 56, 2).astype(np.float32)
    for k in range(8):
        np.testing.assert_array_equal(tiling.dihedral(vox, k), jax_tiling.dihedral(vox, k))
        np.testing.assert_array_equal(tiling.dihedral_inverse(vox, k),
                                      jax_tiling.dihedral_inverse(vox, k))
    tiles, idx = tiling.extract_tiles(vox, 16, trans_num)
    jtiles, jidx = jax_tiling.extract_tiles(vox, 16, trans_num)
    np.testing.assert_array_equal(tiles, jtiles)
    assert idx == jidx

    def fake_net(lq_tiles, vox_tiles):    # (b, t, h, w, 3): lq scaled per frame
        t = np.arange(1, vox_tiles.shape[1] + 1, dtype=np.float32)
        return lq_tiles[:, None] * t[None, :, None, None, None] + vox_tiles[..., :1]

    got = tiling.tiled_apply(fake_net, lq, vox, 16, max_minibatch=3, trans_num=trans_num)
    want = jax_tiling.tiled_apply(fake_net, lq, vox, 16, max_minibatch=3, trans_num=trans_num)
    np.testing.assert_array_equal(got, want)


def test_tiling_single_image_fn_keeps_a_time_axis():
    rng = np.random.RandomState(7)
    lq = rng.rand(40, 56, 3).astype(np.float32)
    vox = rng.rand(40, 56, 6).astype(np.float32)
    out = tiling.tiled_apply(lambda l, v: l + v[..., :3], lq, vox, 16, max_minibatch=3,
                             out_frames=1)
    assert out.shape == (1, 40, 56, 3)
    np.testing.assert_array_equal(out, jax_tiling.tiled_apply(
        lambda l, v: l + v[..., :3], lq, vox, 16, max_minibatch=3))


# --- MATLAB imresize, NIQE, FID ---------------------------------------------

@pytest.mark.parametrize("scale,shape,aa", [(0.5, (20, 24, 3), True), (0.25, (32, 28), True),
                                            (2.0, (9, 11, 3), True), (0.5, (20, 24, 3), False),
                                            (1 / 3, (30, 33, 2), True)])
def test_imresize_matches_jax(scale, shape, aa):
    img = np.random.RandomState(8).rand(*shape)
    np.testing.assert_allclose(matlab.imresize(img, scale, aa),
                               jax_matlab.imresize(img, scale, aa), rtol=0, atol=1e-5)
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(matlab.cubic(x), jax_matlab.cubic(x))


@pytest.mark.parametrize("shape", [(32, 40, 3), (29, 31)])
def test_duf_downsample_matches_jax(shape):
    img = np.random.RandomState(9).rand(*shape).astype(np.float32)
    want = jax_matlab.duf_downsample(img)
    got = matlab.duf_downsample(img)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def niqe_params(tmp_path_factory):
    """A synthetic BasicSR-style pristine-params file: a positive definite
    covariance, a normalized 7x7 Gaussian window."""
    rng = np.random.RandomState(10)
    a = rng.randn(36, 36)
    g = metrics.gaussian_kernel_1d(7, 7 / 6)
    path = tmp_path_factory.mktemp("niqe") / "pris.npz"
    np.savez(path, mu_pris_param=rng.randn(1, 36), cov_pris_param=a @ a.T / 36 + np.eye(36),
             gaussian_window=np.outer(g, g))
    return str(path)


@pytest.mark.parametrize("convert_to,order,crop,shape", [
    ("y", "HWC", 0, (200, 300, 3)), ("y", "CHW", 4, (3, 200, 296)),
    ("gray", "HWC", 0, (193, 290, 3)), ("y", "HW", 0, (192, 289))])
def test_niqe_matches_jax(niqe_params, convert_to, order, crop, shape):
    rng = np.random.RandomState(11)
    base = rng.rand(*shape) * 180
    smooth = np.cumsum(np.cumsum(rng.randn(*shape), axis=0), axis=1)
    img = np.clip(base * 0.5 + 40 + 0.3 * smooth, 0, 255).astype(np.float32)
    kw = dict(crop_border=crop, input_order=order, convert_to=convert_to,
              params_path=niqe_params)
    want = jax_niqe.calculate_niqe(img, **kw)
    got = niqe.calculate_niqe(img, **kw)
    assert np.isfinite(want) and abs(got - want) <= 1e-4 * abs(want)


def test_niqe_filter_and_halving_match_scipy_and_cv2():
    import cv2
    from scipy.ndimage import convolve
    rng = np.random.RandomState(12)
    img = (rng.rand(23, 30) * 255).astype(np.float32)
    win = rng.rand(7, 5)
    np.testing.assert_allclose(niqe._filter(img, win), convolve(img, win, mode="nearest"),
                               rtol=1e-6, atol=1e-3)
    for shape in ((24, 30), (23, 31)):
        x = rng.rand(*shape).astype(np.float32)
        want = cv2.resize(x, (shape[1] // 2, shape[0] // 2), interpolation=cv2.INTER_LINEAR)
        # an exact half is a 2x2 mean in both; cv2's general path weighs in
        # another float32 order
        np.testing.assert_allclose(niqe._half_size(x), want, rtol=0,
                                   atol=1e-6 if shape[0] % 2 == 0 else 1e-5)
    with pytest.raises(FileNotFoundError):
        niqe.calculate_niqe(img, params_path="/nonexistent.npz")


def test_fid_matches_jax():
    rng = np.random.RandomState(13)
    fx = rng.randn(40, 6)
    fy = fx @ (np.eye(6) + 0.2 * rng.randn(6, 6)) + 0.3
    mx, sx = fid.extract_statistics(fx)
    my, sy = fid.extract_statistics(fy)
    jmx, jsx = jax_fid.extract_statistics(fx)
    np.testing.assert_array_equal(mx, jmx)
    np.testing.assert_array_equal(sx, jsx)
    want = jax_fid.calculate_fid(jmx, jsx, *jax_fid.extract_statistics(fy))
    got = fid.calculate_fid(mx, sx, my, sy)
    assert want > 0 and abs(got - want) <= 1e-6 * abs(want)
    assert abs(fid.calculate_fid(mx, sx, mx, sx)) < 1e-6 * np.trace(sx)


# --- InceptionV3 --------------------------------------------------------------

def _random_inception_state(seed):
    """A pt_inception-style state_dict (fc and step counters included) with
    random weights: conv kernels at 0.1, BatchNorm statistics spread out."""
    from refid_tpu_torch.eval.inception import InceptionV3Features
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in InceptionV3Features().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
        elif k.endswith("bn.weight"):
            sd[k] = 1.0 + 0.2 * torch.randn(v.shape, generator=gen)
        elif k.endswith("conv.weight"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        else:
            sd[k] = 0.2 * torch.randn(v.shape, generator=gen)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    return sd


@pytest.mark.parametrize("resize,normalize,shape", [(False, True, (4, 96, 96, 3)),
                                               (True, False, (1, 40, 50, 3))])
def test_inception_features_match_jax(tmp_path, resize, normalize, shape):
    import jax.numpy as jnp
    from refid_tpu.eval import inception as jax_inception
    from refid_tpu_torch.eval import inception
    sd = _random_inception_state(3)
    path = tmp_path / "pt_inception.pth"
    torch.save(sd, path)
    model = inception.load_patched_inception_v3(str(path), resize_input=resize,
                                                normalize_input=normalize, device="cpu")
    x = np.random.RandomState(14).rand(*shape).astype(np.float32)
    got = inception.extract_inception_features([x[:2], x[2:]][:len(x) // 2 or 1], model)
    want = np.asarray(jax_inception.inception_v3_features(
        jax_inception.convert_torch_state_dict(sd), jnp.asarray(x), resize_input=resize,
        normalize_input=normalize))
    assert got.shape == (len(x), 2048)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    assert set(inception.convert_torch_state_dict(sd)) == {
        k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


def test_inception_loader_defaults_to_the_card(tmp_path, monkeypatch):
    """Like the JAX extractor, which runs on the default device, the loader
    builds on the card unless asked for the CPU; without a card it raises
    before it reads the weights."""
    import inspect
    from refid_tpu_torch.eval import inception
    default = inspect.signature(inception.load_patched_inception_v3).parameters["device"]
    assert default.default == "cuda"
    read = []
    monkeypatch.setattr(inception.torch, "load", lambda *a, **k: read.append(a))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            inception.load_patched_inception_v3(str(tmp_path / "absent.pth"))
        assert read == []
