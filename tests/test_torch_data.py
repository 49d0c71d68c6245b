"""refid_tpu_torch's data path against the JAX package's (CPU): the host-array
voxelizer's plain version, PNG IO, transforms, the GoPro datasets, the
sampler and loader, and option parsing."""

import functools
import os
import random
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from refid_tpu.core.config import dict2str as jax_dict2str
from refid_tpu.core.config import parse_options as jax_parse_options
from refid_tpu.data import build_dataset as jax_build_dataset
from refid_tpu.data import img_util as jax_img
from refid_tpu.data import transforms as jax_tf
from refid_tpu.data.loader import EnlargedIndexSampler as JaxSampler
from refid_tpu.events import voxel as jax_voxel
from refid_tpu.events import voxel_pallas
from refid_tpu.ops.native import get_lib
from refid_tpu_torch.core.config import dict2str, parse_options
from refid_tpu_torch.data import img_util, transforms
from refid_tpu_torch.data.loader import (
    EnlargedIndexSampler, PrefetchLoader, build_dataset, build_loader,
)
from refid_tpu_torch.data.mp_loader import ProcessPrefetchLoader
from refid_tpu_torch.events import voxel
from tests.synthetic_data import make_gopro_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "options", "train", "GoPro",
                      "Final_bidirectionEncoder_XXNet_1attenfusion.yml")
M, N = 2, 1


def _events(seed, n, w, h, x_margin=0, t_span=5e4):
    rng = np.random.RandomState(seed)
    ev = np.zeros((n, 4), np.float32)
    ev[:, 0] = np.sort(rng.uniform(0, t_span, n))
    ev[:, 1] = rng.randint(-x_margin, w + x_margin, n)
    ev[:, 2] = rng.randint(0, h, n)
    ev[:, 3] = rng.randint(0, 2, n)
    return ev


# --- host-array voxelizer --------------------------------------------------

_GRIDS = [(24, 48, 32, 3000, "HWC"), (24, 40, 30, 2500, "CHW"),
          (2, 33, 17, 800, "HWC"), (5, 16, 12, 1, "CHW")]


@pytest.mark.parametrize("bins,w,h,n,fmt", _GRIDS)
def test_plain_matches_numpy_host_path(monkeypatch, bins, w, h, n, fmt):
    """Both rescale in float32; only the order of the sums differs."""
    monkeypatch.setenv("REFID_TPU_NO_NATIVE", "1")
    ev = _events(bins + n, n, w, h)
    got = voxel.events_to_voxel_grid(ev, bins, w, h, fmt, device="cpu")
    want = jax_voxel.events_to_voxel_grid(ev, bins, w, h, fmt)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("bins,w,h,n,fmt", _GRIDS)
def test_plain_matches_cpp_host_path(bins, w, h, n, fmt):
    """The C++ voxelizer rescales in double: votes differ by ~1e-7
    relative, and an event on a bin edge can move its near-zero vote to the
    next bin, hence 1e-5."""
    assert get_lib() is not None, "the JAX package's C++ voxelizer did not build"
    ev = _events(bins + n, n, w, h, x_margin=3)      # C++ drops out-of-frame x too
    got = voxel.events_to_voxel_grid(ev, bins, w, h, fmt, device="cpu")
    want = jax_voxel.events_to_voxel_grid(ev, bins, w, h, fmt)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_plain_matches_pallas_k2_in_interpret_mode(monkeypatch, fmt):
    """K2 (``events_to_voxel_grid_pallas``) run in Pallas interpret mode,
    out-of-frame x included (both drop it)."""
    monkeypatch.setattr(voxel_pallas.pl, "pallas_call",
                        functools.partial(voxel_pallas.pl.pallas_call, interpret=True))
    bins, w, h = 5, 48, 16
    ev = _events(7, 1500, w, h, x_margin=4)
    want = voxel_pallas.events_to_voxel_grid_pallas(ev, bins, w, h, fmt, chunk=256)
    got = voxel.events_to_voxel_grid(ev, bins, w, h, fmt, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_empty_and_equal_stamps():
    empty = np.zeros((0, 4), np.float32)
    got = voxel.events_to_voxel_grid(empty, 4, 8, 6, "HWC", device="cpu")
    assert got.shape == (6, 8, 4) and not got.any()
    ev = _events(3, 300, 8, 6)
    ev[:, 0] = 5.0
    got = voxel.events_to_voxel_grid(ev, 4, 8, 6, "CHW", device="cpu")
    assert not got[1:].any()
    np.testing.assert_allclose(got, jax_voxel.events_to_voxel_grid(ev, 4, 8, 6),
                               atol=2e-6)


def test_host_voxelizer_checks_arguments():
    ev = _events(0, 10, 8, 6)
    with pytest.raises(ValueError):
        voxel.events_to_voxel_grid(ev, 4, 8, 6, "WHC", device="cpu")
    with pytest.raises(ValueError):
        voxel.events_to_voxel_grid(ev[:, :3], 4, 8, 6, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            voxel.events_to_voxel_grid(ev, 4, 8, 6)     # the default is the card


def test_voxel_helpers_match_jax():
    rng = np.random.RandomState(0)
    vox = rng.randn(6, 5, 4).astype(np.float32)
    vox[vox < 0.2] = 0
    np.testing.assert_allclose(voxel.voxel_norm_np(vox), jax_voxel.voxel_norm_np(vox),
                               rtol=1e-6, atol=1e-7)
    ev = _events(1, 50, 8, 6)
    np.testing.assert_array_equal(voxel.event_reverse(ev), jax_voxel.event_reverse(ev))
    t = np.repeat(np.arange(10.0), 3)[:, None]
    cols = [rng.rand(30, 1) for _ in range(3)]
    for got, want in zip(voxel.filter_event(*cols, t, (2, 5)),
                         jax_voxel.filter_event(*cols, t, (2, 5))):
        np.testing.assert_array_equal(got, want)


# --- PNG IO ----------------------------------------------------------------

def _png_with_filters(img: np.ndarray, kinds) -> bytes:
    """Encode RGB ``img`` with row filter ``kinds[r % len(kinds)]``."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for r in range(h):
        kind = kinds[r % len(kinds)]
        cur = rows[r]
        prev = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,kind", [((32, 48, 3), "noise"), ((17, 33, 3), "smooth"),
                                        ((20, 30), "noise"), ((9, 11, 4), "noise")])
def test_png_reader_equals_cv2_on_cv2_files(tmp_path, shape, kind):
    rng = np.random.RandomState(len(shape) + shape[0])
    if kind == "noise":
        img = (rng.rand(*shape) * 255).astype(np.uint8)
    else:
        img = np.clip(np.cumsum(rng.randint(-3, 4, shape), 1) + 128, 0, 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(img_util.imread(path), jax_img.imread(path))
    np.testing.assert_array_equal(img_util.imread(path, rgb=False, float32=False),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_reader_decodes_every_row_filter(tmp_path):
    img = (np.random.RandomState(0).rand(20, 13, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img, [0, 1, 2, 3, 4, 4, 3, 2, 1]))
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    np.testing.assert_array_equal(img_util.imread(path, float32=False), img)


def test_png_writer_is_read_by_cv2(tmp_path):
    rng = np.random.RandomState(1)
    pred = rng.rand(12, 20, 3).astype(np.float32)
    bgr = img_util.tensor2img(pred)
    np.testing.assert_array_equal(bgr, jax_img.tensor2img(pred))
    path = str(tmp_path / "sub" / "w.png")
    assert img_util.imwrite(bgr, path)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), bgr)
    grey = (rng.rand(7, 9) * 255).astype(np.uint8)
    img_util.imwrite(grey, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), grey)
    with pytest.raises(ValueError):
        img_util.imwrite(bgr, str(tmp_path / "w.jpg"))


# --- transforms ------------------------------------------------------------

def test_transforms_match_jax():
    rng = np.random.RandomState(0)
    gts = [rng.rand(24, 36, 3).astype(np.float32) for _ in range(3)]
    lqs = [rng.rand(24, 36, 3).astype(np.float32) for _ in range(2)]
    vox = [rng.rand(24, 36, 5).astype(np.float32)]
    for seed in range(6):
        a, b = random.Random(seed), random.Random(seed)
        for got, want in zip(transforms.triple_random_crop(gts, lqs, vox, 16, 1, a),
                             jax_tf.triple_random_crop(gts, lqs, vox, 16, 1, b)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for g, w in zip(transforms.augment(gts + vox, True, True, a),
                        jax_tf.augment(gts + vox, True, True, b)):
            np.testing.assert_array_equal(g, w)
        for got, want in zip(transforms.paired_random_crop(gts[0], lqs, 8, 1, a),
                             jax_tf.paired_random_crop(gts[0], lqs, 8, 1, b)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert a.random() == b.random()
    np.testing.assert_array_equal(transforms.mod_crop(gts[0], 5), jax_tf.mod_crop(gts[0], 5))


# --- datasets --------------------------------------------------------------

@pytest.fixture(scope="module")
def gopro_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(root, m=M, n=N)
    return root


def _opt(root, dtype="GoProEventRecurrentDataset", **kw):
    opt = {"type": dtype, "dataroot": root, "phase": "train", "scale": 1,
           "num_end_interpolation": M, "num_inter_interpolation": N,
           "norm_voxel": True, "one_voxel_flag": True,
           "return_deblur_voxel": True, "gt_size": 16, "use_hflip": True,
           "use_rot": True, "video_list": ["VID_A", "VID_B"], "seed": 10}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("dtype,kw", [
    ("GoProEventRecurrentDataset", {}),
    ("GoProEventRecurrentDataset", {"return_deblur_voxel": False, "gt_size": None}),
    ("GoProEventRecurrentDataset", {"one_voxel_flag": False}),
    ("GoProBidirEventRecurrentDataset", {"random_reverse": True}),
])
def test_dataset_items_equal_jax(gopro_root, dtype, kw):
    """Same tree, same seed, one worker: the same crops and flips; voxels at
    the C++ host path's 1e-5 (see test_plain_matches_cpp_host_path)."""
    ours = build_dataset(_opt(gopro_root, dtype, **kw), device="cpu")
    ref = jax_build_dataset(_opt(gopro_root, dtype, **kw))
    assert len(ours) == len(ref) == 4
    for idx in [0, 3, 1, 1, 2]:
        got, want = ours[idx], ref[idx]
        assert got.keys() == want.keys()
        for key in ("lq", "gt", "voxel"):
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
        assert (got["seq"], got["origin_index"]) == (want["seq"], want["origin_index"])
    assert ours.timing["items"] == 5 and ours.timing["voxelize_ms"] > 0


@pytest.fixture(scope="module")
def highrev_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("highrev"))
    make_gopro_tree(root, layout="highrev", m=M, n=N)
    return root


@pytest.fixture(scope="module")
def bsergb_root(tmp_path_factory):
    """BS-ERGB layout, as tests/test_datasets.py::test_bsergb_dataset writes
    it: 3_TRAINING/<video>/{images,events}, one more image than windows."""
    rng = np.random.RandomState(0)
    root = str(tmp_path_factory.mktemp("bsergb"))
    h, w = 24, 32
    for video, n_imgs in (("seq0", 10), ("seq1", 7)):
        vdir = os.path.join(root, "3_TRAINING", video)
        os.makedirs(os.path.join(vdir, "images"))
        os.makedirs(os.path.join(vdir, "events"))
        for k in range(n_imgs):
            cv2.imwrite(os.path.join(vdir, "images", "%06d.png" % k),
                        (rng.rand(h, w, 3) * 255).astype(np.uint8))
        for k in range(n_imgs - 1):
            ne = 200
            np.savez(os.path.join(vdir, "events", "%06d.npz" % k),
                     timestamp=np.sort(rng.rand(ne) + k).astype(np.float32),
                     x=rng.randint(0, w, ne).astype(np.int16),
                     y=rng.randint(0, h, ne).astype(np.int16),
                     polarity=rng.choice([0, 1], ne).astype(np.int8))
    return root


@pytest.mark.parametrize("root,dtype,kw", [
    ("gopro_root", "DeblurGoProEventRecurrentDataset", {}),
    ("gopro_root", "DeblurGoProEventRecurrentDataset", {"gt_size": None, "use_rot": False}),
    ("highrev_root", "DeblurUNDEventRecurrentDataset", {"video_list": None}),
    ("gopro_root", "DeblurGoProBidirEventRecurrentDataset", {"random_reverse": True}),
    ("bsergb_root", "BsergbSharpEventRecurrentDataset",
     {"video_list": None, "num_end_interpolation": 1, "num_inter_interpolation": 2}),
    ("bsergb_root", "BsergbSharpEventRecurrentDataset",
     {"video_list": ["seq1"], "num_end_interpolation": 1, "num_inter_interpolation": 1,
      "return_deblur_voxel": True, "gt_size": None}),
])
def test_deblur_and_bsergb_items_equal_jax(request, root, dtype, kw):
    """The deblur datasets (one blurred frame -> m sharp ones) and BS-ERGB
    against the JAX package's, elementwise: images exact, voxels at the C++
    host path's 1e-5; the same crops, flips and reversals from one seed."""
    root = request.getfixturevalue(root)
    opt = _opt(root, dtype, **{"return_deblur_voxel": False, **kw})
    ours = build_dataset(opt, device="cpu")
    ref = jax_build_dataset(_opt(root, dtype, **{"return_deblur_voxel": False, **kw}))
    assert len(ours) == len(ref) > 0
    for idx in [0, len(ref) - 1, 0, len(ref) // 2]:
        got, want = ours[idx], ref[idx]
        assert got.keys() == want.keys()
        for key in ("lq", "gt"):
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
        assert got["voxel"].shape == want["voxel"].shape
        np.testing.assert_allclose(got["voxel"], want["voxel"], rtol=0, atol=1e-5)
        assert (got["seq"], got["origin_index"]) == (want["seq"], want["origin_index"])


def test_norm_voxel_is_not_applied(gopro_root):
    a = build_dataset(_opt(gopro_root, norm_voxel=True, gt_size=None,
                           use_hflip=False, use_rot=False), device="cpu")[0]
    b = build_dataset(_opt(gopro_root, norm_voxel=False, gt_size=None,
                           use_hflip=False, use_rot=False), device="cpu")[0]
    np.testing.assert_array_equal(a["voxel"], b["voxel"])
    c = build_dataset(_opt(gopro_root, apply_voxel_norm=True, gt_size=None,
                           use_hflip=False, use_rot=False), device="cpu")[0]
    assert abs(float(c["voxel"][c["voxel"] != 0].mean())) < 0.2


@pytest.mark.parametrize("kw", [dict(ratio=3, shuffle=True, seed=4),
                                dict(ratio=1, shuffle=False),
                                dict(ratio=2, shuffle=True, num_shards=2, shard_index=1)])
def test_sampler_indices_equal_jax(kw):
    ours = EnlargedIndexSampler(7, **kw)
    ref = JaxSampler(7, **{"num_shards": 1, "shard_index": 0, **kw})
    for epoch in range(3):
        np.testing.assert_array_equal(ours.epoch_indices(epoch), ref.epoch_indices(epoch))


def test_loader_batches_follow_the_sampler(gopro_root):
    opt = _opt(gopro_root, gt_size=None, use_hflip=False, use_rot=False)
    ds = build_dataset(opt, device="cpu")
    loader = build_loader(ds, dict(opt, batch_size_per_gpu=2, dataset_enlarge_ratio=2,
                                   num_worker_per_gpu=3), True, seed=5)
    order = loader.sampler.epoch_indices(1)
    loader.set_epoch(1)
    batches = list(loader)
    assert len(batches) == len(loader) == 4
    for k, batch in enumerate(batches):
        assert batch["lq"].shape == (2, 32, 48, 3 + (M - 1) + 3 + (M - 1))
        for j in range(2):
            np.testing.assert_array_equal(batch["gt"][j], ds[int(order[2 * k + j])]["gt"])
    assert ds.timing["items"] == 16     # 8 from 3 threads, 8 here: no lost update
    process = build_loader(ds, dict(opt, prefetch_mode="process"), True)
    assert isinstance(process, ProcessPrefetchLoader) and process._pool is None
    process.close()


def test_loader_surfaces_worker_errors():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise KeyError(f"item {i}")

    with pytest.raises(KeyError):
        list(PrefetchLoader(Broken(), 1))


# --- options ---------------------------------------------------------------

def test_parse_options_equals_jax(tmp_path):
    got = parse_options(RECIPE, is_train=True, root=str(tmp_path))
    want = jax_parse_options(RECIPE, is_train=True, root=str(tmp_path))
    assert got == want
    assert dict2str(got) == jax_dict2str(want)
    debug = tmp_path / "debug.yml"
    debug.write_text(open(RECIPE).read().replace("name: Final_1skip", "name: debug_x"))
    assert parse_options(str(debug), root=str(tmp_path)) == \
        jax_parse_options(str(debug), root=str(tmp_path))
    assert parse_options(RECIPE, is_train=False, root=str(tmp_path)) == \
        jax_parse_options(RECIPE, is_train=False, root=str(tmp_path))
