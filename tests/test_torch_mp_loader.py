"""refid_tpu_torch's process loader (data/mp_loader.py, ``prefetch_mode:
process``) against its thread loader and against
``refid_tpu.data.mp_loader.ProcessPrefetchLoader``, for 2 epochs on one
synthetic GoPro tree, as tests/test_datasets.py's
test_process_loader_matches_threaded does for the JAX package."""

import numpy as np
import pytest
import torch

from refid_tpu.data import build_dataset as jax_build_dataset
from refid_tpu.data.loader import build_loader as jax_build_loader
from refid_tpu.data.mp_loader import ProcessPrefetchLoader as JaxProcessLoader
from refid_tpu_torch.data.img_util import imread
from refid_tpu_torch.data.loader import PrefetchLoader, build_dataset, build_loader
from refid_tpu_torch.data.mp_loader import ProcessPrefetchLoader
from tests.synthetic_data import make_gopro_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gopro_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(root, m=2, n=1)
    return root


def _opt(root, **kw):
    opt = {"type": "GoProEventRecurrentDataset", "dataroot": root, "phase": "train",
           "scale": 1, "num_end_interpolation": 2, "num_inter_interpolation": 1,
           "one_voxel_flag": True, "return_deblur_voxel": True, "gt_size": None,
           "use_hflip": False, "use_rot": False, "video_list": ["VID_A", "VID_B"],
           "seed": 10, "batch_size_per_gpu": 2, "use_shuffle": True,
           "num_worker_per_gpu": 2, "prefetch_mode": "process", "dataset_enlarge_ratio": 4}
    opt.update(kw)
    return opt


def _epochs(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("augment", [False, True])
def test_process_loader_equals_thread_loader(gopro_root, augment):
    """The same batches for 2 epochs, augmentation included: each item's
    crop, flips and reversal are drawn in sampler order before a worker
    loads it, whichever loader and however many workers."""
    kw = {"gt_size": 16, "use_hflip": True, "use_rot": True,
          "random_reverse": True} if augment else {}
    opt = _opt(gopro_root, **kw)
    ds = build_dataset(opt, device="cpu")
    loader = build_loader(ds, opt, is_train=True, seed=5)
    assert isinstance(loader, ProcessPrefetchLoader)
    try:
        got = _epochs(loader)
        pool = loader._pool
        assert pool is not None and _epochs(loader, (0,))[0] is not None
        assert loader._pool is pool                     # the pool outlives an epoch
    finally:
        loader.close()
    ref_ds = build_dataset(opt, device="cpu")
    want = _epochs(PrefetchLoader(ref_ds, loader.batch_size, loader.sampler, num_workers=3))
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == len(loader) > 0
        for b, w in zip(g_epoch, w_epoch):
            assert b.keys() == w.keys() and b["seq"] == w["seq"]
            for key in ("lq", "gt", "voxel"):
                np.testing.assert_array_equal(b[key], w[key])
    assert ds.timing["items"] == 3 * len(loader) * loader.batch_size   # 3 epochs, parent side


def test_process_loader_equals_jax_process_loader(gopro_root, monkeypatch):
    """Against the JAX package's process loader on the same tree (its float32
    numpy voxelizer): lq and gt exact, voxels within 1e-5 as in
    tests/test_torch_data.py::test_dataset_items_equal_jax."""
    monkeypatch.setenv("REFID_TPU_NO_NATIVE", "1")
    opt = _opt(gopro_root, num_worker_per_gpu=1)
    loader = build_loader(build_dataset(opt, device="cpu"), opt, is_train=True, seed=5)
    ref = jax_build_loader(jax_build_dataset(dict(opt)), dict(opt), is_train=True, seed=5)
    assert isinstance(ref, JaxProcessLoader)
    try:
        got, want = _epochs(loader), _epochs(ref)
    finally:
        loader.close()
        ref.close()
    for g_epoch, w_epoch in zip(got, want):       # the JAX batch spans the local devices
        b, w = ({k: np.concatenate([x[k] for x in epoch]) if k in ("lq", "gt", "voxel")
                 else sum((x[k] for x in epoch), []) for k in epoch[0]}
                for epoch in (g_epoch, w_epoch))
        assert len(b["seq"]) == len(w["seq"]) == 16
        assert b["seq"] == w["seq"] and b["origin_index"] == w["origin_index"]
        np.testing.assert_array_equal(b["lq"][..., :3], w["lq"][..., :3])
        np.testing.assert_array_equal(b["gt"], w["gt"])
        for key in ("lq", "voxel"):
            np.testing.assert_allclose(b[key], w[key], rtol=0, atol=1e-5)


def test_worker_error_reaches_the_consumer(gopro_root, tmp_path):
    opt = _opt(gopro_root)
    ds = build_dataset(opt, device="cpu")
    ds.event_paths = [[str(tmp_path / "missing.npz")] * len(p) for p in ds.event_paths]
    loader = build_loader(ds, opt, is_train=True)
    try:
        with pytest.raises(FileNotFoundError):
            list(loader)
    finally:
        loader.close()


def test_a_dataset_without_load_and_finish_is_refused():
    class Whole:
        device = "cpu"

        def __len__(self):
            return 2

        def __getitem__(self, index):
            return {"x": np.zeros(1)}

    with pytest.raises(TypeError, match="draw / load / finish"):
        ProcessPrefetchLoader(Whole(), batch_size=1)


def test_workers_send_frames_cut_to_the_crop(gopro_root):
    """``load`` (a worker's part) returns the frames cut to the drawn crop
    and the full frame's size, so ``finish`` voxelizes the full frame; the
    item equals ``ds[i]`` of a dataset seeded alike."""
    opt = _opt(gopro_root, gt_size=16, use_hflip=True, use_rot=True, random_reverse=True)
    ds, ref = build_dataset(opt, device="cpu"), build_dataset(opt, device="cpu")
    for index in (0, 1, 0):
        draws = ds.draw(index)
        host = ds.load(index, draws)
        full = ref.lq_paths[index][0]
        assert host["size"] != (16, 16) and host["size"] == imread(full, float32=False).shape[:2]
        assert {img.shape for img in host["lqs"] + host["gts"]} == {(16, 16, 3)}
        got, want = ds.finish(host), ref[index]
        assert got["seq"] == want["seq"]
        for key in ("lq", "gt", "voxel"):
            np.testing.assert_array_equal(got[key], want[key])
