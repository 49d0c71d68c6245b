"""The port's IO backends and lmdb tooling against the JAX package's (CPU):
``FileClient`` (disk, lmdb, memcached), ``LmdbMaker``,
``make_lmdb_from_imgs``, the ``create_lmdb`` CLI and the path pairing of
``data_util``.  Neither ``lmdb`` nor ``mc`` is installed: a stub module
stands in for each, as tests/test_lmdb.py builds them, and without them
both packages raise ``ImportError``.

Tolerances: keys, meta_info.txt and paths are equal as text; the images the
port stores decode (through cv2 and the port) to exactly what the JAX
package's store decodes to.
"""

import importlib
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from refid_tpu.cli import create_lmdb as jax_create_lmdb
from refid_tpu.data import data_util as jax_data_util
from refid_tpu.data import file_client as jax_file_client
from refid_tpu.data import img_util as jax_img
from refid_tpu.data import lmdb_util as jax_lmdb_util
from refid_tpu_torch.cli import create_lmdb
from refid_tpu_torch.data import data_util, file_client, img_util, lmdb_util

torch.set_num_threads(1)


class _Txn:
    def __init__(self, env, write):
        self.env, self.write, self.pending = env, write, {}

    def put(self, k, v):
        assert self.write
        self.pending[k] = v

    def get(self, k):
        return self.env.store.get(k)

    def commit(self):
        self.env.store.update(self.pending)
        self.env.commits += 1
        self.pending = {}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Env:
    def __init__(self, stores, path, kw):
        self.store = stores.setdefault(path, {})
        self.kw, self.commits = kw, 0

    def begin(self, write=False):
        return _Txn(self, write)

    def close(self):
        pass


@pytest.fixture()
def stores(monkeypatch):
    """A stub ``lmdb``: ``open`` -> env with ``begin`` / ``close``; a txn's
    puts land at ``commit``.  Returns ``{path: {key: value}}``."""
    stores, envs = {}, []
    mod = types.ModuleType("lmdb")

    def open_(path, **kw):
        envs.append(_Env(stores, path, kw))
        return envs[-1]

    mod.open = open_
    mod.envs = envs
    monkeypatch.setitem(sys.modules, "lmdb", mod)
    return stores


def _images(folder, rng):
    """A folder of the formats the unchanged read keeps apart: 8-bit BGR,
    16-bit BGRA, grey, in a subfolder too."""
    os.makedirs(os.path.join(folder, "sub"), exist_ok=True)
    imgs = {"a.png": rng.randint(0, 256, (6, 9, 3)).astype(np.uint8),
            "sub/b.png": rng.randint(0, 65536, (5, 4, 4)).astype(np.uint16),
            "sub/c.png": rng.randint(0, 256, (7, 3)).astype(np.uint8)}
    for name, img in imgs.items():
        cv2.imwrite(os.path.join(folder, name), img)
    with open(os.path.join(folder, "notes.txt"), "w") as f:
        f.write("not an image")
    return imgs


def test_prepare_keys_from_folder_matches_jax(tmp_path):
    _images(str(tmp_path / "f"), np.random.RandomState(0))
    got = lmdb_util.prepare_keys_from_folder(str(tmp_path / "f"))
    assert got == jax_lmdb_util.prepare_keys_from_folder(str(tmp_path / "f"))
    assert got == (["a.png", "sub/b.png", "sub/c.png"], ["a", "sub/b", "sub/c"])


@pytest.mark.parametrize("level", [1, 4])
def test_make_lmdb_from_imgs_matches_jax(stores, tmp_path, level):
    folder = str(tmp_path / "frames")
    imgs = _images(folder, np.random.RandomState(level))
    paths, keys = lmdb_util.prepare_keys_from_folder(folder)
    ours, ref = str(tmp_path / "ours.lmdb"), str(tmp_path / "ref.lmdb")
    lmdb_util.make_lmdb_from_imgs(folder, ours, paths, keys, batch=2, compress_level=level)
    jax_lmdb_util.make_lmdb_from_imgs(folder, ref, paths, keys, batch=2, compress_level=level)
    assert stores[ours].keys() == stores[ref].keys() == {k.encode() for k in keys}
    with open(os.path.join(ours, "meta_info.txt")) as f, \
            open(os.path.join(ref, "meta_info.txt")) as g:
        assert f.read() == g.read()
    for path, key in zip(paths, keys):
        mine, theirs = stores[ours][key.encode()], stores[ref][key.encode()]
        for flag in ("unchanged", "color"):
            want = jax_img.imfrombytes(theirs, flag)
            np.testing.assert_array_equal(jax_img.imfrombytes(mine, flag), want)
            np.testing.assert_array_equal(img_util.imfrombytes(mine, flag), want)
        np.testing.assert_array_equal(img_util.imfrombytes(mine, "unchanged"), imgs[path])
    env = sys.modules["lmdb"].envs[-2]            # ours; each map_size from the first image
    assert env.commits == 2 and env.kw["map_size"] > 0


def test_lmdb_maker_and_file_client_read_back(stores, tmp_path):
    path = str(tmp_path / "imgs.lmdb")
    maker = lmdb_util.LmdbMaker(path, batch=2, compress_level=1)
    rng = np.random.RandomState(2)
    imgs = {}
    for i in range(3):
        img = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
        key = f"seq/{i:03d}"
        maker.put(img_util.imencode_png(img), key, img.shape)
        imgs[key] = img
    maker.close()
    with open(os.path.join(path, "meta_info.txt")) as f:
        assert f.read().splitlines() == [f"seq/{i:03d}.png (6,8,3) 1" for i in range(3)]
    ours = file_client.FileClient("lmdb", db_paths=path, client_keys="default")
    ref = jax_file_client.FileClient("lmdb", db_paths=path, client_keys="default")
    for key, img in imgs.items():
        assert ours.get(key) == ref.get(key)
        np.testing.assert_array_equal(img_util.imfrombytes(ours.get(key)), img)
    assert ours.get("missing") is None
    with pytest.raises(ValueError, match=".lmdb"):
        lmdb_util.LmdbMaker(str(tmp_path / "no_suffix"))


def test_file_client_disk_and_multiple_lmdb_keys(stores, tmp_path):
    path = tmp_path / "t.txt"
    path.write_text("hello")
    for mod in (file_client, jax_file_client):
        disk = mod.FileClient("disk")
        assert disk.get(str(path)) == b"hello" and disk.get_text(str(path)) == "hello"
        with pytest.raises(ValueError):
            mod.FileClient("s3")
    stores["a.lmdb"] = {b"k": b"A"}
    stores["b.lmdb"] = {b"k": b"B"}
    fc = file_client.FileClient("lmdb", db_paths=["a.lmdb", "b.lmdb"], client_keys=["lq", "gt"])
    assert (fc.get("k", "lq"), fc.get("k", "gt")) == (b"A", b"B")
    assert sys.modules["lmdb"].envs[0].kw == {"readonly": True, "lock": False,
                                              "readahead": False}


def test_memcached_backend_through_a_stub(monkeypatch):
    store = {"k1": b"payload"}

    class _Client:
        def Get(self, key, buf):
            buf.value = store.get(key)

    mod = types.ModuleType("mc")
    mod.MemcachedClient = types.SimpleNamespace(GetInstance=lambda s, c: _Client())
    mod.pyvector = lambda: types.SimpleNamespace(value=None)
    mod.ConvertBuffer = lambda buf: buf.value
    monkeypatch.setitem(sys.modules, "mc", mod)
    for m in (file_client, jax_file_client):
        fc = m.FileClient("memcached", server_list_cfg="s.conf", client_cfg="c.conf")
        assert fc.get("k1") == b"payload"


def test_missing_packages_raise_import_error_in_both(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    monkeypatch.setitem(sys.modules, "mc", None)
    for fc_mod, maker_mod in ((file_client, lmdb_util), (jax_file_client, jax_lmdb_util)):
        with pytest.raises(ImportError, match="lmdb"):
            fc_mod.FileClient("lmdb", db_paths="x.lmdb")
        with pytest.raises(ImportError, match="mc"):
            fc_mod.FileClient("memcached", server_list_cfg="s", client_cfg="c")
        with pytest.raises(ImportError):
            maker_mod.LmdbMaker(str(tmp_path / "x.lmdb"))
    assert not (tmp_path / "x.lmdb").exists()


def test_create_lmdb_cli_matches_jax(stores, tmp_path):
    for name in ("ours", "ref"):
        _images(str(tmp_path / name / "clips"), np.random.RandomState(5))
    create_lmdb.main([str(tmp_path / "ours" / "clips"), "--compress-level", "3",
                      "--batch", "1"])
    jax_create_lmdb.main([str(tmp_path / "ref" / "clips"), "--compress-level", "3",
                          "--batch", "1"])
    ours = tmp_path / "ours" / "clips.lmdb"
    ref = tmp_path / "ref" / "clips.lmdb"
    assert (ours / "meta_info.txt").read_text() == (ref / "meta_info.txt").read_text()
    assert stores[str(ours)].keys() == stores[str(ref)].keys()
    assert vars(create_lmdb.parse_args(["f"])) == vars(jax_create_lmdb.parse_args(["f"]))
    create_lmdb.main([str(tmp_path / "ours" / "clips"), "--lmdb-path",
                      str(tmp_path / "elsewhere.lmdb")])
    assert (tmp_path / "elsewhere.lmdb" / "meta_info.txt").exists()
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit):
        create_lmdb.main([str(tmp_path / "empty")])


# --- data_util -----------------------------------------------------------------------

@pytest.fixture()
def paired(tmp_path):
    for sub in ("lq", "gt"):
        os.makedirs(tmp_path / sub / "deep")
        for name in ("001.png", "002.png", ".hidden.png"):
            (tmp_path / sub / name).write_bytes(b"x")
        (tmp_path / sub / "deep" / "003.png").write_bytes(b"x")
    return tmp_path


@pytest.mark.parametrize("kw", [{}, {"suffix": ".png"}, {"recursive": True},
                                {"recursive": True, "full_path": True},
                                {"suffix": (".jpg", ".txt")}])
def test_scandir_matches_jax(paired, kw):
    assert list(data_util.scandir(str(paired / "lq"), **kw)) == \
        list(jax_data_util.scandir(str(paired / "lq"), **kw))


def test_paired_paths_match_jax(paired):
    folders, keys = [str(paired / "lq"), str(paired / "gt")], ["lq", "gt"]
    got = data_util.paired_paths_from_folder(folders, keys)
    assert got == jax_data_util.paired_paths_from_folder(folders, keys) and len(got) == 2
    meta = paired / "meta.txt"
    meta.write_text("001.png (4,4,3) 1\n002.png (4,4,3) 1\n\n")
    assert data_util.paired_paths_from_meta_info_file(folders, keys, str(meta), "{}") == \
        jax_data_util.paired_paths_from_meta_info_file(folders, keys, str(meta), "{}")
    for name in ("lq.lmdb", "gt.lmdb"):
        os.makedirs(paired / name)
        (paired / name / "meta_info.txt").write_text(
            "b/002.png (4,4,3) 1\na/001.png (4,4,3) 1\n")
    lmdbs = [str(paired / "lq.lmdb"), str(paired / "gt.lmdb")]
    assert data_util.paired_paths_from_lmdb(lmdbs, keys) == \
        jax_data_util.paired_paths_from_lmdb(lmdbs, keys)
    with pytest.raises(ValueError):
        data_util.paired_paths_from_lmdb(folders, keys)
    (paired / "gt.lmdb" / "meta_info.txt").write_text("c/003.png (4,4,3) 1\n")
    with pytest.raises(ValueError):
        data_util.paired_paths_from_lmdb(lmdbs, keys)
    (paired / "gt" / "extra.png").write_bytes(b"x")
    with pytest.raises(ValueError):
        data_util.paired_paths_from_folder(folders, keys)


def test_recursive_glob_is_the_datasets_one():
    base = importlib.import_module("refid_tpu_torch.data.datasets.base")
    assert data_util.recursive_glob is base.recursive_glob
