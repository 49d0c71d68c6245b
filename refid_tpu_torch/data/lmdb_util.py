"""LMDB creation (mirrors ``refid_tpu/data/lmdb_util.py``; upstream
``basicsr/utils/lmdb_util.py``).  The layout is the reference's, so the
databases are interchangeable with the JAX package's and upstream's:

    <name>.lmdb/
    ├── data.mdb / lock.mdb     # lmdb's own files
    └── meta_info.txt           # "<key>.png (h,w,c) <compress_level>" lines

Keys are image paths relative to the folder without the extension; values
are PNG bytes.  Each image is read with the port's ``unchanged`` read (as
``cv2.imread(..., IMREAD_UNCHANGED)``: depth, alpha and grey kept) and
encoded by the port's PNG writer at ``compress_level`` with libpng's
adaptive row filters (as ``cv2.imencode`` with a compression level).  The
``lmdb`` package is imported only when a database is opened.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from refid_tpu_torch.data.img_util import imencode_png, imfrombytes

__all__ = ["LmdbMaker", "make_lmdb_from_imgs", "prepare_keys_from_folder"]


def prepare_keys_from_folder(folder: str, suffix: str = "png"
                             ) -> Tuple[List[str], List[str]]:
    """The images under ``folder`` (recursively): sorted relative paths and
    their keys (the paths without the extension)."""
    paths = []
    for root, _, files in os.walk(folder):
        for f in sorted(files):
            if f.lower().endswith("." + suffix):
                paths.append(os.path.relpath(os.path.join(root, f), folder))
    paths.sort()
    return paths, [os.path.splitext(p)[0] for p in paths]


def _read_unchanged(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return imfrombytes(f.read(), "unchanged")


class LmdbMaker:
    """Incremental lmdb writer: commits every ``batch`` puts and writes one
    ``meta_info.txt`` line per image."""

    def __init__(self, lmdb_path: str, map_size: int = 1024 ** 4,
                 batch: int = 5000, compress_level: int = 1):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("creating an lmdb needs the lmdb package, which is not "
                              "installed in this environment") from e
        if not lmdb_path.endswith(".lmdb"):
            raise ValueError(f"lmdb_path must end with '.lmdb': {lmdb_path}")
        os.makedirs(lmdb_path, exist_ok=True)
        self.lmdb_path = lmdb_path
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb.open(lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.txt_file = open(os.path.join(lmdb_path, "meta_info.txt"), "w")
        self.counter = 0

    def put(self, img_byte: bytes, key: str, img_shape: Sequence[int]):
        self.counter += 1
        self.txn.put(key.encode("ascii"), img_byte)
        h, w, c = img_shape
        self.txt_file.write(f"{key}.png ({h},{w},{c}) {self.compress_level}\n")
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.txt_file.close()


def make_lmdb_from_imgs(data_path: str, lmdb_path: str,
                        img_path_list: Sequence[str], keys: Sequence[str],
                        batch: int = 5000, compress_level: int = 1,
                        map_size: Optional[int] = None):
    """An lmdb of the PNG-encoded images, one process; ``map_size`` defaults
    to ten times the first image's encoded size per image."""
    if len(img_path_list) != len(keys):
        raise ValueError(f"img_path_list and keys should have the same length, "
                         f"but got {len(img_path_list)} and {len(keys)}")
    print(f"Create lmdb for {data_path}, save to {lmdb_path}...")
    print(f"Total images: {len(img_path_list)}")

    if map_size is None:
        first = imencode_png(_read_unchanged(os.path.join(data_path, img_path_list[0])),
                             compress_level, filter="adaptive")
        map_size = len(first) * len(img_path_list) * 10

    maker = LmdbMaker(lmdb_path, map_size=map_size, batch=batch,
                      compress_level=compress_level)
    try:
        for path, key in zip(img_path_list, keys):
            img = _read_unchanged(os.path.join(data_path, path))
            h, w = img.shape[:2]
            c = 1 if img.ndim == 2 else img.shape[2]
            maker.put(imencode_png(img, compress_level, filter="adaptive"), key, (h, w, c))
    finally:
        maker.close()
    print("Finish writing lmdb.")
