"""LMDB creation CLI: ``python -m refid_tpu_torch.cli.create_lmdb <folder>``
(mirrors ``refid_tpu/cli/create_lmdb.py``).

Packs every image under a folder into ``<folder>.lmdb`` with a
meta_info.txt that the JAX package and upstream read.  Needs the ``lmdb``
package.
"""

from __future__ import annotations

import argparse

from refid_tpu_torch.data.lmdb_util import make_lmdb_from_imgs, prepare_keys_from_folder

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m refid_tpu_torch.cli.create_lmdb",
                                description=__doc__)
    p.add_argument("folder", help="image folder to pack")
    p.add_argument("--lmdb-path", default=None,
                   help="output path (default: <folder>.lmdb)")
    p.add_argument("--suffix", default="png")
    p.add_argument("--compress-level", type=int, default=1)
    p.add_argument("--batch", type=int, default=5000)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    folder = args.folder.rstrip("/")
    lmdb_path = args.lmdb_path or folder + ".lmdb"
    img_path_list, keys = prepare_keys_from_folder(folder, args.suffix)
    if not img_path_list:
        raise SystemExit(f"no .{args.suffix} images found under {folder}")
    make_lmdb_from_imgs(folder, lmdb_path, img_path_list, keys,
                        batch=args.batch, compress_level=args.compress_level)


if __name__ == "__main__":
    main()
