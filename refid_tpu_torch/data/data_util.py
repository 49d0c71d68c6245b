"""Path pairing (mirrors ``refid_tpu/data/data_util.py``; upstream
``basicsr/data/data_util.py``): (lq, gt) path pairs from two folders, from a
meta-info file of gt names, or from two ``.lmdb`` folders' meta_info.txt."""

from __future__ import annotations

import os
from os import path as osp
from typing import List

from refid_tpu_torch.data.datasets.base import recursive_glob  # re-export

__all__ = ["recursive_glob", "scandir", "paired_paths_from_folder",
           "paired_paths_from_meta_info_file", "paired_paths_from_lmdb"]


def scandir(dir_path: str, suffix=None, recursive: bool = False,
            full_path: bool = False):
    """The non-hidden files under ``dir_path`` in name order, relative to it
    unless ``full_path``; ``suffix`` a string or tuple."""
    for entry in sorted(os.scandir(dir_path), key=lambda e: e.name):
        if entry.name.startswith("."):
            continue
        if entry.is_file():
            rel = entry.path if full_path else entry.name
            if suffix is None or rel.endswith(suffix):
                yield rel
        elif recursive and entry.is_dir():
            for sub in scandir(entry.path, suffix, recursive, full_path=True):
                yield sub if full_path else osp.relpath(sub, dir_path)


def _two(folders, keys):
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(f"need two folders and two keys, got {folders} and {keys}")
    return folders, keys


def paired_paths_from_folder(folders, keys, filename_tmpl="{}") -> List[dict]:
    """Pairs by gt basename, the lq name from ``filename_tmpl``."""
    (input_folder, gt_folder), (input_key, gt_key) = _two(folders, keys)
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} folders have different numbers of "
                         f"images: {len(input_paths)}, {len(gt_paths)}.")
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        if input_name not in input_paths:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl="{}") -> List[dict]:
    """Pairs from a meta-info file whose lines start with a gt name."""
    (input_folder, gt_folder), (input_key, gt_key) = _two(folders, keys)
    with open(meta_info_file, "r") as f:
        gt_names = [line.split(" ")[0] for line in f if line.strip()]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_path = osp.join(input_folder, f"{filename_tmpl.format(basename)}{ext}")
        paths.append({f"{input_key}_path": input_path,
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_lmdb(folders, keys) -> List[dict]:
    """Pairs of lmdb keys from the two ``.lmdb`` folders' meta_info.txt."""
    (input_folder, gt_folder), (input_key, gt_key) = _two(folders, keys)
    if not (input_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(f"{input_key} folder and {gt_key} folder should both end with "
                         f".lmdb, got {input_folder} and {gt_folder}")
    with open(osp.join(input_folder, "meta_info.txt")) as f:
        input_keys = [line.split(".")[0] for line in f if line.strip()]
    with open(osp.join(gt_folder, "meta_info.txt")) as f:
        gt_keys = [line.split(".")[0] for line in f if line.strip()]
    if set(input_keys) != set(gt_keys):
        raise ValueError(f"Keys in {input_key}_folder and {gt_key}_folder differ.")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k} for k in sorted(input_keys)]
