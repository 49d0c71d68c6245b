"""YAML option parsing, schema-compatible with the reference option files
(mirrors ``refid_tpu/core/config.py``).

Injects ``is_train`` and per-phase ``phase``/``scale``, expands ``~`` in
paths, derives the experiment / result directories, and shrinks logging
and checkpoint frequencies for ``debug_*`` experiment names.  ``yaml`` is
imported only when a file is parsed.
"""

from __future__ import annotations

import os
from os import path as osp

__all__ = ["parse_options", "dict2str"]


def parse_options(opt_path: str, is_train: bool = True, root: str = None) -> dict:
    import yaml

    with open(opt_path, "r") as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train

    if "datasets" in opt:
        for phase, dataset in opt["datasets"].items():
            phase = phase.split("_")[0]
            dataset["phase"] = phase
            if "scale" in opt:
                dataset["scale"] = opt["scale"]
            for key in ("dataroot", "dataroot_gt", "dataroot_lq"):
                if dataset.get(key) is not None:
                    dataset[key] = osp.expanduser(dataset[key])

    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val is not None and ("resume_state" in key
                                or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)

    opt["path"]["root"] = root or opt["path"].get("root") or os.getcwd()

    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments",
                                    opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_states"] = osp.join(experiments_root,
                                                  "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = osp.join(experiments_root,
                                                "visualization")
        if "debug" in opt["name"]:
            if "val" in opt:
                opt["val"]["val_freq"] = 8
            opt.setdefault("logger", {})
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
            opt["train"]["total_iter"] = min(
                opt["train"].get("total_iter", 16), 16)
    else:
        results_root = osp.join(opt["path"]["root"], "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root, "visualization")

    return opt


def dict2str(opt, indent_level=1):
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg
