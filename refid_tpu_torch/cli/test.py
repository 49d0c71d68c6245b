"""Evaluation CLI: ``python -m refid_tpu_torch.cli.test -opt <yml>
[--root DIR] [--max-items N] [--save-img] [--device cuda|cpu]`` (mirrors
``refid_tpu/cli/test.py``).

Builds every dataset of ``opt["datasets"]`` in sorted order (each item
voxelized on ``--device``: the CUDA kernel K2 on the card), loads
``path.pretrain_network_g`` (an upstream ``.pth``, a port checkpoint file
or a port checkpoint directory), validates each loader with the task's
``val`` metrics and logs to ``<results>/test_<name>.log``.  ``--device``
defaults to ``cuda`` and raises without a card; ``cpu`` runs the plain
versions.

With ``mesh: {spatial: S}`` the ranks of each spatial group split every
prediction by image height: start S processes (or a multiple) with
``--coordinator host:port --num-processes N --process-id K``, or under
torchrun, as for ``cli.train``; every rank evaluates every item, and only
rank 0 writes the log file and the images.

:func:`main` returns ``{dataset name: results}``; :func:`run`, which it
calls, returns the task with those results in ``task.results`` and each
loader's timing (``validate``'s ``val_timing``) in ``task.test_timing``.
:func:`evaluate` is ``run`` after the arguments: it evaluates options
already parsed (``scripts/eval_released_torch.py`` calls it).
"""

from __future__ import annotations

import argparse
import os

from refid_tpu_torch.core.config import dict2str, parse_options
from refid_tpu_torch.core.logging_util import get_root_logger
from refid_tpu_torch.data.loader import build_dataset, build_loader
from refid_tpu_torch.parallel.mesh import add_distributed_args, join_from_args, rank, rank_device
from refid_tpu_torch.tasks import build_task

__all__ = ["evaluate", "main", "parse_args", "run"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m refid_tpu_torch.cli.test")
    p.add_argument("-opt", required=True, help="Path to YAML option file.")
    p.add_argument("--root", default=None,
                   help="Experiment root (default: cwd).")
    p.add_argument("--max-items", type=int, default=None,
                   help="Evaluate only the first N items of each dataset.")
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="Device to evaluate on (default: cuda; cpu runs the "
                        "plain versions of the kernels).")
    add_distributed_args(p)
    return p.parse_args(argv)


def evaluate(opt: dict, device, save_img: bool = False, max_items=None, logger=None):
    """Validate every dataset of the parsed test options ``opt`` in sorted
    order on ``device``, with the weights at ``path.pretrain_network_g``.
    Returns the task, its results in ``task.results`` and each loader's
    timing in ``task.test_timing``."""
    loaders = []
    for phase, dataset_opt in sorted(opt["datasets"].items()):
        ds = build_dataset(dataset_opt, device)
        loaders.append((dataset_opt, build_loader(ds, dataset_opt, False)))
        if logger:
            logger.info(f"test set {dataset_opt.get('name', phase)}: {len(ds)} items")

    task = build_task(opt, device)
    pretrain = opt["path"].get("pretrain_network_g")
    if not pretrain:
        raise ValueError("path.pretrain_network_g is required for testing")
    task.load_pretrained(pretrain)
    if logger:
        logger.info(f"loaded weights from {pretrain}")

    task.results, task.test_timing = {}, {}
    for dataset_opt, loader in loaders:
        name = dataset_opt.get("name", "test")
        task.results[name] = task.validate(loader, dataset_opt, save_img=save_img,
                                           logger=logger, max_items=max_items)
        task.test_timing[name] = dict(task.val_timing)
    return task


def run(argv=None):
    args = parse_args(argv)
    join_from_args(args)
    device = rank_device(args.device)
    opt = parse_options(args.opt, is_train=False, root=args.root)
    lead = rank() == 0
    os.makedirs(opt["path"]["results_root"], exist_ok=True)
    logger = get_root_logger(
        log_file=f"{opt['path']['log']}/test_{opt['name']}.log" if lead else None)
    logger.info(dict2str(opt))
    save_img = (args.save_img or (opt.get("val") or {}).get("save_img", False)) and lead
    return evaluate(opt, device, save_img=save_img, max_items=args.max_items, logger=logger)


def main(argv=None):
    return run(argv).results


if __name__ == "__main__":
    main()
