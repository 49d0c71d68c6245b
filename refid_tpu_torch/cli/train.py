"""Training CLI: ``python -m refid_tpu_torch.cli.train -opt <yml>``
(mirrors ``refid_tpu/cli/train.py``).

One process a card (``--device``, default ``cuda``; ``cpu`` runs the
plain versions).  Reads the reference's option files through the port's
own ``parse_options``; ``--max-iters`` overrides ``train.total_iter``.

Several processes train one model as the JAX CLI's do, with
``--coordinator host:port --num-processes N --process-id K`` (each process
then takes ``cuda:K``, or ``cuda:$LOCAL_RANK``), or under torchrun
(``torchrun --nproc-per-node N -m refid_tpu_torch.cli.train -opt <yml>``):
NCCL between cards, gloo with ``--device cpu``.  The ranks form the
``(data, spatial)`` mesh of ``opt['mesh']['spatial']`` (``parallel/mesh.py``);
a process with no card of its own raises.  Each seed is ``manual_seed`` plus
the rank's data index, so the ranks of a spatial group load the same items
with the same crops; the sampler's permutation is the same on every rank.
Only rank 0 logs to file, writes TensorBoard and wandb and saves
checkpoints; every rank resumes and validates.
Each ``val*`` dataset is validated every ``val.val_freq`` iterations and
once when training ends (not twice when the last iteration was a
validation's), its items voxelized on the training device by the val
loader's own threads.

:func:`train` is what :func:`main` calls after parsing, for callers that
build the option dict themselves.  It returns the task, with
``task.train_loader``, ``task.val_loaders`` (``(dataset options, loader)``
pairs) and ``task.history``: the logged iterations (loss,
grad norm, lr and seconds since the previous iteration ended, its
checkpoint counted and its validation not) and the
validations (``val``: the dataset's name, its results, ``seconds``).

``logger.use_tb_logger`` writes ``losses/<name>`` and ``learning_rate`` at
each logged iteration and ``metrics/<dataset>/<name>`` at each validation
to ``<path.root>/tb_logger/<name>/`` (``core/tb_writer.py``), with wandb
syncing it when ``logger.wandb.project`` is set.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import time

import numpy as np
import torch

from refid_tpu_torch.core.config import dict2str, parse_options
from refid_tpu_torch.core.device import resolve_device
from refid_tpu_torch.core.logging_util import MessageLogger, get_root_logger, init_tb_logger
from refid_tpu_torch.data.loader import build_dataset, build_loader
from refid_tpu_torch.parallel.mesh import init_distributed, local_rank, make_mesh, rank, world_size
from refid_tpu_torch.tasks import build_task

__all__ = ["main", "parse_args", "train"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m refid_tpu_torch.cli.train")
    p.add_argument("-opt", required=True, help="Path to YAML option file.")
    p.add_argument("--root", default=None,
                   help="Experiment root (default: cwd).")
    p.add_argument("--max-iters", type=int, default=None,
                   help="Override train.total_iter (smoke runs).")
    p.add_argument("--device", default="cuda",
                   help="Device to train on (default: cuda; cpu runs the "
                        "plain versions of the kernels).")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (with --num-processes > 1).")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend="gloo" if torch.device(args.device).type == "cpu" else None)
    opt = parse_options(args.opt, is_train=True, root=args.root)
    if args.max_iters:
        opt["train"]["total_iter"] = args.max_iters
    return train(opt, args.device)


def _validate(task, current_iter, tb_logger, logger):
    """Each val loader once: results to the log, ``task.history`` and the
    TensorBoard file (``metrics/<dataset>/<name>``)."""
    save_img = (task.opt.get("val") or {}).get("save_img", False) and rank() == 0
    for dataset_opt, loader in task.val_loaders:
        name = dataset_opt.get("name", "val")
        t0 = time.perf_counter()
        results = task.validate(loader, dataset_opt, current_iter, save_img=save_img,
                                logger=logger)
        seconds = time.perf_counter() - t0
        task.history.append({"iter": current_iter, "val": name, "seconds": seconds,
                             **results})
        if tb_logger is not None and results:
            tb_logger.add_scalars({f"metrics/{name}/{k}": v for k, v in results.items()},
                                  current_iter)


def _rank_device(device) -> torch.device:
    """The device of this rank: ``cuda`` is ``cuda:LOCAL_RANK`` when the
    process group has more than one rank or came from torchrun."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None or not torch.distributed.is_initialized():
        return device
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {index} has no card: {torch.cuda.device_count()} "
                           "visible; start one process a card")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def train(opt: dict, device="cuda"):
    device = _rank_device(device)
    mesh = make_mesh(data=-1, spatial=(opt.get("mesh") or {}).get("spatial", 1))

    seed = opt.get("manual_seed", 0) or 0
    rank_seed = seed + mesh.data_index
    random.seed(rank_seed)
    np.random.seed(rank_seed)
    torch.manual_seed(rank_seed)

    os.makedirs(opt["path"]["experiments_root"], exist_ok=True)
    lead = rank() == 0
    logger = get_root_logger(
        log_file=f"{opt['path']['log']}/train_{opt['name']}.log" if lead else None)
    if not lead:
        logger.setLevel(logging.WARNING)
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                       if device.type == "cuda" else "")
                + f"; mesh: data {mesh.data} x spatial {mesh.spatial} of {world_size()} ranks")
    logger.info(dict2str(opt))

    dataset_opt = opt["datasets"].get("train")
    if dataset_opt is None:
        raise ValueError("no train dataset in options")
    dataset_opt.setdefault("seed", seed)
    train_set = build_dataset(dict(dataset_opt, seed=dataset_opt["seed"] + mesh.data_index),
                              device)
    train_loader = build_loader(train_set, dataset_opt, True, seed, mesh)
    logger.info(f"train dataset: {len(train_set)} items, "
                f"{len(train_loader)} batches/epoch")
    val_loaders = []
    for phase, val_opt in opt["datasets"].items():
        if phase.startswith("val"):
            val_set = build_dataset(val_opt, device)
            val_loaders.append((val_opt, build_loader(val_set, val_opt, False)))
            logger.info(f"val dataset {val_opt.get('name', phase)}: {len(val_set)} items")
    if len(train_loader) == 0:
        raise ValueError(
            "train loader is empty: batch_size_per_gpu exceeds the enlarged "
            "dataset; raise dataset_enlarge_ratio or lower batch_size_per_gpu")

    task = build_task(opt, device, mesh)
    task.train_loader, task.val_loaders = train_loader, val_loaders
    pretrain = opt["path"].get("pretrain_network_g")
    if pretrain:
        task.load_pretrained(pretrain)
        logger.info(f"loaded pretrained weights from {pretrain}")
    else:
        task.init_params(seed)
    task.setup_train_state()
    if task.auto_resume():
        logger.info(f"auto-resumed from iter {task.start_iter}")

    tb_logger = init_tb_logger(opt) if lead else None
    try:
        _train_loop(task, opt, tb_logger, logger)
    finally:
        if tb_logger is not None:
            tb_logger.close()
    return task


def _train_loop(task, opt, tb_logger, logger):
    """Iterations from ``task.start_iter`` to ``train.total_iter``: log,
    checkpoint and validate at their frequencies, then the final checkpoint
    and, unless the last iteration just ran one, a validation."""
    total_iter = opt["train"]["total_iter"]
    print_freq = opt.get("logger", {}).get("print_freq", 100)
    save_freq = int(opt.get("logger", {}).get("save_checkpoint_freq", 0) or 0)
    val_freq = int((opt.get("val") or {}).get("val_freq", 0) or 0)
    validated_at = None
    msg_logger = MessageLogger(opt, task.start_iter + 1, tb_logger)

    current_iter = task.start_iter
    epoch = task.start_epoch
    t_iter = time.time()
    logger.info(f"start training from iter {current_iter} to {total_iter}")
    while current_iter < total_iter:
        task.train_loader.set_epoch(epoch)
        for dev_batch in task.device_prefetch(task.train_loader):
            if current_iter >= total_iter:
                break
            current_iter += 1
            metrics = task.train_step_device(dev_batch)
            if current_iter % print_freq == 0:
                log_vars = {"iter": current_iter, "epoch": epoch,
                            "lr": task.current_lr()}
                log_vars.update({k: float(v) for k, v in metrics.items()})
                log_vars["time"] = time.time() - t_iter   # after the sync above
                task.history.append(dict(log_vars))
                msg_logger(log_vars)
            t_iter = time.time()
            if save_freq and current_iter % save_freq == 0:
                logger.info(f"saving checkpoint at iter {current_iter}")
                task.save(current_iter, epoch)
            if val_freq and current_iter % val_freq == 0 and task.val_loaders:
                t_val = time.time()
                _validate(task, current_iter, tb_logger, logger)
                validated_at = current_iter
                t_iter += time.time() - t_val     # a validation is not the next step's
        epoch += 1

    logger.info("training complete; saving final checkpoint")
    task.save(current_iter, epoch)
    if validated_at != current_iter:
        _validate(task, current_iter, tb_logger, logger)


if __name__ == "__main__":
    main()
