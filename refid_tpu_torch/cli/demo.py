"""Single-image demo CLI: ``python -m refid_tpu_torch.cli.demo -opt <yml>
[--root DIR] [--device cuda|cpu]`` (mirrors ``refid_tpu/cli/demo.py``).

Reads ``img_path.input_img``, builds its event voxel from the
``img_path.input_events`` ``.npz`` (``network_g.num_bins`` bins, default 6,
voxelized ``HWC`` on ``--device``: the CUDA kernel K2 on the card; then
``voxel_norm``), or logs a warning and uses a zero grid when no events are
given, loads ``path.pretrain_network_g`` (required) and writes the restored
frame to ``img_path.output_img``.  This keeps the JAX package's repair of
upstream's demo, which never builds the voxel that
``single_image_inference`` needs.  ``--device`` defaults to ``cuda`` and
raises without a card.  With ``mesh: {spatial: S}`` S processes split the
frame by height (``--coordinator / --num-processes / --process-id`` or
torchrun, as for ``cli.train``); rank 0 writes the image.

:func:`main` returns the task, with the ``(h, w, 3)`` prediction in
``task.demo_output``.
"""

from __future__ import annotations

import argparse

import numpy as np

from refid_tpu_torch.core.config import parse_options
from refid_tpu_torch.core.logging_util import get_root_logger
from refid_tpu_torch.data.datasets.base import load_event_quad
from refid_tpu_torch.data.img_util import imread
from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
from refid_tpu_torch.parallel.mesh import add_distributed_args, join_from_args, rank, rank_device
from refid_tpu_torch.tasks import build_task

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m refid_tpu_torch.cli.demo")
    p.add_argument("-opt", required=True, help="Path to YAML option file.")
    p.add_argument("--root", default=None, help="Experiment root (default: cwd).")
    p.add_argument("--device", default="cuda",
                   help="Device to run on (default: cuda; cpu runs the plain "
                        "versions of the kernels).")
    add_distributed_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    join_from_args(args)
    device = rank_device(args.device)
    opt = parse_options(args.opt, is_train=False, root=args.root)
    logger = get_root_logger()

    paths = opt["img_path"]
    event_path = paths.get("input_events")
    num_bins = opt.get("network_g", {}).get("num_bins", 6)
    pretrain = opt["path"].get("pretrain_network_g")
    if not pretrain:
        raise ValueError("path.pretrain_network_g is required for the demo")

    img = imread(paths["input_img"])
    h, w = img.shape[:2]
    if event_path:
        voxel = events_to_voxel_grid(load_event_quad(event_path), num_bins, w, h, "HWC",
                                     device=device)
        voxel = voxel_norm_np(voxel)
    else:
        logger.warning("no input_events given; using a zero voxel grid")
        voxel = np.zeros((h, w, num_bins), np.float32)

    task = build_task(opt, device)
    task.load_pretrained(pretrain)
    task.demo_output = task.single_image_inference(
        img, voxel, paths["output_img"] if rank() == 0 else None)
    logger.info(f"wrote {paths['output_img']}")
    return task


if __name__ == "__main__":
    main()
