"""Evaluate released reference checkpoints with the PyTorch / CUDA port in
one command (the counterpart of ``scripts/eval_released.py``).

Given a reference ``net_g_*.pth`` and a dataset root, this runs
convert -> (tiled) eval -> PSNR/SSIM on the card, and prints the result as a
BASELINE.md-format table row:

    python scripts/eval_released_torch.py --pth net_g_200000.pth \\
        --dataroot /data/GoPro --config options/test/GoPro/Test_Final_1skip.yml

Any YAML under options/test/ works, and so does a single-image EVHINet
option file (``val.crop_size`` for tiled inference); --dataroot/--pth
override the config's paths.  --max-items N limits the run for smoke
testing.  --int8 [true|scale0] evaluates the int8 serving path with dynamic
scales, where the frame's sides are multiples of the network's
``int8_side`` (EVHINet serves any of them with dynamic scales).  --device
defaults to ``cuda`` and raises without a card; ``cpu`` runs the kernels'
plain versions.

The table goes to stdout; each dataset's details and its predict / metric /
save milliseconds per item go to stderr.  The Hardware cell is the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives
them, or ``cpu``.  :func:`main` returns ``{dataset name: results}``;
:func:`run`, which it calls, returns the task (``task.results``,
``task.test_timing``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pth", required=True,
                   help="Reference net_g_*.pth checkpoint (or a port checkpoint "
                        "file or directory).")
    p.add_argument("--config", required=True,
                   help="Test YAML (options/test/...).")
    p.add_argument("--dataroot", default=None,
                   help="Override every dataset's dataroot.")
    p.add_argument("--root", default=None, help="Results root (default cwd).")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--int8", nargs="?", const="true", default=None,
                   choices=["true", "scale0"],
                   help="Evaluate the int8 (dynamic-scale) serving path "
                        "instead of the float one.")
    p.add_argument("--json-out", default=None,
                   help="Also dump results as JSON to this path.")
    p.add_argument("--device", default="cuda",
                   help="Device to evaluate on (default: cuda; cpu runs the "
                        "plain versions of the kernels).")
    return p.parse_args(argv)


def hardware(device) -> str:
    """The Hardware cell: ``name, power limit`` of the card that holds
    ``device`` (nvidia-smi's row of the same UUID), else its name; ``cpu``
    off the card."""
    import torch

    if device.type != "cuda":
        return device.type
    props = torch.cuda.get_device_properties(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return props.name
    for row in out.strip().splitlines():
        uuid, name_limit = row.split(", ", 1)
        if uuid.endswith(str(props.uuid)):
            return name_limit
    return props.name


def run(argv=None):
    args = parse_args(argv)

    from refid_tpu_torch.cli.test import evaluate
    from refid_tpu_torch.core.config import parse_options
    from refid_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    opt = parse_options(args.config, is_train=False, root=args.root)
    opt["path"]["pretrain_network_g"] = args.pth
    if args.int8:
        opt.setdefault("val", {})["int8"] = (
            True if args.int8 == "true" else args.int8)
    for phase, dopt in opt["datasets"].items():
        dopt.setdefault("name", phase)
        if args.dataroot:
            for key in list(dopt):
                if key.startswith("dataroot"):
                    dopt[key] = args.dataroot

    task = evaluate(opt, device, save_img=args.save_img, max_items=args.max_items)
    for name, timing in task.test_timing.items():
        items = max(timing["items"], 1)
        print(f"evaluated {name}: {timing['items']} items; ms per item: predict "
              f"{timing['predict_ms'] / items:.1f}, metric {timing['metric_ms'] / items:.1f}, "
              f"save {timing['save_ms'] / items:.1f}", file=sys.stderr)

    # BASELINE.md-format rows
    cfg_label = os.path.splitext(os.path.basename(args.config))[0]
    if args.int8:
        cfg_label += f" (int8={args.int8})"
    print("| Metric | Value | Hardware | Source |")
    print("|---|---|---|---|")
    hw = hardware(device)
    for name, res in task.results.items():
        psnr = res.get("total_psnr", res.get("psnr"))
        ssim = res.get("total_ssim", res.get("ssim"))
        cells = []
        if psnr is not None:
            cells.append(f"{psnr:.2f} dB")
        if ssim is not None:
            cells.append(f"{ssim:.4f}")
        value = " / ".join(cells) if cells else json.dumps(res)
        print(f"| {cfg_label} [{name}] — PSNR / SSIM | {value} | {hw} | "
              f"this eval ({os.path.basename(args.pth)}) |")
        extras = {k: round(v, 4) for k, v in res.items()}
        print(f"  details: {json.dumps(extras)}", file=sys.stderr)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(task.results, f, indent=2)
    return task


def main(argv=None):
    return run(argv).results


if __name__ == "__main__":
    main()
