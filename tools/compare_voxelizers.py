#!/usr/bin/env python3
"""Time the CUDA voxelizers K1 and K2 of two checkouts on one card, in turns.

    python3 tools/compare_voxelizers.py OTHER_CHECKOUT [--rounds N]

OTHER_CHECKOUT is another tree of this repository, for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  Each round runs OTHER, this checkout, this checkout, OTHER, each in
a process of its own that imports that tree's ``refid_tpu_torch`` (and so
builds that tree's kernels).  A run times, at the main paths' shape (2**20
events, 24 bins, 1280x720), a uniform stream and a skewed one (every event
in 8 rows, as ``chip_smoke.py`` makes them):

* K1, ``voxelize_cuda`` (CHW): CUDA events per call over 50 calls, and the
  device time per call from torch.profiler (every device activity of the
  call, each averaged over the records kept, summed);
* K2, ``events_to_voxel_grid_cuda`` (HWC): the voxelization of an
  uploaded buffer (the sort and tile kernels the wrapper launches) by CUDA
  events per call over 20 calls, and the device time per call as for K1,
  copies excluded.

It prints the card's name and power limit, one JSON line per run, and a
last line with each tree's runs side by side.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINS, WIDTH, HEIGHT, EVENTS = 24, 1280, 720, 1 << 20


def streams():
    """``{"uniform": ..., "skewed": ...}``: (2**20, 4) float32 time-sorted
    ``[t, x, y, p]`` rows from seeded generators."""
    import numpy as np

    out = {}
    for name, seed in (("uniform", 0), ("skewed", 1)):
        rng = np.random.RandomState(seed)
        ev = np.zeros((EVENTS, 4), np.float32)
        ev[:, 0] = np.sort(rng.uniform(0.0, 5e4, EVENTS))
        ev[:, 1] = rng.randint(0, WIDTH, EVENTS)
        ev[:, 2] = (rng.randint(0, HEIGHT, EVENTS) if name == "uniform"
                    else rng.randint(HEIGHT // 2 - 4, HEIGHT // 2 + 4, EVENTS))
        ev[:, 3] = rng.randint(0, 2, EVENTS)
        out[name] = ev
    return out


def device_ms(fn, iters):
    """Device time per call of ``fn()`` from torch.profiler: each device
    activity but the copies, averaged over the records kept, summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"):
            us.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(sum(v) / len(v) for v in us.values()) / 1e3


def child():
    import torch

    from refid_tpu_torch.core.device import time_ms
    from refid_tpu_torch.events import voxel_cuda

    cuda = torch.device("cuda")
    result = {"tree": os.getcwd()}
    for name, ev in streams().items():
        ev_d = torch.from_numpy(ev).cuda()

        def k1():
            return voxel_cuda.voxelize_cuda(ev_d, EVENTS, BINS, WIDTH, HEIGHT)

        def k2():
            return voxel_cuda.events_to_voxel_grid_cuda(ev, BINS, WIDTH, HEIGHT, "HWC")

        result[f"k1_{name}_ms"] = time_ms(k1, 50, cuda)
        result[f"k1_{name}_device_ms"] = device_ms(k1, 20)
        def k2_kernel():
            return voxel_cuda._voxelize(ev_d, EVENTS, BINS, WIDTH, HEIGHT, True)

        result[f"k2_{name}_ms"] = time_ms(k2_kernel, 20, cuda)
        result[f"k2_{name}_device_ms"] = device_ms(k2, 10)
    print(json.dumps(result), flush=True)


def run(tree):
    env = {**os.environ, "PYTHONPATH": tree}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"compare_voxelizers: the run in {tree} failed:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?", help="another checkout of this repository")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child()
    import torch

    if not torch.cuda.is_available() or args.other is None:
        raise SystemExit("compare_voxelizers: needs a CUDA card and another checkout")
    other = os.path.abspath(args.other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for tree, key in ((other, "other"), (HERE, "this"), (HERE, "this"), (other, "other")):
            runs[key].append(run(tree))
    print(json.dumps({key: {k: [r[k] for r in rs] for k in rs[0] if k != "tree"}
                      for key, rs in runs.items()}), flush=True)


if __name__ == "__main__":
    main()
