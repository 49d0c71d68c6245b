#!/usr/bin/env python3
"""The kernels' launch path on one card: what each wrapper costs the host
per call, where that time goes, and the floors beside it.

    python3 tools/launch_path.py [--calls N]

It measures the ``refid_tpu_torch`` of the checkout it sits in and builds
that checkout's kernels; two commits are compared by unpacking each (``git
archive``) and running each one's copy of this script in turns on one card.
``chip_smoke.py``'s ``launch_path`` phase calls :func:`measure`.

For each wrapper (P1 and P2 through the poison probe's dispatchers, P3,
P4, K1, K2, Q8 static, dynamic and from a device amax, the amax pass alone,
C8) at its main-path or probe shape:

* ``host_us``: ``perf_counter`` around ``--calls`` enqueues with one
  synchronize after (the card is not the pacer: fewer launches than the
  queue holds), the median and the spread of 5 such runs;
* ``split_us``: the same clock around each step alone, ``--calls`` times:
  ``stream`` (``ops/build.py``'s ``launch`` and ``current_stream``: the
  device made current when another one is, the raw stream handle), ``ctypes`` (the C launcher called with the
  arguments the wrapper passed, captured beforehand; it holds the launch
  and the launcher's runtime queries), ``queries`` (those queries, from
  their cost in C), ``plan`` (the conv's tile plan, or the voxelizer's),
  ``alloc`` (the outputs' ``torch.empty``) and ``checks`` (the rest:
  checks, attribute reads, the counter);
* ``ms``: CUDA events per call over 50 calls; ``device_ms`` and
  ``device_launches`` per call, by kernel, from torch.profiler.

Beside them, the floors: ``view.mul_(2)`` on P2's view; the one-call
library versions, ``torch.add(one, view, alpha=2, out=view)`` for P2 (with
the per-call slice of ``d``) and ``torch.add(one, d, alpha=2)`` for P1, each
held bit for bit against its kernel and timed against it in turns
(``paired``: CUDA events a call, 5 rounds of kernel then library, the
medians, so that the host's noise falls on both); an empty kernel's host
and device time (``csrc/launch_floor.cu``); the runtime queries' cost in C.

Prints the card's name and power limit, then one JSON line.  Needs one CUDA
card.
"""

import argparse
import contextlib
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 5
# each launcher's runtime queries a call (csrc/launch.cuh keeps the SM
# count and the shared-memory limit); names index the floor library's costs
QUERIES = {"P1": ["device_sms"], "P2": [], "P3": ["device_sms", "cached_smem"],
           "P4": ["device_sms", "cached_smem"], "K1": ["device", "cached_smem", "cached_smem"],
           "K2": ["device", "cached_smem", "cached_smem"], "Q8_static": [],
           "Q8_dynamic": ["device_sms"], "Q8_device_amax": [], "amax": ["device_sms"],
           "C8": ["device_sms", "cached_smem"]}
QUERY_NAMES = ("device", "sms", "smem", "device_sms", "cached_smem")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def floor_library():
    """``csrc/launch_floor.cu``'s library, its two functions bound."""
    from refid_tpu_torch.ops import build

    lib = build.load("launch_floor")
    lib.refid_launch_floor_empty.argtypes = [ctypes.c_void_p]
    lib.refid_launch_floor_empty.restype = ctypes.c_int
    lib.refid_launch_floor_queries.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    lib.refid_launch_floor_queries.restype = ctypes.c_int
    return lib


def host_us(fn, calls, sync=True):
    """Median and spread (min, max) of host microseconds a call over
    REPEATS runs of ``calls`` calls, the card synchronised after each run
    (outside the clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    gc.disable()
    try:
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) * 1e6 / calls)
            if sync:
                torch.cuda.synchronize()
    finally:
        gc.enable()
    return {"median": statistics.median(runs), "min": min(runs), "max": max(runs)}


def paired_ms(fns, calls, rounds=5):
    """CUDA-event ms a call of each of ``fns`` (``{name: fn}``), measured in
    turns, ``rounds`` times: the medians."""
    import torch

    from refid_tpu_torch.core.device import time_ms

    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(time_ms(fn, calls, torch.device("cuda"), warmup=1))
    return {name: statistics.median(v) for name, v in runs.items()}


def device_per_call(fn, calls):
    """Device ms and launches per call of ``fn()``, by kernel, from
    torch.profiler (up to three sessions when one keeps no record).  The
    profiler may drop records of a session: ``device_ms`` sums each
    kernel's mean over the records kept (every wrapper here launches each of
    its kernels once a call); ``device_launches`` counts the records kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms_n = by_name.setdefault(e.name, [0.0, 0])
                ms_n[0] += e.time_range.elapsed_us() / 1e3
                ms_n[1] += 1
        if by_name:
            break
    return {"device_ms": sum(v[0] / v[1] for v in by_name.values()),
            "device_launches": sum(v[1] for v in by_name.values()) / calls,
            "by_kernel": {k[:80]: {"ms": v[0] / v[1], "launches": v[1] / calls}
                          for k, v in by_name.items()}}


@contextlib.contextmanager
def recording(lib, fn_name, modules):
    """Replace the C function ``fn_name`` of ``lib`` (and any dict of
    ``modules`` that holds it, where a wrapper keeps its bound functions)
    by a recorder of its arguments; yields ``(original, calls)``."""
    original = getattr(lib, fn_name)
    calls = []

    def recorder(*args):
        calls.append(args)
        return original(*args)

    holders = [d for m in modules for d in vars(m).values()
               if isinstance(d, dict) and d.get(fn_name) is original]
    setattr(lib, fn_name, recorder)
    for d in holders:
        d[fn_name] = recorder
    try:
        yield original, calls
    finally:
        setattr(lib, fn_name, original)
        for d in holders:
            d[fn_name] = original


def measure(calls=200):
    """The launch path of this checkout's ``refid_tpu_torch`` (see the
    module docstring); returns one dict."""
    import numpy as np
    import torch

    from refid_tpu_torch.core.device import time_ms
    from refid_tpu_torch.events import voxel_cuda
    from refid_tpu_torch.ops import build, int8_cuda, probe_cuda
    from refid_tpu_torch.probes import band_conv as bc
    from refid_tpu_torch.probes import poison

    cuda = torch.device("cuda")
    index = torch.cuda.current_device()
    t0 = time.perf_counter()
    built = build.build()
    build_s = {"seconds": time.perf_counter() - t0,
               "kernels": {k: v["seconds"] for k, v in built.items()}}
    floor = floor_library()
    gen = torch.Generator().manual_seed(0)

    # ---- the inputs: the probes' shapes, the main paths' sites ----
    d = (torch.randn(1, 64, 360, 640, generator=gen) * 50).to(cuda, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    scratch = d.clone()
    x3 = torch.randn(bc.H, bc.WP, bc.C, generator=gen).to(cuda, torch.bfloat16)
    w3 = (0.05 * torch.randn(3, 3, bc.C, bc.C, generator=gen)).to(cuda, torch.bfloat16)
    wq = bc.quantize(w3, 0.01)
    rng = np.random.RandomState(0)
    n_ev = 1 << 20
    ev = np.zeros((n_ev, 4), np.float32)
    ev[:, 0] = np.sort(rng.uniform(0.0, 5e4, n_ev))
    ev[:, 1] = rng.randint(0, 1280, n_ev)
    ev[:, 2] = rng.randint(0, 720, n_ev)
    ev[:, 3] = rng.randint(0, 2, n_ev)
    ev_d = torch.from_numpy(ev).to(cuda)
    xs = torch.randn(1, 256, 360, 640, generator=gen)
    xs = torch.maximum(xs, 0.1 * xs).to(cuda, torch.bfloat16)        # scale1_trunk_in's input
    shard = xs[:, :, :182].contiguous()                               # a 360-row shard's rows
    shard_amax = int8_cuda.amax_int8_cuda(shard)
    xq, xscale = int8_cuda.quantize_int8_cuda(xs)
    wp = torch.randint(-127, 128, (128, 3, 3, 256), generator=gen, dtype=torch.int8).to(cuda)
    wscale = torch.full((128,), 1e-3, device=cuda)
    bias = (0.1 * torch.randn(128, generator=gen)).to(cuda)

    def c8():
        return int8_cuda.conv_int8_cuda(xq, wp, wscale, xscale, bias, 1, 1, slope=0.1,
                                        out_dtype=torch.bfloat16)

    # name: (call, library, C function, outputs' shapes and types, plan)
    wrappers = {
        "P1": (lambda: poison.passthrough(d), "passthrough", "refid_passthrough",
               [(d.shape, d.dtype)], None),
        "P2": (lambda: poison.tiny_passthrough(scratch), "passthrough",
               "refid_passthrough_slice", [], None),
        "P3": (lambda: bc.band_conv(x3, w3, 8), "band_conv", "refid_band_conv",
               [((9 * bc.C, bc.C), torch.bfloat16), ((bc.H, bc.WP, bc.C), torch.bfloat16)],
               None),
        "P4": (lambda: bc.band_conv_int8(x3, wq, 8), "band_conv", "refid_band_conv",
               [((9 * bc.C, bc.C), torch.int8), ((bc.H, bc.WP, bc.C), torch.bfloat16)], None),
        "K1": (lambda: voxel_cuda.voxelize_cuda(ev_d, n_ev, 24, 1280, 720), "voxelize",
               "refid_voxelize", [((24, 720, 1280), torch.float32),
                                  ((256 * 1441,), torch.int32), ((n_ev, 4), torch.float32)],
               lambda: voxel_cuda.voxel_tile_plan(24, 1280, 720)),
        "K2": (lambda: voxel_cuda.events_to_voxel_grid_cuda(ev, 24, 1280, 720, "HWC"),
               "voxelize", "refid_voxelize",
               [((720, 1280, 24), torch.float32), ((256 * 1441,), torch.int32),
                ((n_ev, 4), torch.float32)],
               lambda: voxel_cuda.voxel_tile_plan(24, 1280, 720)),
        "Q8_static": (lambda: int8_cuda.quantize_int8_cuda(xs, 0.05), "conv_int8",
                      "refid_quantize_int8",
                      [((1, 360, 640, 256), torch.int8), ((1,), torch.float32)], None),
        "Q8_dynamic": (lambda: int8_cuda.quantize_int8_cuda(xs), "conv_int8",
                       "refid_quantize_int8",
                       [((1, 360, 640, 256), torch.int8), ((1,), torch.float32)], None),
        "Q8_device_amax": (lambda: int8_cuda.quantize_int8_cuda(shard, amax=shard_amax),
                           "conv_int8", "refid_quantize_int8",
                           [((1, 182, 640, 256), torch.int8), ((1,), torch.float32)], None),
        "amax": (lambda: int8_cuda.amax_int8_cuda(shard), "conv_int8", "refid_amax_int8",
                 [((1,), torch.float32)], None),
        "C8": (c8, "conv_int8", "refid_conv_int8", [((1, 128, 360, 640), torch.bfloat16)],
               lambda: int8_cuda.conv_plan(1, 360, 640, 256, 128, 3, 3, 1, 2)),
    }
    shapes = {"P1": list(d.shape), "P2": [8, 128], "P3": [bc.H, bc.WP, bc.C],
              "P4": [bc.H, bc.WP, bc.C], "K1": [n_ev, 24, 720, 1280],
              "K2": [n_ev, 720, 1280, 24], "Q8_static": list(xs.shape),
              "Q8_dynamic": list(xs.shape), "Q8_device_amax": list(shard.shape),
              "amax": list(shard.shape), "C8": [256, 128, 360, 640, 3]}

    qns = (ctypes.c_double * 5)()
    err = floor.refid_launch_floor_queries(1000, qns)
    if err:
        raise RuntimeError(f"launch_floor queries failed: CUDA error {err}")
    query_ns = dict(zip(QUERY_NAMES, qns))
    modules = [probe_cuda, int8_cuda, voxel_cuda]

    def stream_step():
        return build.launch(int, index, build.current_stream(index))

    stream_us = host_us(stream_step, calls, sync=False)["median"]
    rows = {}
    for name, (call, lib_name, fn_name, outs, plan) in wrappers.items():
        n_calls = 10 if name == "K2" else calls if name in ("P1", "P2") else calls // 2
        total = host_us(call, n_calls)
        with recording(build.load(lib_name), fn_name, modules) as (original, seen):
            keep = call()
        torch.cuda.synchronize()
        args = seen[-1]
        ctypes_us = host_us(lambda: original(*args), n_calls)["median"]
        torch.cuda.synchronize()
        del keep
        alloc_us = host_us(lambda: [torch.empty(s, dtype=t, device=cuda) for s, t in outs],
                           calls, sync=False)["median"] if outs else 0.0
        plan_us = host_us(plan, calls, sync=False)["median"] if plan else 0.0
        queries_us = sum(query_ns[q] for q in QUERIES[name]) / 1e3
        rows[name] = {
            "shape": shapes[name], "calls": n_calls, "host_us": total,
            "split_us": {"stream": stream_us, "ctypes": ctypes_us, "queries": queries_us,
                         "plan": plan_us, "alloc": alloc_us,
                         "checks": total["median"] - stream_us - ctypes_us - plan_us
                         - alloc_us},
            "ms": time_ms(call, 10 if name == "K2" else 50, cuda),
            **device_per_call(call, 5 if name == "K2" else 20)}

    # ---- the floors ----
    view = scratch[0, 0, :8, :128]
    one = torch.ones((), dtype=d.dtype, device=cuda)
    check_d = d.clone()
    want = check_d.clone()
    poison.tiny_passthrough(want)
    v = check_d[0, 0, :8, :128]
    torch.add(one, v, alpha=2, out=v)
    p1 = poison.passthrough(d)
    p1_library = torch.add(one, d, alpha=2)
    bit_equal = {"P2": bool(torch.equal(check_d, want)), "P1": bool(torch.equal(p1, p1_library))}
    del check_d, want, p1, p1_library

    def p2_library():
        v = scratch[0, 0, :8, :128]
        torch.add(one, v, alpha=2, out=v)

    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        floor.refid_launch_floor_empty(stream)

    floors = {}
    for name, fn in (("view.mul_(2)", lambda: view.mul_(2)),
                     ("P2 library: torch.add(one, d[0, 0, :8, :128], alpha=2, out=view)",
                      p2_library),
                     ("P1 library: torch.add(one, d, alpha=2)",
                      lambda: torch.add(one, d, alpha=2)),
                     ("P1 two ops: d * 2 + 1", lambda: d * 2.0 + 1.0),
                     ("empty kernel (ctypes)", empty)):
        floors[name] = {"host_us": host_us(fn, calls), "ms": time_ms(fn, 50, cuda),
                        **device_per_call(fn, 20)}
    paired = {"P2": paired_ms({"kernel_ms": lambda: poison.tiny_passthrough(scratch),
                               "library_ms": p2_library}, calls),
              "P1": paired_ms({"kernel_ms": lambda: poison.passthrough(d),
                               "library_ms": lambda: torch.add(one, d, alpha=2)}, calls // 2)}
    return {"build": build_s,
            "wrappers": rows, "floors": floors, "paired": paired, "bit_equal": bit_equal,
            "query_ns": query_ns, "calls": calls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("launch_path: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    print(smi_line(), flush=True)
    print(json.dumps({"launch_path": measure(args.calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
