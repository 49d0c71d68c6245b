#!/usr/bin/env python3
"""On-card smoke test of refid_tpu_torch, the PyTorch / CUDA port.

Run from the root of a checkout on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

It builds the CUDA kernels from ``refid_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, drives the port's main path
(``BlurVFIPipeline``, blurry VFI 11+1, production width ``RefidConfig()``
with seeded random weights) against the same pipeline on the CPU, then
serves full-size 1280x720 windows with 2**20 events in float32 and bf16.
Each phase prints one JSON line; the last two lines are the ``kernels``
line and ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without the ``ok`` line; so does a machine without CUDA.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import voxelize_padded_reference
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion
from refid_tpu_torch.ops import build

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BINS, WIDTH, HEIGHT = 24, 1280, 720      # blurry VFI 11+1 at 720p
FULL_EVENTS = 1 << 20
KERNEL_TOL = 1e-4   # f32 atomics add in varying order; a cell sums a few votes of |v| <= 1
PARITY_DB = 60.0


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, message):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def random_events(rng, n, width, height, cap=None, t_span=5e4):
    """``cap`` x 4 float32 buffer: n time-sorted in-frame events, then zeros."""
    ev = np.zeros((cap or n, 4), np.float32)
    ev[:n, 0] = np.sort(rng.uniform(0.0, t_span, n))
    ev[:n, 1] = rng.randint(0, width, n)
    ev[:n, 2] = rng.randint(0, height, n)
    ev[:n, 3] = rng.randint(0, 2, n)
    return ev


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fill_random(model, seed):
    """Every parameter from a seeded generator: conv kernels at 1/sqrt(fan_in),
    LayerNorm weights near 1, everything else (biases, EGACA beta / gamma)
    at 0.1 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 4 and not name.endswith(("beta", "gamma")):
                p.copy_(noise / math.sqrt(p[0].numel()))
            elif p.dim() == 1 and name.endswith("weight"):   # LayerNorm2d
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def parity_db(want, got):
    span = float(want.max() - want.min())
    rmse = float(torch.sqrt(torch.mean((want - got) ** 2)))
    return math.inf if rmse == 0 else 20 * math.log10(span / rmse)


def phase_kernel_check():
    rng = np.random.RandomState(0)
    cap = FULL_EVENTS
    main = random_events(rng, cap - 1000, WIDTH, HEIGHT, cap=cap)
    same_t = random_events(rng, 5000, WIDTH, HEIGHT, cap=1 << 14)
    same_t[:5000, 0] = 123.5
    outside = random_events(rng, 20000, WIDTH, HEIGHT, cap=1 << 15)
    outside[:20000, 1] = rng.randint(-8, WIDTH + 8, 20000)
    outside[:20000, 2] = rng.randint(-8, HEIGHT + 8, 20000)
    cases = {
        "main": (main, cap - 1000),
        "empty": (np.zeros((1 << 14, 4), np.float32), 0),
        "equal_stamps": (same_t, 5000),
        "out_of_frame": (outside, 20000),
    }
    errs, votes = {}, {}
    for name, (ev, n_valid) in cases.items():
        ev_d = torch.from_numpy(ev).cuda()
        got = voxel_cuda.voxelize_cuda(ev_d, n_valid, BINS, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        want = voxelize_padded_reference(ev_d, n_valid, BINS, WIDTH, HEIGHT)
        check(got.shape == (BINS, HEIGHT, WIDTH), f"{name}: shape {tuple(got.shape)}")
        errs[name] = float((got - want).abs().max())
        votes[name] = int((got != 0).sum())
        check(errs[name] <= KERNEL_TOL, f"voxelize {name}: max|diff| {errs[name]} > {KERNEL_TOL}")
    check(votes["empty"] == 0 and votes["out_of_frame"] > 0 and votes["main"] > 0,
          f"unexpected nonzero cell counts {votes}")
    emit("kernel_check", kernel="voxelize", max_abs_err=errs, tol=KERNEL_TOL,
         nonzero_cells=votes)
    return max(errs.values()), main, cap - 1000


def phase_kernel_timing(events, n_valid):
    ev_d = torch.from_numpy(events).cuda()
    ms = cuda_ms(lambda: voxel_cuda.voxelize_cuda(ev_d, n_valid, BINS, WIDTH, HEIGHT), 50)
    plain_ms = cuda_ms(lambda: voxelize_padded_reference(ev_d, n_valid, BINS, WIDTH, HEIGHT), 20)
    # each valid event row read once, the grid written once
    bytes_moved = n_valid * 16 + BINS * HEIGHT * WIDTH * 4
    ops = n_valid * 16   # rescale, truncate, two votes: ~16 f32 operations
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "library_ms": None}
    emit("kernel_timing", kernel="voxelize", n_valid=n_valid, bytes=bytes_moved,
         **timing)
    return timing


def set_tf32(enabled):
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


def count_conv_flops(model, run):
    """``run()`` and the FLOPs (2 x multiply-adds) of the convs and
    transposed convs of ``model`` it executed, counted by forward hooks."""
    total = [0]

    def hook(mod, inp, out):
        taps = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total[0] += 2 * inp[0].numel() * mod.out_channels * taps
        else:
            total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * taps

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        return run(), total[0]
    finally:
        for handle in handles:
            handle.remove()


def phase_parity(state):
    """The main path on the card against the same pipeline on the CPU, at
    full width on a small frame, TF32 off."""
    set_tf32(False)
    rng = np.random.RandomState(1)
    h, w, n_ev = 64, 96, 16000
    b0 = rng.rand(h, w, 3).astype(np.float32)
    b1 = rng.rand(h, w, 3).astype(np.float32)
    ev = random_events(rng, n_ev, w, h)
    before = voxel_cuda.LAUNCHES
    got = BlurVFIPipeline(state, RefidConfig(), device="cuda")(b0, b1, ev)
    torch.cuda.synchronize()
    launched = voxel_cuda.LAUNCHES - before
    cpu = BlurVFIPipeline(state, RefidConfig(), device="cpu")
    want, flops = count_conv_flops(cpu.model, lambda: cpu(b0, b1, ev))
    got = got.float().cpu()
    check(got.shape == (23, h, w, 3), f"parity output shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "parity output not finite")
    db = parity_db(want, got)
    emit("parity", shape=[h, w], events=n_ev, db=db, min_db=PARITY_DB,
         max_abs_err=float((want - got).abs().max()), voxelize_launches=launched,
         conv_flops=flops)
    check(db >= PARITY_DB, f"card vs CPU main path {db:.1f} dB < {PARITY_DB}")
    check(launched > 0, "the main path did not launch the voxelize kernel")
    return flops / (h * w)   # every conv runs at h/2^k x w/2^k: exact per pixel


def phase_serve(pipe, requests, dtype_name, conv_flops):
    """1 warm-up + timed windows, each request byte-distinct."""
    autocast = dtype_name == "bf16"
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, (b0, b1, ev) in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = pipe(b0, b1, ev)
        torch.cuda.synchronize()
        if i > 0:
            times.append((time.perf_counter() - t0) * 1e3)
    check(out.shape == (23, HEIGHT, WIDTH, 3), f"serve output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{dtype_name} serve output not finite")
    ms = sum(times) / len(times)
    emit("serve", dtype=dtype_name, frame=[HEIGHT, WIDTH], events=FULL_EVENTS,
         windows_timed=len(times), ms_per_window=times, mean_ms_per_window=ms,
         frames_per_s=23 * 1e3 / ms, conv_flops=conv_flops,
         conv_tflops_per_s=conv_flops / ms / 1e9,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return out, ms


def phase_profile(pipe, request, window_ms, top=12):
    """One bf16 window under torch.profiler: device time by kernel, and the
    device's idle share against the unprofiled window time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pipe(*request)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms_count = by_name.setdefault(e.name, [0.0, 0])
            ms_count[0] += e.time_range.elapsed_us() / 1e3
            ms_count[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    check(busy_ms > 0, "the profiler recorded no device time")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    emit("profile", dtype="bf16", device_busy_ms=busy_ms, window_ms=window_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms),
         kernel_launches=sum(n for _, n in by_name.values()),
         top=[{"kernel": name[:90], "ms": ms, "launches": n,
               "share": ms / busy_ms} for name, (ms, n) in ranked[:top]])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "ptxas": [
             line for line in v["log"].splitlines() if "Used" in line or "spill" in line]}
                  for k, v in built.items()})

    max_err, events, n_valid = phase_kernel_check()
    timing = phase_kernel_timing(events, n_valid)

    model = FinalBidirectionAttenfusion(RefidConfig())
    fill_random(model, seed=0)
    state = model.state_dict()
    conv_flops = phase_parity(state) * HEIGHT * WIDTH

    rng = np.random.RandomState(2)
    requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 random_events(rng, FULL_EVENTS, WIDTH, HEIGHT))
                for _ in range(4)]
    pipe = BlurVFIPipeline(state, RefidConfig(), device="cuda")
    set_tf32(False)
    voxel_cuda.LAUNCHES = 0                      # the main path's run starts here
    out32, _ = phase_serve(pipe, requests, "f32", conv_flops)
    set_tf32(True)   # bf16 autocast: TF32 settings do not reach bf16 convs
    out16, bf16_ms = phase_serve(pipe, requests, "bf16", conv_flops)
    launches = voxel_cuda.LAUNCHES               # ... and ends here
    check(launches == 2 * len(requests),
          f"voxelize launched {launches} times for {2 * len(requests)} windows")
    emit("serve_bf16_vs_f32", db=parity_db(out32.float(), out16.float()))
    phase_profile(pipe, requests[-1], bf16_ms)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "voxelize", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxelize.cu",
        "replaces": "refid_tpu/events/voxel_pallas.py:311",
        "launches": launches, "max_abs_err": max_err, **timing}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
