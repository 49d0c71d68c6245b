#!/usr/bin/env python3
"""On-card smoke test of refid_tpu_torch, the PyTorch / CUDA port.

Run from the root of a checkout on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

It builds the CUDA kernels from ``refid_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, and drives the port's two
main paths with production-width ``RefidConfig()`` networks and seeded
random weights:

* serving (K1): ``BlurVFIPipeline``, blurry VFI 11+1, against the same
  pipeline on the CPU, then full-size 1280x720 windows with 2**20 events in
  float32 and bf16;
* training (K2): one optimiser step on the card against the CPU, then the
  recipe ``options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml``
  (validation removed) through ``python -m refid_tpu_torch.cli.train``'s
  ``main`` on a synthetic 1280x720 GoPro tree written to a temporary
  directory, in float32 and bf16, and a fixed batch overfitted for 10 steps;
* the probes (P1-P4): ``python -m refid_tpu_torch.probes.band_conv``'s and
  ``python -m refid_tpu_torch.probes.poison``'s ``main`` at the serving
  geometry, after P1-P4 are held against their plain versions.

Each phase prints one JSON line; the last two lines are the ``kernels``
line and ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without the ``ok`` line; so does a machine without CUDA.
"""

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.cli import train as train_cli
from refid_tpu_torch.core.device import time_ms
from refid_tpu_torch.data.img_util import png_encode
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import (
    events_to_voxel_grid_reference, voxelize_padded_reference,
)
from refid_tpu_torch.models.convert import known_unused_keys
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion
from refid_tpu_torch.ops import build, probe_cuda
from refid_tpu_torch.probes import band_conv as probe_bc
from refid_tpu_torch.probes import poison as probe_poison
from refid_tpu_torch.tasks.base import to_nchw
from refid_tpu_torch.train.losses import charbonnier_loss
from refid_tpu_torch.train.trainer import Trainer

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 non-tensor rate, and
# dense tensor-core rates in bf16 and int8
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

BINS, WIDTH, HEIGHT = 24, 1280, 720      # blurry VFI 11+1 at 720p
FULL_EVENTS = 1 << 20
RECIPE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "options",
                      "train", "GoPro", "Final_bidirectionEncoder_XXNet_1attenfusion.yml")
TRAIN_ITERS = 8
OVERFIT_STEPS = 10
# the voxelizers' shared-memory f32 atomics add a tile's votes in varying
# order; a cell sums a few votes of |v| <= 1
KERNEL_TOL = 1e-4
SLAB_TRIAL = (30720, 61440, 122880)   # tile budgets timed beside the default (K1)
PARITY_DB = 60.0
CUDA = torch.device("cuda")
P3_STEPS = 2.0      # bf16 steps per element: float32 sums in another order
# P3/P4 shapes (H, WP, band) at the kernel's edges, beside the probe's: band
# 3 (m2 = WP, one short tile per band), m2 a whole number of tiles (384 =
# 3 x 128, 768 = 3 x 256), WP not a multiple of 8, both roll wraps in one tile
BAND_CONV_EDGES = [(9, 40, 3), (12, 648, 3), (64, 64, 8), (64, 128, 8), (48, 36, 8),
                   (48, 40, 8), (96, 40, 16)]
POISON_VARIANTS = ["torch", "cuda", "cuda_b16", "tiny", "convert"]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, message):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(bytes_moved, ops, ops_per_s):
    """The least time the card could take: bytes at the HBM rate or
    operations at ``ops_per_s``, whichever is longer."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def random_events(rng, n, width, height, cap=None, t_span=5e4):
    """``cap`` x 4 float32 buffer: n time-sorted in-frame events, then zeros."""
    ev = np.zeros((cap or n, 4), np.float32)
    ev[:n, 0] = np.sort(rng.uniform(0.0, t_span, n))
    ev[:n, 1] = rng.randint(0, width, n)
    ev[:n, 2] = rng.randint(0, height, n)
    ev[:n, 3] = rng.randint(0, 2, n)
    return ev


def skewed_events(rng, n, width, height, cap=None, rows=8):
    """``random_events`` with every event in ``rows`` rows mid-frame: events
    crowd on moving edges."""
    ev = random_events(rng, n, width, height, cap=cap)
    ev[:n, 2] = rng.randint(height // 2 - rows // 2, height // 2 + rows // 2, n)
    return ev


def one_pixel_events(rng, n, width, height, bins=BINS):
    """Every event on one pixel, with whole-bin stamps 0 .. bins - 1: each
    vote is exactly +-1 or +-0, so the cells' sums are exact in any order and
    a lost or doubled update under the contention shows."""
    ev = random_events(rng, n, width, height)
    ev[:, 0] = np.sort(rng.randint(0, bins, n))
    ev[0, 0], ev[-1, 0] = 0, bins - 1
    ev[:, 1], ev[:, 2] = width // 2, height // 2
    return ev


def edge_streams(rng):
    """The voxelizers' edge cases beside the main shape: ``{name: (events,
    width, height)}``, unpadded, 24 bins."""
    davis = random_events(rng, 60000, 346, 260)           # DAVIS346: width % 4 != 0
    davis[:, 1] = rng.randint(-2, 348, 60000)
    return {"one_pixel": (one_pixel_events(rng, 1 << 16, WIDTH, HEIGHT), WIDTH, HEIGHT),
            "davis346": (davis, 346, 260),
            "split_row": (random_events(rng, 200000, 2560, 64), 2560, 64)}


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
    skewed = skewed_events(rng, cap - 1000, WIDTH, HEIGHT, cap=cap)
    same_t = random_events(rng, 5000, WIDTH, HEIGHT, cap=1 << 14)
    same_t[:5000, 0] = 123.5
    outside = random_events(rng, 20000, WIDTH, HEIGHT, cap=1 << 15)
    outside[:20000, 1] = rng.randint(-8, WIDTH + 8, 20000)
    outside[:20000, 2] = rng.randint(-8, HEIGHT + 8, 20000)
    cases = {
        "main": (main, cap - 1000, WIDTH, HEIGHT),
        "empty": (np.zeros((1 << 14, 4), np.float32), 0, WIDTH, HEIGHT),
        "equal_stamps": (same_t, 5000, WIDTH, HEIGHT),
        "out_of_frame": (outside, 20000, WIDTH, HEIGHT),
        "skewed": (skewed, cap - 1000, WIDTH, HEIGHT),
        **{name: (ev, len(ev), w, h) for name, (ev, w, h) in edge_streams(rng).items()},
    }
    errs, votes = {}, {}
    for name, (ev, n_valid, w, h) in cases.items():
        ev_d = torch.from_numpy(ev).cuda()
        got = voxel_cuda.voxelize_cuda(ev_d, n_valid, BINS, w, h)
        torch.cuda.synchronize()
        want = voxelize_padded_reference(ev_d, n_valid, BINS, w, h)
        check(got.shape == (BINS, h, w), f"{name}: shape {tuple(got.shape)}")
        errs[name] = float((got - want).abs().max())
        votes[name] = int((got != 0).sum())
        check(errs[name] <= KERNEL_TOL, f"voxelize {name}: max|diff| {errs[name]} > {KERNEL_TOL}")
    check(votes["empty"] == 0 and min(v for k, v in votes.items() if k != "empty") > 0,
          f"unexpected nonzero cell counts {votes}")
    emit("kernel_check", kernel="voxelize", max_abs_err=errs, tol=KERNEL_TOL,
         nonzero_cells=votes)
    return max(errs.values()), main, skewed, cap - 1000


def phase_grid_kernel_check():
    """K2 (numpy in, numpy out) against its plain version on the card."""
    rng = np.random.RandomState(3)
    main = random_events(rng, FULL_EVENTS, WIDTH, HEIGHT)
    skewed = skewed_events(rng, FULL_EVENTS, WIDTH, HEIGHT)
    same_t = random_events(rng, 5000, WIDTH, HEIGHT)
    same_t[:, 0] = 123.5
    outside = random_events(rng, 20000, WIDTH, HEIGHT)
    outside[:, 1] = rng.randint(-8, WIDTH + 8, 20000)
    outside[:, 2] = rng.randint(-8, HEIGHT + 8, 20000)
    cases = {
        "main_chw": (main, BINS, "CHW", WIDTH, HEIGHT),
        "main_hwc": (main, BINS, "HWC", WIDTH, HEIGHT),
        "empty": (np.zeros((0, 4), np.float32), BINS, "HWC", WIDTH, HEIGHT),
        "equal_stamps": (same_t, BINS, "HWC", WIDTH, HEIGHT),
        "out_of_frame": (outside, BINS, "HWC", WIDTH, HEIGHT),
        "two_bins": (random_events(rng, 200000, WIDTH, HEIGHT), 2, "HWC", WIDTH, HEIGHT),
    }
    for name, (ev, w, h) in [("skewed", (skewed, WIDTH, HEIGHT)), *edge_streams(rng).items()]:
        for fmt in ("CHW", "HWC"):
            cases[f"{name}_{fmt.lower()}"] = (ev, BINS, fmt, w, h)
    errs, votes = {}, {}
    for name, (ev, bins, fmt, w, h) in cases.items():
        got = voxel_cuda.events_to_voxel_grid_cuda(ev, bins, w, h, fmt)
        want = events_to_voxel_grid_reference(
            torch.from_numpy(ev).cuda(), bins, w, h, fmt).cpu().numpy()
        shape = (h, w, bins) if fmt == "HWC" else (bins, h, w)
        check(isinstance(got, np.ndarray) and got.shape == shape,
              f"voxel_grid {name}: shape {getattr(got, 'shape', None)}")
        errs[name] = float(np.abs(got - want).max())
        votes[name] = int((got != 0).sum())
        check(errs[name] <= KERNEL_TOL,
              f"voxel_grid {name}: max|diff| {errs[name]} > {KERNEL_TOL}")
    check(votes["empty"] == 0 and min(v for k, v in votes.items() if k != "empty") > 0,
          f"unexpected nonzero cell counts {votes}")
    emit("kernel_check", kernel="voxel_grid", max_abs_err=errs, tol=KERNEL_TOL,
         nonzero_cells=votes)
    return max(errs.values()), main, skewed


def voxelization_device_ms(fn, iters):
    """Device time of one voxelization, from torch.profiler over ``iters``
    calls of ``fn()``: each device activity but the copies (the sort and
    tile kernels), averaged over the records the profiler kept, then
    summed; and those averages by name."""
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
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].strip()
            us.setdefault(name, []).append(e.time_range.elapsed_us())
    by_name = {name: sum(v) / len(v) / 1e3 for name, v in us.items()}
    check(all(any(k in name for name in by_name) for k in ("voxel_sort_kernel", "voxel_tile_kernel"))
          and max(map(len, us.values())) <= iters,
          f"profiler saw {({k: len(v) for k, v in us.items()})} for {iters} voxelizations")
    return sum(by_name.values()), by_name


def phase_kernel_timing(events, skewed, n_valid):
    """K1 at the serving shape: CUDA events per call and the profiler's
    device time per voxelization, for the uniform stream and for the skewed
    one (every event in 8 rows); the device time at each slab budget of
    SLAB_TRIAL; the plain version."""
    ev_d, sk_d = torch.from_numpy(events).cuda(), torch.from_numpy(skewed).cuda()

    def run(ev):
        return lambda: voxel_cuda.voxelize_cuda(ev, n_valid, BINS, WIDTH, HEIGHT)

    def run_slab(slab):     # the wrapper's uncounted core, at another budget
        return lambda: voxel_cuda._voxelize(ev_d, n_valid, BINS, WIDTH, HEIGHT, slab_bytes=slab)

    ms, skewed_ms = time_ms(run(ev_d), 50, CUDA), time_ms(run(sk_d), 50, CUDA)
    device_ms, by_kernel = voxelization_device_ms(run(ev_d), 20)
    skewed_device_ms, skewed_by_kernel = voxelization_device_ms(run(sk_d), 20)
    slab_trial = {slab: voxelization_device_ms(run_slab(slab), 20)[0] for slab in SLAB_TRIAL}
    plain_ms = time_ms(lambda: voxelize_padded_reference(ev_d, n_valid, BINS, WIDTH, HEIGHT),
                       20, CUDA)
    # each valid event row read once, the grid written once
    bytes_moved = n_valid * 16 + BINS * HEIGHT * WIDTH * 4
    ops = n_valid * 16   # rescale, truncate, two votes: ~16 f32 operations
    timing = {"ms": ms, "plain_ms": plain_ms, **bound(bytes_moved, ops, F32_OPS_PER_S),
              "library_ms": None, "device_ms": device_ms}
    timing["bound_share"] = timing["bound_ms"] / ms
    emit("kernel_timing", kernel="voxelize", n_valid=n_valid, bytes=bytes_moved,
         device_ms_by_kernel=by_kernel, skewed_ms=skewed_ms,
         skewed_device_ms=skewed_device_ms, skewed_device_ms_by_kernel=skewed_by_kernel,
         slab_bytes_device_ms=slab_trial, **timing)
    return timing


def phase_grid_kernel_timing(events, skewed, calls=20):
    """K2 at the datasets' shape (2**20 events, 24 bins, 720x1280, HWC):
    the wrapper's own CUDA-event split of upload, voxelization (binning and
    tile pass) and the copy back to pinned host memory, the host-clock wall
    time of a call, the profiler's device time per voxelization, the same
    for the skewed stream (every event in 8 rows), and the plain version on
    the card."""
    def run(ev):
        return lambda: voxel_cuda.events_to_voxel_grid_cuda(ev, BINS, WIDTH, HEIGHT, "HWC")

    def per_call(ev):
        for _ in range(3):
            run(ev)()
        voxel_cuda.reset_grid_stats()
        t0 = time.perf_counter()
        for _ in range(calls):
            run(ev)()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        return {k: v / calls for k, v in voxel_cuda.GRID_TIMES.items()}, wall_ms

    (per, wall_ms), (skewed_per, _) = per_call(events), per_call(skewed)
    device_ms, by_kernel = voxelization_device_ms(run(events), 10)
    skewed_device_ms, _ = voxelization_device_ms(run(skewed), 10)
    ev_d = torch.from_numpy(events).cuda()
    plain_ms = time_ms(lambda: events_to_voxel_grid_reference(
        ev_d, BINS, WIDTH, HEIGHT, "HWC"), 10, CUDA)
    n = events.shape[0]
    bytes_moved = n * 16 + BINS * HEIGHT * WIDTH * 4
    timing = {"ms": per["kernel_ms"], "plain_ms": plain_ms,
              **bound(bytes_moved, n * 16, F32_OPS_PER_S), "library_ms": None,
              "device_ms": device_ms}
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    emit("kernel_timing", kernel="voxel_grid", events=n, format="HWC",
         bytes=bytes_moved, upload_ms=per["upload_ms"], copy_ms=per["copy_ms"],
         wall_ms=wall_ms, device_ms_by_kernel=by_kernel,
         skewed_ms=skewed_per["kernel_ms"], skewed_device_ms=skewed_device_ms, **timing)
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
    """One bf16 window under torch.profiler."""
    def run():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pipe(*request)
    profile_window("profile", run, window_ms, top)


def profile_window(phase, run, window_ms, top=12):
    """``run()`` under torch.profiler: device time by kernel, and the
    device's idle share against the unprofiled wall time ``window_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
    emit(phase, dtype="bf16", device_busy_ms=busy_ms, window_ms=window_ms,
         idle_share=max(0.0, 1.0 - busy_ms / window_ms),
         kernel_launches=sum(n for _, n in by_name.values()),
         top=[{"kernel": name[:90], "ms": ms, "launches": n,
               "share": ms / busy_ms} for name, (ms, n) in ranked[:top]])


def write_gopro_tree(root, seed=0, num_blur=4, num_gt=48, num_windows=47,
                     events_per_window=FULL_EVENTS // BINS):
    """A GoPro-layout tree at 1280x720, one video: ``num_blur`` blur frames,
    ``num_gt`` gt frames (PNG, the port's writer) and ``num_windows`` event
    windows, so that one blur-VFI 11+1 item votes about 2**20 events."""
    rng = np.random.RandomState(seed)
    video = os.path.join(root, "train", "SYNTH")
    ev_dir = os.path.join(root, "train_event", "SYNTH")
    for sub in ("blur", "gt"):
        os.makedirs(os.path.join(video, sub), exist_ok=True)
    os.makedirs(ev_dir, exist_ok=True)
    # smooth frames: a coarse random field, upsampled, plus noise
    coarse = rng.rand(num_blur + num_gt, HEIGHT // 40, WIDTH // 40, 3) * 200
    for k in range(num_blur + num_gt):
        img = np.kron(coarse[k], np.ones((40, 40, 1))) + rng.rand(HEIGHT, WIDTH, 3) * 55
        sub, idx = ("blur", k) if k < num_blur else ("gt", k - num_blur)
        with open(os.path.join(video, sub, "%06d.png" % idx), "wb") as f:
            f.write(png_encode(img.astype(np.uint8)))
    for k in range(num_windows):
        n = events_per_window
        np.savez(os.path.join(ev_dir, "%06d.npz" % k),
                 timestamp=np.sort(rng.uniform(k * 1e4, (k + 1) * 1e4, n)).astype(np.float32),
                 x=rng.randint(0, WIDTH, n).astype(np.int16),
                 y=rng.randint(0, HEIGHT, n).astype(np.int16),
                 polarity=rng.randint(0, 2, n).astype(np.int8))


def recipe_overrides(opt, data_root, name, dtype):
    """The production recipe as ``chip_smoke`` trains it: validation removed
    (it comes with the eval slice), the synthetic tree, a log line per
    iteration, no periodic checkpoints, no TensorBoard, and the compute
    dtype.  Everything else (network, crop, flips, sampler, loader,
    optimiser, schedule, loss, remat) is the recipe's."""
    opt = json.loads(json.dumps(opt))
    opt.pop("val", None)
    opt["datasets"].pop("val", None)
    opt["name"] = name
    opt["datasets"]["train"].update(dataroot=data_root, video_list=["SYNTH"])
    opt["logger"].update(print_freq=1, save_checkpoint_freq=0, use_tb_logger=False)
    if dtype == "bf16":
        opt["network_g"]["compute_dtype"] = "bfloat16"
    return opt


def phase_train_parity(state):
    """One optimiser step of the recipe's network and optimiser, t=23 on a
    32x48 crop, on the card (TF32 off) and on the CPU from the same weights
    and batch."""
    import yaml

    with open(RECIPE) as f:
        train_opt = yaml.safe_load(f)["train"]
    set_tf32(False)
    rng = np.random.RandomState(4)
    h, w, t = 32, 48, 23
    batch = [rng.rand(1, h, w, 26), rng.randn(1, t, h, w, 2), rng.rand(1, t, h, w, 3)]
    results = {}
    for device in ("cuda", "cpu"):
        net = FinalBidirectionAttenfusion(RefidConfig(remat=True))
        net.load_state_dict(state)
        net.to(device)
        trainer = Trainer(net, charbonnier_loss, train_opt, train_opt["total_iter"],
                          frozen=known_unused_keys(net))
        before = {k: p.detach().clone() for k, p in trainer.named}
        args = [to_nchw(torch.from_numpy(a.astype(np.float32)).to(device)) for a in batch]
        metrics = trainer.train_step(*args)
        after = {k: p.detach().float().cpu() for k, p in trainer.named}
        results[device] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                           torch.cat([(after[k] - before[k].cpu()).flatten() for k in after]),
                           torch.cat([after[k].flatten() for k in after]))
    (lc, gc, dc, pc), (lp, gp, dp, pp) = results["cuda"], results["cpu"]
    update_db, params_db = parity_db(dp, dc), parity_db(pp, pc)
    emit("train_parity", shape=[32, 48], t=23, loss_cuda=lc, loss_cpu=lp,
         loss_rel_diff=abs(lc - lp) / abs(lp), grad_norm_rel_diff=abs(gc - gp) / abs(gp),
         update_db=update_db, params_db=params_db, min_db=PARITY_DB)
    check(math.isfinite(lc) and abs(lc - lp) / abs(lp) < 1e-4,
          f"train step loss card {lc} vs CPU {lp}")
    check(update_db >= PARITY_DB and params_db >= PARITY_DB,
          f"train step card vs CPU: update {update_db:.1f} dB, params "
          f"{params_db:.1f} dB < {PARITY_DB}")


def phase_train(data_root, work, dtype):
    """The recipe through the train CLI's ``main``; returns the task."""
    import yaml

    with open(RECIPE) as f:
        opt = recipe_overrides(yaml.safe_load(f), data_root, f"chip_smoke_{dtype}", dtype)
    path = os.path.join(work, f"{dtype}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    voxel_cuda.reset_grid_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = train_cli.main(["-opt", path, "--root", work, "--max-iters", str(TRAIN_ITERS)])
    seconds = time.perf_counter() - t0
    timing = dict(task.train_loader.dataset.timing)
    items, launches = timing.pop("items"), voxel_cuda.GRID_LAUNCHES
    losses = [h["loss"] for h in task.history]
    step_ms = [h["time"] * 1e3 for h in task.history]
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(v) for v in losses),
          f"{dtype} training losses {losses}")
    check(items > 0 and launches == items,
          f"{dtype} training: K2 launched {launches} times for {items} items")
    per_item = {k: v / items for k, v in timing.items()}
    per_item.update({k.replace("_ms", "_cuda_ms"): v / launches
                     for k, v in voxel_cuda.GRID_TIMES.items()})
    emit("train", dtype=dtype, iters=TRAIN_ITERS, crop=opt["datasets"]["train"]["gt_size"],
         t=23, losses=losses, step_ms=step_ms,
         mean_step_ms_after_first=sum(step_ms[1:]) / len(step_ms[1:]),
         items_loaded=items, voxel_grid_launches=launches, data_ms_per_item=per_item,
         max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=seconds)
    return task, launches


def timed_steps(task, batch, steps):
    """Host-clock ms of each of ``steps`` train steps on one host batch
    (copy to the card included, no data loading), and their losses."""
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(task.train_step(batch)["loss"]))   # syncs
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def phase_overfit(task):
    """One fixed batch from the loader, OVERFIT_STEPS steps: the loss falls."""
    batch = next(iter(task.train_loader))
    losses, ms = timed_steps(task, batch, OVERFIT_STEPS)
    emit("overfit", dtype="f32", steps=OVERFIT_STEPS, losses=losses, step_ms=ms,
         mean_step_ms_after_first=sum(ms[1:]) / len(ms[1:]))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"fixed-batch loss did not fall: {losses}")
    return batch


def phase_train_profile(task, batch, top=12):
    """bf16 training steps on one fixed batch: the batch's copy to the card
    alone, host-clock step times without data loading, and one step under
    torch.profiler against that step time."""
    h2d = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task._ready(task._to_device(batch))
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    _, ms = timed_steps(task, batch, 4)
    step_ms = sum(ms[1:]) / len(ms[1:])
    emit("train_fixed_batch", dtype="bf16", h2d_ms=h2d, step_ms=ms,
         mean_step_ms_after_first=step_ms,
         batch_bytes=sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray)))
    profile_window("train_profile", lambda: task.train_step(batch), step_ms, top)


def kernel_device_ms(fn, iters, name_part):
    """Device time per launch of the kernels whose name holds ``name_part``
    over ``iters`` calls of ``fn()``, from torch.profiler: for a kernel
    whose calls the host cannot launch as fast as the card runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name_part in e.name]
    # the profiler may drop some device records of a long session: average
    # those it kept
    check(0 < len(us) <= iters, f"profiler saw {len(us)} {name_part} launches for {iters} calls")
    return sum(us) / len(us) / 1e3


def _probe_d(gen, dtype):
    """The poison probe's scale-1 activation: (1, 64, 360, 640) channels_last."""
    return (torch.randn(1, 64, 360, 640, generator=gen) * 50).to("cuda", dtype).contiguous(
        memory_format=torch.channels_last)


def phase_probe_kernel_check():
    """P1-P4 against their plain versions on the card at the probes' shapes:
    P1 and P2 bit-exact in bf16 and float32 on the poison probe's
    (1, 64, 360, 640); P3 within P3_STEPS bf16 steps (floored near zero) and
    >= PARITY_DB, rolls on and off, and P4 bit-exact in its three variants,
    at (720, 648, 128) and at BAND_CONV_EDGES; one full-geometry poison step
    of each kernel variant against ``torch``.  Times P1 and P2 (CUDA events
    per call, and the kernel's device time from the profiler; plain version;
    library call), the plain versions of P3 and P4 and the device time of
    the three band-conv kernels; the probe run times P3 and P4 per call."""
    gen = torch.Generator().manual_seed(5)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        d = _probe_d(gen, dtype)
        want = probe_poison.passthrough_reference(d)
        for band in (8, 16):
            got = probe_poison.passthrough(d, band)
            errs["passthrough"] = max(errs.get("passthrough", 0.0),
                                      float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, want), f"P1 {dtype} band {band} differs from 2x + 1")
        got = probe_poison.tiny_passthrough(d.clone())
        want = probe_poison.tiny_passthrough_reference(d.clone())
        errs["passthrough_slice"] = max(errs.get("passthrough_slice", 0.0),
                                        float((got.float() - want.float()).abs().max()))
        check(torch.equal(got, want), f"P2 {dtype} differs from 2x + 1 on the slice")
    d = _probe_d(gen, torch.bfloat16)
    scratch = d.clone()
    p1 = {"ms": time_ms(lambda: probe_poison.passthrough(d), 50, CUDA),
          "plain_ms": time_ms(lambda: probe_poison.passthrough_reference(d), 50, CUDA),
          "library_ms": time_ms(lambda: d * 2.0 + 1.0, 50, CUDA),
          **bound(2 * d.numel() * d.element_size(), 2 * d.numel(), F32_OPS_PER_S)}
    p2 = {"ms": time_ms(lambda: probe_poison.tiny_passthrough(scratch), 50, CUDA),
          "plain_ms": time_ms(lambda: probe_poison.tiny_passthrough_reference(scratch), 50, CUDA),
          "library_ms": None, **bound(2 * 8 * 128 * 2, 2 * 8 * 128, F32_OPS_PER_S)}
    p1_device_ms = kernel_device_ms(lambda: probe_poison.passthrough(d), 20,
                                    "passthrough_kernel")
    p2_device_ms = kernel_device_ms(lambda: probe_poison.tiny_passthrough(scratch), 20,
                                    "passthrough_slice_kernel")
    del d, scratch

    # P3 and P4 at the probe's shape and at the kernel's edges (see
    # BAND_CONV_EDGES), rolls on and off, P4 in its three modes
    steps, dbs = {}, {}
    for h, wp, band in [(probe_bc.H, probe_bc.WP, 8), *BAND_CONV_EDGES]:
        probe_shape = (h, wp) == (probe_bc.H, probe_bc.WP)
        x = torch.randn(h, wp, probe_bc.C, generator=gen).to("cuda", torch.bfloat16)
        w = (0.05 * torch.randn(3, 3, probe_bc.C, probe_bc.C, generator=gen)).to(
            "cuda", torch.bfloat16)
        for rolls in (True, False):
            name = ("tap_roll" if rolls else "tap_noroll") + (
                "" if probe_shape else f"_{h}x{wp}_b{band}")
            got = probe_bc.band_conv(x, w, band, rolls)
            want = probe_bc.band_conv_reference(x, w, band, rolls)
            floor = probe_bc.STEP_FLOOR * float(want.float().abs().max())
            steps[name] = float(probe_bc.bf16_steps(got, want, floor).max())
            dbs[name] = parity_db(want.float(), got.float())
            errs[name] = float((got.float() - want.float()).abs().max())
            check(steps[name] <= P3_STEPS and dbs[name] >= PARITY_DB,
                  f"P3 {name}: {steps[name]} bf16 steps, {dbs[name]:.1f} dB")
        xs = x * 4 if not probe_shape else x     # small shapes: the int8 range spread out
        wq, xq = probe_bc.quantize(w, 0.01), probe_bc.quantize(xs, 0.05)
        for kind in ("roll", "noroll", "pre"):
            name = f"int8_{kind}" + ("" if probe_shape else f"_{h}x{wp}_b{band}")
            xi = xq if kind == "pre" else xs
            args = dict(rolls=kind != "noroll", in_int8=kind == "pre")
            got = probe_bc.band_conv_int8(xi, wq, band, **args)
            want = probe_bc.band_conv_int8_reference(xi, wq, band, **args)
            errs[name] = float((got.float() - want.float()).abs().max())
            check(torch.equal(got, want), f"P4 {name} differs from its plain version")
        if probe_shape:
            p3_plain_ms = time_ms(lambda: probe_bc.band_conv_reference(x, w, 8), 5, CUDA,
                                  warmup=1)
            p4_plain_ms = time_ms(lambda: probe_bc.band_conv_int8_reference(x, wq, 8), 3,
                                  CUDA, warmup=1)
            device_ms = {
                "band_conv": kernel_device_ms(lambda: probe_bc.band_conv(x, w, 8), 20,
                                              "band_conv_kernel<0>"),
                "band_conv_int8": kernel_device_ms(
                    lambda: probe_bc.band_conv_int8(x, wq, 8), 20, "band_conv_kernel<1>"),
                "band_conv_int8_pre": kernel_device_ms(
                    lambda: probe_bc.band_conv_int8(xq, wq, 8, in_int8=True), 20,
                    "band_conv_kernel<2>")}
    del x, w, xs, wq, xq, got, want

    e_np, params_np = probe_poison.random_inputs(0)
    e0 = probe_poison.to_nchw(e_np, "cuda")
    params = probe_poison.params_from_jax(params_np, "cuda")
    base = probe_poison.make_step("torch", params)(e0).float()
    step_db = {}
    for variant in POISON_VARIANTS[1:]:
        out = probe_poison.make_step(variant, params)(e0)
        check(out.shape == e0.shape and bool(torch.isfinite(out).all()),
              f"poison step {variant}: shape {tuple(out.shape)} or not finite")
        step_db[variant] = parity_db(base, out.float())
        if variant != "tiny":       # tiny applies 2x + 1 twice on its slice
            check(step_db[variant] >= PARITY_DB,
                  f"poison step {variant} vs torch {step_db[variant]:.1f} dB")
    emit("probe_kernel_check", p1_p2="bit-exact (bf16, f32; bands 8, 16)", p3_steps=steps,
         p3_db=dbs, p3_max_steps=P3_STEPS, min_db=PARITY_DB, p4="bit-exact",
         max_abs_err=errs, poison_step_db_vs_torch=step_db, p1=p1, p2=p2,
         p1_device_ms=p1_device_ms, p2_device_ms=p2_device_ms,
         p3_plain_ms=p3_plain_ms, p4_plain_ms=p4_plain_ms, p3_p4_device_ms=device_ms,
         edges=[list(e) for e in BAND_CONV_EDGES])
    return errs, p1, p2, p3_plain_ms, p4_plain_ms, device_ms


def phase_probe_band_conv():
    """The band-conv probe's ``main`` at the serving geometry, every variant,
    with each one's bound and the share of it reached."""
    results = probe_bc.main(["--variants", *probe_bc.VARIANTS, "--iters", "32"])
    by_name = {}
    for r in results:
        work = probe_bc.work(r["variant"])
        r.update(bound(work["bytes"], work["ops"],
                       INT8_OPS_PER_S if work["int8"] else BF16_OPS_PER_S))
        if "l2_bytes" in work:
            r["l2_bytes"] = work["l2_bytes"]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        by_name[r["variant"]] = r
    emit("probe_band_conv", variants=results)
    return by_name


def phase_probe_poison():
    """The poison probe's ``main`` at full serving geometry: ms per step."""
    results = probe_poison.main(["--variants", *POISON_VARIANTS, "--steps", "3",
                                 "--iters", "16"])
    check(all(math.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0 for r in results),
          f"poison probe times {results}")
    emit("probe_poison", variants=results)


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

    max_err, events, skewed, n_valid = phase_kernel_check()
    timing = phase_kernel_timing(events, skewed, n_valid)
    grid_err, grid_events, grid_skewed = phase_grid_kernel_check()
    grid_timing = phase_grid_kernel_timing(grid_events, grid_skewed)

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
    del pipe, requests, out32, out16

    phase_train_parity(state)
    logging.getLogger("refid_tpu_torch").setLevel(logging.WARNING)   # the CLI's log
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "gopro")
        t0 = time.perf_counter()
        write_gopro_tree(data_root)
        emit("train_data", seconds=time.perf_counter() - t0, frame=[HEIGHT, WIDTH],
             events_per_item=FULL_EVENTS // BINS * BINS)
        torch.backends.cudnn.allow_tf32 = True       # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        voxel_cuda.LAUNCHES = 0                    # the training path starts here
        task, grid_launches = phase_train(data_root, work, "f32")
        phase_overfit(task)
        del task
        task, bf16_launches = phase_train(data_root, work, "bf16")
        grid_launches += bf16_launches
        check(voxel_cuda.LAUNCHES == 0, "training launched the serving voxelizer K1")
        batch = next(iter(task.train_loader))
        phase_train_profile(task, batch)            # ... and ends here
        del task

    t0 = time.perf_counter()
    probe_errs, p1, p2, p3_plain_ms, p4_plain_ms, device_ms = phase_probe_kernel_check()
    probe_cuda.reset_launches()                     # the probe path starts here
    rates = phase_probe_band_conv()
    phase_probe_poison()
    probe_launches = {"passthrough": probe_cuda.PASSTHROUGH_LAUNCHES,
                      "passthrough_slice": probe_cuda.SLICE_LAUNCHES,
                      "band_conv": probe_cuda.BAND_CONV_LAUNCHES,
                      "band_conv_int8": probe_cuda.BAND_CONV_INT8_LAUNCHES}   # ... and ends here
    emit("probe_path", launches=probe_launches, seconds=time.perf_counter() - t0)
    check(min(probe_launches.values()) > 0, f"a probe kernel was not launched: {probe_launches}")

    def rate_entry(variant, plain_ms, library, kernel):
        r = rates[variant]
        return {"ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": rates[library]["ms"],
                "device_ms": device_ms[kernel], "bound_share": r["bound_ms"] / r["ms"]}

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "voxelize", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxelize.cu",
        "replaces": "refid_tpu/events/voxel_pallas.py:311",
        "launches": launches, "max_abs_err": max_err, **timing}, {
        "name": "voxel_grid", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxelize.cu",
        "replaces": "refid_tpu/events/voxel_pallas.py:129",
        "launches": grid_launches, "max_abs_err": grid_err, **grid_timing}, {
        "name": "passthrough", "route": "cuda",
        "source": "refid_tpu_torch/csrc/passthrough.cu",
        "replaces": "scripts/probe_poison.py:56",
        "launches": probe_launches["passthrough"], "max_abs_err": probe_errs["passthrough"],
        **p1}, {
        "name": "passthrough_slice", "route": "cuda",
        "source": "refid_tpu_torch/csrc/passthrough.cu",
        "replaces": "scripts/probe_poison.py:70",
        "launches": probe_launches["passthrough_slice"],
        "max_abs_err": probe_errs["passthrough_slice"], **p2}, {
        "name": "band_conv", "route": "cuda",
        "source": "refid_tpu_torch/csrc/band_conv.cu",
        "replaces": "scripts/probe_band_conv.py:62",
        "launches": probe_launches["band_conv"], "max_abs_err": probe_errs["tap_roll"],
        **rate_entry("tap_roll", p3_plain_ms, "library_conv", "band_conv")}, {
        "name": "band_conv_int8", "route": "cuda",
        "source": "refid_tpu_torch/csrc/band_conv.cu",
        "replaces": "scripts/probe_band_conv.py:113",
        "launches": probe_launches["band_conv_int8"], "max_abs_err": probe_errs["int8_roll"],
        **rate_entry("int8_roll", p4_plain_ms, "library_int8", "band_conv_int8")}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
