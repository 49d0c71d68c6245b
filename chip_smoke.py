#!/usr/bin/env python3
"""On-card smoke test of refid_tpu_torch, the PyTorch / CUDA port.

Run from the root of a checkout on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

It builds the CUDA kernels from ``refid_tpu_torch/csrc``, measures the
launch path they share (``launch_path``: each wrapper's host time a call and
where it goes, beside the floors; ``tools/launch_path.py``), holds each
kernel against its plain PyTorch version on the card, and drives the port's
two main paths with production-width ``RefidConfig()`` networks and seeded
random weights:

* serving (K1): ``BlurVFIPipeline``, blurry VFI 11+1, against the same
  pipeline on the CPU, then full-size 1280x720 windows with 2**20 events in
  float32 and bf16;
* training (K2): one optimiser step on the card against the CPU, then the
  recipe ``options/train/GoPro/Final_bidirectionEncoder_XXNet_1attenfusion.yml``
  (validating every ``VAL_FREQ`` iterations) through
  ``python -m refid_tpu_torch.cli.train``'s ``main`` on a synthetic 1280x720
  GoPro tree written to a temporary directory, in float32 and bf16, and a
  fixed batch overfitted for 10 steps;
* evaluation (K2): ``python -m refid_tpu_torch.cli.test``'s entry on
  ``options/test/GoPro/Test_Final_1skip.yml`` pointed at the same tree and
  at a checkpoint of the seeded weights, after PSNR / SSIM on the card are
  held against the CPU;
* int8 serving (``quantize_int8``, ``conv_int8``): both kernels against
  their plain versions at every production int8 conv shape and at the edge
  shapes of the conv's tile plan (one for each tile variant and store
  path), their times at the scale-1 and scale-2 trunk ``conv_in`` and the
  ``dec2_trunk`` shapes beside cuDNN's bf16 channels_last conv and nine
  ``torch._int_mm`` taps (the quantization dynamic and static), then 1280x720 windows
  with 2**20 events in ``int8=True``, ``"scale0"`` and ``"static"``
  (calibrated on another window) under bf16 autocast, each against the
  float32 window;
* single-image deblurring (K2, the normalisation VN, ``quantize_int8``,
  ``conv_int8``): VN (``voxel_norm_np`` on K2's page-locked grid) against
  the numpy chain at 720x1280x6, the
  full-width EVHINet card against CPU at 256x256, both int8 kernels against
  their plain versions at EVHINet's 14 int8 site shapes, 1280x720 images
  (6-bin voxels from K2) in float32, bf16, int8 ``True`` and ``"static"``
  (each against float32, gated at 50 dB), then ``python -m
  refid_tpu_torch.cli.test``'s entry on the synthetic tree's single-image
  items (whole and tiled) and ``python -m refid_tpu_torch.cli.demo``'s
  ``main`` on one frame;
* the IO and training tail (K2): the host PNG codec on a 1280x720 frame
  (decode per row filter, adaptive and Adam7 through the C unfilter, held
  byte for byte against the plain Python unfilter; the write split into
  packing, zlib, chunks and file write for the earlier writer and the
  current one; the recipe's train items from the filter-0 tree and a
  filter-4 copy),
  one full-width EVHINet optimiser step card against CPU, EVHINet trained
  through the train CLI's ``main`` in float32 and bf16 with validations and
  its TensorBoard file read back, and one item of each deblur dataset and
  of BS-ERGB built on the card against the CPU;
* released-checkpoint evaluation (K2, ``quantize_int8``, ``conv_int8``):
  ``scripts/eval_released_torch.py`` on the seeded weights saved as
  ``.pth`` files, the flagship through ``Test_Final_1skip.yml`` in float
  (equal to the test CLI's results) and both int8 modes, EVHINet tiled in
  float (equal to the test CLI's) and int8, and the HighREV option file
  ``Test_UND_Final_1skip.yml`` on a HighREV-layout copy of the tree;
* the padded-capacity voxelizer entry (K1) at the serving shape;
* the probes (P1-P4): ``python -m refid_tpu_torch.probes.band_conv``'s and
  ``python -m refid_tpu_torch.probes.poison``'s ``main`` at the serving
  geometry, after P1-P4 are held against their plain versions;
* distribution and the process loader (K1, K2), last: the recipe's items
  through ``prefetch_mode: process`` against the thread loader
  (``mp_loader``), the recipe through the train CLI as one torchrun rank
  over NCCL against a plain process (``ddp_train``), then two gloo ranks
  spawned on the one card: the collectives the halo exchange needs, the
  flagship at a toy width row-sharded against whole (forward, and two
  steps at data 1 x spatial 2 and data 2 x spatial 1; ``spatial_parity``),
  720p windows through ``BlurVFIPipeline(mesh=)`` (``spatial_serve``: two
  ranks sharing one card time the exchange overhead, not scaling), then the
  other configurations on the shards: 720p int8 windows in every mode
  against the whole int8 window (``spatial_int8``), every ablation lineage
  at its production widths on the toy geometry (``spatial_ablation``), two
  lineages' 720p windows through ``BlurVFIPipeline(mesh=)``
  (``spatial_lineage_serve``) and a 720p EVHINet image and step
  (``spatial_evhinet``); ``spatial_int8_kernel_check`` holds both int8
  kernels as a shard runs them (row padding 0, a device amax) after
  ``int8_kernel_check``.

Each phase prints one JSON line; the last two lines are the ``kernels``
line and ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without the ``ok`` line; so does a machine without CUDA.
"""

import importlib.util
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import struct
import tempfile
import time
import zlib
from unittest import mock

import numpy as np
import torch

from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.cli import demo as demo_cli
from refid_tpu_torch.cli import test as test_cli
from refid_tpu_torch.cli import train as train_cli
from refid_tpu_torch.core.checkpoint import CheckpointManager
from refid_tpu_torch.core.device import time_ms
from refid_tpu_torch.core.registry import ARCHS
from refid_tpu_torch.core.tb_writer import read_scalars
from refid_tpu_torch.data import img_util
from refid_tpu_torch.data.datasets.base import GOPRO_TEST_VIDEOS
from refid_tpu_torch.data.img_util import imread, png_encode, tensor2img
from refid_tpu_torch.data.loader import build_dataset
from refid_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.events.voxel import (
    events_to_voxel_grid, events_to_voxel_grid_padded, events_to_voxel_grid_reference,
    pad_events, voxel_norm, voxel_norm_np, voxelize_padded_reference,
)
from refid_tpu_torch.models import archs as _archs  # noqa: F401 (registers the archs)
from refid_tpu_torch.models.convert import known_unused_keys, load_state
from refid_tpu_torch.models.evhinet import EVHINet
from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion
from refid_tpu_torch.ops import build, int8_cuda, probe_cuda
from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
from refid_tpu_torch.probes import band_conv as probe_bc
from refid_tpu_torch.probes import poison as probe_poison
from refid_tpu_torch.serve import quant
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.tasks.base import to_nchw
from refid_tpu_torch.train.losses import charbonnier_loss
from refid_tpu_torch.train.trainer import Trainer

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 and float64 non-tensor
# rates, and dense tensor-core rates in bf16 and int8
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

BINS, WIDTH, HEIGHT = 24, 1280, 720      # blurry VFI 11+1 at 720p
FULL_EVENTS = 1 << 20
OPTIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "options")
RECIPE = os.path.join(OPTIONS, "train", "GoPro", "Final_bidirectionEncoder_XXNet_1attenfusion.yml")
EVAL_OPTIONS = os.path.join(OPTIONS, "test", "GoPro", "Test_Final_1skip.yml")
HIGHREV_OPTIONS = os.path.join(OPTIONS, "test", "HighREV", "Test_UND_Final_1skip.yml")
EVAL_RELEASED = os.path.join(os.path.dirname(OPTIONS), "scripts", "eval_released_torch.py")
RELEASED_ITEMS = 2                 # the flagship's items (all of the tree's test split)
RELEASED_INT8_DB = 1.0             # int8 PSNR within this of float (the JAX script's test)
TABLE_HEADER = "| Metric | Value | Hardware | Source |"
TRAIN_ITERS = 8
VAL_FREQ = 4                  # validations after iterations 4 and 8
PADDED_EVENTS = (1 << 20) - 48576     # 10**6 events: the entry pads them to 2**20
METRIC_TOL = 1e-5             # PSNR (dB) and SSIM, card against CPU
OVERFIT_STEPS = 10
# the voxelizers' shared-memory f32 atomics add a tile's votes in varying
# order; a cell sums a few votes of |v| <= 1
KERNEL_TOL = 1e-4
# the card normalisation against the numpy chain: the card sums in float64,
# numpy in float32 (test_torch_data.py::test_voxel_helpers_match_jax's tolerance)
NORM_RTOL, NORM_ATOL = 1e-6, 1e-7
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
# the int8 sites' convs at 1280x720: name -> (Cin, Cout, output H, W, kernel,
# stride); each 3x3 has padding 1, each 4x4/2 padding 1
INT8_CONV_SHAPES = {
    "scale1_trunk_in": (256, 128, 360, 640, 3, 1), "scale1_trunk": (128, 128, 360, 640, 3, 1),
    "scale1_down": (128, 128, 180, 320, 4, 2), "scale2_stage": (128, 256, 180, 320, 3, 1),
    "scale2_trunk_in": (512, 256, 180, 320, 3, 1), "scale2_trunk": (256, 256, 180, 320, 3, 1),
    "scale2_down": (256, 256, 90, 160, 4, 2), "resblock": (256, 256, 90, 160, 3, 1),
    "dec0_trunk_in": (256, 128, 180, 320, 3, 1), "dec0_trunk": (128, 128, 180, 320, 3, 1),
    "scale0_trunk_in": (128, 64, 720, 1280, 3, 1), "scale0_trunk": (64, 64, 720, 1280, 3, 1),
    "dec1_trunk_in": (128, 64, 360, 640, 3, 1), "dec1_trunk": (64, 64, 360, 640, 3, 1),
    "dec2_trunk_in": (64, 32, 720, 1280, 3, 1), "dec2_trunk": (32, 32, 720, 1280, 3, 1)}
INT8_TIMED = ("scale1_trunk_in", "scale2_trunk_in", "dec2_trunk")
# conv_int8 at the edges of its tile plan (ops/int8_cuda.py::conv_plan), one
# case for each variant and store path: (n, Cin, Cout, H, W, kernel, stride,
# padding) -> N 16, 32, 64 (operands swapped), 128 (Cout 136, 256: two
# tiles); K chunks of 32 (cp 32, 96), 64 and 128 bytes; weights resident and
# streamed; 1x1, 3x3/1, 4x4/2 (odd input height too); rows that take 16-byte
# stores and rows that do not (widths 19, 13; 20 in bf16); n = 2
INT8_EDGE_SHAPES = [(1, 16, 16, 24, 40, 3, 1, 1), (2, 32, 32, 20, 19, 3, 1, 1),
                    (1, 64, 64, 33, 72, 3, 1, 1), (2, 64, 64, 16, 20, 1, 1, 0),
                    (1, 128, 128, 30, 64, 4, 2, 1), (1, 96, 136, 14, 22, 3, 1, 1),
                    (1, 256, 256, 24, 48, 3, 1, 1), (2, 40, 136, 13, 20, 4, 2, 1),
                    (1, 512, 64, 12, 16, 1, 1, 0), (1, 24, 40, 9, 13, 3, 1, 1)]
INT8_SITES = {True: 575, "scale0": 713, "static": 851}     # a t = 23 window
# single-image deblurring: EVHINet at the width the repo defines, 6 voxel
# bins, a request's events about ten 43690-event windows (the datasets'
# +-5-frame window)
EVHINET_NET = {"type": "SingleMultiConnectEVHINet", "in_chn": 3, "ev_chn": 6, "wf": 64,
               "depth": 3, "fac_place": 2, "hin_position_left": 0, "hin_position_right": 4}
EV_BINS = 6
EV_EVENTS = 1 << 19
EVHINET_IMAGES = 42                # calibration, warm-up, 40 timed
EVHINET_PARITY_CROP = 256
# float32 card against CPU reads ~138 dB and bf16 against float32 ~74 dB: the
# bar between them fails a forward that leaks reduced precision (TF32, autocast)
EVHINET_PARITY_DB = 100.0
EVHINET_CROP = 256                 # the tiled evaluation's crop_size
# EVHINet training (no shipped option file fixes the batch) and the new
# datasets' items: 6-bin single-image items, crops of ITEM_CROP
EVHINET_TRAIN_BATCH = 4
ITEM_CROP = 256
EVHINET_TRAIN_PARITY_CROP = 64
PNG_REPEATS = 5                    # decode and write timings: the median
PNG_DATA_ITEMS = 2                 # the recipe's train items read from each tree
EVHINET_SITES = 25
# the ablation lineages (registry name, recurrent_block_type): the 13 cases of
# tests/test_ablation_shapes.py, UNetPSDecoderRecurrent/convgru of
# tests/test_ablation_parity.py and FinalBidirection; then one with the DCN
# first conv (use_first_dcn)
ABLATIONS = [("UNetRecurrent", "convlstm", False), ("UNetRecurrent", "convgru", False),
             ("UNetDecoderRecurrent", "simpleconv", False),
             ("UNetDecoderRecurrent", "simpleconvThendown", False),
             ("UNetDecoderRecurrent", "convlstm", False),
             ("UNetDecoderRecurrent", "convgru", False),
             ("BidirUNetRecurrent", "simpleconv", False),
             ("UNetDecoderRecurrentBidirection", "simpleconv", False),
             ("UNetDecoderRecurrentBidirection", "simpleconvThendown", False),
             ("UNetDecoderRecurrentAllBidirection", "simpleconvThendown", False),
             ("UNetPSDecoderRecurrent", "convlstm", False),
             ("UNetDecoderRecurrentSiameseImg", "simpleconvThendown", False),
             ("UNetDecoderRecurrentSiameseImgNoAtten", "simpleconvThendown", False),
             ("UNetPSDecoderRecurrent", "convgru", False),
             ("FinalBidirection", None, False),
             ("UNetDecoderRecurrent", "simpleconv", True)]
ABLATION_PARITY_SIZE, ABLATION_PARITY_T = 128, 5
ABLATION_WINDOWS = 3               # a dtype's windows: 1 warm-up, 2 timed
# the ablation_train phase's networks: (name, recurrent_block_type, overrides)
ABLATION_TRAIN = [("UNetRecurrent", "convlstm", {}), ("UNetPSDecoderRecurrent", "convgru", {}),
                  ("UNetDecoderRecurrentAllBidirection", None, {}),
                  ("UNetDecoderRecurrentSiameseImg", None, {}),
                  ("FinalBidirectionAttenfusion", None, {"remat_policy": "all"}),
                  ("FinalBidirectionAttenfusion", None, {"remat_policy": "stage_outputs"})]
ABLATION_TRAIN_ITERS = 3
ABLATION_FIXED_STEPS = 3           # timed steps on one batch after the CLI's
# distribution: the recipe through cli.train as one torchrun rank over NCCL
# and as a plain process; the spatial axis at 2 ranks sharing the one card
# over gloo (a toy width for parity, full width for serving); the loaders
DDP_ITERS = 3
SPATIAL_RANKS = 2
SPATIAL_TOY = {"base_num_channels": 8}          # num_encoders 3: blocks of 8 rows
SPATIAL_TOY_SHAPE = (2, 5, 64, 96)              # batch, t, h, w
SPATIAL_FORWARD_DB = 100.0
SPATIAL_WINDOWS = 3                             # 1 warm-up, 2 timed
# bf16 sharded against bf16 whole: each side rounds on its own (bf16 against
# f32 reads ~60 dB); a row lost at a shard edge reads below 20
SPATIAL_SERVE_MIN_DB = 40.0
SPATIAL_TIMEOUT = 600
# the spatial phases of the other configurations: 720p int8 windows a
# mode (static calibrated on another window first; 1 warm-up, 1 timed), the
# ablation lineages at their production widths on SPATIAL_TOY_SHAPE's
# geometry, two of them also served at 720p through BlurVFIPipeline(mesh=)
# (the bilinear decoder's edge halos and ConvLSTM gates; the DCN's gather),
# a 720p EVHINet image and one EVHINet step at (batch, crop); a sharded
# step's loss and gradient norm within SPATIAL_STEP_RTOL of the whole step's
SPATIAL_INT8_WINDOWS = 2
SPATIAL_LINEAGES_SERVED = [("UNetRecurrent", "convlstm", False),
                           ("UNetDecoderRecurrent", "simpleconv", True)]
SPATIAL_LINEAGE_WINDOWS = 2                     # 1 warm-up, 1 timed
SPATIAL_EVHINET_STEP = (2, 64)
SPATIAL_STEP_RTOL = 1e-4
LOADER_EPOCHS = 2
# EVHINet's int8 sites at 1280x720 by distinct (Cin, Cout, H, W, kernel): stride
# 1, padding kernel // 2, no fused activation (refid_tpu/serve/evhinet_fast.py)
EVHINET_INT8_SHAPES = {
    "full_3x3": (64, 64, 720, 1280, 3), "full_identity": (64, 64, 720, 1280, 1),
    "full_merge": (64, 128, 720, 1280, 1), "upblk1_conv_1": (128, 64, 720, 1280, 3),
    "upblk1_identity": (128, 64, 720, 1280, 1), "half_conv_1": (64, 128, 360, 640, 3),
    "half_3x3": (128, 128, 360, 640, 3), "half_identity": (64, 128, 360, 640, 1),
    "half_merge": (128, 256, 360, 640, 1), "upblk0_conv_1": (256, 128, 360, 640, 3),
    "upblk0_identity": (256, 128, 360, 640, 1), "quarter_conv_1": (128, 256, 180, 320, 3),
    "quarter_3x3": (256, 256, 180, 320, 3), "quarter_identity": (128, 256, 180, 320, 1)}


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


def early_stamp_events(rng, n, width, height, cap=None, early=0.02):
    """``random_events`` with stamps 10 .. 20 (the first 10, the last 20) and
    a share ``early`` of them moved into [9, 10), before the first: at 24
    bins their truncated bins are 0, -1 (only the right vote lands, in bin
    0) and -2 (no vote).  An unsorted stream."""
    ev = random_events(rng, n, width, height, cap=cap)
    ev[:n, 0] = np.sort(rng.uniform(10.0, 20.0, n))
    ev[0, 0], ev[n - 1, 0] = 10.0, 20.0
    k = int(n * early)
    ev[rng.choice(np.arange(1, n - 1), k, replace=False), 0] = rng.uniform(9.0, 10.0, k)
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
            "split_row": (random_events(rng, 200000, 2560, 64), 2560, 64),
            "early_stamps": (early_stamp_events(rng, 1 << 18, WIDTH, HEIGHT), WIDTH, HEIGHT)}


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
    # the single-image datasets' and the demo's configuration: EV_BINS bins HWC
    cases["evhinet_hwc"] = (random_events(rng, EV_EVENTS, WIDTH, HEIGHT), EV_BINS, "HWC",
                            WIDTH, HEIGHT)
    cases["evhinet_skewed_hwc"] = (skewed_events(rng, EV_EVENTS, WIDTH, HEIGHT), EV_BINS,
                                   "HWC", WIDTH, HEIGHT)
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


def device_records(fn, iters, kernel):
    """``(name, us)`` of each device activity over ``iters`` calls of
    ``fn()`` under torch.profiler, after one call outside it.  The profiler
    may drop some device records of a long session, or all of a session's
    after earlier sessions: profile again (up to three sessions) while it
    kept no record of a kernel whose name holds ``kernel``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if any(kernel in name for name, _ in records):
            break
    return records


def voxelization_device_ms(fn, iters):
    """Device time of one voxelization, from torch.profiler over ``iters``
    calls of ``fn()``: each device activity but the copies (the sort and
    tile kernels), averaged over the records the profiler kept, then
    summed; those averages by name; and the copies' averages by direction
    (``HtoD``, ``DtoH``; none where the call copies nothing)."""
    us, copies = {}, {}
    for name, t in device_records(fn, iters, "voxel_tile_kernel"):
        if name.startswith("Memcpy"):          # "Memcpy HtoD (Pinned -> Device)"
            copies.setdefault(name.split()[1], []).append(t)
            continue
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        name = name.split("(")[0].strip()
        us.setdefault(name, []).append(t)
    by_name = {name: sum(v) / len(v) / 1e3 for name, v in us.items()}
    check(all(any(k in name for name in by_name) for k in ("voxel_sort_kernel", "voxel_tile_kernel"))
          and max(map(len, us.values()), default=0) <= iters
          and all(len(v) <= iters for v in copies.values()),
          f"profiler saw {({k: len(v) for k, v in us.items()})} for {iters} voxelizations")
    return (sum(by_name.values()), by_name,
            {way: sum(v) / len(v) / 1e3 for way, v in copies.items()})


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
    device_ms, by_kernel, _ = voxelization_device_ms(run(ev_d), 20)
    skewed_device_ms, skewed_by_kernel, _ = voxelization_device_ms(run(sk_d), 20)
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
    the voxelization (binning and tile pass) on an uploaded buffer by CUDA
    events per call, the profiler's device time of the upload and of the
    copy back to pinned host memory, the host-clock wall time of a whole
    call, the profiler's device time per voxelization, the same for the
    skewed stream (every event in 8 rows), and the plain version on the
    card."""
    def run(ev):
        return lambda: voxel_cuda.events_to_voxel_grid_cuda(ev, BINS, WIDTH, HEIGHT, "HWC")

    def kernel(ev_d):
        return lambda: voxel_cuda._voxelize(ev_d, ev_d.shape[0], BINS, WIDTH, HEIGHT, True)

    for _ in range(3):
        run(events)()
    t0 = time.perf_counter()
    for _ in range(calls):
        run(events)()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    ev_d, sk_d = torch.from_numpy(events).cuda(), torch.from_numpy(skewed).cuda()
    ms, skewed_ms = time_ms(kernel(ev_d), calls, CUDA), time_ms(kernel(sk_d), calls, CUDA)
    device_ms, by_kernel, copies = voxelization_device_ms(run(events), 10)
    skewed_device_ms = voxelization_device_ms(run(skewed), 10)[0]
    plain_ms = time_ms(lambda: events_to_voxel_grid_reference(
        ev_d, BINS, WIDTH, HEIGHT, "HWC"), 10, CUDA)
    n = events.shape[0]
    bytes_moved = n * 16 + BINS * HEIGHT * WIDTH * 4
    timing = {"ms": ms, "plain_ms": plain_ms,
              **bound(bytes_moved, n * 16, F32_OPS_PER_S), "library_ms": None,
              "device_ms": device_ms}
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    emit("kernel_timing", kernel="voxel_grid", events=n, format="HWC",
         bytes=bytes_moved, upload_ms=copies["HtoD"], copy_ms=copies["DtoH"],
         wall_ms=wall_ms, device_ms_by_kernel=by_kernel,
         skewed_ms=skewed_ms, skewed_device_ms=skewed_device_ms, **timing)
    return timing


def phase_norm_kernel_check():
    """VN (``voxel_norm_np`` on K2's page-locked grid, ``csrc/voxel_norm.cu``)
    against the numpy chain (``voxel_norm_np`` of a pageable copy) at the
    single-image items' 720x1280x6 grid, HWC and CHW, within NORM_RTOL /
    NORM_ATOL: one launch a card call and none for the pageable copy, the
    same bits on a second call, the input unchanged; K2's output reads
    page-locked and ``np.zeros`` not; an all-zero page-locked grid comes
    back as the same object.  Returns VN's launches, its max |diff| and the
    HWC grid."""
    rng = np.random.RandomState(9)
    events = random_events(rng, EV_EVENTS, WIDTH, HEIGHT)
    voxel_cuda.reset_norm_stats()
    errs, excess, grids = {}, {}, {}
    for fmt in ("HWC", "CHW"):
        grid = voxel_cuda.events_to_voxel_grid_cuda(events, EV_BINS, WIDTH, HEIGHT, fmt)
        check(torch.from_numpy(grid).is_pinned(), f"voxel_norm {fmt}: K2's grid is pageable")
        kept = grid.copy()
        before = voxel_cuda.NORM_LAUNCHES
        want = voxel_norm_np(kept)                   # pageable: the numpy chain
        check(voxel_cuda.NORM_LAUNCHES == before, f"voxel_norm {fmt}: a pageable grid launched")
        got, again = voxel_norm_np(grid), voxel_norm_np(grid)
        check(voxel_cuda.NORM_LAUNCHES == before + 2,
              f"voxel_norm {fmt}: {voxel_cuda.NORM_LAUNCHES - before} launches for 2 calls")
        check(got is not grid and got.dtype == np.float32 and got.shape == grid.shape
              and torch.from_numpy(got).is_pinned(), f"voxel_norm {fmt}: result {got.shape}")
        check(np.array_equal(grid.view(np.uint32), kept.view(np.uint32)),
              f"voxel_norm {fmt}: the input was modified")
        check(np.array_equal(got.view(np.uint32), again.view(np.uint32)),
              f"voxel_norm {fmt}: two calls differ")
        diff = np.abs(got.astype(np.float64) - want)
        errs[fmt] = float(diff.max())
        excess[fmt] = float((diff - (NORM_ATOL + NORM_RTOL * np.abs(want))).max())
        check(excess[fmt] <= 0, f"voxel_norm {fmt}: max|diff| {errs[fmt]} beyond rtol "
              f"{NORM_RTOL} / atol {NORM_ATOL} (by {excess[fmt]})")
        grids[fmt] = grid
    shape = (HEIGHT, WIDTH, EV_BINS)
    zeros = torch.zeros(shape, dtype=torch.float32, pin_memory=True).numpy()
    check(not torch.from_numpy(np.zeros(shape, np.float32)).is_pinned(),
          "np.zeros reads page-locked")
    check(voxel_norm_np(zeros) is zeros, "voxel_norm: an all-zero grid came back as another")
    launches = voxel_cuda.NORM_LAUNCHES
    check(launches == 5, f"voxel_norm: {launches} launches for 5 card calls")
    emit("kernel_check", kernel="voxel_norm", max_abs_err=errs, rtol=NORM_RTOL,
         atol=NORM_ATOL, excess_over_tol=excess, nonzero_cells=int((grids["HWC"] != 0).sum()),
         launches=launches)
    return launches, max(errs.values()), grids["HWC"]


def phase_norm_kernel_timing(grid, calls=200):
    """VN at the 720x1280x6 grid: its two kernels on an uploaded grid (CUDA
    events per call, the profiler's device time by kernel); the whole call
    (upload, kernels, copy back into page-locked memory, the wait) on the
    host clock, with its copies' device time; the numpy chain on the host
    clock; and the plain version on the card, ``voxel_norm`` (PyTorch ops)
    in float64 on the uploaded grid, by CUDA events and as a whole call
    that uploads and copies back as the wrapper does, timed in turns with
    the wrapper.  The largest |diff| between the two card versions."""
    grid_d = torch.from_numpy(grid).cuda()
    pageable = grid.copy()

    def torch_chain():
        out = voxel_norm(torch.from_numpy(grid).to(CUDA, non_blocking=True).double()).float()
        host = torch.empty(grid.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return host.numpy()

    def wall_ms(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    ms = time_ms(lambda: voxel_cuda._voxel_norm(grid_d), calls, CUDA)
    plain_ms = time_ms(lambda: voxel_norm(grid_d.double()).float(), calls, CUDA)
    for fn in (lambda: voxel_cuda.voxel_norm_cuda(grid), torch_chain):
        fn()
    walls = {"wrapper": [], "torch_chain": []}
    for _ in range(5):                              # in turns, 20 calls each
        walls["wrapper"].append(wall_ms(lambda: voxel_cuda.voxel_norm_cuda(grid), 20))
        walls["torch_chain"].append(wall_ms(torch_chain, 20))
    numpy_ms = wall_ms(lambda: voxel_norm_np(pageable), 5)
    chain_err = float(np.abs(voxel_cuda.voxel_norm_cuda(grid) - torch_chain()).max())
    us = {}       # copies by their full name: the grid's and the count's readback differ
    for name, t in device_records(lambda: voxel_cuda.voxel_norm_cuda(grid), 20,
                                  "voxel_norm_apply_kernel"):
        if not name.startswith("Memcpy"):
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
        us.setdefault(name, []).append(t)
    by_name = {k: sum(v) / len(v) / 1e3 for k, v in us.items()}
    parts = {"stats": "voxel_norm_stats_kernel", "apply": "voxel_norm_apply_kernel"}
    found = {k: [n for n in us if part in n] for k, part in parts.items()}
    check(all(len(v) == 1 and len(us[v[0]]) <= 20 for v in found.values()),
          f"profiler saw {({k: len(v) for k, v in us.items()})} for 20 normalisations")
    by_kernel = {k: by_name[v[0]] for k, v in found.items()}

    def copy_ms(way):                # the largest copy that way: the grid's
        return max((v for n, v in by_name.items() if way in n), default=None)
    n = grid.size
    bytes_moved = 2 * n * 4              # the grid read once, the result written once
    timing = {"ms": ms, "plain_ms": plain_ms, **bound(bytes_moved, 8 * n, F64_OPS_PER_S),
              "library_ms": None, "device_ms": sum(by_kernel.values())}
    timing["bound_share"] = timing["bound_ms"] / ms
    emit("kernel_timing", kernel="voxel_norm", shape=list(grid.shape), bytes=bytes_moved,
         device_ms_by_kernel=by_kernel, upload_ms=copy_ms("HtoD"),
         copy_ms=copy_ms("DtoH"), device_ms_by_name=by_name, wall_ms=statistics.median(walls["wrapper"]),
         torch_chain_wall_ms=statistics.median(walls["torch_chain"]), wall_ms_in_turns=walls,
         numpy_ms=numpy_ms, torch_chain_max_abs_diff=chain_err, **timing)
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


def idle_share(busy_ms, wall_ms):
    """The device's idle share of a wall time, from a profiled run's busy
    time and unprofiled runs' wall time; unclamped, so that a busy time
    above the wall time shows as a negative share."""
    return 1.0 - busy_ms / wall_ms


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
         idle_share=idle_share(busy_ms, window_ms),
         kernel_launches=sum(n for _, n in by_name.values()),
         top=[{"kernel": name[:90], "ms": ms, "launches": n,
               "share": ms / busy_ms} for name, (ms, n) in ranked[:top]])


def int8_operands(name, seed, x_dtype=torch.bfloat16):
    """An int8 site's input (bf16 activations, leaky-ReLU-like), weights at
    1/sqrt(fan_in) and a 0.1 N(0, 1) bias, on the card."""
    cin, cout, h, w, k, stride = INT8_CONV_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(1, cin, h * stride, w * stride, generator=gen)
    x = torch.maximum(x, 0.1 * x).to(CUDA, x_dtype)
    weight = (torch.randn(cout, cin, k, k, generator=gen) / math.sqrt(cin * k * k)).to(CUDA)
    bias = (0.1 * torch.randn(cout, generator=gen)).to(CUDA)
    return x, weight, bias, k, stride


def phase_int8_kernel_check():
    """``quantize_int8`` (dynamic and static, bit for bit) and ``conv_int8``
    (bias, leaky 0.1, bf16 out; bit for bit) against their plain versions at
    every shape of INT8_CONV_SHAPES; at the first, also float32 input and
    output, relu and no activation.  Returns the largest max |diff| of each."""
    errs = {"quantize_int8": {}, "conv_int8": {}}

    def held(kernel, name, got, want):
        errs[kernel][name] = float((got.float() - want.float()).abs().max())
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{kernel} {name}: max|diff| {errs[kernel][name]} against its plain version")

    for i, name in enumerate(INT8_CONV_SHAPES):
        variants = [("", torch.bfloat16, torch.bfloat16, 0.1, False)]
        if i == 0:
            variants += [("_f32", torch.float32, torch.float32, 0.1, False),
                         ("_relu", torch.bfloat16, torch.bfloat16, None, True),
                         ("_plain", torch.bfloat16, torch.float32, None, False)]
        for tag, x_dtype, out_dtype, slope, relu in variants:
            x, weight, bias, k, stride = int8_operands(name, 10 + i, x_dtype)
            for scale in (None, 0.02):
                key = name + tag + ("" if scale is None else "_static")
                got = quant.quantize_int8(x, scale)
                want = quant.quantize_int8_reference(x, scale)
                held("quantize_int8", key, got[1], want[1])
                held("quantize_int8", key, got[0], want[0])
            wp, wscale, b = quant.WeightCache().packed(weight, bias)
            xq, xs = want
            args = (xq, wp, wscale, xs, b, stride, 1, slope, relu, out_dtype)
            got = quant.conv_int8_packed(*args)
            torch.cuda.synchronize()
            held("conv_int8", name + tag, got, quant.conv_int8_reference(*args))
            del x, weight, bias, wp, xq, got, want
    for i, (n, cin, cout, h, w, k, stride, pad) in enumerate(INT8_EDGE_SHAPES):
        gen = torch.Generator().manual_seed(60 + i)
        x = torch.randn(n, cin, h, w, generator=gen)
        x = torch.maximum(x, 0.1 * x).to(CUDA, torch.bfloat16)
        weight = (torch.randn(cout, cin, k, k, generator=gen) / math.sqrt(cin * k * k)).to(CUDA)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(CUDA)
        got, want = quant.quantize_int8(x), quant.quantize_int8_reference(x)
        held("quantize_int8", f"edge{i}", got[0], want[0])
        wp, wscale, b = quant.WeightCache().packed(weight, bias)
        xq, xs = want
        for out_dtype, slope, relu in ((torch.bfloat16, 0.1, False), (torch.float32, None, i % 2)):
            args = (xq, wp, wscale, xs, b if relu or slope else None, stride, pad, slope,
                    bool(relu), out_dtype)
            got = quant.conv_int8_packed(*args)
            torch.cuda.synchronize()
            plan = int8_cuda.conv_plan(n, got.shape[2], got.shape[3], xq.shape[3], cout, k, k,
                                       stride, got.element_size())
            held("conv_int8", f"edge{i}_{str(out_dtype)[6:]}_n{plan.bn}_c{plan.chunk}"
                 f"_{'res' if plan.resident else 'ring'}_{'vec' if plan.vector_store else 'elt'}"
                 f"_{'kx' if plan.shared else 'tap'}",
                 got, quant.conv_int8_reference(*args))
    emit("int8_kernel_check", shapes={k: list(v) for k, v in INT8_CONV_SHAPES.items()},
         edge_shapes=INT8_EDGE_SHAPES, max_abs_err=errs, tol="bit-exact")
    return {k: max(v.values()) for k, v in errs.items()}


def shard_site_shapes():
    """The int8 sites of a row shard: the 360-row half of a 720p frame at
    every INT8_CONV_SHAPES site and EVHINET_INT8_SHAPES site, each with its
    halo rows (padding above, kernel - stride - padding below) in the tensor:
    ``{name: (cin, cout, input rows, input width, kernel, stride)}``."""
    shapes = {}
    for name, (cin, cout, h, w, k, stride) in INT8_CONV_SHAPES.items():
        shapes[name] = (cin, cout, h * stride // 2 + k - stride, w * stride, k, stride)
    for name, (cin, cout, h, w, k) in EVHINET_INT8_SHAPES.items():
        shapes["evhinet_" + name] = (cin, cout, h // 2 + k - 1, w, k, 1)
    return shapes


def phase_spatial_int8_kernel_check():
    """The two int8 kernels as a row shard runs them: ``conv_int8`` with its
    halo rows in the tensor, row padding 0 and column padding 1 (k // 2 for
    EVHINet's), and ``quantize_int8`` in device-amax mode (the amax pass
    alone, then the quantization from an amax in device memory: the shard's
    own and a larger one, as the group's max may be), each bit for bit
    against its plain version at every shard_site_shapes() site; then the
    INT8_TIMED sites' shard times (CUDA events) beside their bounds.
    Returns the largest max |diff| of each kernel."""
    t_phase = time.perf_counter()
    errs = {"quantize_int8": {}, "conv_int8": {}}

    def held(kernel, name, got, want):
        errs[kernel][name] = float((got.float() - want.float()).abs().max())
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{kernel} {name} at a shard: max|diff| {errs[kernel][name]} against its "
              "plain version")

    timing = {}
    for i, (name, (cin, cout, h, w, k, stride)) in enumerate(shard_site_shapes().items()):
        gen = torch.Generator().manual_seed(80 + i)
        x = torch.randn(1, cin, h, w, generator=gen)
        x = torch.maximum(x, 0.1 * x).to(CUDA, torch.bfloat16)
        weight = (torch.randn(cout, cin, k, k, generator=gen) / math.sqrt(cin * k * k)).to(CUDA)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(CUDA)
        own = quant.amax_int8(x)
        held("quantize_int8", name + "_amax", own, x.float().abs().amax().reshape(1))
        for tag, amax in (("", own), ("_group", own * 1.5)):
            got = quant.quantize_int8(x, amax=amax)
            want = quant.quantize_int8_reference(x, amax=amax)
            held("quantize_int8", name + tag, got[1], want[1])
            held("quantize_int8", name + tag, got[0], want[0])
        wp, wscale, b = quant.WeightCache().packed(weight, bias)
        xq, xs = want
        pad = (0, 1 if k == 4 else k // 2)
        args = (xq, wp, wscale, xs, b, stride, pad, 0.1, False, torch.bfloat16)
        got = quant.conv_int8_packed(*args)
        torch.cuda.synchronize()
        held("conv_int8", name, got, quant.conv_int8_reference(*args))
        if name in INT8_TIMED:
            ho, wo = got.shape[2:]
            q_bytes = x.numel() * x.element_size() + xq.numel()
            c_ops = 2 * ho * wo * cout * cin * k * k
            c_bytes = xq.numel() + wp.numel() + ho * wo * cout * 2
            timing[name] = {
                "input": [cin, h, w], "output": [cout, ho, wo],
                "conv_int8": {"ms": time_ms(lambda: quant.conv_int8_packed(*args), 50, CUDA),
                              **bound(c_bytes, c_ops, INT8_OPS_PER_S)},
                "quantize_int8": {
                    "ms": time_ms(lambda: quant.quantize_int8(x, amax=own), 50, CUDA),
                    "amax_ms": time_ms(lambda: quant.amax_int8(x), 50, CUDA),
                    **bound(q_bytes + x.numel() * x.element_size(), 0, F32_OPS_PER_S)}}
        del x, weight, bias, wp, xq, got, want
    emit("spatial_int8_kernel_check", shapes={k: list(v) for k, v in shard_site_shapes().items()},
         padding="rows 0, columns 1 (k // 2)", max_abs_err=errs, tol="bit-exact",
         timing_at_shards=timing, seconds=time.perf_counter() - t_phase)
    return {k: max(v.values()) for k, v in errs.items()}


def int_mm_taps(xq, wp):
    """Nine ``torch._int_mm`` taps of the 3x3 conv of ``xq`` (1, h, w, cp) with
    the packed weights: the probe's int8 yardstick."""
    return probe_bc.library_conv_int8(xq[0], wp.permute(1, 2, 3, 0).contiguous())


def quantize_per_tensor_cell(x, scale):
    """``torch.quantize_per_tensor(x, scale, 0, torch.qint8)``, the one-call
    library quantizer nearest to Q8 at a static scale: its ms (on ``x``, or
    on ``x`` in float32 where it refuses ``x``'s dtype, as it refuses bf16),
    and how its values compare with Q8's (it leaves NCHW and clamps to -128,
    Q8 writes NHWC with padded channels and clamps to -127)."""
    def call(xin):
        return torch.quantize_per_tensor(xin, scale, 0, torch.qint8)

    xin = x
    try:
        lib = call(xin)
    except (RuntimeError, NotImplementedError):
        xin = x.float()
        lib = call(xin)
    got = torch.int_repr(lib).permute(0, 2, 3, 1).int()
    want = quant.quantize_int8(x, scale)[0][..., :x.shape[1]].int()
    diff = (got - want).abs()
    return {"static_library_ms": time_ms(lambda: call(xin), 50, CUDA),
            "static_library_call": "torch.quantize_per_tensor(x, scale, 0, torch.qint8)",
            "static_library_input": str(xin.dtype).removeprefix("torch."),
            "static_library_layout": "NCHW", "static_library_equal": bool(diff.max() == 0),
            "static_library_mismatches": int((diff > 0).sum()),
            "static_library_max_abs_diff": int(diff.max())}


def phase_int8_kernel_timing():
    """Both kernels at the INT8_TIMED shapes (bf16 input, dynamic scale, bias,
    leaky 0.1, bf16 out): CUDA events per call, device time from the
    profiler, the plain versions, the bound, TOP/s, cuDNN's bf16
    channels_last conv with the same epilogue and nine ``torch._int_mm``
    taps; the quantization static too, beside ``torch.quantize_per_tensor``.
    Returns ``{"quantize_int8": ..., "conv_int8": ...}`` at INT8_TIMED[0],
    with every shape's figures in the phase's line."""
    shapes = {}
    for name in INT8_TIMED:
        cin, cout, h, w, k, stride = INT8_CONV_SHAPES[name]
        x, weight, bias, k, stride = int8_operands(name, 30)
        wp, wscale, b = quant.WeightCache().packed(weight, bias)
        xq, xs = quant.quantize_int8(x)

        def conv():
            return quant.conv_int8_packed(xq, wp, wscale, xs, b, 1, 1, 0.1, False,
                                          torch.bfloat16)

        x_cl = x.contiguous(memory_format=torch.channels_last)
        w_cl = weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)

        def cudnn():
            y = torch.nn.functional.conv2d(x_cl, w_cl, b16, padding=1)
            return torch.maximum(y, 0.1 * y)

        q_bytes = x.numel() * x.element_size() + xq.numel()
        conv_ops = 2 * h * w * cout * cin * k * k
        conv_bytes = xq.numel() + wp.numel() + h * w * cout * 2
        q = {"ms": time_ms(lambda: quant.quantize_int8(x), 50, CUDA),
             "plain_ms": time_ms(lambda: quant.quantize_int8_reference(x), 10, CUDA),
             "library_ms": None, "bytes": q_bytes, **bound(q_bytes, 0, F32_OPS_PER_S),
             "quantize_device_ms": kernel_device_ms(lambda: quant.quantize_int8(x), 20,
                                                    "quantize_kernel"),
             "amax_device_ms": kernel_device_ms(lambda: quant.quantize_int8(x), 20,
                                                "amax_kernel"),
             "static_ms": time_ms(lambda: quant.quantize_int8(x, 0.02), 50, CUDA),
             "static_device_ms": kernel_device_ms(lambda: quant.quantize_int8(x, 0.02), 20,
                                                  "quantize_kernel"),
             **quantize_per_tensor_cell(x, 0.02)}
        q["device_ms"] = q["quantize_device_ms"] + q["amax_device_ms"]
        q["static_bound_share"] = q["bound_ms"] / q["static_ms"]
        c = {"ms": time_ms(conv, 50, CUDA),
             "plain_ms": time_ms(lambda: quant.conv_int8_reference(
                 xq, wp, wscale, xs, b, 1, 1, 0.1, False, torch.bfloat16), 3, CUDA, warmup=1),
             "library_ms": time_ms(cudnn, 50, CUDA),
             "int_mm_taps_ms": time_ms(lambda: int_mm_taps(xq, wp), 5, CUDA, warmup=1),
             "ops": conv_ops, "bytes": conv_bytes,
             **bound(conv_bytes, conv_ops, INT8_OPS_PER_S),
             "device_ms": kernel_device_ms(conv, 20, "conv_int8_kernel"),
             "plan": int8_cuda.conv_plan(1, h, w, xq.shape[3], cout, k, k, 1)._asdict()}
        for t in (q, c):
            t["bound_share"] = t["bound_ms"] / t["ms"]
        c["tera_ops_per_s"] = conv_ops / c["ms"] / 1e9
        c["device_bound_share"] = c["bound_ms"] / c["device_ms"]
        shapes[name] = {"quantize_int8": q, "conv_int8": c}
        del x, weight, bias, wp, xq, x_cl, w_cl
    emit("int8_kernel_timing", shapes=shapes)
    return shapes[INT8_TIMED[0]]


def int8_share(run, dynamic):
    """The int8 kernels' share of one window's device time, from the
    profiler: ``{kernel: (ms, launches)}`` and the device busy ms.  Fails
    when the profiler saw no launch of a kernel that the wrappers' counts
    (and, for ``amax_kernel``, a ``dynamic`` mode) say ran: a kernel whose
    name no longer matches would read as 0 % of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("conv_int8_kernel", "quantize_kernel", "amax_kernel")
    before = int8_cuda.CONV_LAUNCHES, int8_cuda.QUANTIZE_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counted = {"conv_int8_kernel": int8_cuda.CONV_LAUNCHES - before[0],
               "quantize_kernel": int8_cuda.QUANTIZE_LAUNCHES - before[1]}
    counted["amax_kernel"] = counted["quantize_kernel"] if dynamic else 0
    busy, mine = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            for k in names:
                if k in e.name:
                    ms_n = mine.setdefault(k, [0.0, 0])
                    ms_n[0] += ms
                    ms_n[1] += 1
    for k in names:
        check(counted[k] == 0 or mine.get(k, [0.0, 0])[1] > 0,
              f"the profiler saw no {k} launch where the wrappers counted {counted[k]}")
    return mine, busy


def module_init_state(seed=0):
    """The network's own initialisation (the modules' inits, as
    ``RestorationTaskBase.init_params`` draws them) from ``seed``: the weight
    distribution that int8 quality is read on, as the JAX package read it on
    its init's."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return FinalBidirectionAttenfusion(RefidConfig()).state_dict()


def phase_int8_serve(requests):
    """720p windows in each int8 mode under bf16 autocast, TF32 off, with
    the network's own init (``module_init_state``): ``"static"`` calibrated
    on ``requests[0]``, every mode served on the rest (1 warm-up, then
    timed), the last window against the same window in float32 (and the bf16
    window beside it), then one window under the profiler for the int8
    kernels' share.  Returns the two kernels' launches over the int8 path
    and, for each mode, its dB and whether it is more than 3 dB below bf16's."""
    state = module_init_state()
    plain = BlurVFIPipeline(state, RefidConfig(), device="cuda")
    out32 = plain(*requests[-1]).float()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        bf16_db = parity_db(out32, plain(*requests[-1]).float())
    del plain
    int8_cuda.reset_launches()                     # the int8 path starts here
    dbs, faults = {"bf16": bf16_db}, []
    for mode in INT8_SITES:
        pipe = BlurVFIPipeline(state, RefidConfig(), int8=mode, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        calib_ms = None
        if mode == "static":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                pipe.calibrate(*requests[0])
            torch.cuda.synchronize()
            calib_ms = (time.perf_counter() - t0) * 1e3
        before = int8_cuda.CONV_LAUNCHES, int8_cuda.QUANTIZE_LAUNCHES
        times = []
        for i, request in enumerate(requests[1:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = pipe(*request)
            torch.cuda.synchronize()
            if i > 0:
                times.append((time.perf_counter() - t0) * 1e3)
        served = len(requests) - 1
        convs = int8_cuda.CONV_LAUNCHES - before[0]
        quants = int8_cuda.QUANTIZE_LAUNCHES - before[1]
        peak = torch.cuda.max_memory_allocated()
        check(out.shape == (23, HEIGHT, WIDTH, 3) and bool(torch.isfinite(out).all()),
              f"int8={mode} window: shape {tuple(out.shape)} or not finite")
        check(convs == quants == INT8_SITES[mode] * served,
              f"int8={mode}: {convs} convs, {quants} quantizations for {served} windows of "
              f"{INT8_SITES[mode]} sites")
        dbs[mode] = parity_db(out32, out.float())
        if dbs[mode] < bf16_db - 3.0:
            faults.append(mode)
        ms = sum(times) / len(times)

        def run():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                pipe(*requests[-1])

        mine, busy = int8_share(run, mode != "static")
        int8_ms = sum(v[0] for v in mine.values())
        emit("int8_serve", mode=mode, weights="module init, seed 0", frame=[HEIGHT, WIDTH],
             events=FULL_EVENTS, sites_per_window=INT8_SITES[mode], conv_launches=convs,
             quantize_launches=quants, windows=served, ms_per_window=times,
             mean_ms_per_window=ms, frames_per_s=23 * 1e3 / ms, db_vs_f32=dbs[mode],
             bf16_db_vs_f32=bf16_db, calibrate_ms=calib_ms,
             calibrated_sites=None if pipe._int8_scales is None else len(pipe._int8_scales),
             max_memory_allocated=peak, profiled_device_busy_ms=busy,
             idle_share=idle_share(busy, ms),
             int8_device_ms=int8_ms, int8_share=int8_ms / busy,
             int8_kernels={k: {"ms": v[0], "launches": v[1]} for k, v in mine.items()})
        del pipe, out
    launches = {"quantize_int8": int8_cuda.QUANTIZE_LAUNCHES,   # ... and ends here
                "conv_int8": int8_cuda.CONV_LAUNCHES}
    windows = len(requests)          # each mode: the served windows and the profiled one
    check(all(v == sum(INT8_SITES.values()) * windows for v in launches.values()),
          f"int8 path launches {launches} for {windows} windows a mode")
    return launches, dbs, faults


# --- single-image deblurring: EVHINet ---------------------------------------------

def evhinet_task(state, device, compute_dtype="float32", **val):
    """The single-image task (``TestImageEventRestorationModel``) with the
    full-width EVHINet of EVHINET_NET and ``state`` loaded."""
    task = build_task({"name": "chip_smoke_evhinet", "model_type": "TestImageEventRestorationModel",
                       "is_train": False,
                       "network_g": dict(EVHINET_NET, compute_dtype=compute_dtype),
                       "val": val}, device)
    load_state(task.net, state)
    return task


def evhinet_state(seed, filled):
    """EVHINet weights: every parameter filled (``fill_random``), or the
    network's own init, from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = EVHINet()
    if filled:
        fill_random(net, seed)
    return net.state_dict()


def evhinet_voxel(events, width, height, device="cuda"):
    """A single-image item's voxel: ``EV_BINS`` bins ``HWC`` (K2 on the card),
    then ``voxel_norm``, as the datasets and the demo build it; and the max
    |diff| of the grid before ``voxel_norm`` against its plain version on
    the same device."""
    grid = events_to_voxel_grid(events, EV_BINS, width, height, "HWC", device=device)
    want = events_to_voxel_grid_reference(torch.from_numpy(events).to(device), EV_BINS,
                                          width, height, "HWC").cpu().numpy()
    return voxel_norm_np(grid), float(np.abs(grid - want).max())


class RecordingQuant(quant.QuantState):
    """A QuantState that records each site's (cin, cout, h, w, k)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.shapes = []

    def conv(self, module, x, slope=None, relu=False, exact=None):
        cout, cin, k, _ = module.weight.shape
        self.shapes.append((cin, cout, x.shape[-2], x.shape[-1], k))
        return super().conv(module, x, slope, relu, exact)


def evhinet_forward(task, img, voxel, q):
    """One image through the task's network with the quant state ``q`` (the
    model's int8 entry; ``predict_tensor`` builds its own state)."""
    lq, vox = (to_nchw(torch.from_numpy(a[None]).to(CUDA)) for a in (img, voxel))
    with torch.inference_mode():
        return task.net.eval()(lq, vox, q).movedim(-3, -1)[0]


def phase_evhinet_parity(state):
    """The full-width EVHINet through the single-image task on the card
    against the CPU, f32 with TF32 off, at an EVHINET_PARITY_CROP crop."""
    set_tf32(False)
    rng = np.random.RandomState(7)
    c = EVHINET_PARITY_CROP
    img = rng.rand(c, c, 3).astype(np.float32)
    vox, _ = evhinet_voxel(random_events(rng, 1 << 16, c, c), c, c, device="cpu")
    outs = {d: evhinet_task(state, d).predict_tensor(img[None], vox[None]).float().cpu()
            for d in ("cuda", "cpu")}
    got, want = outs["cuda"], outs["cpu"]
    check(got.shape == (1, c, c, 3) and bool(torch.isfinite(got).all()),
          f"evhinet parity output {tuple(got.shape)} or not finite")
    db = parity_db(want, got)
    emit("evhinet_parity", crop=[c, c], wf=EVHINET_NET["wf"], db=db,
         min_db=EVHINET_PARITY_DB, max_abs_err=float((want - got).abs().max()))
    check(db >= EVHINET_PARITY_DB, f"EVHINet card vs CPU {db:.1f} dB < {EVHINET_PARITY_DB}")


def phase_evhinet_kernel_check():
    """``quantize_int8`` (dynamic and static) and ``conv_int8`` (bias, bf16
    out as under autocast; f32 out at the first shape) against their plain
    versions, bit for bit, at each distinct EVHINet int8 site shape at
    1280x720; then both kernels' times at the full-resolution 64 -> 64 3x3
    site beside cuDNN's bf16 channels_last conv.  Returns the largest max
    |diff| of each kernel."""
    errs = {"quantize_int8": {}, "conv_int8": {}}

    def held(kernel, name, got, want):
        errs[kernel][name] = float((got.float() - want.float()).abs().max())
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"evhinet {kernel} {name}: max|diff| {errs[kernel][name]} against plain")

    for i, (name, (cin, cout, h, w, k)) in enumerate(EVHINET_INT8_SHAPES.items()):
        gen = torch.Generator().manual_seed(40 + i)
        x = torch.randn(1, cin, h, w, generator=gen)
        x = torch.maximum(x, 0.2 * x).to(CUDA, torch.bfloat16)
        weight = (torch.randn(cout, cin, k, k, generator=gen) / math.sqrt(cin * k * k)).to(CUDA)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(CUDA)
        for scale in (None, 0.03):
            key = name + ("" if scale is None else "_static")
            got, want = quant.quantize_int8(x, scale), quant.quantize_int8_reference(x, scale)
            held("quantize_int8", key, got[1], want[1])
            held("quantize_int8", key, got[0], want[0])
        wp, wscale, b = quant.WeightCache().packed(weight, bias)
        xq, xs = want
        for out_dtype in (torch.bfloat16, torch.float32) if i == 0 else (torch.bfloat16,):
            args = (xq, wp, wscale, xs, b, 1, k // 2, None, False, out_dtype)
            got = quant.conv_int8_packed(*args)
            torch.cuda.synchronize()
            held("conv_int8", name + ("_f32" if out_dtype == torch.float32 else ""), got,
                 quant.conv_int8_reference(*args))
        if i == 0:
            timing = evhinet_int8_timing(x, weight, bias, wp, wscale, b, xq, xs, k)
        del x, weight, bias, wp, xq, got, want
    emit("evhinet_kernel_check", shapes={k: list(v) for k, v in EVHINET_INT8_SHAPES.items()},
         max_abs_err=errs, tol="bit-exact", timed=next(iter(EVHINET_INT8_SHAPES)), **timing)
    return {k: max(v.values()) for k, v in errs.items()}


def evhinet_int8_timing(x, weight, bias, wp, wscale, b, xq, xs, k):
    """Both kernels at one EVHINet site: CUDA events per call, device time
    from the profiler, the bound, cuDNN's bf16 channels_last conv with the
    same bias; the quantization static too."""
    _, cin, h, w = x.shape
    cout = weight.shape[0]
    x_cl = x.contiguous(memory_format=torch.channels_last)
    w_cl = weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b16 = bias.to(torch.bfloat16)
    ops = 2 * h * w * cout * cin * k * k
    conv_bytes = h * w * quant.padded_channels(cin) + wp.numel() + h * w * cout * 2
    q_bytes = x.numel() * 2 + xq.numel()

    def run():
        return quant.conv_int8_packed(xq, wp, wscale, xs, b, 1, k // 2, None, False,
                                      torch.bfloat16)

    conv = {"ms": time_ms(run, 30, CUDA),
            "device_ms": kernel_device_ms(run, 20, "conv_int8_kernel"),
            "library_ms": time_ms(lambda: torch.nn.functional.conv2d(x_cl, w_cl, b16,
                                                                     padding=k // 2), 30, CUDA),
            "ops": ops, **bound(conv_bytes, ops, INT8_OPS_PER_S),
            "plan": int8_cuda.conv_plan(1, h, w, xq.shape[3], cout, k, k, 1)._asdict()}
    q = {"ms": time_ms(lambda: quant.quantize_int8(x), 30, CUDA), "bytes": q_bytes,
         **bound(q_bytes, 0, F32_OPS_PER_S),
         "quantize_device_ms": kernel_device_ms(lambda: quant.quantize_int8(x), 20,
                                                "quantize_kernel"),
         "amax_device_ms": kernel_device_ms(lambda: quant.quantize_int8(x), 20, "amax_kernel"),
         "static_ms": time_ms(lambda: quant.quantize_int8(x, 0.03), 30, CUDA)}
    q["device_ms"] = q["quantize_device_ms"] + q["amax_device_ms"]
    for t in (conv, q):
        t["bound_share"] = t["bound_ms"] / t["ms"]
    conv["tera_ops_per_s"] = ops / conv["ms"] / 1e9
    conv["device_bound_share"] = conv["bound_ms"] / conv["device_ms"]
    return {"conv_int8_timing": conv, "quantize_int8_timing": q}


def phase_evhinet_serve(requests):
    """1280x720 single images (``EV_BINS``-bin voxels from K2) through the
    full-width EVHINet with the network's own init (seed 0): float32 (TF32
    off), bf16 autocast, int8 ``True`` (dynamic, the task's ``val.int8``)
    and ``"static"`` (calibrated on ``requests[0]``), each on ``requests[1:]``
    (1 warm-up, then timed, the host clock around a synchronised call: mean,
    median, spread), dB against the float32 image, peak memory, the bf16
    image's device time by kernel and the int8 kernels' share of a profiled
    image.  Each request's K2 grid is held against its plain version.
    Each request's voxel is normalised on the card (VN).  Returns the int8
    kernels' launches over the path, K2's launches and max |diff|, VN's
    launches, each mode's dB and the int8 modes below PRODUCTION_DB_GATE."""
    state = evhinet_state(0, filled=False)
    set_tf32(False)
    voxel_cuda.reset_grid_stats()                  # the EVHINet serving path starts here
    voxel_cuda.reset_norm_stats()
    int8_cuda.reset_launches()
    voxels = [evhinet_voxel(ev, WIDTH, HEIGHT) for _, ev in requests]
    vn = voxel_cuda.NORM_LAUNCHES
    check(vn == len(requests), f"evhinet serving: VN launched {vn} times for {len(requests)}")
    k2_err = max(err for _, err in voxels)
    check(k2_err <= KERNEL_TOL, f"evhinet serving: K2 max|diff| {k2_err} > {KERNEL_TOL}")
    requests = [(img, vox) for (img, _), (vox, _) in zip(requests, voxels)]
    del voxels
    outs, dbs, rows, shapes = {}, {}, {}, None
    conv_flops = None
    for mode in ("f32", "bf16", True, "static"):
        task = evhinet_task(state, "cuda", "float32" if mode == "f32" else "bfloat16",
                            **({"int8": True} if mode is True else {}))
        q_static = None
        if mode == "static":
            rec = RecordingQuant("calib", task._int8_weights)
            evhinet_forward(task, *requests[0], rec)
            shapes = rec.shapes
            amax, _ = quant.calibration_stats(rec)
            q_static = lambda: quant.QuantState("static", task._int8_weights, amax)

        def run(request):
            if q_static is None:
                return task.predict_tensor(request[0][None], request[1][None])[0]
            return evhinet_forward(task, *request, q_static())

        if mode == "f32":
            _, conv_flops = count_conv_flops(task.net, lambda: run(requests[-1]))
        torch.cuda.reset_peak_memory_stats()
        before = int8_cuda.CONV_LAUNCHES, int8_cuda.QUANTIZE_LAUNCHES
        times = []
        for i, request in enumerate(requests[1:]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(request)
            torch.cuda.synchronize()
            if i > 0:
                times.append((time.perf_counter() - t0) * 1e3)
        check(out.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(out).all()),
              f"evhinet {mode}: output {tuple(out.shape)} or not finite")
        outs[mode] = out.float().cpu()
        ms = statistics.fmean(times)
        row = {"mean_ms_per_image": ms, "median_ms_per_image": statistics.median(times),
               "stdev_ms_per_image": statistics.stdev(times),
               "min_ms_per_image": min(times), "max_ms_per_image": max(times),
               "images_per_s": 1e3 / ms, "conv_tflops_per_s": conv_flops / ms / 1e9,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "conv_launches": int8_cuda.CONV_LAUNCHES - before[0],
               "quantize_launches": int8_cuda.QUANTIZE_LAUNCHES - before[1]}
        if mode == "bf16":
            profile_window("evhinet_profile", lambda: run(requests[-1]), ms)
        if mode in (True, "static"):
            check(row["conv_launches"] == row["quantize_launches"]
                  == EVHINET_SITES * (len(requests) - 1),
                  f"evhinet int8={mode}: {row['conv_launches']} convs for "
                  f"{len(requests) - 1} images of {EVHINET_SITES} sites")
            mine, busy = int8_share(lambda: run(requests[-1]), mode is True)
            int8_ms = sum(v[0] for v in mine.values())
            row.update(profiled_device_busy_ms=busy, idle_share=idle_share(busy, ms),
                       int8_device_ms=int8_ms, int8_share=int8_ms / busy,
                       int8_kernels={k: {"ms": v[0], "launches": v[1]} for k, v in mine.items()})
        rows[str(mode)] = row
        del task
    for mode in ("bf16", True, "static"):
        dbs[str(mode)] = parity_db(outs["f32"], outs[mode])
    int8_ops = sum(2 * h * w * cin * cout * k * k for cin, cout, h, w, k in shapes)
    launches = {"quantize_int8": int8_cuda.QUANTIZE_LAUNCHES,   # ... and ends here
                "conv_int8": int8_cuda.CONV_LAUNCHES}
    k2 = voxel_cuda.GRID_LAUNCHES
    emit("evhinet_serve", weights="module init, seed 0", frame=[HEIGHT, WIDTH], bins=EV_BINS,
         wf=EVHINET_NET["wf"], images_timed=len(requests) - 2, modes=rows, db_vs_f32=dbs,
         db_gate=quant.PRODUCTION_DB_GATE, conv_flops=conv_flops, int8_sites=len(shapes),
         int8_site_ops=int8_ops, voxel_grid_launches=k2, voxel_grid_max_abs_err=k2_err,
         voxel_grid_tol=KERNEL_TOL, voxel_norm_launches=vn, launches=launches)
    check(len(shapes) == EVHINET_SITES and set(shapes) == set(EVHINET_INT8_SHAPES.values()),
          f"evhinet int8 sites {shapes}")
    check(k2 == len(requests), f"evhinet serving: K2 launched {k2} times for {len(requests)}")
    expected = 2 * EVHINET_SITES * len(requests)     # both modes: served and profiled images
    check(all(v == expected for v in launches.values()),
          f"evhinet int8 path launches {launches}, expected {expected} each")
    low = [m for m in ("True", "static") if dbs[m] < quant.PRODUCTION_DB_GATE]
    return launches, k2, k2_err, vn, dbs, low


def write_single_image_options(work, data_root, weights, crop):
    """A test option file for the single-image task on the synthetic tree
    (its four blurred frames), EVHINet at full width, ``crop`` tiles or
    whole frames; images saved when untiled."""
    import yaml

    opt = {"name": f"chip_smoke_evhinet_{crop or 'full'}",
           "model_type": "TestImageEventRestorationModel",
           "network_g": dict(EVHINET_NET),
           "path": {"pretrain_network_g": weights},
           "val": {"save_img": crop is None, "crop_size": crop, "max_minibatch": 2,
                   "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0,
                                        "test_y_channel": False},
                               "ssim": {"type": "calculate_ssim", "crop_border": 0,
                                        "test_y_channel": False}}},
           "datasets": {"test": {"name": "synth", "type": "GoProSingleImageEventDataset",
                                 "dataroot": data_root, "num_bins": EV_BINS}}}
    path = os.path.join(work, f"{opt['name']}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path, opt["name"]


def phase_evhinet_eval(data_root, work, state):
    """``cli.test`` (``run``) on the synthetic tree's single-image items,
    untiled with its images saved and in EVHINET_CROP tiles, then
    ``cli.demo`` on one blurred frame and one event window; each item's
    whole grid is normalised on the card (VN), once an item.  Returns K2's
    and VN's launches and the results by ``crop_size``."""
    import yaml

    weights = os.path.join(work, "evhinet.pth")
    torch.save({"params": state}, weights)
    set_tf32(True)      # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    total, vn, by_crop = 0, 0, {}
    for crop in (None, EVHINET_CROP):
        path, name = write_single_image_options(work, data_root, weights, crop)
        voxel_cuda.reset_grid_stats()
        voxel_cuda.reset_norm_stats()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        task = test_cli.run(["-opt", path, "--root", work])
        seconds = time.perf_counter() - t0
        results, timing = task.results["synth"], task.test_timing["synth"]
        items, launches = timing["items"], voxel_cuda.GRID_LAUNCHES
        saved = sum(len(files) for _, _, files in os.walk(
            os.path.join(work, "results", name, "visualization")))
        emit("evhinet_eval", crop_size=crop, frame=[HEIGHT, WIDTH], items=items,
             results=results, predict_ms_per_item=timing["predict_ms"] / max(items, 1),
             metric_ms_per_item=timing["metric_ms"] / max(items, 1),
             save_ms_per_item=timing["save_ms"] / max(items, 1), images_saved=saved,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             voxel_grid_launches=launches, voxel_norm_launches=voxel_cuda.NORM_LAUNCHES,
             seconds=seconds)
        check(items == 4 and all(math.isfinite(results.get(k, math.nan))
                                 for k in ("psnr", "ssim")),
              f"evhinet eval results {results} over {items} items")
        check(launches == items, f"evhinet eval: K2 launched {launches} times for {items} items")
        check(voxel_cuda.NORM_LAUNCHES == items,
              f"evhinet eval: VN launched {voxel_cuda.NORM_LAUNCHES} times for {items} items")
        check(saved == (items if crop is None else 0), f"evhinet eval saved {saved} images")
        total += launches
        vn += voxel_cuda.NORM_LAUNCHES
        by_crop[crop] = results
        del task

    out = os.path.join(work, "demo.png")
    demo_opt = {"name": "chip_smoke_demo", "model_type": "ImageEventRestorationModel",
                "network_g": dict(EVHINET_NET), "val": {},
                "path": {"pretrain_network_g": weights},
                "img_path": {"input_img": os.path.join(data_root, "train", "SYNTH", "blur",
                                                       "000002.png"),
                             "input_events": os.path.join(data_root, "train_event", "SYNTH",
                                                          "000020.npz"),
                             "output_img": out}}
    path = os.path.join(work, "demo.yml")
    with open(path, "w") as f:
        yaml.safe_dump(demo_opt, f)
    voxel_cuda.reset_grid_stats()
    voxel_cuda.reset_norm_stats()
    t0 = time.perf_counter()
    task = demo_cli.main(["-opt", path, "--root", work])
    seconds = time.perf_counter() - t0
    written = imread(out, float32=False, rgb=False)
    emit("evhinet_demo", frame=[HEIGHT, WIDTH], seconds=seconds, output=list(written.shape),
         voxel_grid_launches=voxel_cuda.GRID_LAUNCHES, voxel_norm_launches=voxel_cuda.NORM_LAUNCHES)
    check(written.shape == (HEIGHT, WIDTH, 3) and tuple(task.demo_output.shape)
          == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(task.demo_output).all()),
          f"demo wrote {written.shape}")
    check(voxel_cuda.GRID_LAUNCHES == 1, f"demo: K2 launched {voxel_cuda.GRID_LAUNCHES} times")
    check(voxel_cuda.NORM_LAUNCHES == 1, f"demo: VN launched {voxel_cuda.NORM_LAUNCHES} times")
    return total + voxel_cuda.GRID_LAUNCHES, vn + voxel_cuda.NORM_LAUNCHES, by_crop


def released_psnr(results):
    return results.get("total_psnr", results.get("psnr", math.nan))


def released_run(script, work, smi, options, pth, dataroot, max_items=None, int8=None):
    """One ``scripts/eval_released_torch.py`` run in this process (``run``,
    which its ``main`` calls): the one dataset's results, items and kernel
    launches; the printed table checked (header, one row, the card's name
    and power limit in its Hardware cell); its stderr passes through."""
    import contextlib
    import io

    label = f"{os.path.splitext(os.path.basename(options))[0]}_{int8 or 'float'}"
    argv = ["--pth", pth, "--config", options, "--dataroot", dataroot,
            "--root", os.path.join(work, "released", label)]
    argv += ["--max-items", str(max_items)] if max_items else []
    argv += ["--int8", int8] if int8 else []
    voxel_cuda.reset_grid_stats()
    voxel_cuda.reset_norm_stats()
    q0, c0 = int8_cuda.QUANTIZE_LAUNCHES, int8_cuda.CONV_LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        task = script.run(argv)
    seconds = time.perf_counter() - t0
    launches = {"voxel_grid": voxel_cuda.GRID_LAUNCHES, "voxel_norm": voxel_cuda.NORM_LAUNCHES,
                "quantize_int8": int8_cuda.QUANTIZE_LAUNCHES - q0,
                "conv_int8": int8_cuda.CONV_LAUNCHES - c0}
    (name, results), = task.results.items()
    timing, items = task.test_timing[name], task.test_timing[name]["items"]
    rows = [line for line in out.getvalue().splitlines() if line.startswith("|")]
    emit("eval_released", options=os.path.relpath(options, os.path.dirname(OPTIONS)),
         mode=int8 or "float", frame=[HEIGHT, WIDTH], items=items, results=results,
         predict_ms_per_item=timing["predict_ms"] / max(items, 1),
         metric_ms_per_item=timing["metric_ms"] / max(items, 1),
         save_ms_per_item=timing["save_ms"] / max(items, 1),
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         seconds=seconds, table=rows, nvidia_smi=smi)
    check(items > 0 and all(math.isfinite(v) for v in results.values()),
          f"eval_released {label}: results {results} over {items} items")
    check(len(rows) == 3 and rows[0] == TABLE_HEADER and rows[2].split(" | ")[2] == smi,
          f"eval_released {label}: table {rows}, the card {smi!r}")
    return results, items, launches


def phase_eval_released(work, data_root, highrev, state, evhinet_pth, eval_results,
                        evhinet_tiled):
    """``scripts/eval_released_torch.py`` on the card, each run in this
    process: ``state`` saved as a released ``{"params": ...}`` checkpoint
    through Test_Final_1skip.yml on the synthetic tree in float (equal to
    ``eval``'s results), ``--int8`` and ``--int8 scale0`` (within
    RELEASED_INT8_DB of float, not equal to it, C8 and Q8 launched);
    EVHINet's checkpoint tiled in float (equal to ``evhinet_eval``'s tiled
    results) and ``--int8``; Test_UND_Final_1skip.yml on the HighREV-layout
    tree, one item.  K2 launches once an item the loader reads, and VN once
    an EVHINet item.  Returns the launches of K2, VN, Q8 and C8."""
    spec = importlib.util.spec_from_file_location("eval_released_torch", EVAL_RELEASED)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    smi = smi_line()
    pth = os.path.join(work, "released_flagship.pth")
    torch.save({"params": state}, pth)
    total = {"voxel_grid": 0, "voxel_norm": 0, "quantize_int8": 0, "conv_int8": 0}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    float_res, items, launches = released_run(script, work, smi, EVAL_OPTIONS, pth, data_root,
                                              RELEASED_ITEMS)
    add(launches)
    diff = max(abs(float_res[k] - eval_results[k]) for k in eval_results)
    check(float_res.keys() == eval_results.keys() and diff <= METRIC_TOL,
          f"eval_released float {float_res} differs from eval's {eval_results}")
    check(launches["voxel_grid"] == items == RELEASED_ITEMS,
          f"eval_released float: K2 launched {launches['voxel_grid']} times for {items} items")
    for mode in ("true", "scale0"):
        res, items, launches = released_run(script, work, smi, EVAL_OPTIONS, pth, data_root,
                                            RELEASED_ITEMS, int8=mode)
        add(launches)
        gap = released_psnr(res) - released_psnr(float_res)
        check(abs(gap) <= RELEASED_INT8_DB and res != float_res,
              f"eval_released int8={mode}: {res} against float {float_res}")
        check(launches["voxel_grid"] == items and launches["quantize_int8"] > 0
              and launches["conv_int8"] > 0,
              f"eval_released int8={mode}: launches {launches} for {items} items")

    options, _ = write_single_image_options(work, data_root, evhinet_pth, EVHINET_CROP)
    ev_float, items, launches = released_run(script, work, smi, options, evhinet_pth, data_root)
    add(launches)
    diff = max(abs(ev_float[k] - evhinet_tiled[k]) for k in evhinet_tiled)
    check(ev_float.keys() == evhinet_tiled.keys() and diff <= METRIC_TOL,
          f"eval_released EVHINet tiled {ev_float} differs from evhinet_eval's {evhinet_tiled}")
    check(launches["voxel_grid"] == launches["voxel_norm"] == items,
          f"eval_released EVHINet: K2 / VN launched {launches['voxel_grid']} / "
          f"{launches['voxel_norm']} times for {items} items")
    ev_int8, items, launches = released_run(script, work, smi, options, evhinet_pth, data_root,
                                            int8="true")
    add(launches)
    check(abs(released_psnr(ev_int8) - released_psnr(ev_float)) <= RELEASED_INT8_DB
          and ev_int8 != ev_float, f"eval_released EVHINet int8: {ev_int8} against {ev_float}")
    check(launches["voxel_grid"] == launches["voxel_norm"] == items
          and launches["quantize_int8"] > 0 and launches["conv_int8"] > 0,
          f"eval_released EVHINet int8: launches {launches} for {items} items")

    # the test split of the HighREV-layout tree is its train video
    os.symlink(os.path.join(highrev, "train"), os.path.join(highrev, "test"))
    _, items, launches = released_run(script, work, smi, HIGHREV_OPTIONS, pth, highrev, 1)
    add(launches)
    # the test loader reads one item ahead of the one evaluated
    check(items == 1 and 1 <= launches["voxel_grid"] <= 2,
          f"eval_released HighREV: K2 launched {launches['voxel_grid']} times for {items} items")
    return total


def write_gopro_tree(root, seed=0, num_blur=4, num_gt=48, num_windows=47,
                     events_per_window=FULL_EVENTS // BINS):
    """A GoPro-layout tree at 1280x720, one video: ``num_blur`` blur frames,
    ``num_gt`` gt frames (PNG, the port's writer) and ``num_windows`` event
    windows, so that one blur-VFI 11+1 item votes about 2**20 events.  The
    test split links the same video under the first name of the GoPro test
    list, which the val and test datasets read when no ``video_list`` is
    given."""
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
    for split in ("", "_event"):
        os.makedirs(os.path.join(root, "test" + split), exist_ok=True)
        os.symlink(os.path.join(root, "train" + split, "SYNTH"),
                   os.path.join(root, "test" + split, GOPRO_TEST_VIDEOS[0]))


def recipe_overrides(opt, data_root, name, dtype):
    """The production recipe as ``chip_smoke`` trains it: the synthetic tree
    for training and validation, a validation every ``VAL_FREQ``
    iterations, a log line per iteration, no periodic checkpoints, no
    TensorBoard, and the compute dtype.  Everything else (network, crop,
    flips, sampler, loader, optimiser, schedule, loss, remat, metrics) is
    the recipe's."""
    opt = json.loads(json.dumps(opt))
    opt["name"] = name
    opt["datasets"]["train"].update(dataroot=data_root, video_list=["SYNTH"])
    opt["datasets"]["val"]["dataroot"] = data_root
    opt["val"]["val_freq"] = VAL_FREQ
    opt["logger"].update(print_freq=1, save_checkpoint_freq=0, use_tb_logger=False)
    if dtype == "bf16":
        opt["network_g"]["compute_dtype"] = "bfloat16"
    return opt


def card_vs_cpu_step(make_net, state, train_opt, batch, nchw):
    """One optimiser step on the card (TF32 off) and on the CPU from the
    same weights and batch: ``{device: (loss, grad norm, update, params)}``."""
    set_tf32(False)
    results = {}
    for key, device in (("cuda", CUDA), ("cpu", torch.device("cpu"))):
        net = make_net()
        net.load_state_dict(state)
        net.to(device)
        trainer = Trainer(net, charbonnier_loss, train_opt, train_opt["total_iter"],
                          frozen=known_unused_keys(net))
        before = {k: p.detach().clone() for k, p in trainer.named}
        args = [nchw(torch.from_numpy(a.astype(np.float32)).to(device)) for a in batch]
        metrics = trainer.train_step(*args)
        after = {k: p.detach().float().cpu() for k, p in trainer.named}
        results[key] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        torch.cat([(after[k] - before[k].cpu()).flatten() for k in after]),
                        torch.cat([after[k].flatten() for k in after]))
    return results


def check_step_parity(phase, results, **fields):
    (lc, gc, dc, pc), (lp, gp, dp, pp) = results["cuda"], results["cpu"]
    update_db, params_db = parity_db(dp, dc), parity_db(pp, pc)
    emit(phase, **fields, loss_cuda=lc, loss_cpu=lp,
         loss_rel_diff=abs(lc - lp) / abs(lp), grad_norm_rel_diff=abs(gc - gp) / abs(gp),
         update_db=update_db, params_db=params_db, min_db=PARITY_DB)
    check(math.isfinite(lc) and abs(lc - lp) / abs(lp) < 1e-4,
          f"{phase}: loss card {lc} vs CPU {lp}")
    check(update_db >= PARITY_DB and params_db >= PARITY_DB,
          f"{phase} card vs CPU: update {update_db:.1f} dB, params "
          f"{params_db:.1f} dB < {PARITY_DB}")


def recipe_train_opt():
    import yaml

    with open(RECIPE) as f:
        return yaml.safe_load(f)["train"]


def phase_train_parity(state):
    """One optimiser step of the recipe's network and optimiser, t=23 on a
    32x48 crop, on the card (TF32 off) and on the CPU from the same weights
    and batch."""
    rng = np.random.RandomState(4)
    h, w, t = 32, 48, 23
    batch = [rng.rand(1, h, w, 26), rng.randn(1, t, h, w, 2), rng.rand(1, t, h, w, 3)]
    results = card_vs_cpu_step(lambda: FinalBidirectionAttenfusion(RefidConfig(remat=True)),
                               state, recipe_train_opt(), batch, to_nchw)
    check_step_parity("train_parity", results, shape=[32, 48], t=23)


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
    val_items = sum(loader.dataset.timing["items"] for _, loader in task.val_loaders)
    steps = [h for h in task.history if "loss" in h]
    vals = [h for h in task.history if "val" in h]
    losses = [h["loss"] for h in steps]
    step_ms = [h["time"] * 1e3 for h in steps]
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(v) for v in losses),
          f"{dtype} training losses {losses}")
    check([h["iter"] for h in vals] == list(range(VAL_FREQ, TRAIN_ITERS + 1, VAL_FREQ))
          and all(math.isfinite(h[k]) for h in vals for k in ("total_psnr", "total_ssim")),
          f"{dtype} training validations {vals}")
    check(items > 0 and val_items > 0 and launches == items + val_items,
          f"{dtype} training: K2 launched {launches} times for {items} + {val_items} items")
    per_item = {k: v / items for k, v in timing.items()}
    emit("train", dtype=dtype, iters=TRAIN_ITERS, crop=opt["datasets"]["train"]["gt_size"],
         t=23, losses=losses, step_ms=step_ms,
         mean_step_ms_after_first=sum(step_ms[1:]) / len(step_ms[1:]),
         items_loaded=items, val_items_loaded=val_items, voxel_grid_launches=launches,
         data_ms_per_item=per_item, validations=vals,
         val_ms_per_item={k: v / task.val_timing["items"] for k, v in task.val_timing.items()
                          if k != "items"},
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


def phase_metric_parity(data_root):
    """PSNR and SSIM of two 1280x720 uint8 frames of the tree, on the card
    against the CPU, and the card's ms for one frame's pair."""
    video = os.path.join(data_root, "train", "SYNTH", "gt")
    a, b = (imread(os.path.join(video, "%06d.png" % k), float32=False, rgb=False)
            for k in (0, 1))
    cpu = {"psnr": calculate_psnr(a, b), "ssim": calculate_ssim(a, b)}
    a_d, b_d = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    card = {"psnr": calculate_psnr(a_d, b_d), "ssim": calculate_ssim(a_d, b_d)}
    ms = time_ms(lambda: (calculate_psnr(a_d, b_d), calculate_ssim(a_d, b_d)), 10, CUDA)
    diff = {k: abs(card[k] - cpu[k]) for k in cpu}
    emit("metric_parity", frame=[HEIGHT, WIDTH], cpu=cpu, card=card, abs_diff=diff,
         tol=METRIC_TOL, card_ms_per_frame=ms)
    check(all(math.isfinite(v) for v in card.values()) and max(diff.values()) <= METRIC_TOL,
          f"metrics card {card} vs CPU {cpu}")


def phase_eval(data_root, work, state):
    """The test CLI's entry (``cli.test.run``, which ``main`` calls) on
    ``Test_Final_1skip.yml`` with its dataroot set to the synthetic tree and
    its weights to a checkpoint of ``state``; returns the K2 launches and
    the results."""
    import yaml

    models = os.path.join(work, "eval_models")
    CheckpointManager(models).save(0, state)
    with open(EVAL_OPTIONS) as f:
        opt = yaml.safe_load(f)
    opt["datasets"]["test"]["dataroot"] = data_root
    opt["path"]["pretrain_network_g"] = models
    path = os.path.join(work, "eval.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    voxel_cuda.reset_grid_stats()
    k1_before = voxel_cuda.LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = test_cli.run(["-opt", path, "--root", work])
    seconds = time.perf_counter() - t0
    results, timing = task.results["test"], task.test_timing["test"]
    launches, items = voxel_cuda.GRID_LAUNCHES, timing["items"]
    saved = sum(len(files) for _, _, files in os.walk(os.path.join(
        work, "results", opt["name"], "visualization")))
    emit("eval", options=os.path.relpath(EVAL_OPTIONS, os.path.dirname(OPTIONS)),
         frame=[HEIGHT, WIDTH], items=items, results=results,
         predict_ms_per_item=timing["predict_ms"] / max(items, 1),
         metric_ms_per_item=timing["metric_ms"] / max(items, 1),
         save_ms_per_item=timing["save_ms"] / max(items, 1),
         max_memory_allocated=torch.cuda.max_memory_allocated(), images_saved=saved,
         voxel_grid_launches=launches, voxelize_launches=voxel_cuda.LAUNCHES - k1_before,
         seconds=seconds)
    check(items > 0 and all(math.isfinite(results.get(k, math.nan))
                            for k in ("total_psnr", "total_ssim")),
          f"eval results {results} over {items} items")
    check(launches == items, f"eval: K2 launched {launches} times for {items} items")
    check(saved == items * 23, f"eval saved {saved} images for {items} items")
    return launches, results


def median_ms(fn, repeats):
    """Median host milliseconds of ``repeats`` calls of ``fn`` (and its
    last result)."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def synthetic_frame(rng):
    """A 1280x720 RGB uint8 frame like the synthetic tree's: a coarse random
    field, upsampled, plus noise."""
    coarse = rng.rand(HEIGHT // 40, WIDTH // 40, 3) * 200
    return (np.kron(coarse, np.ones((40, 40, 1))) + rng.rand(HEIGHT, WIDTH, 3) * 55).astype(
        np.uint8)


def legacy_png_write(bgr, path):
    """The port's earlier PNG write, step by step, from a uint8
    BGR tensor on the card: the copy to the host, then filter 0 and zlib's
    default strategy at level 1, with a copy of the flipped view, of the
    rows' bytes and of each chunk.  ``{step: ms}``."""
    t0 = time.perf_counter()
    host = bgr.cpu().numpy()
    t1 = time.perf_counter()
    img = np.ascontiguousarray(host[..., ::-1])
    rows = np.zeros((HEIGHT, 1 + WIDTH * 3), np.uint8)
    rows[:, 1:] = img.reshape(HEIGHT, -1)
    raw = rows.tobytes()
    t2 = time.perf_counter()
    idat = zlib.compress(raw, 1)
    t3 = time.perf_counter()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", WIDTH, HEIGHT, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))
    t4 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(data)
    t5 = time.perf_counter()
    return {"to_host_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3,
            "zlib_ms": (t3 - t2) * 1e3, "chunks_crc_ms": (t4 - t3) * 1e3,
            "write_ms": (t5 - t4) * 1e3, "bytes": len(data)}


def png_write(bgr, path):
    """``img_util.imwrite``'s steps from a uint8 BGR tensor on the card:
    channels reordered on the card and copied to the host, Sub rows, zlib's
    RLE strategy at level 1 (cv2.imwrite's settings).  ``{step: ms}``."""
    t0 = time.perf_counter()
    rgb = img_util.png_order(bgr)
    t1 = time.perf_counter()
    header, lines = img_util.png_scanlines(rgb, 1)
    t2 = time.perf_counter()
    idat = img_util.png_deflate(lines, 1, zlib.Z_RLE)
    t3 = time.perf_counter()
    data = img_util.png_chunks(header, idat)
    t4 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(data)
    t5 = time.perf_counter()
    return {"to_host_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3,
            "zlib_ms": (t3 - t2) * 1e3, "chunks_crc_ms": (t4 - t3) * 1e3,
            "write_ms": (t5 - t4) * 1e3, "bytes": len(data)}


def filtered_tree(src, dst, filter):
    """A copy of the synthetic tree's train video with every PNG re-encoded
    with row filter ``filter``; the event windows linked."""
    for sub in ("blur", "gt"):
        out = os.path.join(dst, "train", "SYNTH", sub)
        os.makedirs(out)
        for name in sorted(os.listdir(os.path.join(src, "train", "SYNTH", sub))):
            img = imread(os.path.join(src, "train", "SYNTH", sub, name), float32=False)
            with open(os.path.join(out, name), "wb") as f:
                f.write(png_encode(img, filter=filter))
    os.makedirs(os.path.join(dst, "train_event"))
    os.symlink(os.path.join(src, "train_event", "SYNTH"),
               os.path.join(dst, "train_event", "SYNTH"))


def data_ms_per_item(data_root, items=PNG_DATA_ITEMS):
    """The recipe's train dataset on ``data_root`` (K2 on the card): host ms
    per item of reading (PNG decode and event windows), voxelizing, and
    cropping, and K2's launches."""
    import yaml

    with open(RECIPE) as f:
        opt = yaml.safe_load(f)["datasets"]["train"]
    opt.update(dataroot=data_root, video_list=["SYNTH"], phase="train", seed=0)
    ds = build_dataset(opt, "cuda")
    voxel_cuda.reset_grid_stats()
    for k in range(items):
        ds[k % len(ds)]
    timing = dict(ds.timing)
    n = timing.pop("items")
    return {k: v / n for k, v in timing.items()}, voxel_cuda.GRID_LAUNCHES


def phase_png(data_root, work):
    """The host PNG codec on a 1280x720 RGB frame: decode through the C
    unfilter for each row filter, an adaptive mix and Adam7 (equal to the
    plain Python unfilter byte for byte; the plain path timed on the
    filter-4 file), ``tensor2img`` on the card, the write of its output split
    into the copy to the host, packing, zlib, chunks and the file write,
    for the earlier writer and the current one, and the recipe's train items
    read from the filter-0 tree and from a filter-4 copy.  Host times.
    Returns K2's launches."""
    rng = np.random.RandomState(11)
    frame = synthetic_frame(rng)
    decode = {}
    for name, filt, interlace in [("0", 0, False), ("1", 1, False), ("2", 2, False),
                                  ("3", 3, False), ("4", 4, False),
                                  ("adaptive", "adaptive", False), ("adam7", "adaptive", True)]:
        header, lines = img_util.png_scanlines(frame, filt, interlace)
        idat = img_util.png_deflate(lines, 1)
        data = img_util.png_chunks(header, idat)
        ms, got = median_ms(lambda: img_util.imfrombytes(data, float32=True, rgb=True),
                            PNG_REPEATS)
        inflate_ms, raw = median_ms(lambda: np.frombuffer(zlib.decompress(idat), np.uint8),
                                    PNG_REPEATS)
        entry = {"bytes": len(data), "decode_ms": ms, "inflate_ms": inflate_ms}
        if not interlace:
            entry["unfilter_ms"], _ = median_ms(
                lambda: img_util.unfilter(raw, HEIGHT, WIDTH * 3, 3), PNG_REPEATS)
        check(np.array_equal(np.round(got * 255).astype(np.uint8), frame),
              f"png decode (filter {name}) does not give the frame back")
        t0 = time.perf_counter()
        with mock.patch.object(img_util, "unfilter", img_util._unfilter):
            plain = img_util.imfrombytes(data, "unchanged")
        if name == "4":
            entry["plain_decode_ms"] = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(plain, img_util.imfrombytes(data, "unchanged")),
              f"png decode (filter {name}): the C unfilter differs from the plain one")
        decode[name] = entry

    pred = torch.from_numpy(frame.astype(np.float32) / 255).to(CUDA)
    torch.cuda.synchronize()

    def to_bgr():
        out = tensor2img(pred)
        torch.cuda.synchronize()
        return out

    tensor2img_ms, bgr = median_ms(to_bgr, PNG_REPEATS)
    encode = {}
    for name, write in (("before", legacy_png_write), ("after", png_write)):
        runs = [write(bgr, os.path.join(work, f"png_{name}.png")) for _ in range(PNG_REPEATS)]
        encode[name] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        encode[name]["total_ms"] = statistics.median(
            sum(v for k, v in r.items() if k.endswith("_ms")) for r in runs)
        check(np.array_equal(imread(os.path.join(work, f"png_{name}.png"), float32=False),
                             frame), f"png write ({name}) does not read back")

    t0 = time.perf_counter()
    paeth_root = os.path.join(work, "gopro_filter4")
    filtered_tree(data_root, paeth_root, 4)
    copy_s = time.perf_counter() - t0
    filter0, k2_0 = data_ms_per_item(data_root)
    filter4, k2_4 = data_ms_per_item(paeth_root)
    emit("png", frame=[HEIGHT, WIDTH, 3], repeats=PNG_REPEATS, decode=decode,
         tensor2img_ms=tensor2img_ms, encode=encode,
         data_ms_per_item={"filter0_tree": filter0, "filter4_tree": filter4},
         items_per_tree=PNG_DATA_ITEMS, filter4_copy_seconds=copy_s,
         voxel_grid_launches=k2_0 + k2_4, clock="host")
    check(k2_0 == k2_4 == PNG_DATA_ITEMS, f"png data items: K2 launched {k2_0} + {k2_4} times")
    return k2_0 + k2_4


def evhinet_train_options(data_root, name, dtype):
    """EVHINet trained as no shipped option file does: the flagship recipe's
    optimiser, schedule, loss and loader, ``SingleMultiConnectEVHINet`` at
    its defaults, 6-bin single-image items cropped to ITEM_CROP with flips and
    rotations in batches of EVHINET_TRAIN_BATCH, validation every
    ``VAL_FREQ`` iterations on the tree's single-image items, TensorBoard
    on."""
    import yaml

    with open(RECIPE) as f:
        recipe = yaml.safe_load(f)
    loader = {k: recipe["datasets"]["train"][k]
              for k in ("use_shuffle", "num_worker_per_gpu", "dataset_enlarge_ratio",
                        "num_prefetch_queue")}
    single = {"type": "GoProSingleImageEventDataset", "dataroot": data_root,
              "num_bins": EV_BINS, "io_backend": {"type": "disk"}}
    network = {"type": "SingleMultiConnectEVHINet"}
    if dtype == "bf16":
        network["compute_dtype"] = "bfloat16"
    return {"name": name, "model_type": "ImageEventRestorationModel", "scale": 1,
            "num_gpu": 1, "manual_seed": recipe["manual_seed"],
            "datasets": {
                "train": {**single, **loader, "name": "train", "video_list": ["SYNTH"],
                          "gt_size": ITEM_CROP, "use_hflip": True, "use_rot": True,
                          "batch_size_per_gpu": EVHINET_TRAIN_BATCH},
                "val": {**single, "name": "synth"}},
            "network_g": network,
            "path": {"pretrain_network_g": None},
            "train": recipe["train"],
            "val": {"val_freq": VAL_FREQ, "save_img": False,
                    "metrics": {k: {"type": f"calculate_{k}", "crop_border": 0,
                                    "test_y_channel": False} for k in ("psnr", "ssim")}},
            "logger": {"print_freq": 1, "save_checkpoint_freq": 0, "use_tb_logger": True}}


def phase_evhinet_train_parity(state):
    """One optimiser step of full-width EVHINet with the recipe's optimiser
    on an EVHINET_TRAIN_PARITY_CROP crop, batch 2, card (TF32 off) against
    CPU from the same weights and batch."""
    rng = np.random.RandomState(12)
    c = EVHINET_TRAIN_PARITY_CROP
    batch = [rng.rand(2, c, c, 3), rng.randn(2, c, c, EV_BINS), rng.rand(2, c, c, 3)]
    results = card_vs_cpu_step(lambda: EVHINet(), state, recipe_train_opt(), batch,
                               lambda t: t.permute(0, 3, 1, 2).contiguous())
    check_step_parity("evhinet_train_parity", results, shape=[c, c], batch=2, wf=64)


def phase_evhinet_train(data_root, work, dtype):
    """EVHINet through the train CLI's ``main`` for TRAIN_ITERS iterations
    with validations after iterations 4 and 8, its TensorBoard file read
    back; returns K2's launches."""
    import yaml

    name = f"chip_smoke_evhinet_{dtype}"
    path = os.path.join(work, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(evhinet_train_options(data_root, name, dtype), f)
    voxel_cuda.reset_grid_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task = train_cli.main(["-opt", path, "--root", work, "--max-iters", str(TRAIN_ITERS)])
    seconds = time.perf_counter() - t0
    timing = dict(task.train_loader.dataset.timing)
    items, launches = timing.pop("items"), voxel_cuda.GRID_LAUNCHES
    val_items = sum(loader.dataset.timing["items"] for _, loader in task.val_loaders)
    steps = [h for h in task.history if "loss" in h]
    vals = [h for h in task.history if "val" in h]
    losses = [h["loss"] for h in steps]
    step_ms = [h["time"] * 1e3 for h in steps]
    tb_dir = os.path.join(work, "tb_logger", name)
    files = [f for f in os.listdir(tb_dir) if f.startswith("events.out.tfevents.")]
    scalars = read_scalars(os.path.join(tb_dir, files[0])) if len(files) == 1 else []
    tags = sorted({tag for _, tag, _ in scalars})
    want_tags = sorted(["learning_rate", "losses/grad_norm", "losses/loss",
                        "metrics/synth/psnr", "metrics/synth/ssim"])
    loss_steps = [step for step, tag, _ in scalars if tag == "losses/loss"]
    metric_steps = [step for step, tag, _ in scalars if tag == "metrics/synth/psnr"]
    emit("evhinet_train", dtype=dtype, iters=TRAIN_ITERS, batch=EVHINET_TRAIN_BATCH,
         crop=ITEM_CROP, wf=64, losses=losses, step_ms=step_ms,
         mean_step_ms_after_first=sum(step_ms[1:]) / len(step_ms[1:]),
         items_loaded=items, val_items_loaded=val_items, voxel_grid_launches=launches,
         data_ms_per_item={k: v / items for k, v in timing.items()}, validations=vals,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         tensorboard={"files": files, "tags": tags, "scalars": len(scalars),
                      "loss_steps": loss_steps, "metric_steps": metric_steps},
         seconds=seconds)
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(v) for v in losses),
          f"evhinet {dtype} training losses {losses}")
    check([h["iter"] for h in vals] == list(range(VAL_FREQ, TRAIN_ITERS + 1, VAL_FREQ))
          and all(math.isfinite(h[k]) for h in vals for k in ("psnr", "ssim")),
          f"evhinet {dtype} training validations {vals}")
    check(items > 0 and val_items > 0 and launches == items + val_items,
          f"evhinet {dtype} training: K2 launched {launches} times for {items} + "
          f"{val_items} items")
    check(tags == want_tags and loss_steps == list(range(1, TRAIN_ITERS + 1))
          and metric_steps == [h["iter"] for h in vals],
          f"evhinet {dtype} TensorBoard file {files}: tags {tags}, loss steps "
          f"{loss_steps}, metric steps {metric_steps}")
    return launches


def layout_trees(data_root, work):
    """The synthetic video in the HighREV layout (events under the video,
    ``(N, 1)`` fields, x and y swapped) and the BS-ERGB one
    (``3_TRAINING/<video>/images`` with one more frame than
    ``events/``)."""
    highrev = os.path.join(work, "highrev")
    video = os.path.join(highrev, "train", "SYNTH")
    os.makedirs(os.path.join(video, "event"))
    for sub in ("blur", "gt"):
        os.symlink(os.path.join(data_root, "train", "SYNTH", sub), os.path.join(video, sub))
    ev_dir = os.path.join(data_root, "train_event", "SYNTH")
    for name in sorted(os.listdir(ev_dir)):
        d = np.load(os.path.join(ev_dir, name))
        np.savez(os.path.join(video, "event", name), timestamp=d["timestamp"][:, None],
                 x=d["y"][:, None].astype(np.float32), y=d["x"][:, None].astype(np.float32),
                 polarity=d["polarity"][:, None].astype(np.float32))
    bsergb = os.path.join(work, "bsergb")
    video = os.path.join(bsergb, "3_TRAINING", "SYNTH")
    os.makedirs(video)
    os.symlink(os.path.join(data_root, "train", "SYNTH", "gt"), os.path.join(video, "images"))
    os.symlink(ev_dir, os.path.join(video, "events"))
    return highrev, bsergb


def phase_datasets(data_root, highrev, bsergb):
    """One item of each deblur dataset and of BS-ERGB at 1280x720 (the trees
    of :func:`layout_trees`), built on the card (K2) and on the CPU (the
    plain voxelizer) from one seed: images equal, voxels within KERNEL_TOL.
    Returns K2's launches."""
    deblur = {"num_end_interpolation": 11, "num_inter_interpolation": 1}
    cases = [("DeblurGoProEventRecurrentDataset", data_root, deblur),
             ("DeblurUNDEventRecurrentDataset", highrev, deblur),
             ("DeblurGoProBidirEventRecurrentDataset", data_root, deblur),
             ("BsergbSharpEventRecurrentDataset", bsergb,
              {"num_end_interpolation": 1, "num_inter_interpolation": 3})]
    results, total = {}, 0
    for dtype, root, kw in cases:
        opt = {"type": dtype, "dataroot": root, "phase": "train", "scale": 1,
               "video_list": ["SYNTH"], "one_voxel_flag": True, "return_deblur_voxel": False,
               "gt_size": ITEM_CROP, "use_hflip": True, "use_rot": True, "seed": 5, **kw}
        voxel_cuda.reset_grid_stats()
        card = build_dataset(dict(opt), "cuda")[0]
        launches = voxel_cuda.GRID_LAUNCHES
        cpu = build_dataset(dict(opt), "cpu")[0]
        err = float(np.abs(card["voxel"] - cpu["voxel"]).max())
        same = all(np.array_equal(card[k], cpu[k]) for k in ("lq", "gt"))
        results[dtype] = {"lq": list(card["lq"].shape), "gt": list(card["gt"].shape),
                          "voxel": list(card["voxel"].shape), "images_equal": same,
                          "voxel_max_abs_err": err, "voxel_grid_launches": launches}
        check(same and card["voxel"].shape == cpu["voxel"].shape and err <= KERNEL_TOL
              and np.isfinite(card["voxel"]).all(),
              f"{dtype}: card item differs from the CPU item ({results[dtype]})")
        check(launches == (2 if "Bidir" in dtype else 1),
              f"{dtype}: K2 launched {launches} times for one item")
        total += launches
    emit("datasets", frame=[HEIGHT, WIDTH], datasets=results, tol=KERNEL_TOL)
    return total


def phase_voxel_grid_padded(calls=4):
    """K1 through ``events_to_voxel_grid_padded`` at the serving shape (10**6
    events padded to 2**20, 24 x 720 x 1280): ``calls`` timed calls with the
    launch count reset (the entry's path), then each layout against the
    plain version on the card.  Returns the path's K1 launches."""
    rng = np.random.RandomState(6)
    ev = random_events(rng, PADDED_EVENTS, WIDTH, HEIGHT)

    def run(fmt="CHW"):
        return events_to_voxel_grid_padded(ev, BINS, WIDTH, HEIGHT, fmt)

    voxel_cuda.LAUNCHES = 0                        # the entry's path starts here
    ms = time_ms(run, calls, CUDA, warmup=0)
    launches = voxel_cuda.LAUNCHES                 # ... and ends here
    padded, n = pad_events(ev, 1 << 20, CUDA)
    plain = voxelize_padded_reference(padded, n, BINS, WIDTH, HEIGHT)
    errs = {}
    for fmt in ("CHW", "HWC"):
        got = run(fmt)
        want = plain if fmt == "CHW" else plain.permute(1, 2, 0)
        check(tuple(got.shape) == tuple(want.shape), f"padded {fmt}: shape {tuple(got.shape)}")
        errs[fmt] = float((got - want).abs().max())
    emit("voxel_grid_padded", events=PADDED_EVENTS, capacity=1 << 20, calls=calls,
         ms_per_call=ms, launches=launches, max_abs_err=errs, tol=KERNEL_TOL)
    check(launches == calls, f"the padded entry launched K1 {launches} times in {calls} calls")
    check(max(errs.values()) <= KERNEL_TOL, f"padded entry vs plain: {errs}")
    return launches


def phase_launch_path():
    """The kernels' launch path (``tools/launch_path.py::measure``): each
    wrapper's host microseconds a call at its main-path or probe shape and
    their split, CUDA-event and device ms, and the floors (``view.mul_(2)``,
    the one-call library versions of P1 and P2, an empty kernel, the
    runtime queries; whether P1's and P2's one-call library versions are
    bit-equal to the kernels).  Fails if the amax pass alone takes more than
    one launch."""
    spec = importlib.util.spec_from_file_location(
        "launch_path", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                    "launch_path.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    t0 = time.perf_counter()
    result = module.measure()
    rows, paired = result["wrappers"], result["paired"]
    emit("launch_path", seconds=time.perf_counter() - t0,
         p2_at_or_under_library=paired["P2"]["kernel_ms"] <= paired["P2"]["library_ms"],
         p1_at_or_under_library=paired["P1"]["kernel_ms"] <= paired["P1"]["library_ms"],
         **result)
    # the profiler may drop records, never add them: at most one launch a
    # call, every one the amax kernel
    amax = rows["amax"]
    check(amax["by_kernel"] and all("amax_kernel" in k for k in amax["by_kernel"])
          and amax["device_launches"] <= 1,
          f"the amax pass launched {amax['by_kernel']} a call")
    return result


def kernel_device_ms(fn, iters, name_part):
    """Device time per launch of the kernels whose name holds ``name_part``
    over ``iters`` calls of ``fn()``, from torch.profiler: for a kernel
    whose calls the host cannot launch as fast as the card runs them."""
    # averaged over the records the profiler kept (device_records)
    us = [t for name, t in device_records(fn, iters, name_part) if name_part in name]
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
    one = torch.ones((), dtype=d.dtype, device=CUDA)

    def p2_library():          # one PyTorch call, in place, on the slice taken each call
        view = scratch[0, 0, :8, :128]
        torch.add(one, view, alpha=2, out=view)

    p1 = {"ms": time_ms(lambda: probe_poison.passthrough(d), 50, CUDA),
          "plain_ms": time_ms(lambda: probe_poison.passthrough_reference(d), 50, CUDA),
          "library_ms": time_ms(lambda: torch.add(one, d, alpha=2), 50, CUDA),
          "library_two_ops_ms": time_ms(lambda: d * 2.0 + 1.0, 50, CUDA),
          **bound(2 * d.numel() * d.element_size(), 2 * d.numel(), F32_OPS_PER_S)}
    p2 = {"ms": time_ms(lambda: probe_poison.tiny_passthrough(scratch), 50, CUDA),
          "plain_ms": time_ms(lambda: probe_poison.tiny_passthrough_reference(scratch), 50, CUDA),
          "library_ms": time_ms(p2_library, 50, CUDA),
          **bound(2 * 8 * 128 * 2, 2 * 8 * 128, F32_OPS_PER_S)}
    p1_device_ms = kernel_device_ms(lambda: probe_poison.passthrough(d), 20,
                                    "passthrough_kernel")
    p2_device_ms = kernel_device_ms(lambda: probe_poison.tiny_passthrough(scratch), 20,
                                    "passthrough_slice_kernel")
    # one PyTorch op on the same (8, 128) view beside P2 (the launch floor, an
    # empty kernel, is the launch_path phase's)
    view = scratch[0, 0, :8, :128]
    p2_floor = {"op": "view.mul_(2)", "ms": time_ms(lambda: view.mul_(2), 50, CUDA),
                "device_ms": kernel_device_ms(lambda: view.mul_(2), 20, "elementwise")}
    p2.update(device_ms=p2_device_ms, view_mul_device_ms=p2_floor["device_ms"])
    del d, scratch, view, one

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
         p1_device_ms=p1_device_ms, p2_device_ms=p2_device_ms, p2_view_mul=p2_floor,
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


# --- the ablation lineages ------------------------------------------------------

def ablation_label(name, rbt, dcn=False, **overrides):
    return "/".join([name] + ([rbt] if rbt else []) + (["dcn"] if dcn else [])
                    + [f"{k}={v}" for k, v in overrides.items()])


def ablation_net_opt(name, rbt, dcn=False):
    """``network_g`` at the production widths (blurry VFI 11+1), seeded
    weights to come."""
    opt = {"type": name, "img_chn": 26, "ev_chn": 2, "num_encoders": 3,
           "base_num_channels": 32, "num_block": 1, "num_residual_blocks": 2,
           "use_first_dcn": dcn}
    if rbt:
        opt["recurrent_block_type"] = rbt
    return opt


def ablation_model(k, name, rbt, dcn):
    model = ARCHS.get(name)(ablation_net_opt(name, rbt, dcn))
    fill_random(model, seed=100 + k)         # every parameter, DCN offsets included
    return model


def phase_ablation_parity():
    """Each ablation network (seeded random weights) on the card (float32,
    TF32 off) against the CPU, at full width on a 128x128 frame, t = 5."""
    set_tf32(False)
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    s, t = ABLATION_PARITY_SIZE, ABLATION_PARITY_T
    x = torch.from_numpy(rng.rand(1, 26, s, s).astype(np.float32))
    ev = torch.from_numpy(rng.randn(1, t, 2, s, s).astype(np.float32))
    dbs, errs = {}, {}
    for k, (name, rbt, dcn) in enumerate(ABLATIONS):
        label = ablation_label(name, rbt, dcn)
        model = ablation_model(k, name, rbt, dcn).eval()
        with torch.no_grad():
            want = model(x, ev)
            got = model.to(CUDA)(x.to(CUDA), ev.to(CUDA)).cpu()
        check(got.shape == (1, t, 3, s, s) and bool(torch.isfinite(got).all()),
              f"ablation_parity {label}: shape {tuple(got.shape)} or not finite")
        dbs[label] = parity_db(want, got)
        errs[label] = float((want - got).abs().max())
        del model
    emit("ablation_parity", shape=[s, s], t=t, db=dbs, max_abs_err=errs, min_db=PARITY_DB,
         seconds=time.perf_counter() - t0)
    low = {k: v for k, v in dbs.items() if v < PARITY_DB}
    check(not low, f"ablation card vs CPU below {PARITY_DB} dB: {low}")


def dcn_hooks(model, enter, leave):
    """``enter(mod)`` before and ``leave(mod)`` after every call of a
    deformable conv of ``model``; returns a function that removes the hooks."""
    from refid_tpu_torch.ops.deform_conv import ModulatedDeformConvPack

    handles = []
    for mod in model.modules():
        if isinstance(mod, ModulatedDeformConvPack):
            handles += [mod.register_forward_pre_hook(lambda m, inp: enter(m)),
                        mod.register_forward_hook(lambda m, inp, out: leave(m))]
    return lambda: [handle.remove() for handle in handles]


def profile_dcn_window(pipe, request, dtype):
    """The DCN network's deformable convs in two more windows: CUDA events
    around each call (the stream's time from a call's first kernel to its
    last, host gaps included) against the host-clock window; then
    torch.profiler with a ``deform_conv`` range around each call: the
    device time of the kernels the ranges launched against all kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def run():
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == "bf16"):
            pipe(*request)
        torch.cuda.synchronize()

    pairs, scopes = [], []

    def start_events(mod):
        pairs.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()

    remove = dcn_hooks(pipe.model, start_events, lambda mod: pairs[-1][1].record())
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        remove()
    event_ms = sum(start.elapsed_time(end) for start, end in pairs)

    def enter(mod):
        scopes.append(record_function("deform_conv"))
        scopes[-1].__enter__()

    remove = dcn_hooks(pipe.model, enter, lambda mod: scopes.pop().__exit__(None, None, None))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        remove()
    events = prof.events()
    # kernels and copies; the ranges' own device-side spans are not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "deform_conv"]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    dcn_ms = sum(e.device_time_total for e in events
                  if e.name == "deform_conv" and e.device_type == DeviceType.CPU) / 1e3
    check(busy_ms > 0 and pairs and event_ms > 0 and dcn_ms > 0,
          f"DCN window: busy {busy_ms} ms, {len(pairs)} calls, {event_ms} / {dcn_ms} ms")
    return {"dtype": dtype, "window_ms": window_ms, "dcn_calls": len(pairs),
            "dcn_ms_cuda_events": event_ms, "dcn_share_of_window": event_ms / window_ms,
            "device_busy_ms_profiled": busy_ms, "kernels_profiled": len(kernels),
            "dcn_device_ms_profiler": dcn_ms, "dcn_share_of_device_time": dcn_ms / busy_ms}


def phase_ablation_serve():
    """Each ablation network (seeded random weights) through BlurVFIPipeline
    at 1280x720 with 2**20 events, ``voxelizer='pallas'`` (K1): float32 (TF32
    off) and bf16 autocast, ``ABLATION_WINDOWS`` windows each (the first a
    warm-up); host-clock ms per synchronised window, peak memory, bf16 against
    float32; the DCN network's deformable convs timed and profiled in two
    more windows of each dtype.  Returns K1's launches."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(12)
    requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 random_events(rng, FULL_EVENTS, WIDTH, HEIGHT))
                for _ in range(ABLATION_WINDOWS)]
    rows, dcn_profile = {}, []
    voxel_cuda.LAUNCHES = 0                      # the ablation serving path starts here
    for k, (name, rbt, dcn) in enumerate(ABLATIONS):
        label = ablation_label(name, rbt, dcn)
        model = ablation_model(k, name, rbt, dcn)
        pipe = BlurVFIPipeline(model, model.cfg, voxelizer="pallas", device="cuda")
        row, outs = {}, {}
        for dtype in ("f32", "bf16"):
            set_tf32(False)      # float32 without TF32; bf16 autocast ignores it
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i, request in enumerate(requests):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == "bf16"):
                    out = pipe(*request)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            check(out.shape == (23, HEIGHT, WIDTH, 3) and bool(torch.isfinite(out).all()),
                  f"ablation_serve {label} {dtype}: shape {tuple(out.shape)} or not finite")
            outs[dtype] = out.float()
            mean = sum(times) / len(times)
            row[dtype] = {"ms_per_window": times, "mean_ms_per_window": mean,
                          "frames_per_s": 23 * 1e3 / mean,
                          "max_memory_allocated": torch.cuda.max_memory_allocated()}
        row["bf16_vs_f32_db"] = parity_db(outs["f32"], outs["bf16"])
        if dcn:
            dcn_profile = [profile_dcn_window(pipe, requests[-1], dtype)
                           for dtype in ("f32", "bf16")]
        rows[label] = row
        del pipe, model, outs, out
        torch.cuda.empty_cache()
    launches = voxel_cuda.LAUNCHES               # ... and ends here
    emit("ablation_serve", frame=[HEIGHT, WIDTH], events=FULL_EVENTS, voxelizer="pallas",
         windows_per_dtype=ABLATION_WINDOWS, results=rows, dcn_profile=dcn_profile,
         voxelize_launches=launches, seconds=time.perf_counter() - t_phase)
    windows = len(ABLATIONS) * 2 * ABLATION_WINDOWS + 4      # + the DCN's four
    check(launches == windows, f"ablation serving launched K1 {launches} times for "
          f"{windows} windows")
    return launches


def ablation_train_options(data_root, name, rbt, overrides):
    """The production recipe as ``phase_train`` runs it (``recipe_overrides``,
    bf16), with ``network_g.type`` (and the block type and overrides)
    replaced, and no validation dataset."""
    import yaml

    with open(RECIPE) as f:
        opt = recipe_overrides(yaml.safe_load(f), data_root,
                               "ablation_" + ablation_label(name, rbt, **overrides)
                               .replace("/", "_").replace("=", "_"), "bf16")
    opt["network_g"].update(type=name, **overrides)
    if rbt:
        opt["network_g"]["recurrent_block_type"] = rbt
    del opt["datasets"]["val"]
    return opt


def phase_ablation_train(data_root, work):
    """The recipe (256x256 crops, t = 23, batch 1, remat) through the train
    CLI's ``main`` in bf16 for ``ABLATION_TRAIN_ITERS`` iterations, for each
    network of ABLATION_TRAIN (the flagship with ``remat_policy`` ``'all'``
    and ``'stage_outputs'``), then ``ABLATION_FIXED_STEPS`` timed steps on
    one batch: ms per iteration and peak memory.  Returns K2's launches."""
    import yaml

    t_phase = time.perf_counter()
    rows, grid_launches = {}, 0
    for k, (name, rbt, overrides) in enumerate(ABLATION_TRAIN):
        label = ablation_label(name, rbt, **overrides)
        path = os.path.join(work, f"ablation_{k}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(ablation_train_options(data_root, name, rbt, overrides), f)
        voxel_cuda.reset_grid_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        task = train_cli.main(["-opt", path, "--root", work,
                               "--max-iters", str(ABLATION_TRAIN_ITERS)])
        cli_memory = torch.cuda.max_memory_allocated()
        steps = [h for h in task.history if "loss" in h]
        losses = [h["loss"] for h in steps]
        items, launches = task.train_loader.dataset.timing["items"], voxel_cuda.GRID_LAUNCHES
        check(len(losses) == ABLATION_TRAIN_ITERS and all(math.isfinite(v) for v in losses),
              f"ablation_train {label}: losses {losses}")
        check(items > 0 and launches == items,
              f"ablation_train {label}: K2 launched {launches} times for {items} items")
        check(task.net.cfg.remat and task.net.cfg.dtype == torch.bfloat16,
              f"ablation_train {label}: not the recipe's remat in bf16")
        grid_launches += launches
        batch = next(iter(task.train_loader))
        torch.cuda.reset_peak_memory_stats()
        fixed_losses, fixed_ms = timed_steps(task, batch, ABLATION_FIXED_STEPS)
        rows[label] = {
            "losses": losses, "step_ms": [h["time"] * 1e3 for h in steps],
            "fixed_batch_losses": fixed_losses, "fixed_batch_step_ms": fixed_ms,
            "mean_fixed_step_ms_after_first": sum(fixed_ms[1:]) / len(fixed_ms[1:]),
            "max_memory_allocated_cli": cli_memory,
            "max_memory_allocated_fixed": torch.cuda.max_memory_allocated(),
            "items_loaded": items, "voxel_grid_launches": launches,
            "params": sum(p.numel() for p in task.net.parameters())}
        check(all(math.isfinite(v) for v in fixed_losses),
              f"ablation_train {label}: fixed-batch losses {fixed_losses}")
        del task, batch
        torch.cuda.empty_cache()
    emit("ablation_train", dtype="bf16", crop=256, t=23, batch=1, iters=ABLATION_TRAIN_ITERS,
         results=rows, seconds=time.perf_counter() - t_phase)
    return grid_launches


def ddp_options(data_root, work, name):
    """The recipe as ``phase_train`` runs it (``recipe_overrides``, bf16) with
    no validation dataset, written to ``{work}/{name}.yml``: (path, the
    parsed options)."""
    import yaml

    from refid_tpu_torch.core.config import parse_options

    with open(RECIPE) as f:
        opt = recipe_overrides(yaml.safe_load(f), data_root, name, "bf16")
    del opt["datasets"]["val"]
    path = os.path.join(work, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path, parse_options(path, is_train=True, root=work)


def phase_ddp_train(data_root, work):
    """The recipe (full width, its crop, bf16) through ``cli.train``'s
    ``main`` for DDP_ITERS iterations twice: as a plain process, and launched
    as torchrun launches a world of one (``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``MASTER_*`` in the environment: NCCL, the state
    broadcast from rank 0 and the gradients and loss all-reduced each step,
    one-rank NCCL collectives on the card).  The trained
    parameters must be bit-equal or agree at PARITY_DB on the update.
    Returns K2's launches."""
    t_phase = time.perf_counter()
    runs, launches = {}, 0
    for launch in ("plain", "torchrun"):
        env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        path, _ = ddp_options(data_root, work, f"ddp_{launch}")
        voxel_cuda.reset_grid_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if launch == "torchrun":
            os.environ.update(env)
        try:
            task = train_cli.main(["-opt", path, "--root", work, "--max-iters", str(DDP_ITERS)])
            backend = (torch.distributed.get_backend() if torch.distributed.is_initialized()
                       else None)
            reduced = task.trainer.mesh is not None
        finally:
            if launch == "torchrun":
                for key in env:
                    del os.environ[key]
                if torch.distributed.is_initialized():
                    torch.distributed.destroy_process_group()
        seconds = time.perf_counter() - t0
        check(backend == ("nccl" if launch == "torchrun" else None),
              f"ddp_train {launch}: process group backend {backend}")
        check(reduced == (launch == "torchrun"),
              f"ddp_train {launch}: gradients all-reduced {reduced}")
        steps = [h for h in task.history if "loss" in h]
        items = task.train_loader.dataset.timing["items"]
        check(len(steps) == DDP_ITERS and all(math.isfinite(h["loss"]) for h in steps),
              f"ddp_train {launch}: {steps}")
        check(items > 0 and voxel_cuda.GRID_LAUNCHES == items,
              f"ddp_train {launch}: K2 launched {voxel_cuda.GRID_LAUNCHES} times for {items}")
        launches += voxel_cuda.GRID_LAUNCHES
        runs[launch] = {"params": {k: v.detach().float().cpu()
                                   for k, v in task.net.state_dict().items()},
                        "step_ms": [h["time"] * 1e3 for h in steps], "seconds": seconds,
                        "device": str(task.device)}
        del task
        torch.cuda.empty_cache()
    _, opt = ddp_options(data_root, work, "ddp_init")
    init = build_task(opt, "cpu")
    init.init_params(opt.get("manual_seed", 0) or 0)
    start = {k: v.float() for k, v in init.net.state_dict().items()}
    plain, ddp = runs["plain"]["params"], runs["torchrun"]["params"]
    bit_equal = all(torch.equal(plain[k], ddp[k]) for k in plain)
    update = {name: torch.cat([(run[k] - start[k]).flatten() for k in sorted(start)])
              for name, run in (("plain", plain), ("torchrun", ddp))}
    update_db = parity_db(update["plain"], update["torchrun"])
    emit("ddp_train", dtype="bf16", iters=DDP_ITERS, world_size=1, backend="nccl",
         bit_equal=bit_equal, update_db=update_db, min_db=PARITY_DB,
         ms_per_iteration={k: v["step_ms"] for k, v in runs.items()},
         mean_ms_after_first={k: sum(v["step_ms"][1:]) / len(v["step_ms"][1:])
                              for k, v in runs.items()},
         devices={k: v["device"] for k, v in runs.items()}, voxel_grid_launches=launches,
         seconds=time.perf_counter() - t_phase)
    check(bit_equal or update_db >= PARITY_DB,
          f"ddp_train: the torchrun rank's update {update_db:.1f} dB < {PARITY_DB} from the plain run")
    return launches


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gloo_cuda_collectives():
    """Whether gloo carries, for CUDA tensors, the two collectives the
    spatial axis runs: ``all_reduce`` of bytes (the halos, the gathered
    output) and of float32 (the SE pools, gradients, loss).  ``{op: True or
    the error}``."""
    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device="cuda") + dist.get_rank()
    want = sum(torch.arange(8, dtype=torch.float32) + r for r in range(dist.get_world_size()))
    result = {}
    for name, dtype in (("all_reduce_uint8", torch.uint8), ("all_reduce_float32", torch.float32)):
        try:
            y = x.to(dtype)
            dist.all_reduce(y)
            result[name] = torch.equal(y.float().cpu(), want) or "wrong sum"
        except (RuntimeError, ValueError) as e:
            result[name] = str(e).splitlines()[0][:160]
        dist.barrier()
    return result


def spatial_rank(rank, world, port, work):
    """One rank of the spatial phases (spawned; one card shared by the
    ranks, gloo): the collectives gloo carries, then parity at a toy width
    (forward, and two training steps at data 1 x spatial 2 and at data 2 x
    spatial 1, each against the single-process computation in this rank),
    then 720p serving at full width through ``BlurVFIPipeline(mesh=)``.
    Writes ``{work}/spatial_{rank}.json``."""
    import torch.distributed as dist

    from refid_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = {"rank": rank, "collectives": gloo_cuda_collectives()}
        if not all(v is True for v in out["collectives"].values()):
            with open(os.path.join(work, f"spatial_{rank}.json"), "w") as f:
                json.dump(out, f)
            return
        set_tf32(False)
        b, t, h, w = SPATIAL_TOY_SHAPE
        cfg = RefidConfig(**SPATIAL_TOY)
        model = FinalBidirectionAttenfusion(cfg)
        fill_random(model, seed=5)
        state = model.state_dict()
        model = model.cuda()
        gen = torch.Generator().manual_seed(6)
        batches = [[torch.rand(b, cfg.img_chn, h, w, generator=gen),
                    torch.randn(b, t, 2, h, w, generator=gen),
                    torch.rand(b, t, 3, h, w, generator=gen)] for _ in range(2)]
        batches = [[a.cuda() for a in batch] for batch in batches]
        block = 2 ** cfg.num_encoders
        spatial_mesh = make_mesh(data=1, spatial=world)
        data_mesh = make_mesh(data=world, spatial=1)
        with torch.no_grad():
            want = model(*batches[0][:2])
            plan = SpatialPlan(spatial_mesh, h, block)
            with spatial_scope(plan):
                got = plan.gather(model(plan.shard(batches[0][0]), plan.shard(batches[0][1])))
        out["forward"] = {"db": parity_db(want, got), "max_abs_err": float((want - got).abs().max()),
                          "exchanges": plan.exchanges, "reductions": plan.reductions}

        def steps(mesh):
            net = FinalBidirectionAttenfusion(cfg)
            net.load_state_dict(state)
            net = net.cuda()
            trainer = Trainer(net, charbonnier_loss, recipe_train_opt(), 100,
                              frozen=known_unused_keys(net), mesh=mesh)
            losses = []
            for lq, vox, gt in batches:
                plan = None
                if mesh is not None and mesh.spatial > 1:
                    plan = SpatialPlan(mesh, h, block)
                    lq, vox, gt = (plan.shard(a) for a in (lq, vox, gt))
                elif mesh is not None and mesh.data > 1:
                    lq, vox, gt = (a[mesh.data_index::mesh.data] for a in (lq, vox, gt))
                losses.append(float(trainer.train_step(lq, vox, gt, plan)["loss"]))
            return losses, torch.cat([(p.detach() - state[k].cuda()).flatten().float()
                                      for k, p in trainer.named])

        ref_losses, ref_update = steps(None)
        out["steps"] = {}
        for name, mesh in (("data1_spatial2", spatial_mesh), ("data2_spatial1", data_mesh)):
            losses, update = steps(mesh)
            out["steps"][name] = {"update_db": parity_db(ref_update, update), "losses": losses,
                                  "single_process_losses": ref_losses}
        del model, batches
        torch.cuda.empty_cache()
        out["serve"] = spatial_serve(rank, spatial_mesh)
        torch.cuda.empty_cache()
        out["int8"] = spatial_int8(spatial_mesh)
        torch.cuda.empty_cache()
        out["ablation"] = spatial_ablation(spatial_mesh)
        out["evhinet"] = spatial_evhinet(spatial_mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"spatial_{rank}.json"), "w") as f:
        json.dump(out, f)


def spatial_serve(rank, mesh):
    """SPATIAL_WINDOWS 720p windows (2**20 events, bf16 autocast, full width)
    through ``BlurVFIPipeline(mesh=)``, every rank making the same call;
    then rank 0 serves the last window unsharded for the dB."""
    import torch.distributed as dist

    model = FinalBidirectionAttenfusion(RefidConfig())
    fill_random(model, seed=0)
    state = model.state_dict()
    rng = np.random.RandomState(13)
    requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 random_events(rng, FULL_EVENTS, WIDTH, HEIGHT)) for _ in range(SPATIAL_WINDOWS)]
    pipe = BlurVFIPipeline(state, RefidConfig(), mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    voxel_cuda.LAUNCHES = 0                      # this rank's spatial serving path starts here
    times = []
    for i, request in enumerate(requests):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = pipe(*request)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = voxel_cuda.LAUNCHES               # ... and ends here
    plan = pipe.last_plan                        # None on a single rank
    result = {"ms_per_window": times, "mean_ms_per_window": sum(times) / len(times),
              "rows": plan.rows if plan else [(0, HEIGHT)],
              "exchanges_per_window": plan.exchanges if plan else 0,
              "exchange_bytes_per_window": plan.exchange_bytes if plan else 0,
              "allreduce_bytes_per_window": plan.allreduce_bytes if plan else 0,
              "pooled_reductions_per_window": plan.reductions if plan else 0,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "voxelize_launches": launches, "finite": bool(torch.isfinite(got).all()),
              "shape": list(got.shape)}
    del pipe
    if rank == 0:
        single = BlurVFIPipeline(state, RefidConfig(), device="cuda")
        with torch.autocast("cuda", dtype=torch.bfloat16):
            want = single(*requests[-1])
        result["db_vs_single_process"] = parity_db(want.float(), got.float())
        del single
    dist.barrier()
    return result


def sharded_update(model, state, batch, mesh, block, loss_fn=charbonnier_loss):
    """One recipe optimiser step of ``model`` (reset to ``state``) on
    ``batch`` (``lq, voxel, gt`` on the card), on this rank's rows under a
    spatial ``mesh`` or whole (None): the update, flat, and the step's
    loss and gradient norm (before the clip; reduced over the group)."""
    model.load_state_dict(state)
    trainer = Trainer(model, loss_fn, recipe_train_opt(), 100,
                      frozen=known_unused_keys(model), mesh=mesh)
    plan = None
    if mesh is not None:
        plan = SpatialPlan(mesh, batch[0].shape[-2], block)
        batch = [plan.shard(a) for a in batch]
    metrics = trainer.train_step(*batch, plan)
    update = torch.cat([(p.detach() - state[k]).flatten().float() for k, p in trainer.named])
    return update, float(metrics["loss"]), float(metrics["grad_norm"])


def step_parity(ref, got):
    """The dB of a sharded step's update against the whole step's, and the
    relative errors of its loss and gradient norm (one AdamW step's update
    is about the gradient's sign: the norm sees its magnitude)."""
    return {"update_db": parity_db(ref[0], got[0]), "loss": got[1], "whole_loss": ref[1],
            "grad_norm": got[2], "whole_grad_norm": ref[2],
            "loss_rel_err": abs(got[1] - ref[1]) / abs(ref[1]),
            "grad_norm_rel_err": abs(got[2] - ref[2]) / abs(ref[2])}


def step_ok(row):
    return (row["update_db"] >= PARITY_DB and row["loss_rel_err"] <= SPATIAL_STEP_RTOL
            and row["grad_norm_rel_err"] <= SPATIAL_STEP_RTOL)


def sharded_forward(model, mesh, *inputs):
    """``model(*inputs)`` on this rank's rows, gathered, with the plan."""
    plan = SpatialPlan(mesh, inputs[0].shape[-2], model.row_block)
    with torch.no_grad(), spatial_scope(plan):
        return plan.gather(model(*(plan.shard(a) for a in inputs))), plan


def spatial_int8(mesh):
    """720p windows (2**20 events, bf16 autocast, the network's own init) in
    each int8 mode through ``BlurVFIPipeline(mesh=)`` ("static" calibrated on
    another window on the shards first); the last window against the whole
    int8 window served in this rank with the same scales.  Counts the int8
    kernels' launches over the sharded windows: each window launches
    ``conv_int8`` and ``quantize_int8`` once a site (and the amax pass once a
    dynamic site)."""
    import torch.distributed as dist

    state = module_init_state()
    rng = np.random.RandomState(21)
    requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 random_events(rng, FULL_EVENTS, WIDTH, HEIGHT))
                for _ in range(SPATIAL_INT8_WINDOWS + 1)]
    result, totals = {}, {"conv_int8": 0, "quantize_int8": 0, "voxelize": 0}
    for mode in INT8_SITES:
        pipe = BlurVFIPipeline(state, RefidConfig(), int8=mode, mesh=mesh, device="cuda")
        calib_ms = None
        if mode == "static":
            dist.barrier()
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                pipe.calibrate(*requests[0])
            torch.cuda.synchronize()
            calib_ms = (time.perf_counter() - t0) * 1e3
        int8_cuda.reset_launches()               # this mode's sharded windows start here
        voxel_cuda.LAUNCHES = 0
        times = []
        for i, request in enumerate(requests[1:]):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = pipe(*request)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        launches = {"conv_int8": int8_cuda.CONV_LAUNCHES,           # ... and end here
                    "quantize_int8": int8_cuda.QUANTIZE_LAUNCHES,
                    "amax_pass": int8_cuda.AMAX_LAUNCHES, "voxelize": voxel_cuda.LAUNCHES}
        for k in totals:
            totals[k] += launches[k]
        plan = pipe.last_plan
        whole = BlurVFIPipeline(state, RefidConfig(), int8=mode, device="cuda")
        if mode == "static":                    # the shards' scales
            whole._int8_scales, whole._int8_exclude = pipe._int8_scales, pipe._int8_exclude
        with torch.autocast("cuda", dtype=torch.bfloat16):
            want = whole(*requests[-1])
        if mode == "static":
            calibrated = BlurVFIPipeline(state, RefidConfig(), int8=mode, device="cuda")
            with torch.autocast("cuda", dtype=torch.bfloat16):
                calibrated.calibrate(*requests[0])
            amax_equal = calibrated._int8_raw_amax == pipe._int8_raw_amax
            del calibrated
        result[str(mode)] = {
            "sites": INT8_SITES[mode], "windows": SPATIAL_INT8_WINDOWS,
            "launches": launches, "ms_per_window": times, "calibrate_ms": calib_ms,
            "calibrated_amax_equal_to_whole": amax_equal if mode == "static" else None,
            "exchanges_per_window": plan.exchanges, "reductions_per_window": plan.reductions,
            "exchange_bytes_per_window": plan.exchange_bytes,
            "db_vs_whole": parity_db(want.float(), got.float()),
            "bit_equal": bool(torch.equal(want, got)),
            "max_abs_err": float((want.float() - got.float()).abs().max()),
            "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del pipe, whole, got, want
        torch.cuda.empty_cache()
    return {"modes": result, "launches": totals}


def spatial_ablation(mesh):
    """Each ablation lineage of ABLATIONS at its production widths
    (``ablation_net_opt``) on SPATIAL_TOY_SHAPE, seeded weights, f32, TF32
    off: the forward on the shards against the whole one, and one optimiser
    step against the whole step; then SPATIAL_LINEAGES_SERVED at 720p."""
    b, t, h, w = SPATIAL_TOY_SHAPE
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(22)
    batch = [torch.rand(b, 26, h, w, generator=gen), torch.randn(b, t, 2, h, w, generator=gen),
             torch.rand(b, t, 3, h, w, generator=gen)]
    batch = [a.cuda() for a in batch]
    rows = {}
    for k, (name, rbt, dcn) in enumerate(ABLATIONS):
        model = ablation_model(k, name, rbt, dcn)
        state = {key: v.cuda() for key, v in model.state_dict().items()}
        model = model.cuda()
        with torch.no_grad():
            want = model(*batch[:2])
        got, plan = sharded_forward(model, mesh, *batch[:2])
        ref = sharded_update(model, state, batch, None, model.row_block)
        upd = sharded_update(model, state, batch, mesh, model.row_block)
        rows[ablation_label(name, rbt, dcn)] = {
            "forward_db": parity_db(want, got), "max_abs_err": float((want - got).abs().max()),
            **step_parity(ref, upd), "exchanges": plan.exchanges,
            "reductions": plan.reductions}
        del model, state
    seconds = time.perf_counter() - t_phase
    return {"rows": rows, "seconds": seconds, "served": spatial_lineage_serve(mesh)}


def spatial_lineage_serve(mesh):
    """SPATIAL_LINEAGES_SERVED through ``BlurVFIPipeline(mesh=)`` at 720p
    (2**20 events, f32, TF32 off, seeded weights), every rank making the
    same calls; the last window against the whole window in this rank.
    Counts K1's launches over the sharded windows."""
    import torch.distributed as dist

    rng = np.random.RandomState(25)
    requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                 random_events(rng, FULL_EVENTS, WIDTH, HEIGHT))
                for _ in range(SPATIAL_LINEAGE_WINDOWS)]
    rows, launches = {}, 0
    for name, rbt, dcn in SPATIAL_LINEAGES_SERVED:
        model = ablation_model(ABLATIONS.index((name, rbt, dcn)), name, rbt, dcn)
        pipe = BlurVFIPipeline(model, model.cfg, mesh=mesh, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        voxel_cuda.LAUNCHES = 0                  # this lineage's sharded windows start here
        times = []
        for i, request in enumerate(requests):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pipe(*request)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        launches += voxel_cuda.LAUNCHES          # ... and end here
        plan = pipe.last_plan
        whole = BlurVFIPipeline(model, model.cfg, device="cuda")
        want = whole(*requests[-1])
        rows[ablation_label(name, rbt, dcn)] = {
            "db_vs_whole": parity_db(want, got), "max_abs_err": float((want - got).abs().max()),
            "ms_per_window": times, "exchanges_per_window": plan.exchanges,
            "exchange_bytes_per_window": plan.exchange_bytes,
            "allreduce_bytes_per_window": plan.allreduce_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape)}
        del pipe, whole, model, got, want
        torch.cuda.empty_cache()
    return {"rows": rows, "voxelize_launches": launches}


def spatial_evhinet(mesh):
    """EVHINet at full width (seeded weights, f32, TF32 off): a 720p image
    (2**19 events in 6 bins, K2 on this rank) on the shards against the
    whole image, and one optimiser step at SPATIAL_EVHINET_STEP against the
    whole step."""
    t_phase = time.perf_counter()
    state = {k: v.cuda() for k, v in evhinet_state(1, filled=True).items()}
    net = EVHINet().cuda()
    net.load_state_dict(state)
    rng = np.random.RandomState(23)
    img = rng.rand(HEIGHT, WIDTH, 3).astype(np.float32)
    voxel_cuda.GRID_LAUNCHES = 0                 # this rank's item voxelized here
    voxel_cuda.reset_norm_stats()
    vox, _ = evhinet_voxel(random_events(rng, EV_EVENTS, WIDTH, HEIGHT), WIDTH, HEIGHT)
    grids, norms = voxel_cuda.GRID_LAUNCHES, voxel_cuda.NORM_LAUNCHES
    x, v = (to_nchw(torch.from_numpy(a[None]).cuda()) for a in (img, vox))
    with torch.no_grad():
        want = net(x, v)
    got, plan = sharded_forward(net, mesh, x, v)
    n, crop = SPATIAL_EVHINET_STEP
    gen = torch.Generator().manual_seed(24)
    batch = [a.cuda() for a in (torch.rand(n, 3, crop, crop, generator=gen),
                                torch.randn(n, EV_BINS, crop, crop, generator=gen),
                                torch.rand(n, 3, crop, crop, generator=gen))]
    ref = sharded_update(net, state, batch, None, net.row_block)
    upd = sharded_update(net, state, batch, mesh, net.row_block)
    return {"forward_db": parity_db(want, got), "bit_equal": bool(torch.equal(want, got)),
            "max_abs_err": float((want - got).abs().max()), "exchanges": plan.exchanges,
            "reductions": plan.reductions, **step_parity(ref, upd),
            "voxel_grid_launches": grids, "voxel_norm_launches": norms,
            "seconds": time.perf_counter() - t_phase}


def phase_spatial(work):
    """spatial_parity, spatial_serve, spatial_int8, spatial_ablation and
    spatial_evhinet: SPATIAL_RANKS gloo ranks on the one card (spawned).
    Fails where gloo does not carry the halo's collectives for CUDA tensors.
    Returns the launches of K1, K2, VN and the two int8 kernels in the ranks."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    world = SPATIAL_RANKS
    ctx = mp.start_processes(spatial_rank, args=(world, free_port(), work), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPATIAL_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise SystemExit(f"chip_smoke: FAILED: spatial ranks ran past {SPATIAL_TIMEOUT} s")
    ranks = []
    for rank in range(world):
        with open(os.path.join(work, f"spatial_{rank}.json")) as f:
            ranks.append(json.load(f))
    carried = ranks[0]["collectives"]
    emit("gloo_cuda_collectives", world=world, results=carried)
    check(all(v is True for v in carried.values()) and all("serve" in r for r in ranks),
          f"spatial: gloo does not carry the halo's collectives for CUDA tensors: {carried}")
    forward = ranks[0]["forward"]
    emit("spatial_parity", ranks=world, config=SPATIAL_TOY, shape=SPATIAL_TOY_SHAPE,
         dtype="f32", tf32=False, forward=forward, forward_min_db=SPATIAL_FORWARD_DB,
         steps=ranks[0]["steps"], steps_min_db=PARITY_DB)
    check(forward["db"] >= SPATIAL_FORWARD_DB,
          f"spatial_parity forward {forward['db']:.1f} dB < {SPATIAL_FORWARD_DB}")
    for name, row in ranks[0]["steps"].items():
        check(row["update_db"] >= PARITY_DB,
              f"spatial_parity {name}: update {row['update_db']:.1f} dB < {PARITY_DB}")
    serve = [r["serve"] for r in ranks]
    emit("spatial_serve", ranks=world, frame=[HEIGHT, WIDTH], events=FULL_EVENTS,
         dtype="bf16", windows_timed=SPATIAL_WINDOWS - 1,
         note="ranks sharing one card: exchange overhead, not scaling",
         db_vs_single_process=serve[0]["db_vs_single_process"], per_rank=serve,
         seconds=time.perf_counter() - t_phase)
    check(all(r["finite"] and r["shape"] == [23, HEIGHT, WIDTH, 3] for r in serve),
          f"spatial_serve outputs {[(r['shape'], r['finite']) for r in serve]}")
    check(serve[0]["db_vs_single_process"] >= SPATIAL_SERVE_MIN_DB,
          f"spatial_serve {serve[0]['db_vs_single_process']:.1f} dB < {SPATIAL_SERVE_MIN_DB} "
          "vs one process")
    launches = sum(r["voxelize_launches"] for r in serve)
    check(launches == world * SPATIAL_WINDOWS,
          f"spatial_serve launched K1 {launches} times for {world} x {SPATIAL_WINDOWS} windows")
    return {"voxelize": launches, **phase_spatial_others(ranks)}


def phase_spatial_others(ranks):
    """The lines and checks of spatial_int8, spatial_ablation and
    spatial_evhinet from the ranks' results; their launches."""
    world = len(ranks)
    int8 = [r["int8"] for r in ranks]
    per_mode = {mode: [r["modes"][str(mode)] for r in int8] for mode in INT8_SITES}
    emit("spatial_int8", ranks=world, frame=[HEIGHT, WIDTH], events=FULL_EVENTS, dtype="bf16",
         weights="module init, seed 0", windows_a_mode=SPATIAL_INT8_WINDOWS,
         min_db=SPATIAL_SERVE_MIN_DB, note="ranks sharing one card: exchange overhead",
         per_mode={str(m): v for m, v in per_mode.items()})
    for mode, rows in per_mode.items():
        want = INT8_SITES[mode] * SPATIAL_INT8_WINDOWS
        for rank, row in enumerate(rows):
            got = row["launches"]
            check(got["conv_int8"] == got["quantize_int8"] == want
                  and got["amax_pass"] == (0 if mode == "static" else want)
                  and got["voxelize"] == SPATIAL_INT8_WINDOWS,
                  f"spatial_int8 {mode} rank {rank}: launches {got} for "
                  f"{SPATIAL_INT8_WINDOWS} windows of {INT8_SITES[mode]} sites")
            check(row["finite"] and row["shape"] == [23, HEIGHT, WIDTH, 3]
                  and row["db_vs_whole"] >= SPATIAL_SERVE_MIN_DB and row["bit_equal"],
                  f"spatial_int8 {mode} rank {rank}: {row['db_vs_whole']:.1f} dB against the "
                  f"whole window (bit-equal {row['bit_equal']}, required: the int8 sums are "
                  f"exact and the scales the whole frame's), shape {row['shape']}")
    rows = ranks[0]["ablation"]["rows"]
    emit("spatial_ablation", ranks=world, shape=SPATIAL_TOY_SHAPE,
         base_num_channels=ablation_net_opt("UNetRecurrent", None)["base_num_channels"],
         dtype="f32", tf32=False, forward_min_db=SPATIAL_FORWARD_DB, update_min_db=PARITY_DB,
         step_rtol=SPATIAL_STEP_RTOL, rows=rows,
         seconds=[r["ablation"]["seconds"] for r in ranks])
    low = {k: (v["forward_db"], v["update_db"], v["loss_rel_err"], v["grad_norm_rel_err"])
           for k, v in rows.items() if v["forward_db"] < SPATIAL_FORWARD_DB or not step_ok(v)}
    check(len(rows) == len(ABLATIONS) and not low,
          f"spatial_ablation below {SPATIAL_FORWARD_DB} / {PARITY_DB} dB or loss / grad "
          f"norm beyond {SPATIAL_STEP_RTOL}: {low}")
    served = [r["ablation"]["served"] for r in ranks]
    emit("spatial_lineage_serve", ranks=world, frame=[HEIGHT, WIDTH], events=FULL_EVENTS,
         dtype="f32", tf32=False, windows=SPATIAL_LINEAGE_WINDOWS, min_db=SPATIAL_FORWARD_DB,
         note="ranks sharing one card: exchange overhead, not scaling",
         per_rank=[s["rows"] for s in served])
    for rank, s in enumerate(served):
        bad = {k: (v["db_vs_whole"], v["shape"], v["finite"]) for k, v in s["rows"].items()
               if v["db_vs_whole"] < SPATIAL_FORWARD_DB or not v["finite"]
               or v["shape"] != [23, HEIGHT, WIDTH, 3]}
        check(len(s["rows"]) == len(SPATIAL_LINEAGES_SERVED) and not bad,
              f"spatial_lineage_serve rank {rank}: below {SPATIAL_FORWARD_DB} dB or bad "
              f"output: {bad}")
        want = len(SPATIAL_LINEAGES_SERVED) * SPATIAL_LINEAGE_WINDOWS
        check(s["voxelize_launches"] == want,
              f"spatial_lineage_serve rank {rank}: K1 launched {s['voxelize_launches']} times "
              f"for {want} windows")
    ev = [r["evhinet"] for r in ranks]
    emit("spatial_evhinet", ranks=world, frame=[HEIGHT, WIDTH], dtype="f32", tf32=False,
         step=SPATIAL_EVHINET_STEP, forward_min_db=SPATIAL_FORWARD_DB, update_min_db=PARITY_DB,
         per_rank=ev)
    check(all(e["forward_db"] >= SPATIAL_FORWARD_DB and step_ok(e)
              and e["voxel_grid_launches"] == e["voxel_norm_launches"] == 1 for e in ev),
          f"spatial_evhinet: {[(e['forward_db'], e['update_db']) for e in ev]} dB "
          f"(bars {SPATIAL_FORWARD_DB} / {PARITY_DB}), loss / grad norm relative errors "
          f"{[(e['loss_rel_err'], e['grad_norm_rel_err']) for e in ev]} (bar "
          f"{SPATIAL_STEP_RTOL}) or K2 / VN not once a rank")
    return {"voxelize_int8": sum(r["launches"]["voxelize"] for r in int8)
            + sum(s["voxelize_launches"] for s in served),
            "voxel_grid": sum(e["voxel_grid_launches"] for e in ev),
            "voxel_norm": sum(e["voxel_norm_launches"] for e in ev),
            "conv_int8": sum(r["launches"]["conv_int8"] for r in int8),
            "quantize_int8": sum(r["launches"]["quantize_int8"] for r in int8)}


def phase_mp_loader(data_root, work):
    """The recipe's train items (its crop, flips, reversal and enlarge ratio;
    items voxelized by K2 on the card) through the process loader and the
    thread loader for LOADER_EPOCHS epochs: the same items, equal gts, lq
    (which packs voxel bins) and voxels within KERNEL_TOL (K2's order of
    adds).  The first epoch warms each loader up (the process pool's spawn
    falls in it); items/s is read over the later ones, the steady state.
    The process loader's
    workers read, decode and crop only: every voxelization is K2 in this
    process, one for each item.  Returns K2's launches."""
    from refid_tpu_torch.data.loader import PrefetchLoader, build_loader
    from refid_tpu_torch.data.mp_loader import ProcessPrefetchLoader

    opt = ddp_options(data_root, work, "mp_loader")[1]["datasets"]["train"]
    opt.update(prefetch_mode="process", seed=3)
    result, batches, launches = {}, {}, 0
    for name in ("process", "thread"):
        dataset = build_dataset(dict(opt), "cuda")
        process = build_loader(dataset, opt, is_train=True, seed=7)
        check(isinstance(process, ProcessPrefetchLoader), "prefetch_mode: process built no pool")
        loader = process if name == "process" else PrefetchLoader(
            dataset, process.batch_size, process.sampler, process.num_workers,
            process.prefetch_batches)
        voxel_cuda.reset_grid_stats()
        seconds = []
        try:
            batches[name] = []
            for epoch in range(LOADER_EPOCHS):
                t0 = time.perf_counter()
                loader.set_epoch(epoch)
                batches[name] += list(loader)
                seconds.append(time.perf_counter() - t0)
        finally:
            process.close()
        items = sum(len(b["seq"]) for b in batches[name])
        per_epoch = items // LOADER_EPOCHS
        check(voxel_cuda.GRID_LAUNCHES == items == dataset.timing["items"],
              f"mp_loader {name}: K2 launched {voxel_cuda.GRID_LAUNCHES} times for {items} items")
        launches += voxel_cuda.GRID_LAUNCHES
        result[name] = {"items": items, "epoch_seconds": seconds,
                        "items_per_s_first_epoch": per_epoch / seconds[0],
                        "items_per_s_steady": per_epoch * (LOADER_EPOCHS - 1) / sum(seconds[1:]),
                        "workers": loader.num_workers,
                        "data_ms_per_item": {k: v / items for k, v in dataset.timing.items()
                                             if k != "items"}}
    pairs = list(zip(batches["process"], batches["thread"]))
    same = len(batches["process"]) == len(batches["thread"]) and all(
        a["seq"] == b["seq"] and a["origin_index"] == b["origin_index"] for a, b in pairs)
    max_diff = {k: max(float(np.abs(a[k] - b[k]).max()) for a, b in pairs)
                for k in ("lq", "gt", "voxel")}
    emit("mp_loader", epochs=LOADER_EPOCHS, crop=opt["gt_size"],
         enlarge_ratio=opt["dataset_enlarge_ratio"], same_items=same, max_abs_diff=max_diff,
         voxel_tol=KERNEL_TOL, voxel_grid_launches=launches, **result)
    # K2 adds each cell's votes with shared atomics in a varying order
    # (csrc/voxelize.cu), so two runs of one item agree to rounding, not bit
    # for bit: the grids and the bins packed into lq; the gts must be equal.
    check(same and max_diff["gt"] == 0.0 and max(max_diff["lq"], max_diff["voxel"]) <= KERNEL_TOL,
          f"mp_loader: the process loader's batches differ from the thread loader's {max_diff}")
    return launches


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
    t1 = time.perf_counter()
    host = build.build_host("png_unfilter")        # the host C unfilter, not a kernel
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "ptxas": [
             line for line in v["log"].splitlines() if "Used" in line or "spill" in line]}
                  for k, v in built.items()},
         host={"png_unfilter": {"seconds": time.perf_counter() - t1, "path": host.name}})
    launch_path = phase_launch_path()

    max_err, events, skewed, n_valid = phase_kernel_check()
    timing = phase_kernel_timing(events, skewed, n_valid)
    grid_err, grid_events, grid_skewed = phase_grid_kernel_check()
    grid_timing = phase_grid_kernel_timing(grid_events, grid_skewed)
    norm_launches, norm_err, norm_grid = phase_norm_kernel_check()
    norm_timing = phase_norm_kernel_timing(norm_grid)
    del norm_grid

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
    del pipe, out32, out16

    t0 = time.perf_counter()
    int8_errs = phase_int8_kernel_check()
    shard_errs = phase_spatial_int8_kernel_check()
    int8_timing = phase_int8_kernel_timing()
    set_tf32(False)
    int8_launches, int8_db, int8_faults = phase_int8_serve(requests)
    emit("int8_path", launches=int8_launches, db_vs_f32=int8_db,
         seconds=time.perf_counter() - t0)
    check(min(int8_launches.values()) > 0, f"an int8 kernel was not launched: {int8_launches}")
    del requests

    t0 = time.perf_counter()
    evhinet_errs = phase_evhinet_kernel_check()
    phase_evhinet_parity(evhinet_state(1, filled=True))
    rng = np.random.RandomState(8)
    ev_requests = [(rng.rand(HEIGHT, WIDTH, 3).astype(np.float32),
                    random_events(rng, EV_EVENTS, WIDTH, HEIGHT)) for _ in range(EVHINET_IMAGES)]
    evhinet_launches, serve_k2, serve_k2_err, serve_vn, evhinet_db, evhinet_low = \
        phase_evhinet_serve(ev_requests)
    emit("evhinet_path", launches=evhinet_launches, voxel_grid_launches=serve_k2,
         voxel_norm_launches=serve_vn, db_vs_f32=evhinet_db,
         seconds=time.perf_counter() - t0)
    norm_launches += serve_vn
    del ev_requests
    launches += phase_voxel_grid_padded()        # K1's other entry, its own path

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
        del task, batch
        phase_metric_parity(data_root)
        eval_k2, eval_results = phase_eval(data_root, work, state)   # the eval path
        grid_launches += eval_k2
        t0 = time.perf_counter()
        evhinet_k2, evhinet_vn, evhinet_results = phase_evhinet_eval(
            data_root, work, evhinet_state(1, filled=True))
        emit("evhinet_eval_path", voxel_grid_launches=evhinet_k2,
             voxel_norm_launches=evhinet_vn, seconds=time.perf_counter() - t0)
        norm_launches += evhinet_vn
        grid_launches += serve_k2 + evhinet_k2
        t0 = time.perf_counter()                   # released-checkpoint evaluation
        highrev, bsergb = layout_trees(data_root, work)
        released_launches = phase_eval_released(
            work, data_root, highrev, state, os.path.join(work, "evhinet.pth"), eval_results,
            evhinet_results[EVHINET_CROP])
        emit("eval_released_path", launches=released_launches, seconds=time.perf_counter() - t0)
        grid_launches += released_launches["voxel_grid"]
        norm_launches += released_launches["voxel_norm"]
        t0 = time.perf_counter()                   # the IO and training tail
        grid_launches += phase_png(data_root, work)
        phase_evhinet_train_parity(evhinet_state(1, filled=True))
        torch.backends.cudnn.allow_tf32 = True       # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype in ("f32", "bf16"):
            grid_launches += phase_evhinet_train(data_root, work, dtype)
        grid_launches += phase_datasets(data_root, highrev, bsergb)
        emit("io_train_tail", seconds=time.perf_counter() - t0)

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
        check(min(probe_launches.values()) > 0,
              f"a probe kernel was not launched: {probe_launches}")

        t0 = time.perf_counter()                   # the ablation lineages
        phase_ablation_parity()
        launches += phase_ablation_serve()          # K1, each window
        torch.backends.cudnn.allow_tf32 = True       # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        grid_launches += phase_ablation_train(data_root, work)   # K2, each item
        emit("ablation_path", seconds=time.perf_counter() - t0)

        t0 = time.perf_counter()                   # distribution and the process loader
        torch.backends.cudnn.allow_tf32 = True       # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        grid_launches += phase_mp_loader(data_root, work)  # K2, each item, in this process
        grid_launches += phase_ddp_train(data_root, work)  # K2, each item
        spatial_launches = phase_spatial(work)       # K1, K2, C8, Q8 in each rank
        launches += spatial_launches["voxelize"] + spatial_launches["voxelize_int8"]
        grid_launches += spatial_launches["voxel_grid"]
        norm_launches += spatial_launches["voxel_norm"]
        emit("distribution_path", seconds=time.perf_counter() - t0)

    def rate_entry(variant, plain_ms, library, kernel):
        r = rates[variant]
        return {"ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": rates[library]["ms"],
                "device_ms": device_ms[kernel], "bound_share": r["bound_ms"] / r["ms"]}

    # checked last, so that the other phases still report: an int8 mode more
    # than 3 dB below the bf16 window is a fault, not a figure
    check(not int8_faults, f"int8 modes {int8_faults} more than 3 dB below bf16: {int8_db}")
    check(not evhinet_low, f"EVHINet int8 modes {evhinet_low} below the "
          f"{quant.PRODUCTION_DB_GATE} dB gate: {evhinet_db}")
    print(smi, flush=True)
    kernels = [{
        "name": "voxelize", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxelize.cu",
        "replaces": "refid_tpu/events/voxel_pallas.py:311",
        "launches": launches, "max_abs_err": max_err, **timing}, {
        "name": "voxel_grid", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxelize.cu",
        "replaces": "refid_tpu/events/voxel_pallas.py:129",
        "launches": grid_launches, "max_abs_err": max(grid_err, serve_k2_err),
        **grid_timing}, {
        "name": "voxel_norm", "route": "cuda",
        "source": "refid_tpu_torch/csrc/voxel_norm.cu",
        "replaces": "refid_tpu/events/voxel.py:195",
        "launches": norm_launches, "max_abs_err": norm_err, **norm_timing}, {
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
        **rate_entry("int8_roll", p4_plain_ms, "library_int8", "band_conv_int8")}, {
        "name": "quantize_int8", "route": "cuda",
        "source": "refid_tpu_torch/csrc/conv_int8.cu",
        "replaces": "refid_tpu/serve/quant.py:147",
        "launches": int8_launches["quantize_int8"] + evhinet_launches["quantize_int8"]
        + spatial_launches["quantize_int8"] + released_launches["quantize_int8"],
        "max_abs_err": max(int8_errs["quantize_int8"], evhinet_errs["quantize_int8"],
                           shard_errs["quantize_int8"]),
        **int8_timing["quantize_int8"]}, {
        "name": "conv_int8", "route": "cuda",
        "source": "refid_tpu_torch/csrc/conv_int8.cu",
        "replaces": "refid_tpu/serve/quant.py:147",
        "launches": int8_launches["conv_int8"] + evhinet_launches["conv_int8"]
        + spatial_launches["conv_int8"] + released_launches["conv_int8"],
        "max_abs_err": max(int8_errs["conv_int8"], evhinet_errs["conv_int8"],
                           shard_errs["conv_int8"]),
        **int8_timing["conv_int8"]}]
    # each wrapper's host time a call, from the launch_path phase (VN's whole
    # call is its timing's wall_ms); P2's launch floor there, an empty
    # kernel's device time
    wrappers = {"voxelize": "K1", "voxel_grid": "K2", "passthrough": "P1",
                "passthrough_slice": "P2", "band_conv": "P3", "band_conv_int8": "P4",
                "quantize_int8": "Q8_dynamic", "conv_int8": "C8"}
    for k in kernels:
        if k["name"] not in wrappers:
            continue
        k["host_us"] = launch_path["wrappers"][wrappers[k["name"]]]["host_us"]["median"]
        if k["name"] == "passthrough_slice":
            k["launch_floor_device_ms"] = \
                launch_path["floors"]["empty kernel (ctypes)"]["device_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
