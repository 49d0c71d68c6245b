"""Does a hand-written kernel between cuDNN convs slow them?  The port's
counterpart of ``scripts/probe_poison.py``.

    python -m refid_tpu_torch.probes.poison [--variants ...] [--steps 3]
        [--iters 16] [--device cuda|cpu]

On the TPU, any Pallas kernel in a module demoted XLA's large convs to slow
loop fusions (``refid_tpu/events/voxel_pallas.py:3``).  The probe replays
the scale-0 / scale-1 structure of the network at full serving geometry,
channels_last bf16, chained over ``--steps`` steps:

    e (1,128,720,640) --3x3 trunk convs--> h --(4,3)/(2,1) down--> d
    (1,64,360,640) --[variant]--> 3x3 up to 256, upmix --> e' = h + up

Variants for the scale-1 op:

* ``torch``: ``d * 2 + 1`` in PyTorch (the JAX script's ``xla``).
* ``cuda``, ``cuda_bN``: P1, :func:`passthrough`, the CUDA kernel of
  ``csrc/passthrough.cu`` over bands of 8 (or N) rows (``pallas``,
  ``pallas_bN``).
* ``tiny``: ``d * 2 + 1`` then P2, :func:`tiny_passthrough`, on one
  ``(8, 128)`` slice.
* ``convert``: P1 with a float32 round trip on each side.
* ``barrier``: runs as ``cuda``.  The JAX script wraps the kernel in
  ``optimization_barrier``; eager PyTorch materializes every operand
  already, so there is nothing to add.

Each prints ms per step, timed with CUDA events around ``--iters`` runs of
``--steps`` steps (each run starts again from the same input) after a
warm-up.  ``--device cpu`` runs the plain versions on the host clock.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from refid_tpu_torch.core.device import resolve_device, time_ms
from refid_tpu_torch.ops import probe_cuda

__all__ = ["H", "W", "C", "passthrough", "passthrough_reference", "tiny_passthrough",
           "tiny_passthrough_reference", "random_inputs", "params_from_jax", "to_nchw", "make_step", "main"]

H, W, C = 720, 640, 128


def passthrough_reference(d: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``d * 2 + 1``."""
    return d * 2.0 + 1.0


def passthrough(d: torch.Tensor, band: int = 8) -> torch.Tensor:
    """P1: ``2 d + 1`` of a float32 or bf16 ``(N, C, H, W)`` tensor, by bands
    of ``band`` rows of H.  On the card ``d`` must be channels_last (the
    rows of a band are then contiguous); on the CPU, the plain version."""
    if d.dim() != 4:
        raise ValueError(f"passthrough takes (N, C, H, W), got {tuple(d.shape)}")
    if d.is_cuda:
        if not d.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("passthrough on the card needs a channels_last tensor")
        return probe_cuda.passthrough_cuda(d, d.shape[0] * d.shape[2], band)
    return passthrough_reference(d)


def tiny_passthrough_reference(d: torch.Tensor) -> torch.Tensor:
    """Plain version of P2, in place like the kernel; returns ``d``."""
    view = d[0, 0, :8, :128]
    view.copy_(passthrough_reference(view))
    return d


def tiny_passthrough(d: torch.Tensor) -> torch.Tensor:
    """P2: ``2 x + 1`` on the slice ``d[0, 0, :8, :128]`` of an ``(N, C, H, W)``
    tensor (the JAX script's ``d[0, :8, :128, 0]`` in NHWC), in place, where
    the JAX script writes a new array; returns ``d``.  On the card the
    kernel reads the window from ``d``'s strides: no view is built."""
    if d.is_cuda:
        return probe_cuda.passthrough_slice_cuda(d)
    return tiny_passthrough_reference(d)


def random_inputs(seed: int = 0, h: int = H, w: int = W, c: int = C):
    """The JAX script's input and weights as float32 numpy arrays, in its
    layouts: e ``(1, h, w, c)`` NHWC and five HWIO kernels."""
    rng = np.random.RandomState(seed)
    e = rng.randn(1, h, w, c).astype(np.float32)
    shapes = [(3, 3, c, c), (3, 3, c, c), (3, 3, c, c), (4, 3, c, c // 2),
              (3, 3, c // 2, 2 * c)]
    return e, [0.05 * rng.randn(*s).astype(np.float32) for s in shapes]


def to_nchw(e_nhwc: np.ndarray, device="cpu") -> torch.Tensor:
    """NHWC numpy -> bf16 ``(N, C, H, W)`` channels_last tensor."""
    return torch.from_numpy(e_nhwc).to(device, torch.bfloat16).permute(0, 3, 1, 2)


def params_from_jax(params, device="cpu") -> tuple:
    """HWIO numpy kernels (the JAX script's weights) -> OIHW bf16
    channels_last tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(device, torch.bfloat16)
                 .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                 for p in params)


def _scale1(variant: str):
    if variant == "torch":
        return passthrough_reference
    if variant in ("cuda", "barrier"):
        return passthrough
    if variant.startswith("cuda_b") and variant[6:].isdigit():
        band = int(variant[6:])
        return lambda d: passthrough(d, band)
    if variant == "tiny":
        return lambda d: tiny_passthrough(passthrough_reference(d))
    if variant == "convert":
        return lambda d: passthrough(d.float().to(torch.bfloat16)).float().to(torch.bfloat16)
    raise ValueError(f"unknown variant {variant!r}")


def make_step(variant: str, params):
    """One step of the probe's graph on a bf16 channels_last ``(1, C, H, W)``
    input, with ``params`` from :func:`params_from_jax`."""
    w1, w2, w3, wd, wu = params
    scale1 = _scale1(variant)

    def step(e):
        h1 = F.conv2d(e, w1, padding=1)
        h1 = torch.maximum(h1, 0.1 * h1)
        h2 = torch.relu(F.conv2d(h1, w2, padding=1))
        h3 = h1 + F.conv2d(h2, w3, padding=1)
        d = scale1(F.conv2d(h3, wd, stride=(2, 1), padding=1))   # (1, C/2, H/2, W)
        up = F.conv2d(d, wu, padding=1)                           # C/2 -> 2C
        half = up.shape[1] // 2
        up2 = up[:, :half] + up[:, half:]                         # cheap upmix
        e2 = h3 + torch.cat([up2, torch.flip(up2, dims=[2])], dim=2)[:, :, :e.shape[2]]
        return e2.to(torch.bfloat16)

    return step


def main(argv=None) -> list:
    """Run the probe; returns one dict per variant."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=["torch", "cuda", "barrier", "convert"],
                    help="torch cuda cuda_bN tiny convert barrier")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for variant in args.variants:
        _scale1(variant)                 # unknown names fail before any work

    e_np, params_np = random_inputs(0, args.height, args.width)
    e0 = to_nchw(e_np, device)
    params = params_from_jax(params_np, device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    results = []
    for variant in args.variants:
        step = make_step(variant, params)

        def run():
            e = e0
            for _ in range(args.steps):
                e = step(e)
            return e

        ms = time_ms(run, args.iters, device, warmup=1) / args.steps
        print(f"{variant:8s}: {ms:7.3f} ms/step", flush=True)
        result = {"probe": "poison", "variant": variant, "ms_per_step": ms,
                  "steps": args.steps, "iters": args.iters,
                  "shape": [1, C, args.height, args.width], "device": kind}
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
