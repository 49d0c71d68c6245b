"""EFNet deblurring as the demo serves it, image after image: the calls of
``deblur_serve`` (``events_to_voxel_grid(..., "HWC", device)``,
``voxel_norm_np``, ``single_image_inference``) with the single-image task
running ``network_g.type: EFNet`` from a seeded upstream-names state_dict,
in the configuration's compute dtype.

Weights: ``seeded_state``, then two groups drawn again from the seed
(:func:`redraw`): the MLPs' ``nn.Linear`` weights at ``gain /
sqrt(fan_in)`` as the convs are drawn (the 0.1 N rule would scale fc2's
output up by up to 3x), and each EICA ``temperature`` at ``T (1 + 0.1 N)``
with the configuration's ``T``, so that the softmax rows are far from
uniform (the 0.1 N rule leaves them nearly uniform and Q, K untested).

The control (``control=True``) computes in a lower precision than the
bf16 the configuration states: it serves the same state rounded to float8
e4m3 (per tensor, scaled to the format's largest value), and rounds the
output of each convolution, linear layer and LayerNorm to float8 e4m3 the
same way (:func:`fp8_activations`).

The check: for each sampled answer the reference voxelizes the events,
normalises the grid and runs the frozen EFNet in float32 (TF32 off);
``rel_rms`` and ``max_gap`` as in ``deblur_serve``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.drivers import deblur_serve
from portbench.drivers.deblur_serve import compare
from portbench.reference.efnet import EFNetRef, efnet_args
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state, torch_seed

__all__ = ["Driver", "END_TO_END", "redraw", "fp8_state", "fp8_activations", "efnet_state"]


END_TO_END = {"deblur_images_per_s": lambda w: w.items / w.elapsed}

REDRAW_STREAM = 0x45464E     # a generator stream apart from seeded_state's


def redraw(model: torch.nn.Module, state: Dict[str, torch.Tensor], seed: int, device,
           gain: float, temperature: float) -> Dict[str, torch.Tensor]:
    """``state`` with ``model``'s ``nn.Linear`` weights and EICA
    temperatures drawn again from ``seed``."""
    gen = torch.Generator(device).manual_seed(torch_seed(seed) ^ REDRAW_STREAM)
    out = dict(state)
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.Linear):
            w = torch.randn(module.weight.shape, generator=gen, device=device)
            out[f"{name}.weight"] = w * (gain / math.sqrt(module.in_features))
        elif hasattr(module, "temperature"):
            t = torch.randn(module.temperature.shape, generator=gen, device=device)
            out[f"{name}.temperature"] = temperature * (1 + 0.1 * t)
    return out


def efnet_state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's float32 upstream-names state_dict for ``seed``."""
    with torch.device("meta"):
        meta = EFNetRef(**efnet_args(config["network_g"]))
    weights = config["weights"]
    state = seeded_state(meta, seed, device, weights["gain"])
    return redraw(meta, state, seed, device, weights["gain"], weights["temperature"])


FP8_LAYERS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear, torch.nn.LayerNorm)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale, in its own dtype."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def fp8_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor rounded to float8 e4m3 at a per-tensor scale."""
    return {name: fp8_round(w.float()) for name, w in state.items()}


def fp8_activations(model: torch.nn.Module) -> None:
    """Round the output of each of ``model``'s ``FP8_LAYERS`` to float8 e4m3."""
    for module in model.modules():
        if isinstance(module, FP8_LAYERS):
            module.register_forward_hook(lambda m, args, out: fp8_round(out))


class Driver(deblur_serve.Driver):
    def setup(self) -> None:
        from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
        from refid_tpu_torch.models.convert import load_state
        from refid_tpu_torch.tasks.base import build_task

        self._voxelize, self._norm = events_to_voxel_grid, voxel_norm_np
        config = self.cell.config
        self.state = efnet_state(config, self.seed, self.device)
        self.task = build_task({"name": "portbench", "model_type": "TestImageEventRestorationModel",
                                "is_train": False,
                                "network_g": dict(config["network_g"],
                                                  compute_dtype=config["compute_dtype"]),
                                "val": {}}, self.device)
        load_state(self.task.net, fp8_state(self.state) if self.control else self.state)
        if self.control:
            fp8_activations(self.task.net)
        self.bins = config["num_bins"]
        self.pool = generate.make(self.cell.traffic, self.seed)
        for i in range(2):                   # every shape the window serves
            self.call(i, False)
        self.samples["voxel_ms"].clear()

    def check(self, indices) -> dict:
        with torch.device("meta"):
            net = EFNetRef(**efnet_args(self.cell.config["network_g"]))
        net = net.to_empty(device=self.device)
        net.load_state_dict(self.state)
        worst = {}
        with torch.no_grad():
            for i in indices:
                img, events = self.pool[i % len(self.pool)]
                h, w = img.shape[:2]
                vox = voxel_norm(voxel_grid(torch.from_numpy(events).to(self.device),
                                            self.bins, w, h))
                x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
                want = net(x.permute(2, 0, 1)[None], vox[None])[0].permute(1, 2, 0)
                for k, v in compare(self.kept.pop(i), want).items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
