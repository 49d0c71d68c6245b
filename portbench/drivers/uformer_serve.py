"""Uformer deblurring as the demo serves it, image after image: the calls
of ``deblur_serve`` (``events_to_voxel_grid(..., "HWC", device)``,
``voxel_norm_np``, ``single_image_inference``) with the single-image task
running ``network_g.type: Uformer`` from a seeded upstream-names
state_dict, in the configuration's compute dtype.

Weights: ``seeded_state`` at the configuration's gain, then two groups
drawn again from the seed: the ``nn.Linear`` weights at ``gain /
sqrt(fan_in)`` as the convs are drawn (``efnet_serve.redraw``; the 0.1 N
rule would shrink every token linear's output), and each
``relative_position_bias_table`` at ``bias_table * N`` with the
configuration's ``bias_table``, so that the softmax rows of a window are
far from uniform (the 0.1 N rule leaves them nearly uniform and the
relative position bias untested).

Set-up checks that each warm-up call ran every LeWin block once
(``models/uformer.py::LEWIN_BLOCKS``).

The control (``control=True``) computes in a lower precision than the
bf16 the configuration states, as EFNet's and Restormer's controls do: the
state rounded to float8 e4m3 per tensor, and each conv, transposed-conv,
linear and LayerNorm output rounded the same way (on the card the
pre-norms run the pre-norm kernel, which no hook sees).

The check: for each sampled answer the reference voxelizes the events,
normalises the grid and runs the frozen Uformer in float32 (TF32 off);
``rel_rms`` and ``max_gap`` as in ``deblur_serve``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.drivers import deblur_serve
from portbench.drivers.deblur_serve import compare
from portbench.drivers.efnet_serve import fp8_activations, fp8_state, redraw
from portbench.reference.uformer import UformerRef, uformer_args
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state, torch_seed

__all__ = ["Driver", "END_TO_END", "uformer_state", "blocks_per_call"]


END_TO_END = {"deblur_images_per_s": lambda w: w.items / w.elapsed}

TABLE_STREAM = 0x55464D     # a generator stream apart from seeded_state's and redraw's


def uformer_state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's float32 upstream-names state_dict for ``seed``."""
    with torch.device("meta"):
        meta = UformerRef(**uformer_args(config["network_g"]))
    weights = config["weights"]
    state = seeded_state(meta, seed, device, weights["gain"])
    state = redraw(meta, state, seed, device, weights["gain"], None)
    gen = torch.Generator(device).manual_seed(torch_seed(seed) ^ TABLE_STREAM)
    for name, p in meta.named_parameters():
        if name.endswith("relative_position_bias_table"):
            state[name] = weights["bias_table"] * torch.randn(p.shape, generator=gen,
                                                              device=device)
    return state


def blocks_per_call(network_g: dict) -> int:
    """LeWin blocks a forward: every layer's."""
    return sum(network_g["depths"])


class Driver(deblur_serve.Driver):
    def setup(self) -> None:
        from refid_tpu_torch.models import uformer      # first: a program without it fails here
        from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
        from refid_tpu_torch.models.convert import load_state
        from refid_tpu_torch.tasks.base import build_task

        self._voxelize, self._norm = events_to_voxel_grid, voxel_norm_np
        config = self.cell.config
        self.state = uformer_state(config, self.seed, self.device)
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
        before = uformer.LEWIN_BLOCKS
        for i in range(2):                   # every shape the window serves
            self.call(i, False)
        ran, want = uformer.LEWIN_BLOCKS - before, 2 * blocks_per_call(config["network_g"])
        if ran != want:
            raise RuntimeError(f"two warm-up calls ran {ran} LeWin blocks, not {want}")
        self.samples["voxel_ms"].clear()

    def check(self, indices) -> dict:
        with torch.device("meta"):
            net = UformerRef(**uformer_args(self.cell.config["network_g"]))
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
