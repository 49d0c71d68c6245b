"""Single-image deblurring as the demo serves it, image after image.

Each call takes one request of the pool (a photo and its events, host
numpy arrays) through the demo's three calls: ``events_to_voxel_grid(...,
"HWC", device)`` (the card's voxelizer, the grid copied back),
``voxel_norm_np`` on the host, and the single-image task's
``single_image_inference(img, voxel, None)``, then waits for the restored
image on the card.  The task runs EVHINet from the seeded upstream-names
state_dict in the configuration's compute dtype; the control
(``control=True``) switches on the program's own int8 path (``val.int8``).

The check: for each sampled answer the reference voxelizes the events,
normalises the grid and runs the frozen EVHINet in float32 (TF32 off);
``rel_rms`` and ``max_gap`` as in ``vfi_serve``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference.evhinet import EVHINetRef, evhinet_args
from portbench.reference.voxel import voxel_grid, voxel_norm
from portbench.traffic import generate
from portbench.weights import seeded_state

__all__ = ["Driver", "END_TO_END"]


END_TO_END = {"deblur_images_per_s": lambda w: w.items / w.elapsed}



def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return {"rel_rms": float("inf"), "max_gap": float("inf")}
    err = got - want
    return {"rel_rms": float(err.square().mean().sqrt() / want.square().mean().sqrt()),
            "max_gap": float(err.abs().max() / want.abs().max())}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.control = control
        self.kept = {}
        self.samples = {"voxel_ms": []}

    def setup(self) -> None:
        from refid_tpu_torch.events.voxel import events_to_voxel_grid, voxel_norm_np
        from refid_tpu_torch.models.convert import load_state
        from refid_tpu_torch.tasks.base import build_task

        self._voxelize, self._norm = events_to_voxel_grid, voxel_norm_np
        config = self.cell.config
        with torch.device("meta"):
            meta = EVHINetRef(**evhinet_args(config["network_g"]))
        self.state = seeded_state(meta, self.seed, self.device, config["weights"]["gain"])
        val = {"int8": True} if self.control else {}
        self.task = build_task({"name": "portbench", "model_type": "TestImageEventRestorationModel",
                                "is_train": False,
                                "network_g": dict(config["network_g"],
                                                  compute_dtype=config["compute_dtype"]),
                                "val": val}, self.device)
        load_state(self.task.net, self.state)
        self.bins = config["num_bins"]
        self.pool = generate.make(self.cell.traffic, self.seed)
        for i in range(2):                   # every shape the window serves
            self.call(i, False)
        self.samples["voxel_ms"].clear()

    def call(self, i: int, keep: bool) -> int:
        img, events = self.pool[i % len(self.pool)]
        h, w = img.shape[:2]
        t0 = time.perf_counter()
        with record_function("portbench.voxel"):
            voxel = self._norm(self._voxelize(events, self.bins, w, h, "HWC",
                                              device=self.device))
        self.samples["voxel_ms"].append((time.perf_counter() - t0) * 1e3)
        with record_function("portbench.network"):
            out = self.task.single_image_inference(img, voxel, None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if keep:
            self.kept[i] = out
        self.last = (i, out)
        return 1

    def release(self) -> None:
        i, out = self.last
        self.kept[i] = out
        del self.task, self.last

    def check(self, indices) -> dict:
        with torch.device("meta"):
            net = EVHINetRef(**evhinet_args(self.cell.config["network_g"]))
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
