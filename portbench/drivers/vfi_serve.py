"""Blurry-VFI serving: ``BlurVFIPipeline.__call__`` window after window.

Each call hands the pipeline one request of the pool as host numpy arrays
(two blurred frames, the events) and waits for its ``(t, h, w, 3)`` sharp
frames on the card.  The program builds the network from the seeded
upstream-names state_dict with its own loader, in the configuration's
compute dtype and int8 mode; ``"static"`` calibrates during set-up on a
request outside the pool.  The control (``control=True``) serves the same
weights through the cell's ``control``: the program's own int8 path in
that mode, or ``"int4"``, the reference with the int8 sites rounded to
4 bits, in the program's place.

The check: for each sampled answer, the reference voxelizes the request's
events, packs the input and runs the frozen network in float32 (TF32 off),
and once more under bf16 autocast, the plain bf16 computation of the same
window.  ``rel_rms_vs_bf16`` is the answer's RMS error against the float32
window over the plain bf16 window's RMS error against it: about 1 for a
program that computes in bf16 as the configuration states, about 3 for one
that rounds its int8 sites to 8 bits (the seeded network's sensitivity to
rounding, which differs by 2x from seed to seed, cancels).  ``rel_rms``
(error RMS over the float32 window's RMS) and ``max_gap`` (largest error
over the largest magnitude) are read beside it.  The worst sampled answer
counts.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from portbench.reference.quant import int4_sites
from portbench.reference.refid import RefidNet, blur_vfi_window, refid_args
from portbench.reference.voxel import voxel_grid
from portbench.traffic import generate
from portbench.weights import seeded_state

END_TO_END = {"vfi_frames_per_s": lambda w: w.items / w.elapsed}
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}



def compare(got: torch.Tensor, want: torch.Tensor, plain_bf16: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return {"rel_rms_vs_bf16": float("inf"), "rel_rms": float("inf"),
                "max_gap": float("inf")}
    err = (got - want).square().mean().sqrt()
    floor = (plain_bf16.float() - want).square().mean().sqrt()
    return {"rel_rms_vs_bf16": float(err / floor),
            "rel_rms": float(err / want.square().mean().sqrt()),
            "max_gap": float((got - want).abs().max() / want.abs().max())}


class ReferenceServe:
    """The reference served like the pipeline (the int4 control)."""

    def __init__(self, net, m, n, device):
        self.net, self.m, self.n, self.device = net, m, n, device

    def __call__(self, b0, b1, ev):
        from portbench.harness import reference_precision

        h, w = b0.shape[:2]
        with torch.no_grad(), reference_precision():
            vox = voxel_grid(torch.from_numpy(ev).to(self.device), 2 * self.m + self.n + 1, w, h)
            return blur_vfi_window(self.net, torch.from_numpy(b0).to(self.device),
                                   torch.from_numpy(b1).to(self.device), vox, self.m, self.n)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.control = control
        self.kept = {}
        self.samples = {}

    def setup(self) -> None:
        from refid_tpu_torch.models.refid import RefidConfig
        from refid_tpu_torch.pipeline import BlurVFIPipeline

        config, work = self.cell.config, self.cell.workload
        net = config["network_g"]
        self.m = config["num_end_interpolation"]
        self.n = config["num_inter_interpolation"]
        with torch.device("meta"):
            meta = RefidNet(**refid_args(config["network_g"]))
        self.state = seeded_state(meta, self.seed, self.device, config["weights"]["gain"])
        cfg = RefidConfig(img_chn=net["img_chn"], ev_chn=net["ev_chn"],
                          num_encoders=net["num_encoders"],
                          base_num_channels=net["base_num_channels"],
                          num_block=net["num_block"],
                          num_residual_blocks=net["num_residual_blocks"],
                          dtype=DTYPES[config["compute_dtype"]])
        int8 = work["control"] if self.control else config["int8"]
        if int8 == "int4":
            self.pipe = ReferenceServe(int4_sites(self._reference(), config["int8"]),
                                       self.m, self.n, self.device)
        else:
            self.pipe = BlurVFIPipeline(self.state, cfg, self.m, self.n, int8=int8,
                                        device=self.device)
        traffic = self.cell.traffic
        self.pool = generate.make(traffic, self.seed)
        if int8 == "static":
            self.pipe.calibrate(*generate.make(traffic, self.seed, generate.SETUP, 1)[0])
        for request in self.pool[:2]:       # every shape the window serves
            self.pipe(*request)
        self._sync()
        self.frames = 2 * self.m + self.n

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, i: int, keep: bool) -> int:
        with record_function("portbench.pipeline"):
            out = self.pipe(*self.pool[i % len(self.pool)])
            self._sync()
        if keep:
            self.kept[i] = out
        self.last = (i, out)
        return self.frames

    def release(self) -> None:
        i, out = self.last
        self.kept[i] = out
        del self.pipe, self.last

    def _reference(self) -> RefidNet:
        with torch.device("meta"):
            net = RefidNet(**refid_args(self.cell.config["network_g"]))
        net = net.to_empty(device=self.device)
        net.load_state_dict(self.state)
        return net

    def check(self, indices) -> dict:
        net = self._reference()
        h, w = self.cell.traffic["height"], self.cell.traffic["width"]
        worst = {}
        with torch.no_grad():
            for i in indices:
                b0, b1, ev = self.pool[i % len(self.pool)]
                vox = voxel_grid(torch.from_numpy(ev).to(self.device),
                                 2 * self.m + self.n + 1, w, h)
                args = (net, torch.from_numpy(b0).to(self.device),
                        torch.from_numpy(b1).to(self.device), vox, self.m, self.n)
                want = blur_vfi_window(*args)
                with torch.autocast(self.device.type, dtype=torch.bfloat16):
                    plain_bf16 = blur_vfi_window(*args)
                for k, v in compare(self.kept.pop(i), want, plain_bf16).items():
                    worst[k] = max(worst.get(k, 0.0), v)
                del want, plain_bf16, vox
        return worst
