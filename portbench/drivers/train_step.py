"""Recipe training: the task's ``train_step`` iteration after iteration,
as the train CLI runs it (forward with remat under the configuration's
compute dtype, Charbonnier loss, backward, clip, AdamW at the cosine
schedule), each batch handed over as the loader's host arrays so that the
copy to the card is inside the step.

Set-up builds the task from the seeded upstream-names state_dict and
drives its first steps (the mix's ``sample``) through the window's own call, on
pool batches that all differ; the window's steps continue on the same
task.  From those first steps it keeps what the check compares: each
step's loss, each trained leaf's first gradient as AdamW got it (its first
moment after one step over ``1 - beta1``) and each leaf's change after the
last of them.

The check runs the reference's steps on the same batches from the same
weights (float32, TF32 off) and reads, by the worst leaf, the gap between
the program's norm and the reference's over the larger of the reference's
norm of that leaf and its median leaf: ``grad_gap`` (first gradients) and
``change_gap`` (the change, leaving out leaves whose reference gradient is
under a thousandth of the median leaf's, which move by round-off alone);
``change_gap_median`` is the median leaf's change gap, steady from seed to
seed where the worst leaf (EGACA's SE gate, fed by a spatial mean) is not;
``loss_gap`` is the worst step's relative loss gap.  The control
(``control=True``) puts the reference in float8 in the program's place.
"""

from __future__ import annotations

import copy
import statistics

import torch
from torch.profiler import record_function

from portbench.reference.refid import RefidNet, refid_args
from portbench.reference.train import fp8_convs, run_steps
from portbench.traffic import generate
from portbench.weights import seeded_state

__all__ = ["Driver", "END_TO_END", "gaps"]

END_TO_END = {"train_iters_per_s": lambda w: w.items / w.elapsed}
DTYPES = {"float32": None, "bfloat16": "bfloat16"}
QUIET = 1e-3          # a leaf whose reference gradient is under this share of the median



def gaps(got: dict, want: dict) -> dict:
    """The compared numbers from two readings of ``run_steps``' form."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_med = statistics.median(want["first_grad"].values())
    grad = {n: abs(got["first_grad"][n] - r) / max(r, g_med)
            for n, r in want["first_grad"].items()}
    moved = [n for n, r in want["first_grad"].items() if r >= QUIET * g_med]
    c_med = statistics.median(want["change"][n] for n in moved)
    change = {n: abs(got["change"][n] - want["change"][n]) / max(want["change"][n], c_med)
              for n in moved}
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": loss, "grad_gap": grad[worst_grad], "change_gap": change[worst_change],
            "grad_gap_leaf": worst_grad, "change_gap_leaf": worst_change,
            "change_gap_median": statistics.median(change.values()),
            "leaves_left_out": len(grad) - len(moved)}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, control: bool = False):
        self.cell, self.seed, self.device = cell, seed, device
        self.control = control
        self.kept = {}
        self.samples = {}

    def _reference(self, fp8: bool = False) -> RefidNet:
        with torch.device("meta"):
            net = RefidNet(**refid_args(self.cell.config["network_g"]))
        net = net.to_empty(device=self.device)
        net.load_state_dict(self.state)
        return fp8_convs(net) if fp8 else net

    def setup(self) -> None:
        config, traffic = self.cell.config, self.cell.traffic
        with torch.device("meta"):
            meta = RefidNet(**refid_args(config["network_g"]))
        self.state = seeded_state(meta, self.seed, self.device, config["weights"]["gain"])
        self.pool = generate.make(traffic, self.seed)
        self.warm = traffic["sample"]
        if self.control:                  # the reference in float8, in the program's place
            from portbench.harness import reference_precision

            with reference_precision():
                self.reading = run_steps(self._reference(fp8=True), self.pool[:self.warm],
                                         config["train"])
            self.kept[0] = self.reading
            return
        from refid_tpu_torch.models.convert import load_state
        from refid_tpu_torch.tasks.base import build_task

        net_opt = dict(config["network_g"])
        if DTYPES[config["compute_dtype"]]:
            net_opt["compute_dtype"] = DTYPES[config["compute_dtype"]]
        self.task = build_task({"name": "portbench",
                                "model_type": "TwoImageEventRecurrentRestorationModel",
                                "is_train": True, "network_g": net_opt,
                                "train": copy.deepcopy(config["train"])}, self.device)
        load_state(self.task.net, self.state)
        trainer = self.task.setup_train_state()
        losses = []
        for i in range(self.warm):
            losses.append(float(self._step(i)["loss"]))
            if i == 0:
                beta1 = config["train"]["optim_g"]["betas"][0]
                first = {n: float(trainer.optimizer.state[p]["exp_avg"].norm() / (1 - beta1))
                         for n, p in trainer.named}
        change = {n: float((p.detach() - self.state[n]).norm()) for n, p in trainer.named}
        self.reading = {"losses": losses, "first_grad": first, "change": change}
        self.kept[0] = self.reading
        self.first_call = self.warm

    def _step(self, i: int) -> dict:
        with record_function("portbench.train_step"):
            out = self.task.train_step(self.pool[i % len(self.pool)])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return out

    def call(self, i: int, keep: bool) -> int:
        if self.control:
            return 0
        self._step(self.first_call + i)
        return 1

    def release(self) -> None:
        self.task = None

    def check(self, indices) -> dict:
        want = run_steps(self._reference(), self.pool[:self.warm], self.cell.config["train"])
        got = self.reading
        missing = set(want["first_grad"]) ^ set(got["first_grad"])
        if missing:
            raise KeyError(f"trained leaves differ from the reference's: {sorted(missing)}")
        return gaps(got, want)
