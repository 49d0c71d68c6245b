"""One inference call of a network, for the VFI pipelines (``pipeline.py``)
and the tasks' predictions (``tasks/base.py``) alike: the weights' memory
format, the int8 state and the spatial plan, decided here once."""

from __future__ import annotations

import json
from contextlib import nullcontext

import torch

from refid_tpu_torch.core.timer import span
from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
from refid_tpu_torch.serve.quant import QuantState, WeightCache, calibration_stats

__all__ = ["ServedNetwork"]


class ServedNetwork:
    """``net`` on ``device`` in the ``int8`` mode (validated by the caller),
    split by height over ``mesh``'s spatial group (None: unsplit) and
    gathered on every rank, in eval mode under ``torch.inference_mode``, as
    the span ``<prefix>.network``.  The int8 state: one ``WeightCache`` and
    the calibration record, ``scales`` (headroom applied), ``raw_amax``,
    ``rms`` and ``exclude`` (sites in exact math).

    A float, unsplit call from a caller that packs its inputs NHWC
    (``packs_nhwc``) serves channels_last, also as the span
    ``<prefix>.channels_last``: cuDNN's bf16 convs on sm_90 are NHWC, so an
    NCHW network pays a layout pass into and out of each conv.  The weights
    are converted once, here; other calls serve NCHW (C8 and Q8 read NCHW),
    calibration calls too."""

    def __init__(self, net, int8, mesh, device, prefix: str, packs_nhwc: bool):
        self.int8, self.mesh, self.last_plan = int8, mesh, None
        self.channels_last = packs_nhwc and not int8 and (mesh is None or mesh.spatial == 1)
        fmt = torch.channels_last if self.channels_last else torch.contiguous_format
        self.net = net.to(device, memory_format=fmt)
        self.weights = WeightCache()
        self.scales = self.raw_amax = self.rms = self.exclude = None
        self._spans = f"{prefix}.network", f"{prefix}.channels_last"

    def _quant_state(self):
        if not self.int8:
            return None
        if self.int8 == "static" and self.scales is None:
            raise ValueError("int8='static' serving requires calibration: "
                             "call pipe.calibrate(...) first")
        return QuantState(self.int8, self.weights, self.scales or (), self.exclude)

    def __call__(self, x, event):
        """A serving call on the whole frame, in the int8 mode."""
        return self._run(x, event, self._quant_state(), self.channels_last)

    def predict(self, x, event, params=None):
        """A task's prediction: in int8 only where both frame sides are
        multiples of the network's ``int8_side`` (the JAX task's rule; other
        frames run the float forward), with ``params`` (the trainer's EMA
        weights) in place of the module's own where given."""
        k = self.int8 and self.net.int8_side
        q = self._quant_state() if k and x.shape[-2] % k == x.shape[-1] % k == 0 else None
        return self._run(x, event, q, self.channels_last, params)

    def calibrate(self, x, event, headroom, accumulate, exclude_crest):
        """``BlurVFIPipeline.calibrate``'s forward and record."""
        q = QuantState("calib", self.weights)
        out = self._run(x, event, q, False)
        raw, rms = calibration_stats(q)
        if accumulate and self.raw_amax is not None:
            if len(raw) != len(self.raw_amax):
                raise ValueError(f"calibration site-count mismatch on accumulate: "
                                 f"{len(raw)} vs {len(self.raw_amax)} recorded")
            raw = [max(a, b) for a, b in zip(raw, self.raw_amax)]
            if self.rms is not None:
                rms = [max(a, b) for a, b in zip(rms, self.rms)]
        self.raw_amax, self.rms = tuple(raw), tuple(rms)
        self.scales = tuple(a * headroom for a in raw)
        if exclude_crest is not None:
            self.exclude = tuple(i for i, (a, r) in enumerate(zip(raw, rms))
                                 if a > exclude_crest * max(r, 1e-12))
        return out

    def save_calibration(self, path: str) -> None:
        if self.scales is None:
            raise ValueError("no calibration recorded: call calibrate()")
        with open(path, "w") as f:
            json.dump({"amax": list(self.scales), "rms": list(self.rms or ()),
                       "exclude": list(self.exclude or ())}, f)

    def load_calibration(self, path: str) -> None:
        with open(path) as f:
            d = json.load(f)
        self.scales = self.raw_amax = tuple(float(a) for a in d["amax"])
        self.rms = tuple(float(a) for a in d.get("rms", ())) or None
        self.exclude = tuple(int(i) for i in d.get("exclude", ())) or None

    def _run(self, x, event, q, channels_last: bool, params=None):
        net, plan, training = self.net, None, self.net.training
        if training:
            net.eval()
        try:
            with torch.inference_mode(), span(self._spans[0]):
                if self.mesh is not None and self.mesh.spatial > 1:
                    plan = self.last_plan = SpatialPlan(self.mesh, x.shape[-2], net.row_block)
                    x, event = plan.shard(x), plan.shard(event)
                with spatial_scope(plan), span(self._spans[1]) if channels_last else nullcontext():
                    if params is None:
                        out = net(x, event, q)
                    else:
                        out = torch.func.functional_call(net, params, (x, event, q))
                return out if plan is None else plan.gather(out)
        finally:
            if training:
                net.train()
