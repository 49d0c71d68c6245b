"""Toy copies of the benchmark's cells, written to a temporary root that
the harness reads by name: the same drivers, readers and limits, at sizes
the CPU runs in seconds, in float32."""

from __future__ import annotations

import json
import os
from pathlib import Path

from portbench.harness import ROOT

TOY = {
    "vfi720-bf16": ({"network_g": {"base_num_channels": 8}},
                    {"height": 32, "width": 48, "events": 4000, "sample_within": 3}),
    "vfi720-int8static": ({"network_g": {"base_num_channels": 8}},
                          {"height": 32, "width": 48, "events": 4000, "sample_within": 3}),
    "deblur720-bf16": ({"network_g": {"wf": 16}},
                       {"height": 32, "width": 48, "events": 4000, "sample_within": 5}),
    "train256-bf16": ({"network_g": {"base_num_channels": 8}}, {"crop": 32, "frames": 5}),
}


def _load(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def toy_root(tmp: Path, cell: str, dtype: str = "float32") -> Path:
    """A root holding the toy copy of ``cell`` under the same name."""
    for kind in ("configs", "workloads", "traffic"):
        (tmp / kind).mkdir(parents=True, exist_ok=True)
    for kind in ("drivers", "metrics"):
        if not (tmp / kind).exists():
            os.symlink(ROOT / kind, tmp / kind)
    workload = _load("workloads", cell)
    config_over, traffic_over = TOY[cell]
    config = _merge(_load("configs", workload["config"]), config_over)
    config["compute_dtype"] = dtype
    traffic = _merge(_load("traffic", workload["traffic"]), traffic_over)
    for kind, name, body in (("configs", workload["config"], config),
                             ("traffic", workload["traffic"], traffic),
                             ("workloads", cell, workload)):
        with open(tmp / kind / f"{name}.json", "w") as f:
            json.dump(body, f)
    return tmp


def manifest() -> dict:
    with open(ROOT.parent / "BENCHMARK.json") as f:
        return json.load(f)
