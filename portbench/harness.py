"""The benchmark's harness: one run of one cell.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its driver (``drivers/<driver>.py``, the served path) and the limits of the
numbers that decide ``correct``.  A per-layer metric is the reader
``metrics/<metric>.py``.  Everything is found by name, so a new cell,
configuration, mix or metric is new files only.

A run: set-up (the driver builds the program, its weights and a pool of
requests from the seed, and warms up every shape it serves), a measured
window of ``seconds`` of back-to-back calls (a closed loop), with
``--trace 1`` a few more calls under ``torch.profiler``, then the check of
the sampled answers against the frozen reference, once the program's
state is freed.  The last line of standard output is the result.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional


from portbench.traffic import generate

__all__ = ["ROOT", "Cell", "Window", "load_cell", "load_module", "forbidden_modules",
           "reference_precision", "run", "main"]

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "refid_tpu")
WINDOW_SPAN = "portbench.window"


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


class Forbidden(RuntimeError):
    """A module the benchmark must not load is loaded."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict


def load_cell(name: str, root: Path = ROOT) -> Cell:
    workload = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{workload['config']}.json")
    return Cell(name, workload, config, generate.load(root, workload["traffic"]))


def load_module(path: Path) -> ModuleType:
    """A harness file by its path (its name may hold dots or dashes)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``refid_tpu_torch`` is not ``refid_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def reference_precision():
    """Float32 with TF32 off, restored afterwards."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@dataclass
class Window:
    """The calls of the measured window: latencies of those that returned,
    seconds from the first call's start to the last one's end."""
    calls: int = 0
    failed: int = 0
    latencies: List[float] = field(default_factory=list)
    elapsed: float = 0.0
    items: int = 0


@dataclass
class RunContext:
    """What a per-layer metric's reader reads."""
    cell: Cell
    window: Window
    trace: object
    driver: object
    peaks: dict


def _check_chips(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: the benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    return torch.cuda.get_device_name(0)


def _sample(cell: Cell, seed: int) -> set:
    """Call indices whose answers the check reads, drawn from the seed
    (the window's last answer is added to them when it closes)."""
    k = max(0, cell.traffic["sample"] - 1)
    within = cell.traffic["sample_within"]
    rng = generate.rng_for(seed, generate.SAMPLE)
    return set(rng.choice(within, min(k, within), replace=False).tolist())


def _measure(driver, seconds: float, keep: set) -> Window:
    w = Window()
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            w.items += driver.call(w.calls, w.calls in keep)
            w.latencies.append(time.perf_counter() - t0)
        except Exception:          # a failed request counts; the loop goes on
            traceback.print_exc()
            w.failed += 1
        w.calls += 1
        end = time.perf_counter()
        if end - start >= seconds:
            w.elapsed = end - start
            return w


def _profile(driver, calls: int, first: int, device: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import from_profiler

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            for i in range(calls):
                driver.call(first + i, False)
            if device == "cuda":
                torch.cuda.synchronize()
    return from_profiler(prof, WINDOW_SPAN, calls)


def _per_layer(cell: Cell, manifest: dict, reports: set) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    return [m for m in manifest["per_layer"]
            if cell.name in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in reports)]


def _end_to_end(cell: Cell, manifest: dict) -> List[dict]:
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
        manifest: Optional[dict] = None, device: str = "cuda", control: bool = False,
        started: Optional[float] = None, numbers: Optional[dict] = None) -> Dict:
    """One run; returns the result line's object (``checks`` last).
    ``numbers``, a dict, receives every number the check read, those
    without a limit too."""
    started = time.perf_counter() if started is None else started
    cell = load_cell(cell_name, root)
    if manifest is None:
        manifest = load_json(root.parent / "BENCHMARK.json")
    kind = _check_chips(cell.workload["chips"]) if device == "cuda" else "cpu"

    import torch

    driver_module = load_module(root / "drivers" / f"{cell.workload['driver']}.py")
    driver = driver_module.Driver(cell, seed, torch.device(device), control)
    driver.setup()
    keep = _sample(cell, seed)
    setup_s = time.perf_counter() - started
    window = _measure(driver, seconds, keep)
    trace_obj = None
    if trace:
        trace_obj = _profile(driver, cell.workload["trace_calls"], window.calls, device)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded after the window: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    e2e = _end_to_end(cell, manifest)
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in e2e:
            value = (setup_s if m["name"] == "setup_s"
                     else driver_module.END_TO_END[m["name"]](window))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        from portbench.peaks import peaks

        ctx = RunContext(cell, window, trace_obj, driver,
                         peaks(kind) if device == "cuda" else {})
        for m in _per_layer(cell, manifest, {m["name"] for m in e2e}):
            value = load_module(root / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    sampled = sorted(driver.kept)
    with reference_precision():
        read = driver.check(sampled)
    if numbers is not None:
        numbers.update(read)
    limits = cell.workload["limits"]
    checks = {name: {"value": read[name], "limit": limit} for name, limit in limits.items()}
    correct = (window.failed == 0 and bool(sampled)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": window.calls, "failed": window.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                         "count": cell.workload["chips"], "memory_peak_bytes": peak}}
    if trace_obj is not None:
        result["device"].update(busy_s=trace_obj.busy_s, window_s=trace_obj.window_s)
        result["breakdown"] = {"device_ops": trace_obj.top_device_ops(),
                               "idle_gaps": trace_obj.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, started: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    except (NoDevice, Forbidden) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 1
    if forbidden_modules():
        print(f"portbench: loaded: {', '.join(forbidden_modules())}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
