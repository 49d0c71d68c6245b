"""Guards of the benchmark's files: what they import, the manifest's names
and units, that every cell, configuration, driver and reader is found by
name, that the traffic is a function of the seed, and that a new cell is
new files only."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.harness import ROOT
from portbench.tests.toy import manifest
from portbench.traffic import generate

FORBIDDEN = {"jax", "jaxlib", "flax", "refid_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _imports(path: Path):
    """Top-level names of the absolute imports in a Python file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


PY_FILES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(ROOT).parts:
        assert "refid_tpu_torch" not in set(_imports(path)), f"{path} imports the program"


def test_top_level_names_are_compared_whole():
    assert "refid_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "refid_tpu.models".split(".")[0] in FORBIDDEN


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_is_found_by_name():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"] and cell.workload["why"] == w["why"]
        assert (ROOT / "drivers" / f"{cell.workload['driver']}.py").is_file()
        config = configs[w["config"]]
        assert Path(ROOT.parent / config["file"]) == ROOT / "configs" / f"{w['config']}.json"
        assert cell.config["reduced"] == config["reduced"]
        assert set(cell.workload["limits"]) and all(v > 0 for v in cell.workload["limits"].values())
    used = {w["config"] for w in m["workloads"]}
    assert used == set(configs)


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    reports = {c: {e["name"] for e in m["end_to_end"] if c in e.get("workloads", cells)}
               for c in cells}
    assert all("setup_s" in r and len(r) >= 2 for r in reports.values())
    for metric in m["per_layer"]:
        assert (ROOT / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["workloads"] and set(metric["workloads"]) <= cells
        assert all(metric["moves"] in reports[c] for c in metric["workloads"])
        assert callable(harness.load_module(ROOT / "metrics" / f"{metric['name']}.py").read)
    for c in cells:
        assert any(c in metric["workloads"] for metric in m["per_layer"])
    for metric in m["end_to_end"]:
        if metric["name"] != "setup_s":
            for c in metric["workloads"]:
                driver = harness.load_cell(c).workload["driver"]
                module = harness.load_module(ROOT / "drivers" / f"{driver}.py")
                assert metric["name"] in module.END_TO_END


@pytest.mark.parametrize("mix", sorted(p.stem for p in (ROOT / "traffic").glob("*.json")))
def test_traffic_is_the_same_twice_for_a_seed(mix):
    params = generate.load(ROOT, mix)
    seed = 2 ** 31 + 12345
    a, b = generate.make(params, seed, count=2), generate.make(params, seed, count=2)
    c = generate.make(params, seed + 1, count=2)

    def flat(reqs):
        return [np.asarray(x) for r in reqs for x in (r.values() if isinstance(r, dict) else r)]

    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert [x.shape for x in flat(a)] == [x.shape for x in flat(c)]
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a), flat(c)))
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a)[: len(flat(a)) // 2],
                                                        flat(a)[len(flat(a)) // 2:]))


def test_a_new_cell_is_found_by_name_without_edits(tmp_path):
    for kind in ("configs", "workloads", "traffic"):
        (tmp_path / kind).mkdir()
    for kind in ("drivers", "metrics"):
        (tmp_path / kind).symlink_to(ROOT / kind)
    config = json.loads((ROOT / "configs" / "evhinet_wf64.json").read_text())
    config["network_g"]["wf"] = 8
    config["compute_dtype"] = "float32"
    (tmp_path / "configs" / "throwaway_net.json").write_text(json.dumps(config))
    traffic = dict(generate.load(ROOT, "deblur720_uniform"), height=16, width=24, events=500,
                   sample_within=3)
    (tmp_path / "traffic" / "throwaway_mix.json").write_text(json.dumps(traffic))
    workload = dict(config="throwaway_net", traffic="throwaway_mix", driver="deblur_serve",
                    chips=1, control="int8", trace_calls=3, why="a throwaway cell",
                    limits={"rel_rms": 1e-3, "max_gap": 1e-3})
    (tmp_path / "workloads" / "throwaway-cell.json").write_text(json.dumps(workload))
    m = {"end_to_end": [{"name": "deblur_images_per_s", "unit": "images/s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": [{"name": "voxel_ms.deblur", "unit": "ms", "moves": "deblur_images_per_s",
                        "workloads": ["throwaway-cell"]}]}
    result = harness.run("throwaway-cell", 7, 0.2, False, root=tmp_path, manifest=m,
                         device="cpu")
    assert result["correct"] and set(result["metrics"]) == {"deblur_images_per_s", "setup_s"}
    traced = harness.run("throwaway-cell", 8, 0.2, True, root=tmp_path, manifest=m,
                         device="cpu")
    assert set(traced["metrics"]) == {"voxel_ms.deblur"} and "breakdown" in traced
