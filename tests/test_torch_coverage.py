"""The port is complete: every module of refid_tpu has a counterpart of the
same path in refid_tpu_torch (one under another name, listed here), or is
named in the README's "Not ported as code" paragraph; and every top-level
entry point of the repo (bench.py, __graft_entry__.py, the scripts) has a
counterpart that exists (a script, a refid_tpu_torch CLI or probe, a
chip_smoke.py phase or a tools/ script, listed here), or is named in the
README's "Entry points not ported as code" paragraph."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
RENAMED = {"events/voxel_pallas.py": "events/voxel_cuda.py"}


# what each entry point that the port covers maps to: files of the repo,
# or chip_smoke.py's phase functions as "chip_smoke.py::<name>"
ENTRY_COUNTERPARTS = {
    "__graft_entry__.py": ["chip_smoke.py::phase_parity", "chip_smoke.py::phase_spatial"],
    "scripts/bench_e2e.py": ["chip_smoke.py::phase_serve", "chip_smoke.py::phase_int8_serve"],
    "scripts/bench_evhinet.py": ["chip_smoke.py::phase_evhinet_serve"],
    "scripts/bench_int8.py": ["chip_smoke.py::phase_int8_kernel_timing"],
    "scripts/bench_pipeline.py": ["chip_smoke.py::phase_serve",
                                  "chip_smoke.py::phase_int8_serve"],
    "scripts/bench_train.py": ["chip_smoke.py::phase_train_profile"],
    "scripts/bench_voxelize.py": ["chip_smoke.py::phase_kernel_timing",
                                  "tools/compare_voxelizers.py"],
    "scripts/eval_released.py": ["scripts/eval_released_torch.py"],
    "scripts/probe_band_conv.py": ["refid_tpu_torch/probes/band_conv.py"],
    "scripts/probe_poison.py": ["refid_tpu_torch/probes/poison.py"],
    "scripts/profile_e2e.py": ["chip_smoke.py::phase_profile"],
    "scripts/profile_forward.py": ["chip_smoke.py::phase_profile"],
    "scripts/profile_train.py": ["chip_smoke.py::phase_train_profile"],
    "scripts/quant_db.py": ["chip_smoke.py::phase_int8_serve"],
    "scripts/quant_db_evhinet.py": ["chip_smoke.py::phase_evhinet_serve"],
    "scripts/time_forward.py": ["chip_smoke.py::phase_serve"],
}


def _paragraph(title):
    text = (REPO / "README.md").read_text()
    start = text.index(title)
    paragraph = text[start:text.index("\n\n", start)]
    return set(re.findall(r"`([\w/]+\.py)`", paragraph))


def _not_ported():
    return _paragraph("**Not ported as code**")


def _entry_decisions():
    return _paragraph("**Entry points not ported as code**")


def _entry_points():
    return ["bench.py", "__graft_entry__.py"] + sorted(
        str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("*.py")
        if not p.stem.endswith("_torch"))


def _chip_smoke_functions():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def _modules():
    return sorted(str(p.relative_to(REPO / "refid_tpu"))
                  for p in (REPO / "refid_tpu").rglob("*.py"))


@pytest.mark.parametrize("module", _modules())
def test_every_jax_module_has_a_counterpart_or_a_decision(module):
    port = REPO / "refid_tpu_torch" / RENAMED.get(module, module)
    assert port.is_file() or module in _not_ported(), (
        f"refid_tpu/{module} has no counterpart and no 'Not ported as code' entry")


def test_the_decisions_name_modules_that_exist_and_are_not_ported():
    names = ({n for n in _not_ported() if "/" in n and not n.startswith("tests/")}
             - set(RENAMED) - set(RENAMED.values()))
    assert {"serve/packing.py", "serve/fast_forward.py", "ops/native.py"} <= names
    for name in names:
        assert (REPO / "refid_tpu" / name).is_file(), name
        assert not (REPO / "refid_tpu_torch" / name).exists(), name
    assert all((REPO / "refid_tpu_torch" / p).is_file() for p in RENAMED.values())


@pytest.mark.parametrize("entry", _entry_points())
def test_every_entry_point_has_a_counterpart_or_a_decision(entry):
    targets = ENTRY_COUNTERPARTS.get(entry, [])
    decided = entry in _entry_decisions()
    assert bool(targets) != decided, (
        f"{entry} needs exactly one of a counterpart and an 'Entry points not ported "
        f"as code' entry (counterparts {targets}, decided {decided})")
    for target in targets:
        path, _, function = target.partition("::")
        assert (REPO / path).is_file(), target
        if function:
            assert function in _chip_smoke_functions(), target


def test_the_entry_decisions_name_entry_points_that_exist():
    decided = _entry_decisions()
    assert {"bench.py", "scripts/probe_winograd.py", "scripts/bench_geometry.py",
            "scripts/diag_bench_compile.py"} <= decided
    assert decided <= set(_entry_points())
    assert not decided & set(ENTRY_COUNTERPARTS)
    assert set(ENTRY_COUNTERPARTS) <= set(_entry_points())
    text = (REPO / "README.md").read_text()
    start = text.index("**Entry points not ported as code**")
    assert "`benchmark` PR, ROADMAP item 8" in text[start:text.index("\n\n", start)]
    assert ENTRY_COUNTERPARTS["scripts/eval_released.py"] == ["scripts/eval_released_torch.py"]
