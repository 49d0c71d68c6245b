"""The port is complete: every module of refid_tpu has a counterpart of the
same path in refid_tpu_torch (one under another name, listed here), or is
named in the README's "Not ported as code" paragraph."""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
RENAMED = {"events/voxel_pallas.py": "events/voxel_cuda.py"}


def _not_ported():
    text = (REPO / "README.md").read_text()
    start = text.index("**Not ported as code**")
    paragraph = text[start:text.index("\n\n", start)]
    return set(re.findall(r"`([\w/]+\.py)`", paragraph))


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
