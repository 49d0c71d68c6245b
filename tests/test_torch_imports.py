"""refid_tpu_torch stands alone: it imports with jax, flax and refid_tpu blocked
(and with cv2 and yaml blocked: the port reads PNG itself, and yaml is needed
only when an option file is parsed), and no module of it (nor chip_smoke.py)
names them in an import statement; lmdb, mc, wandb, requests, dlib and tqdm
are imported only inside the functions that use them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "refid_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "refid_tpu")
OPTIONAL = ("cv2", "yaml")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN + OPTIONAL!r}:
    sys.modules[name] = None     # any import of it now raises ImportError
import refid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(refid_tpu_torch.__path__,
                                               "refid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""

# the single-image path: EVHINet, its datasets and task, the demo CLI
SINGLE_IMAGE_MODULES = {"refid_tpu_torch.models.evhinet", "refid_tpu_torch.tasks.single",
                        "refid_tpu_torch.data.datasets.single_image",
                        "refid_tpu_torch.cli.demo"}
# the IO and training tail: backends, lmdb tooling, path pairing, the deblur
# and BS-ERGB datasets, the TensorBoard writer
IO_MODULES = {"refid_tpu_torch.data.file_client", "refid_tpu_torch.data.lmdb_util",
              "refid_tpu_torch.data.data_util", "refid_tpu_torch.cli.create_lmdb",
              "refid_tpu_torch.data.datasets.deblur_recurrent",
              "refid_tpu_torch.data.datasets.bsergb", "refid_tpu_torch.core.tb_writer"}
# the ablation lineages' deformable conv and the arch utilities
ABLATION_MODULES = {"refid_tpu_torch.ops.deform_conv", "refid_tpu_torch.models.arch_util"}
# distribution, the process loader, the timers and the BasicSR utilities
LAST_MODULES = {"refid_tpu_torch.parallel", "refid_tpu_torch.parallel.mesh",
                "refid_tpu_torch.parallel.spatial", "refid_tpu_torch.data.mp_loader",
                "refid_tpu_torch.core.timer", "refid_tpu_torch.utils",
                "refid_tpu_torch.utils.flow_util", "refid_tpu_torch.utils.face_util",
                "refid_tpu_torch.utils.download_util"}
# client packages imported only inside the function that needs them
LAZY = ("lmdb", "mc", "wandb", "requests", "dlib", "tqdm")


def test_every_module_imports_with_jax_and_refid_tpu_blocked():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 64      # the eval package, test CLI, single-image path and IO
    assert SINGLE_IMAGE_MODULES | IO_MODULES | ABLATION_MODULES | LAST_MODULES <= names


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_names_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_client_packages_are_imported_only_where_used(path):
    """lmdb, mc, wandb, requests, dlib and tqdm are in no module-level
    import: a module imports without them, and only the function that uses
    one needs its package."""
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in LAZY]


def test_yaml_is_needed_only_to_parse_a_file(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from refid_tpu_torch.cli import train\n"
            "try:\n    train.main(['-opt', 'x.yml'])\n"
            "except ImportError:\n    print('needs yaml')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "needs yaml", out.stderr


def test_import_builds_nothing():
    """Importing the package (and the kernel wrappers and probes) must not
    build or load a CUDA library: the CPU has no nvcc."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    code = ("import refid_tpu_torch.events.voxel_cuda as v, refid_tpu_torch.ops.build as b;"
            "import refid_tpu_torch.ops.probe_cuda as p, refid_tpu_torch.probes.band_conv,"
            " refid_tpu_torch.probes.poison, refid_tpu_torch.cli.test, refid_tpu_torch.eval.niqe,"
            " refid_tpu_torch.cli.demo, refid_tpu_torch.tasks.single,"
            " refid_tpu_torch.cli.create_lmdb, refid_tpu_torch.data.lmdb_util;"
            "import refid_tpu_torch.data.img_util as i, refid_tpu_torch.ops.int8_cuda as q;"
            "print(v._fns == {} and p._fns == {} and q._fns == {} and i._lib is None,"
            " b._loaded == {})")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "True"], out.stderr
