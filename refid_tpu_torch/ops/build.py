"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<hash>.so``, a
shared library with a plain C interface, for Hopper (``sm_90a``).  The hash
covers the sources under ``csrc/`` and the compiler flags, so an edited
source rebuilds and an unchanged one is reused.  Builds happen at first
use, into ``refid_tpu_torch/_build/`` (listed in ``.gitignore``), from the
sources in the checkout alone; nothing is downloaded.  A missing ``nvcc``
or a failed compile raises with the compiler's output.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "kernel_names", "build", "load", "raise_on_error"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def kernel_names():
    """Names of the kernel sources, one library each."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{cuda_home}/bin): cannot build the CUDA kernels")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):   # the .cu and any .cuh
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernel sources (default: all), starting one
    ``nvcc`` per source at once.  Returns ``{name: {"path", "seconds",
    "log"}}``; a library already built from the same sources is reused
    (``seconds`` 0, ``log`` empty)."""
    names = list(kernel_names() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    result = {}
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no kernel source {src}")
        out = _library_path(name)
        if out.is_file():
            result[name] = {"path": out, "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, cmd, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, cmd, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)}\n(exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)    # atomic: another process never loads half a file
        result[name] = {"path": out, "seconds": time.perf_counter() - t0,
                        "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process.  Every library exports ``refid_cuda_error_string``."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]["path"]))
            lib.refid_cuda_error_string.argtypes = [ctypes.c_int]
            lib.refid_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch function of ``lib`` returned a CUDA error."""
    if err != 0:
        msg = lib.refid_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
