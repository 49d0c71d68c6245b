"""Build the port's CUDA kernels with ``nvcc``, and its host C functions with
the C compiler, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<hash>.so``, a
shared library with a plain C interface, for Hopper (``sm_90a``).  The hash
covers the sources under ``csrc/`` and the compiler flags, so an edited
source rebuilds and an unchanged one is reused.  Builds happen at first
use, into ``refid_tpu_torch/_build/`` (listed in ``.gitignore``), from the
sources in the checkout alone; nothing is downloaded.  A missing ``nvcc``
or a failed compile raises with the compiler's output.

Each ``csrc/<name>.c`` (host code, e.g. the PNG unfilter) compiles with
``$CC``, else ``cc``, else ``gcc`` (``-O3 -shared -fPIC``) into
``lib<name>-<hash>.so`` in the same directory, hashed from that one source,
the compiler and its flags: editing it rebuilds no CUDA library, and
editing a ``.cu`` rebuilds no host library.  A missing compiler raises.

The launch path that every kernel wrapper shares, per call: its checks,
the bound C function (:func:`bind`: the library loaded and each function's
``argtypes`` set once), the raw handle of the current stream
(:func:`current_stream`, no ``torch.cuda.Stream`` object), the call itself
with the device made current only when another one is (:func:`launch`),
and :func:`raise_on_error` when the C launcher returns a CUDA error.  The C
launchers keep the SM count and the shared-memory limit they set once a
device (``csrc/launch.cuh``).

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "kernel_names", "build", "load", "raise_on_error",
           "build_host", "load_host", "bind", "current_stream", "launch"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_CFLAGS = ("-O3", "-shared", "-fPIC")

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


def bind(name: str, signatures: Dict[str, list]) -> Dict[str, ctypes._CFuncPtr]:
    """Load ``csrc/<name>.cu``'s library and give each function of
    ``signatures`` (``{function: argtypes}``) its ``argtypes`` and an int
    (CUDA error code) ``restype``; returns ``{function: bound function}``.
    A wrapper calls it once and keeps the result."""
    lib = load(name)
    fns = {}
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def current_stream(index: int) -> int:
    """The raw ``cudaStream_t`` of CUDA device ``index``'s current stream:
    ``torch.cuda.current_stream(index).cuda_stream`` without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn, index: int, *args) -> int:
    """``fn(*args)`` with CUDA device ``index`` current, which the C
    launchers read; ``torch.cuda.device`` is entered only when another
    device is current."""
    if torch._C._cuda_getDevice() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def _find_cc() -> list:
    """The host C compiler: ``$CC`` (may carry flags), else ``cc``, else
    ``gcc``."""
    env = shlex.split(os.environ.get("CC", ""))
    for cand in ([env] if env else []) + [["cc"], ["gcc"]]:
        path = shutil.which(cand[0])
        if path:
            return [path, *cand[1:]]
    raise RuntimeError("no C compiler found ($CC, cc, gcc on PATH): cannot build the "
                       "port's host C functions (csrc/*.c)")


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.c`` into a shared library (reused when built
    from the same source, compiler and flags) and return its path."""
    src = CSRC_DIR / f"{name}.c"
    if not src.is_file():
        raise FileNotFoundError(f"no host source {src}")
    cmd = _find_cc()
    digest = hashlib.sha256(" ".join(cmd + list(HOST_CFLAGS)).encode())
    digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*cmd, *HOST_CFLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host C build failed:\n{' '.join(cmd)}\n"
                           f"(exit {proc.returncode})\n{proc.stdout}")
    os.replace(tmp, out)    # atomic: another process never loads half a file
    return out


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.c``'s library, once per
    process."""
    key = f"{name}.c"
    with _load_lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = _loaded[key] = ctypes.CDLL(str(build_host(name)))
        return lib


def raise_on_error(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch function of ``lib`` returned a CUDA error."""
    if err != 0:
        msg = lib.refid_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
