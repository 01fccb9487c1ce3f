"""Builds the CUDA kernels from ``csrc/`` at first use and loads them.

Each ``.cu`` source compiles with its own ``nvcc`` process into a shared
library with a plain C interface (all started together), loaded with
ctypes. Libraries go to ``_build/`` beside this file, named by a digest of
the sources and flags, so an edited source never loads a stale build.
Nothing is built at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ...device import KernelUnavailable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: library name -> its one source; headers are shared by all
SOURCES = {"verify": "verify.cu", "probe": "probe.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: ctypes signatures of every C entry point (each returns a cudaError_t)
SIGNATURES = {
    "tm_ed25519_verify_dense": (
        "verify", [_c_void_p] * 5 + [_c_int, _c_int, _c_void_p]),
    "tm_ed25519_verify_sparse": (
        "verify", [_c_void_p, _c_int, _c_void_p, _c_int] + [_c_void_p] * 5
        + [_c_int, _c_void_p, _c_void_p, _c_int, _c_void_p]),
    "tm_probe_sum_u8": ("probe", [_c_void_p, _c_ll, _c_void_p, _c_void_p]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) of each library built by this process
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelUnavailable("nvcc not found: the CUDA kernels need "
                                "the CUDA toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library that is not built yet, one nvcc per source,
    all in parallel. Raises :class:`KernelUnavailable` with the compiler's
    output when a build fails."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, digest) for name in SOURCES}
    procs = {}
    for name, src in SOURCES.items():
        if paths[name].exists():
            continue
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise KernelUnavailable("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype set on each of its entry points. Raises
    :class:`KernelUnavailable` when it cannot be built or loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(build_all()[name]))
                for fn, (owner, argtypes) in SIGNATURES.items():
                    if owner == name:
                        f = getattr(lib, fn)
                        f.argtypes = argtypes
                        f.restype = ctypes.c_int
            except (OSError, AttributeError) as e:
                raise KernelUnavailable(
                    f"kernel library {name!r} cannot be built or loaded: "
                    f"{e}") from e
            _libs[name] = lib
    return lib
