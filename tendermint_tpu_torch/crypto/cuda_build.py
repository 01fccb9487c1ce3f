"""Builds a package's CUDA kernels from its ``csrc/`` at first use and
loads them.

A kernel package (``ed25519_cuda``, ``merkle_cuda``) describes its kernels
with one :class:`CudaPackage`: its ``csrc`` directory, its ``sources``
(library name -> its one ``.cu`` source; headers are shared by all) and the
ctypes ``signatures`` of its C entry points. The instance owns the loaded
libraries and the compiler's output.

Each ``.cu`` source compiles with its own ``nvcc`` process into a shared
library with a plain C interface (all started together, across every
package passed to :func:`build_all`), loaded with ctypes. Libraries go to
the package's ``build_dir`` (``_build/`` beside ``csrc/``), named by a
digest of the package's sources and the flags, so an edited source never
loads a stale build. Nothing is built at import time: the CPU tests import
every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ..device import KernelUnavailable

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelUnavailable("nvcc not found: the CUDA kernels need "
                                "the CUDA toolkit (set CUDA_HOME)")
    return found


class CudaPackage:
    """The CUDA sources of one kernel package and the libraries built from
    them."""

    def __init__(self, csrc: Path, sources: Dict[str, str],
                 signatures: Dict[str, Tuple[str, Sequence]]):
        self.csrc = csrc
        self.build_dir = csrc.parent / "_build"
        #: library name -> its one source
        self.sources = sources
        #: C entry point -> (its library, ctypes argtypes); each returns a
        #: cudaError_t
        self.signatures = signatures
        #: loaded libraries by name
        self.libs: Dict[str, ctypes.CDLL] = {}
        #: ptxas report (registers, spills) of each library built here
        self.build_logs: Dict[str, str] = {}
        self._lock = threading.Lock()

    def lib_paths(self) -> Dict[str, Path]:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(self.csrc.iterdir()):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        digest = h.hexdigest()[:16]
        return {name: self.build_dir / f"lib{name}-{digest}.so"
                for name in self.sources}

    def library(self, name: str) -> ctypes.CDLL:
        """The loaded library ``name`` (built first if needed), with
        argtypes and restype set on each of its entry points. Raises
        :class:`KernelUnavailable` when it cannot be built or loaded."""
        lib = self.libs.get(name)
        if lib is not None:
            return lib
        with self._lock:
            lib = self.libs.get(name)
            if lib is None:
                try:
                    lib = ctypes.CDLL(str(build_all(self)[0][name]))
                    for fn, (owner, argtypes) in self.signatures.items():
                        if owner == name:
                            f = getattr(lib, fn)
                            f.argtypes = list(argtypes)
                            f.restype = ctypes.c_int
                except (OSError, AttributeError) as e:
                    raise KernelUnavailable(
                        f"kernel library {name!r} cannot be built or "
                        f"loaded: {e}") from e
                self.libs[name] = lib
        return lib


def build_all(*pkgs: CudaPackage) -> List[Dict[str, Path]]:
    """Compile every library of ``pkgs`` that is not built yet, one nvcc
    per source, all in parallel. Returns each package's library paths.
    Raises :class:`KernelUnavailable` with the compiler's output when a
    build fails."""
    all_paths, procs = [], []
    for pkg in pkgs:
        paths = pkg.lib_paths()
        all_paths.append(paths)
        pkg.build_dir.mkdir(parents=True, exist_ok=True)
        for name, src in pkg.sources.items():
            if paths[name].exists():
                continue
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(pkg.csrc), "-o", str(tmp),
                   str(pkg.csrc / src)]
            procs.append((pkg, name, tmp, paths[name], subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for pkg, name, tmp, path, proc in procs:
        out, _ = proc.communicate()
        pkg.build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{pkg.sources[name]} (exit {proc.returncode}):"
                          f"\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise KernelUnavailable("nvcc failed for " + "\n".join(failed))
    return all_paths
