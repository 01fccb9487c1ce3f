"""The SHA-256 CUDA kernel, built from ``csrc/`` at first use into
``_build/`` beside it (see :mod:`..cuda_build`)."""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p
from pathlib import Path

from ..cuda_build import CudaPackage

PACKAGE = CudaPackage(
    Path(__file__).resolve().parent / "csrc",
    sources={"sha256": "sha256.cu"},
    signatures={
        "tm_sha256_many": ("sha256", [c_void_p, c_longlong, c_int, c_void_p,
                                      c_void_p]),
    })
