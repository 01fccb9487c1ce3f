"""The Ed25519 CUDA kernels, built from ``csrc/`` at first use into
``_build/`` beside it (see :mod:`..cuda_build`)."""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p
from pathlib import Path

from ..cuda_build import CudaPackage

PACKAGE = CudaPackage(
    Path(__file__).resolve().parent / "csrc",
    sources={"verify": "verify.cu", "probe": "probe.cu",
             "tally": "tally.cu", "stub": "stub.cu"},
    signatures={
        "tm_ed25519_verify_dense": (
            "verify", [c_void_p] * 5 + [c_int, c_int, c_void_p]),
        "tm_ed25519_verify_sparse": (
            "verify", [c_void_p, c_int, c_void_p, c_int] + [c_void_p] * 5
            + [c_int, c_void_p, c_void_p, c_int, c_void_p]),
        "tm_ed25519_verify_tally": (
            "tally", [c_void_p] * 7 + [c_int, c_int, c_void_p]),
        "tm_probe_sum_u8": ("probe", [c_void_p, c_longlong, c_void_p,
                                      c_void_p, c_int, c_void_p]),
        "tm_probe_blocks": ("probe", [c_longlong, c_int]),
        "tm_stub_verify_dense": (
            "stub", [c_void_p] * 7 + [c_int, c_int, c_int, c_void_p]),
        "tm_stub_verify_sparse": (
            "stub", [c_void_p, c_int] + [c_void_p] * 6
            + [c_int, c_int, c_void_p]),
        "tm_stub_chain": ("stub", [c_void_p, c_void_p, c_int, c_void_p]),
    })
