"""The BLS12-381 G2-add CUDA kernels, built from ``csrc/`` at first use into
``_build/`` beside it (see :mod:`..cuda_build`)."""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p
from pathlib import Path

from ..cuda_build import CudaPackage

PACKAGE = CudaPackage(
    Path(__file__).resolve().parent / "csrc",
    sources={"g2_add": "g2_add.cu"},
    signatures={
        "tm_bls_g2_add_round": ("g2_add", [c_void_p, c_void_p, c_void_p,
                                           c_longlong, c_void_p]),
        "tm_bls_g2_tree_sum": ("g2_add", [c_void_p, c_void_p, c_void_p,
                                          c_longlong, c_void_p]),
        "tm_bls_fq_mul": ("g2_add", [c_void_p, c_void_p, c_void_p, c_int,
                                     c_int, c_void_p]),
    })
