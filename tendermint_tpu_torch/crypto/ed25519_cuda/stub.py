"""The device-profile tool's stub kernels (``csrc/stub.cu``) and their
plain PyTorch versions.

Counterparts of the stubs ``tools/device_profile.py``
``install_stub_kernels`` swaps in for the JAX package's verify kernels
(P1-P3): the same wire formats in, a verdict per item out, and
``device_work`` rounds of an LCG on the card between, so that a profile
can measure packing, upload and dispatch without the cost of a real
verify, or with a chosen amount of device work in its place. The verdict
is a per-item function of the item's packed bytes, so it does not depend on
how a batch is cut into segments, shards or lanes.

Each wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. The plain versions compute
the LCG rounds in closed form (x -> A x + C mod 2^32, A and C from the
round count), so they are not a copy of the kernel's chain.

:func:`stub_chain` is on no path: one warp's chain of rounds between two
clock reads, which measures the cycles of one dependent round on the card
(the floor of a stub's time at many rounds).
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import torch

from . import build
from .verify import (_check, _launch_check, _on_device, _same_device,
                     _stream_ptr)

LCG_MUL = 1664525
LCG_ADD = 1013904223
M32 = 0xFFFFFFFF

#: launches of each stub kernel by its wrapper (plain-version calls excluded)
launches = {"stub_verify_dense": 0, "stub_verify_sparse": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        launches[name] += 1


def _work(device_work: int) -> int:
    if not 0 <= device_work < 1 << 31:
        raise ValueError(f"device_work must be in [0, 2^31), got "
                         f"{device_work}")
    return int(device_work)


def stub_verify_dense(blocks: torch.Tensor, nblk: torch.Tensor,
                      s_words: torch.Tensor, device_work: int = 0,
                      limbs: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """P1/P2: the dense wire format (blocks (n, NBLK, 32) int32, nblk (n,)
    int32, s_words (n, 8) int32) -> ((n,) bool verdicts, (n,) int32 burned
    words, and with limbs (n, 8) int32 the (8,) int64 limb sums over the
    accepted items, else None)."""
    n = blocks.shape[0] if blocks.dim() == 3 else -1
    nb = blocks.shape[1] if blocks.dim() == 3 else -1
    _check(blocks, "blocks", torch.int32, (n, nb, 32))
    _check(nblk, "nblk", torch.int32, (n,))
    _check(s_words, "s_words", torch.int32, (n, 8))
    ts = [blocks, nblk, s_words]
    if limbs is not None:
        _check(limbs, "limbs", torch.int32, (n, 8))
        ts.append(limbs)
    work = _work(device_work)
    dev = _same_device(ts, "stub_verify_dense")
    if dev.type == "cpu":
        return stub_verify_dense_plain(blocks, nblk, s_words, work, limbs)
    lib = build.PACKAGE.library("stub")
    with _on_device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        burned = torch.empty(n, dtype=torch.int32, device=dev)
        sums = (None if limbs is None
                else torch.zeros(8, dtype=torch.int64, device=dev))
        rc = lib.tm_stub_verify_dense(
            blocks.data_ptr(), nblk.data_ptr(), s_words.data_ptr(),
            None if limbs is None else limbs.data_ptr(), out.data_ptr(),
            burned.data_ptr(), None if sums is None else sums.data_ptr(),
            n, max(nb, 0), work, _stream_ptr(dev))
    _launch_check(rc, "stub_verify_dense")
    _count("stub_verify_dense")
    return out.view(torch.bool), burned, sums


def stub_verify_sparse(diff_vals: torch.Tensor, mlen: torch.Tensor,
                       r: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                       device_work: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P3: the per-item half of the sparse wire format (diff_vals (n, C)
    uint8, mlen (n,) int32, r/a/s (n, 32) uint8) -> ((n,) bool verdicts,
    (n,) int32 burned words)."""
    n = mlen.shape[0] if mlen.dim() == 1 else -1
    c = diff_vals.shape[1] if diff_vals.dim() == 2 else -1
    _check(diff_vals, "diff_vals", torch.uint8, (n, c))
    _check(mlen, "mlen", torch.int32, (n,))
    for name, t in (("r", r), ("a", a), ("s", s)):
        _check(t, name, torch.uint8, (n, 32))
    work = _work(device_work)
    dev = _same_device([diff_vals, mlen, r, a, s], "stub_verify_sparse")
    if dev.type == "cpu":
        return stub_verify_sparse_plain(diff_vals, mlen, r, a, s, work)
    lib = build.PACKAGE.library("stub")
    with _on_device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        burned = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.tm_stub_verify_sparse(
            diff_vals.data_ptr(), c, mlen.data_ptr(), r.data_ptr(),
            a.data_ptr(), s.data_ptr(), out.data_ptr(), burned.data_ptr(),
            n, work, _stream_ptr(dev))
    _launch_check(rc, "stub_verify_sparse")
    _count("stub_verify_sparse")
    return out.view(torch.bool), burned


def stub_chain(rounds: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One warp of 32 lanes, lane l from x = l, through ``rounds`` LCG
    rounds on the card -> ((32,) int32 burned words, (32,) int64 clock64
    cycles each lane spent in its chain). Card only: a measurement of the
    card, with no CPU version; not counted in :data:`launches`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"stub_chain: measures the card, got {dev}")
    work = _work(rounds)
    lib = build.PACKAGE.library("stub")
    with _on_device(dev):
        out = torch.empty(32, dtype=torch.int32, device=dev)
        cycles = torch.empty(32, dtype=torch.int64, device=dev)
        rc = lib.tm_stub_chain(out.data_ptr(), cycles.data_ptr(), work,
                               _stream_ptr(dev))
    _launch_check(rc, "stub_chain")
    return out, cycles


# --- plain PyTorch versions ------------------------------------------------

@functools.lru_cache(maxsize=64)
def lcg_coefficients(rounds: int) -> Tuple[int, int]:
    """(A, C) with rounds LCG steps == x -> A x + C (mod 2^32)."""
    a, c = 1, 0
    mul, add = LCG_MUL, LCG_ADD
    k = rounds
    while k:  # square-and-multiply over the affine maps
        if k & 1:
            a, c = (a * mul) & M32, (c * mul + add) & M32
        mul, add = (mul * mul) & M32, (add * mul + add) & M32
        k >>= 1
    return a, c


def _burn_plain(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """x (int64, values < 2^32) after ``rounds`` LCG steps, in int64; the
    product A x is split at 16 bits so it never leaves int64."""
    a, c = lcg_coefficients(rounds)
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi + c) & M32


def _decide(x: torch.Tensor, rounds: int):
    burned = _burn_plain(x & M32, rounds)
    verdict = (burned & 1) == 0
    as_i32 = torch.where(burned >= 1 << 31, burned - (1 << 32), burned)
    return verdict, as_i32.to(torch.int32)


def stub_verify_dense_plain(blocks, nblk, s_words, device_work: int = 0,
                            limbs=None):
    """The plain version of :func:`stub_verify_dense`, on any device."""
    x = ((blocks.to(torch.int64) & M32).sum(dim=(1, 2))
         + (s_words.to(torch.int64) & M32).sum(dim=1)
         + (nblk.to(torch.int64) & M32))
    verdict, burned = _decide(x, device_work)
    sums = None
    if limbs is not None:
        masked = torch.where(verdict.unsqueeze(1), limbs.to(torch.int64), 0)
        sums = masked.sum(0, dtype=torch.int64)
    return verdict, burned, sums


def stub_verify_sparse_plain(diff_vals, mlen, r, a, s, device_work: int = 0):
    """The plain version of :func:`stub_verify_sparse`, on any device."""
    x = (diff_vals.to(torch.int64).sum(dim=1)
         + r.to(torch.int64).sum(dim=1) + a.to(torch.int64).sum(dim=1)
         + s.to(torch.int64).sum(dim=1) + (mlen.to(torch.int64) & M32))
    return _decide(x, device_work)


def stub_chain_plain(rounds: int) -> torch.Tensor:
    """The burned words of :func:`stub_chain`, (32,) int32 on the CPU."""
    return _decide(torch.arange(32, dtype=torch.int64), rounds)[1]
