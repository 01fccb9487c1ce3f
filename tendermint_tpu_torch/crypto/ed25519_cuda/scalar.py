"""Reduction mod L of the 512-bit challenge, in plain PyTorch: the plain
version of K2.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/scalar.py`` and of the
CUDA ``csrc/scalar.cuh``, with the same algorithm: radix-2^11 limbs, three
signed folds at bit 253 (2^253 = -2 delta mod L), +8L, then conditional
subtractions of 8L, 4L, 2L, L. Limbs are lists of ``(*batch,)`` int64
tensors (arithmetic right shift gives the floor carries).
"""

from __future__ import annotations

from typing import List

import torch

from ..ed25519 import L as L_INT

RADIX = 11
MASK = (1 << RADIX) - 1
NL = 23                      # 23 * 11 = 253 bits: fold boundary
DELTA2_INT = 2 * (L_INT - 2**252)


def _int_to_limbs11(x: int, n: int) -> List[int]:
    return [(x >> (RADIX * i)) & MASK for i in range(n)]


_D2 = _int_to_limbs11(DELTA2_INT, 12)
_L_MULTS = {m: _int_to_limbs11(m * L_INT, 24) for m in (8, 4, 2, 1)}


def words_to_limbs11(words: torch.Tensor, nlimbs: int) -> List[torch.Tensor]:
    """(16, *batch) int64 little-endian u32 words -> nlimbs 11-bit limbs."""
    out = []
    nwords = words.shape[0]
    for k in range(nlimbs):
        bit = RADIX * k
        w, off = bit // 32, bit % 32
        if w >= nwords:
            out.append(torch.zeros_like(words[0]))
            continue
        v = words[w] >> off
        if off > 32 - RADIX and w + 1 < nwords:
            v = v | (words[w + 1] << (32 - off))
        out.append(v & MASK)
    return out


def _signed_carry(limbs: List[torch.Tensor]) -> List[torch.Tensor]:
    out = list(limbs)
    for i in range(len(out) - 1):
        c = out[i] >> RADIX
        out[i] = out[i] - (c << RADIX)
        out[i + 1] = out[i + 1] + c
    return out


def _fold(limbs: List[torch.Tensor]) -> List[torch.Tensor]:
    """limbs (len > NL) -> lo - hi * 2 delta, carried, max(24, len-12) limbs."""
    hi = limbs[NL:]
    n = max(NL + 1, len(hi) + len(_D2) - 1)
    out = [limbs[k] if k < NL else torch.zeros_like(limbs[0])
           for k in range(n)]
    for i, h in enumerate(hi):
        for j, d in enumerate(_D2):
            out[i + j] = out[i + j] - h * d
    return _signed_carry(out)


def _cond_sub(limbs: List[torch.Tensor], sub: List[int]) -> List[torch.Tensor]:
    d = [limbs[i] - sub[i] for i in range(len(limbs))]
    for i in range(len(d) - 1):
        borrow = (d[i] < 0).to(torch.int64)
        d[i] = d[i] + (borrow << RADIX)
        d[i + 1] = d[i + 1] - borrow
    take = d[-1] >= 0
    return [torch.where(take, d[i], limbs[i]) for i in range(len(limbs))]


def sc_reduce_digits(words: torch.Tensor) -> torch.Tensor:
    """(16, *batch) int64 LE u32 words of a 512-bit integer -> (64, *batch)
    int64 4-bit window digits of (value mod L), least significant first."""
    x = _fold(words_to_limbs11(words, 47))   # |x| < 2^386
    x = _fold(x)                             # |x| < 2^259
    x = _fold(x)                             # |x| < 2^253, 24 limbs
    x = _signed_carry([x[i] + _L_MULTS[8][i] for i in range(24)])
    for m in (8, 4, 2, 1):
        x = _cond_sub(x, _L_MULTS[m])
    digs = []
    for nib in range(64):
        bit = 4 * nib
        a, off = bit // RADIX, bit % RADIX
        v = x[a] >> off
        if off > RADIX - 4 and a + 1 < len(x):
            v = v | (x[a + 1] << (RADIX - off))
        digs.append(v & 15)
    return torch.stack(digs)
