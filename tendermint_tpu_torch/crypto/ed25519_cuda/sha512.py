"""SHA-512 in plain PyTorch: the plain version of K3.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/sha512.py`` and of the
CUDA ``csrc/sha512.cuh``. PyTorch on the CPU has no shifts for uint64, so
each 64-bit word is an (hi, lo) pair of 32-bit halves held in int64
tensors; sums of several halves are normalized once (carry = lo >> 32).
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF

_K64 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

_IV64 = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b, 0xa54ff53a5f1d36f1,
    0x510e527fade682d1, 0x9b05688c2b3e6c1f, 0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]

Word = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), each in [0, 2^32)


def _sum(*ws) -> Word:
    """Sum of 64-bit words (tensors or python-int pairs), mod 2^64."""
    lo = sum(w[1] for w in ws)
    hi = sum(w[0] for w in ws)
    return (hi + (lo >> 32)) & M32, lo & M32


def _rotr(w: Word, n: int) -> Word:
    h, l = w
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & M32,
            ((l >> n) | (h << (32 - n))) & M32)


def _shr(w: Word, n: int) -> Word:  # n < 32
    h, l = w
    return h >> n, ((l >> n) | (h << (32 - n))) & M32


def _xor3(a: Word, b: Word, c: Word) -> Word:
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def compress(state, block):
    """state: 8 words; block: (32, *batch) int64 big-endian u32 words."""
    w = [(block[2 * t], block[2 * t + 1]) for t in range(16)]
    for t in range(16, 80):
        w2, w15 = w[t - 2], w[t - 15]
        s1 = _xor3(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
        s0 = _xor3(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
        w.append(_sum(s1, w[t - 7], s0, w[t - 16]))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _xor3(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = ((e[0] & f[0]) ^ ((M32 - e[0]) & g[0]),
              (e[1] & f[1]) ^ ((M32 - e[1]) & g[1]))
        k = (_K64[t] >> 32, _K64[t] & M32)
        t1 = _sum(h, S1, ch, k, w[t])
        S0 = _xor3(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        mj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
              (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t2 = _sum(S0, mj)
        h, g, f, e = g, f, e, _sum(d, t1)
        d, c, b, a = c, b, a, _sum(t1, t2)
    return [_sum(s, x) for s, x in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_blocks(blocks: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """blocks (NBLK, 32, *batch) int64 BE u32 words; nblk (*batch,) — each
    item's block count. Items with fewer blocks keep their state after
    their last one. Returns the digest as (16, *batch) BE u32 words."""
    zero = torch.zeros_like(blocks[0, 0])
    state = [(zero + (v >> 32), zero + (v & M32)) for v in _IV64]
    for b in range(blocks.shape[0]):
        new = compress(state, blocks[b])
        live = b < nblk
        state = [(torch.where(live, n[0], s[0]), torch.where(live, n[1], s[1]))
                 for n, s in zip(new, state)]
    return torch.stack([x for w in state for x in w])


def bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x & 0xFF) << 24))


def digest_le32(digest: torch.Tensor) -> torch.Tensor:
    """(16, *batch) BE digest words -> (16, *batch) LE u32 words of the
    digest read as one little-endian integer (the Ed25519 challenge)."""
    return bswap32(digest)
