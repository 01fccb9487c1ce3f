"""The SHA-256 kernel's wrapper and its plain PyTorch version.

:func:`sha256_many` takes n messages of one length as an (n, L) uint8
tensor and returns their (n, 32) uint8 digests. On a CUDA tensor it
launches ``sha256_many`` (``csrc/sha256.cu``, K9 of the JAX package's
``crypto/merkle_fast.py``) or raises; on a CPU tensor it runs
:func:`sha256_many_plain`, the same rounds on torch tensors.
"""

from __future__ import annotations

import threading

import torch

from . import build

K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

#: launches of the kernel by its wrapper (plain-version calls excluded)
launches = {"sha256_many": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        launches["sha256_many"] = 0


def n_blocks(length: int) -> int:
    """64-byte blocks of a padded message of ``length`` bytes."""
    return (length + 8) // 64 + 1


def sha256_many(msgs: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 messages -> (n, 32) uint8 SHA-256 digests."""
    if not isinstance(msgs, torch.Tensor):
        raise TypeError(f"msgs: expected a tensor, got {type(msgs).__name__}")
    if msgs.dtype != torch.uint8 or msgs.dim() != 2:
        raise TypeError(f"msgs: expected a 2-D uint8 tensor, got "
                        f"{msgs.dtype} of shape {tuple(msgs.shape)}")
    if not msgs.is_contiguous():
        raise ValueError("msgs: must be contiguous")
    dev = msgs.device
    if dev.type == "cpu":
        return sha256_many_plain(msgs)
    if dev.type != "cuda":
        raise ValueError(f"sha256_many: unsupported device {dev}")
    n, length = msgs.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    lib = build.PACKAGE.library("sha256")
    rc = lib.tm_sha256_many(msgs.data_ptr(), n, length, out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sha256_many: CUDA error {rc} at launch")
    with _LAUNCH_LOCK:
        launches["sha256_many"] += 1
    return out


# --- plain PyTorch version ----------------------------------------------------
#
# Words live in int64 masked to 32 bits: torch's int32 right shift is
# arithmetic and its uint32 shift support is uneven, so a rotate written on
# int32 would be silently wrong.

M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x >> k) | (x << (32 - k))) & M32


def sha256_many_plain(msgs: torch.Tensor) -> torch.Tensor:
    """The kernel's function on torch tensors: (n, L) uint8 -> (n, 32)
    uint8, on the tensor's device."""
    n, length = msgs.shape
    nblk = n_blocks(length)
    dev = msgs.device
    padded = torch.zeros((n, nblk * 64), dtype=torch.int64, device=dev)
    padded[:, :length] = msgs.to(torch.int64)
    padded[:, length] = 0x80
    bits = length * 8
    for j in range(8):
        padded[:, nblk * 64 - 1 - j] = (bits >> (8 * j)) & 0xFF
    scale = torch.tensor([1 << 24, 1 << 16, 1 << 8, 1], dtype=torch.int64,
                         device=dev)
    words = (padded.view(n, nblk * 16, 4) * scale).sum(-1)
    hs = [torch.full((n,), iv, dtype=torch.int64, device=dev) for iv in IV]
    for blk in range(nblk):
        w = [words[:, 16 * blk + t] for t in range(16)]
        for t in range(16, 64):
            x15, x2 = w[t - 15], w[t - 2]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        a, b, c, d, e, f, g, h = hs
        for t in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = (h + s1 + ch + K[t] + w[t]) & M32
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            h, g, f, e, d, c, b = g, f, e, (d + t1) & M32, c, b, a
            a = (t1 + s0 + maj) & M32
        hs = [(x + y) & M32 for x, y in zip(hs, (a, b, c, d, e, f, g, h))]
    digest = torch.stack(hs, dim=1)  # (n, 8) big-endian words
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=dev)
    return ((digest.unsqueeze(-1) >> shifts) & 0xFF).reshape(n, 32).to(
        torch.uint8)
