"""GF(2^255-19) arithmetic in plain PyTorch: the plain version of K1.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/field.py`` and of the
CUDA ``csrc/field.cuh``. Same representation as the kernel: 10 limbs of
alternately 26 and 25 bits (radix 2^25.5), shaped ``(10, *batch)``. The
limbs are int64 here because PyTorch on the CPU has no shifts or adds for
uint32/uint64, and 64 bits hold the column sums (< 2^61) of a multiply.

Every result is "carried": limbs below 2^26 + 2^20 (even) and 2^25 + 2^16
(odd), so a multiply's column sums stay below 2^61. Subtraction adds 4p
first, so limbs never go negative.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

NLIMBS = 10
WIDTHS = tuple(26 if i % 2 == 0 else 25 for i in range(NLIMBS))
OFFSETS = tuple((i // 2) * 51 + (26 if i % 2 else 0) for i in range(NLIMBS))
P_INT = 2**255 - 19


def int_to_limbs(x: int) -> List[int]:
    """A non-negative int below 2^255 as 10 limbs."""
    return [(x >> OFFSETS[i]) & ((1 << WIDTHS[i]) - 1) for i in range(NLIMBS)]


def limbs_to_int(limbs: Sequence[int]) -> int:
    return sum(int(limbs[i]) << OFFSETS[i] for i in range(NLIMBS))


def from_ints(xs: Sequence[int], device=None) -> torch.Tensor:
    """Python ints (each < 2^255) -> (10, n) int64 limbs."""
    return torch.tensor([int_to_limbs(x) for x in xs], dtype=torch.int64,
                        device=device).T.contiguous()


def to_ints(a: torch.Tensor) -> List[int]:
    """(10, n) limbs -> Python ints (not reduced)."""
    cols = a.cpu().T.tolist()
    return [limbs_to_int(c) for c in cols]


_CONSTS: Dict[Tuple[str, int], dict] = {}


def _consts(like: torch.Tensor) -> dict:
    """Per-device constant tensors shaped to broadcast over ``like``'s
    batch dims (10, 1, ...)."""
    key = (str(like.device), like.dim())
    c = _CONSTS.get(key)
    if c is None:
        bshape = (1,) * (like.dim() - 1)
        dev = like.device

        def col(vals):
            return torch.tensor(vals, dtype=torch.int64,
                                device=dev).reshape((NLIMBS,) + bshape)

        # fe_mul's column k sums f_i * g_j over j = (k - i) mod 10, with a
        # factor 2 when i and j are both odd and 19 when i + j >= 10
        idx = [[(k - i) % NLIMBS for i in range(NLIMBS)]
               for k in range(NLIMBS)]
        coef = [[(2 if (i % 2 and ((k - i) % NLIMBS) % 2) else 1)
                 * (19 if i + (k - i) % NLIMBS >= NLIMBS else 1)
                 for i in range(NLIMBS)] for k in range(NLIMBS)]
        c = {
            "shift": col(WIDTHS),
            "mask": col([(1 << w) - 1 for w in WIDTHS]),
            "four_p": col([4 * ((1 << 26) - 19)]
                          + [4 * ((1 << w) - 1) for w in WIDTHS[1:]]),
            "idx": torch.tensor(idx, dtype=torch.int64, device=dev),
            "coef": torch.tensor(coef, dtype=torch.int64,
                                 device=dev).reshape((NLIMBS, NLIMBS) + bshape),
        }
        _CONSTS[key] = c
    return c


def carry(h: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes: each moves every limb's excess one limb up,
    the top limb's folding into limb 0 with 19 (2^255 = 19 mod p)."""
    c = _consts(h)
    for _ in range(passes):
        hi = h >> c["shift"]
        h = (h & c["mask"]) + torch.cat([hi[NLIMBS - 1:] * 19,
                                         hi[:NLIMBS - 1]], dim=0)
    return h


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + _consts(a)["four_p"] - b, 1)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(_consts(a)["four_p"] - a, 1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One broadcast multiply of a against b gathered per column, one sum,
    two carry passes (column sums < 2^61 -> carried)."""
    c = _consts(a)
    prod = a.unsqueeze(0) * b[c["idx"]] * c["coef"]
    return carry(prod.sum(dim=1), 2)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sqr(a)
    return a


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p), every limb within its width:
    three exact sequential passes bring a carried value below 2^255, then
    adding 19 sets bit 255 exactly when the value is >= p."""
    h = list(a.unbind(0))
    for _ in range(3):
        for i in range(NLIMBS - 1):
            h[i + 1] = h[i + 1] + (h[i] >> WIDTHS[i])
            h[i] = h[i] & ((1 << WIDTHS[i]) - 1)
        top = h[9] >> 25
        h[9] = h[9] & ((1 << 25) - 1)
        h[0] = h[0] + 19 * top
    t = list(h)
    t[0] = t[0] + 19
    for i in range(NLIMBS - 1):
        t[i + 1] = t[i + 1] + (t[i] >> WIDTHS[i])
        t[i] = t[i] & ((1 << WIDTHS[i]) - 1)
    ge_p = (t[9] >> 25) == 1
    t[9] = t[9] & ((1 << 25) - 1)
    return torch.where(ge_p.unsqueeze(0), torch.stack(t), torch.stack(h))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (freeze(a) == 0).all(dim=0)


def parity(a: torch.Tensor) -> torch.Tensor:
    return freeze(a)[0] & 1


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) int64 little-endian bytes -> (10, *batch) limbs of the
    low 255 bits (bit 255 ignored; the value may be >= p)."""
    b = b.clone()
    b[31] = b[31] & 0x7F
    out = []
    for i in range(NLIMBS):
        off, w = OFFSETS[i], WIDTHS[i]
        acc = torch.zeros_like(b[0])
        for j in range(off // 8, min(32, (off + w - 1) // 8 + 1)):
            sh = 8 * j - off
            acc = acc | ((b[j] << sh) if sh >= 0 else (b[j] >> -sh))
        out.append(acc & ((1 << w) - 1))
    return torch.stack(out)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """(10, *batch) -> (32, *batch) int64 bytes of the canonical value."""
    h = freeze(a)
    out = []
    for j in range(32):
        acc = torch.zeros_like(h[0])
        for i in range(NLIMBS):
            lo, hi = OFFSETS[i], OFFSETS[i] + WIDTHS[i]
            if hi <= 8 * j or lo >= 8 * j + 8:
                continue
            sh = lo - 8 * j
            acc = acc | ((h[i] << sh) if sh >= 0 else (h[i] >> -sh))
        out.append(acc & 0xFF)
    return torch.stack(out)


def _pow_2250_minus_1(z: torch.Tensor):
    """z^(2^250 - 1) and z^11 (the ref10 addition chain)."""
    z2 = sqr(z)
    z9 = mul(sqr_n(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sqr(z11), z9)
    z_10_0 = mul(sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sqr_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def inverse(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2); 0 for z = 0."""
    z_250_0, z11 = _pow_2250_minus_1(z)
    return mul(sqr_n(z_250_0, 5), z11)


def pow_p58(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8)."""
    z_250_0, _ = _pow_2250_minus_1(z)
    return mul(sqr_n(z_250_0, 2), z)


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """A field constant shaped (10, 1, ..) to broadcast over ``like``."""
    return torch.tensor(int_to_limbs(x % P_INT), dtype=torch.int64,
                        device=like.device).reshape(
                            (NLIMBS,) + (1,) * (like.dim() - 1))
