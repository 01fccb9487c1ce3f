"""edwards25519 group operations in plain PyTorch: the plain version of K4.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/curve.py`` and of the
CUDA ``csrc/curve.cuh``: extended coordinates (X, Y, Z, T), each a
``(10, *batch)`` field element, with the complete a = -1 addition law.
Table entries are picked by a gather on the digit, as the kernel indexes
its table (the TPU's one-hot select is not needed for public data).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import field as F
from .. import ed25519 as _spec

D_INT = _spec.D
D2_INT = (2 * _spec.D) % F.P_INT
SQRT_M1_INT = _spec.SQRT_M1


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(like: torch.Tensor) -> Point:
    zero = torch.zeros_like(like)
    one = zero.clone()
    one[0] = 1
    return Point(zero, one, one.clone(), zero.clone())


def add(p: Point, q: Point) -> Point:
    """Complete addition (2d variant), 9 multiplies."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul(F.mul(p.t, q.t), F.const(D2_INT, p.x))
    dd = F.mul(p.z, q.z)
    dd = F.add(dd, dd)
    e, f, g, h = F.sub(b, a), F.sub(dd, c), F.add(dd, c), F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def dbl(p: Point) -> Point:
    """Doubling (mirrors the host spec's _pt_dbl)."""
    a = F.sqr(p.x)
    b = F.sqr(p.y)
    c = F.sqr(p.z)
    c = F.add(c, c)
    h = F.add(a, b)
    e = F.sub(h, F.sqr(F.add(p.x, p.y)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def add_niels(p: Point, ypx, ymx, t2d) -> Point:
    """Mixed addition with an affine niels point (y+x, y-x, 2dxy)."""
    a = F.mul(F.sub(p.y, p.x), ymx)
    b = F.mul(F.add(p.y, p.x), ypx)
    c = F.mul(p.t, t2d)
    dd = F.add(p.z, p.z)
    e, f, g, h = F.sub(b, a), F.sub(dd, c), F.add(dd, c), F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def neg(p: Point) -> Point:
    return Point(F.neg(p.x), p.y, p.z, F.neg(p.t))


def decompress(a_bytes: torch.Tensor):
    """(32, *batch) int64 bytes -> (Point, ok). Rejects y >= p, a
    non-square x^2 and x = 0 with sign 1 (the host spec's _recover_x)."""
    y = F.from_bytes(a_bytes)
    sign = a_bytes[31] >> 7
    y_ok = (F.freeze(y) == y).all(dim=0)
    one = F.const(1, y)
    yy = F.sqr(y)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, F.const(D_INT, y)), one)
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    vxx = F.mul(v, F.sqr(x))
    ok_direct = F.is_zero(F.sub(vxx, u))
    ok_flip = F.is_zero(F.add(vxx, u))
    x = torch.where(ok_direct, x, F.mul(x, F.const(SQRT_M1_INT, y)))
    fx = F.freeze(x)
    x_is_zero = (fx == 0).all(dim=0)
    ok = y_ok & (ok_direct | ok_flip) & ~(x_is_zero & (sign == 1))
    x = torch.where((fx[0] & 1) != sign, F.neg(x), x)
    return Point(x, y, F.const(1, y).expand_as(y).clone(), F.mul(x, y)), ok


def encode(p: Point) -> torch.Tensor:
    """(32, *batch) int64 bytes: canonical y, parity of x in bit 255."""
    zinv = F.inverse(p.z)
    x = F.mul(p.x, zinv)
    out = F.to_bytes(F.mul(p.y, zinv))
    out[31] = out[31] | (F.parity(x) << 7)
    return out


def _stack(p: Point) -> torch.Tensor:
    return torch.stack([p.x, p.y, p.z, p.t])


def scalar_mul_windowed(p: Point, digits: torch.Tensor) -> Point:
    """[k]P, k = sum digits[i] 16^i (digits (64, n)): a table of [0..15]P,
    then 64 windows of 4 doublings and one table addition."""
    entries = [identity(p.x), p]
    for _ in range(14):
        entries.append(add(entries[-1], p))
    table = torch.stack([_stack(e) for e in entries])   # (16, 4, 10, n)
    acc = identity(p.x)
    for i in range(63, -1, -1):
        for _ in range(4):
            acc = dbl(acc)
        idx = digits[i].reshape(1, 1, 1, -1).expand(1, 4, F.NLIMBS, -1)
        acc = add(acc, Point(*table.gather(0, idx)[0].unbind(0)))
    return acc


def scalar_mul_base(digits: torch.Tensor, table: torch.Tensor) -> Point:
    """[s]B from the (64, 16, 3, 10) fixed-base table; digits (64, n)."""
    table = table.to(torch.int64)
    acc = identity(torch.zeros((F.NLIMBS, digits.shape[1]), dtype=torch.int64,
                               device=digits.device))
    for i in range(64):
        ent = table[i][digits[i]].permute(1, 2, 0)       # (3, 10, n)
        acc = add_niels(acc, ent[0], ent[1], ent[2])
    return acc


def build_base_table() -> np.ndarray:
    """(64, 16, 3, 10) uint32: niels form (y+x, y-x, 2dxy) of
    [j * 16^i]B in 10-limb form, from the host spec's group law."""
    P = F.P_INT
    base = (_spec.B[0], _spec.B[1], 1, _spec.B[0] * _spec.B[1] % P)
    flat = []
    for _ in range(64):
        acc = _spec._IDENT
        for _j in range(16):
            flat.append(acc)
            acc = _spec._pt_add(acc, base)
        for _ in range(4):
            base = _spec._pt_dbl(base)
    # one inversion for every Z (Montgomery's trick)
    prefix = [1]
    for pt in flat:
        prefix.append(prefix[-1] * pt[2] % P)
    inv = pow(prefix[-1], P - 2, P)
    out = np.zeros((64 * 16, 3, F.NLIMBS), dtype=np.uint32)
    for idx in range(len(flat) - 1, -1, -1):
        zi = prefix[idx] * inv % P
        inv = inv * flat[idx][2] % P
        x, y = flat[idx][0] * zi % P, flat[idx][1] * zi % P
        out[idx, 0] = F.int_to_limbs((y + x) % P)
        out[idx, 1] = F.int_to_limbs((y - x) % P)
        out[idx, 2] = F.int_to_limbs(2 * D_INT * x % P * y % P)
    return out.reshape(64, 16, 3, F.NLIMBS)


_TABLE_NP = None
_TABLES: Dict[str, torch.Tensor] = {}
_TABLE_LOCK = threading.Lock()


def base_table_np() -> np.ndarray:
    global _TABLE_NP
    with _TABLE_LOCK:
        if _TABLE_NP is None:
            _TABLE_NP = build_base_table()
        return _TABLE_NP


def base_table(device) -> torch.Tensor:
    """The fixed-base table as a (64, 16, 3, 10) int32 tensor (u32 bits)
    resident on ``device``, uploaded once per device."""
    key = str(torch.device(device))
    hit = _TABLES.get(key)
    if hit is None:
        arr = base_table_np()
        t = torch.from_numpy(arr.view(np.int32)).to(device)
        if t.is_cuda:
            # later readers run on other streams: the upload must be done
            torch.cuda.current_stream(t.device).synchronize()
        with _TABLE_LOCK:
            hit = _TABLES.setdefault(key, t)
    return hit
