"""BLS12-381 group ops: G1 over Fq, G2 over the M-twist E'/Fq2.

E : y^2 = x^3 + 4          (G1 = the order-r subgroup of E(Fq))
E': y^2 = x^3 + 4(u + 1)   (G2 = the order-r subgroup of E'(Fq2))

Points are Jacobian tuples (X, Y, Z); Z == 0 is infinity.  Serialization is
the 48/96-byte compressed form with the top-three flag bits (compressed /
infinity / y-sign), matching the layout every production BLS library uses.

Hash-to-G1 is deliberately try-and-increment (hash, check QR, clear the
cofactor) rather than RFC 9380 SSWU: this plane is a self-contained scalar
spec, not a cross-client interop surface, and the simple construction is
easier to mirror in the vectorized engine.  The DST still domain-separates
signatures from proofs of possession.
"""

from __future__ import annotations

import hashlib

from .field import (P, R, F2_ONE, F2_ZERO, f2add, f2sub, f2neg, f2mul, f2sqr,
                    f2scale, f2inv, f2sqrt, fq_sqrt)

B1 = 4
B2 = (4, 4)

# G1/G2 cofactors: |E(Fq)| = h1 * r, |E'(Fq2)| = h2 * r.
H1 = 0x396C8C005555E1568C00AAAB0000AAAB
H2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

INF1 = (1, 1, 0)
INF2 = (F2_ONE, F2_ONE, F2_ZERO)


# --- G1 (plain Fq coordinates) ---------------------------------------------

def g1_is_inf(pt):
    return pt[2] == 0


def g1_double(pt):
    X, Y, Z = pt
    if Z == 0:
        return pt
    A = X * X % P
    B = Y * Y % P
    S = 4 * X * B % P
    M = 3 * A % P
    X3 = (M * M - 2 * S) % P
    Y3 = (M * (S - X3) - 8 * B * B) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def g1_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    H = (U2 - U1) % P
    Rr = (S2 - S1) % P
    if H == 0:
        return g1_double(p) if Rr == 0 else INF1
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (Rr * Rr - HHH - 2 * V) % P
    Y3 = (Rr * (V - X3) - S1 * HHH) % P
    Z3 = Z1 * Z2 * H % P
    return (X3, Y3, Z3)


def g1_neg(pt):
    return pt if pt[2] == 0 else (pt[0], -pt[1] % P, pt[2])


def g1_mul(pt, k: int):
    r = INF1
    for bit in bin(k % R if k >= R else k)[2:]:
        r = g1_double(r)
        if bit == "1":
            r = g1_add(r, pt)
    return r


def g1_to_affine(pt):
    if pt[2] == 0:
        return None
    zi = pow(pt[2], P - 2, P)
    zi2 = zi * zi % P
    return (pt[0] * zi2 % P, pt[1] * zi2 * zi % P)


def g1_on_curve(aff) -> bool:
    x, y = aff
    return (y * y - (x * x % P * x + B1)) % P == 0


def g1_in_subgroup(aff) -> bool:
    return g1_on_curve(aff) and g1_mul((aff[0], aff[1], 1), R)[2] == 0


# --- G2 (Fq2 coordinates, same formulas) -----------------------------------

def g2_is_inf(pt):
    return pt[2] == F2_ZERO


def g2_double(pt):
    X, Y, Z = pt
    if Z == F2_ZERO:
        return pt
    A = f2sqr(X)
    B = f2sqr(Y)
    S = f2scale(f2mul(X, B), 4)
    M = f2scale(A, 3)
    X3 = f2sub(f2sqr(M), f2scale(S, 2))
    Y3 = f2sub(f2mul(M, f2sub(S, X3)), f2scale(f2sqr(B), 8))
    Z3 = f2scale(f2mul(Y, Z), 2)
    return (X3, Y3, Z3)


def g2_add(p, q):
    if p[2] == F2_ZERO:
        return q
    if q[2] == F2_ZERO:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f2sqr(Z1)
    Z2Z2 = f2sqr(Z2)
    U1 = f2mul(X1, Z2Z2)
    U2 = f2mul(X2, Z1Z1)
    S1 = f2mul(f2mul(Y1, Z2), Z2Z2)
    S2 = f2mul(f2mul(Y2, Z1), Z1Z1)
    H = f2sub(U2, U1)
    Rr = f2sub(S2, S1)
    if H == F2_ZERO:
        return g2_double(p) if Rr == F2_ZERO else INF2
    HH = f2sqr(H)
    HHH = f2mul(H, HH)
    V = f2mul(U1, HH)
    X3 = f2sub(f2sub(f2sqr(Rr), HHH), f2scale(V, 2))
    Y3 = f2sub(f2mul(Rr, f2sub(V, X3)), f2mul(S1, HHH))
    Z3 = f2mul(f2mul(Z1, Z2), H)
    return (X3, Y3, Z3)


def g2_neg(pt):
    return pt if pt[2] == F2_ZERO else (pt[0], f2neg(pt[1]), pt[2])


def g2_mul(pt, k: int):
    r = INF2
    for bit in bin(k % R if k >= R else k)[2:]:
        r = g2_double(r)
        if bit == "1":
            r = g2_add(r, pt)
    return r


def g2_to_affine(pt):
    if pt[2] == F2_ZERO:
        return None
    zi = f2inv(pt[2])
    zi2 = f2sqr(zi)
    return (f2mul(pt[0], zi2), f2mul(f2mul(pt[1], zi2), zi))


def g2_on_curve(aff) -> bool:
    x, y = aff
    return f2sub(f2sqr(y), f2add(f2mul(f2sqr(x), x), B2)) == F2_ZERO


def g2_in_subgroup(aff) -> bool:
    return g2_on_curve(aff) and g2_mul((aff[0], aff[1], F2_ONE), R)[2] == F2_ZERO


# --- compressed serialization ----------------------------------------------

_MASK381 = (1 << 381) - 1
_HALF = (P - 1) // 2


def g1_compress(aff) -> bytes:
    if aff is None:
        return bytes([0xC0]) + bytes(47)
    x, y = aff
    flags = 0x80 | (0x20 if y > _HALF else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_decompress(b: bytes):
    """48 bytes -> affine point (no subgroup check), None if malformed."""
    if len(b) != 48 or not b[0] & 0x80:
        return None
    if b[0] & 0x40:  # infinity: everything else must be zero
        if b[0] & 0x3F or any(b[1:]):
            return None
        return "inf"
    sign = (b[0] >> 5) & 1
    x = int.from_bytes(b, "big") & _MASK381
    if x >= P:
        return None
    y = fq_sqrt((x * x % P * x + B1) % P)
    if y is None:
        return None
    if (1 if y > _HALF else 0) != sign:
        y = P - y
    return (x, y)


def g2_compress(aff) -> bytes:
    if aff is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), (y0, y1) = aff
    big = (y1 > _HALF) if y1 else (y0 > _HALF)
    flags = 0x80 | (0x20 if big else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_decompress(b: bytes):
    if len(b) != 96 or not b[0] & 0x80:
        return None
    if b[0] & 0x40:
        if b[0] & 0x3F or any(b[1:]):
            return None
        return "inf"
    sign = (b[0] >> 5) & 1
    x1 = int.from_bytes(b[:48], "big") & _MASK381
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        return None
    x = (x0, x1)
    y = f2sqrt(f2add(f2mul(f2sqr(x), x), B2))
    if y is None:
        return None
    big = (y[1] > _HALF) if y[1] else (y[0] > _HALF)
    if (1 if big else 0) != sign:
        y = f2neg(y)
    return (x, y)


# --- hash to G1 (try-and-increment + cofactor clearing) --------------------

_H2C_CACHE: dict = {}
_H2C_CACHE_MAX = 4096


def hash_to_g1(msg: bytes, dst: bytes):
    """Map msg -> affine G1 point.  Deterministic; memoized per (dst, msg) —
    in aggregated-commit mode every validator signs the *same* zero-timestamp
    precommit bytes, so one hash serves the whole commit."""
    key = (dst, msg)
    hit = _H2C_CACHE.get(key)
    if hit is not None:
        return hit
    base = hashlib.sha256(len(dst).to_bytes(1, "big") + dst + msg).digest()
    for ctr in range(256):
        seed = hashlib.sha256(base + bytes([ctr])).digest()
        ext = hashlib.sha256(seed + b"\x01").digest()
        x = int.from_bytes(seed + ext[:16], "big") % P
        y = fq_sqrt((x * x % P * x + B1) % P)
        if y is None:
            continue
        if ext[16] & 1:
            y = P - y
        pt = g1_mul((x, y, 1), H1)  # clear the cofactor -> lands in G1
        if pt[2] == 0:
            continue
        aff = g1_to_affine(pt)
        if len(_H2C_CACHE) >= _H2C_CACHE_MAX:
            _H2C_CACHE.clear()
        _H2C_CACHE[key] = aff
        return aff
    raise ValueError("hash_to_g1: no curve point in 256 attempts")


def reset_h2c_cache() -> None:
    _H2C_CACHE.clear()
