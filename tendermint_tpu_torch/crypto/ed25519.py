"""Host-side (scalar) Ed25519: the semantic reference implementation.

This is the framework's *specification* of signature acceptance: the TPU
batch verifier (crypto/ed25519_cuda) must make byte-identical
accept/reject decisions to :func:`verify` here, and differential tests
enforce that.

Semantics follow RFC 8032 strict verification as implemented by modern Go
``crypto/ed25519`` (which the reference uses via golang.org/x/crypto —
reference crypto/ed25519/ed25519.go:148-155):

* signature length must be 64, public key length 32;
* ``s`` (sig[32:]) must be canonical: ``s < L`` (and therefore the top three
  bits clear);
* the public key ``A`` must decode per RFC 8032 §5.1.3: ``y < p`` and
  ``x^2 = (y^2-1)/(d y^2+1)`` must have a root; if ``x == 0`` the sign bit
  must be 0;
* the check is *cofactorless*: ``[s]B == R + [h]A`` verified by comparing
  the 32-byte encoding of ``[s]B - [h]A`` against sig[:32] (R is never
  decompressed, exactly like Go's implementation).

Pure Python (hashlib + int arithmetic): slow (~1 ms/verify) but exact.
The fast host path used in production defaults is `cryptography` (OpenSSL);
see batch.py for the dispatch.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

# --- curve constants -------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# base point
_BY = 4 * pow(5, P - 2, P) % P
_BX = None  # filled below


def _recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 §5.1.3 x-recovery. Returns None on failure."""
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate root of u/v: x = u v^3 (u v^7)^((p-5)/8)
    x = (u * pow(v, 3, P)) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
B = (_BX, _BY)  # base point, affine


# --- group ops (affine-free: extended homogeneous (X,Y,Z,T)) ---------------

def _pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dv = 2 * Z1 * Z2 % P
    E, F, G, H = Bv - A, Dv - C, Dv + C, Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def _pt_dbl(p):
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    Bv = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = (A + Bv) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - Bv) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


_IDENT = (0, 1, 1, 0)


def _pt_mul(s: int, p) -> Tuple[int, int, int, int]:
    q = _IDENT
    while s > 0:
        if s & 1:
            q = _pt_add(q, p)
        p = _pt_dbl(p)
        s >>= 1
    return q


def _pt_encode(p) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _pt_decode(s: bytes):
    """Decode 32-byte point encoding → extended coords, or None (strict)."""
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    y = val & ((1 << 255) - 1)
    sign = val >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


# --- keys & signing --------------------------------------------------------

SEED_SIZE = 32
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey, matching the reference's 64-byte privkey
SIGNATURE_SIZE = 64


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def pubkey_from_seed(seed: bytes) -> bytes:
    if len(seed) != SEED_SIZE:
        raise ValueError(f"ed25519 seed must be {SEED_SIZE} bytes, got {len(seed)}")
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return _pt_encode(_pt_mul(a, (B[0], B[1], 1, B[0] * B[1] % P)))


def keygen(seed: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """Returns (priv, pub); priv = seed || pub (64 bytes, like the reference)."""
    if seed is None:
        seed = os.urandom(SEED_SIZE)
    pub = pubkey_from_seed(seed)
    return seed + pub, pub


def sign(priv: bytes, msg: bytes) -> bytes:
    if len(priv) != PRIVKEY_SIZE:
        raise ValueError(f"ed25519 private key must be {PRIVKEY_SIZE} bytes, got {len(priv)}")
    seed, pub = priv[:32], priv[32:]
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = _pt_encode(_pt_mul(r, (B[0], B[1], 1, B[0] * B[1] % P)))
    k = int.from_bytes(hashlib.sha512(R + pub + msg).digest(), "little") % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Strict cofactorless verification; the acceptance spec for the framework."""
    if len(pub) != PUBKEY_SIZE or len(sig) != SIGNATURE_SIZE:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    A = _pt_decode(pub)
    if A is None:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
    # R' = [s]B - [h]A ; accept iff encode(R') == sig[:32]
    negA = (P - A[0], A[1], A[2], P - A[3])
    sB = _pt_mul(s, (B[0], B[1], 1, B[0] * B[1] % P))
    hA = _pt_mul(h, negA)
    return _pt_encode(_pt_add(sB, hA)) == sig[:32]
