"""min-sig BLS12-381 signatures: sigs in G1 (48 B), pubkeys in G2 (96 B).

    sk in Z_r,  pk = sk * g2,  sig = sk * H(m) in G1
    verify:  e(sig, -g2) * e(H(m), pk) == 1
    fast_aggregate_verify(pks, m, asig):  e(asig, -g2) * e(H(m), apk) == 1

Aggregation over one message is only sound against rogue-key attacks when
every pubkey has proven possession of its secret key, so key *registration*
(genesis validation / validator updates) demands a proof-of-possession — a
BLS signature over the pubkey bytes under a dedicated DST — and the
consensus plane refuses unregistered BLS validator keys.  Verification
itself does not re-check PoP: by then the key is already committed to a
validator-set hash that registration vetted.

Decompression + subgroup checks are memoized per byte-string (subgroup
check = one scalar mul by r, the dominant cost), as is the aggregate
pubkey per signer-set.  `reset()` drops every cache; the test harness calls
it between tests.

Known limitation: the pure-Python double-and-add in curve.g1_mul/g2_mul is
VARIABLE-TIME in the scalar — signing leaks timing about the secret key.
That is acceptable for this scalar spec plane (tests, benches, in-proc
nets) but rules out the pure-Python signer for keys that face untrusted
network observers; a production deployment wants a constant-time native
backend behind the same sign/verify surface.
"""

from __future__ import annotations

import hashlib

from . import curve as _c
from . import pairing as _p
from .field import R

DST_SIG = b"TMTPU-BLS12381-SIG-"
DST_POP = b"TMTPU-BLS12381-POP-"

PUBKEY_SIZE = 96
SIG_SIZE = 48

_g1_cache: dict = {}   # sig bytes -> affine G1 point | None
_g2_cache: dict = {}   # pk bytes -> affine G2 point | None
_apk_cache: dict = {}  # tuple(pk bytes) -> affine G2 aggregate | None
_pop_registered: set = set()
_CACHE_MAX = 8192


def reset() -> None:
    _g1_cache.clear()
    _g2_cache.clear()
    _apk_cache.clear()
    _pop_registered.clear()
    _c.reset_h2c_cache()


def _bound(cache: dict) -> None:
    if len(cache) >= _CACHE_MAX:
        cache.clear()


# --- keys ------------------------------------------------------------------

def sk_from_seed(seed: bytes) -> int:
    sk = int.from_bytes(hashlib.sha256(b"tmtpu-bls-keygen" + seed).digest()
                        + hashlib.sha256(b"tmtpu-bls-keygen2" + seed).digest(),
                        "big") % R
    return sk or 1


def sk_to_bytes(sk: int) -> bytes:
    return sk.to_bytes(32, "big")


def sk_from_bytes(b: bytes) -> int:
    if len(b) != 32:
        raise ValueError(f"BLS secret key must be 32 bytes, got {len(b)}")
    sk = int.from_bytes(b, "big") % R
    if sk == 0:
        raise ValueError("BLS secret key is zero")
    return sk


def sk_to_pk(sk: int) -> bytes:
    return _c.g2_compress(_c.g2_to_affine(_c.g2_mul(
        (_c.G2_GEN[0], _c.G2_GEN[1], (1, 0)), sk)))


def decompress_pubkey(pk: bytes):
    """pk bytes -> affine G2 point, or None (malformed / infinity / outside
    the r-subgroup).  Memoized."""
    if pk in _g2_cache:
        return _g2_cache[pk]
    aff = _c.g2_decompress(pk)
    if aff == "inf" or (aff is not None and not _c.g2_in_subgroup(aff)):
        aff = None
    _bound(_g2_cache)
    _g2_cache[pk] = aff
    return aff


def _decompress_sig(sig: bytes):
    if sig in _g1_cache:
        return _g1_cache[sig]
    aff = _c.g1_decompress(sig)
    if aff == "inf" or (aff is not None and not _c.g1_in_subgroup(aff)):
        aff = None
    _bound(_g1_cache)
    _g1_cache[sig] = aff
    return aff


# --- sign / verify ---------------------------------------------------------

def sign(sk: int, msg: bytes, dst: bytes = DST_SIG) -> bytes:
    h = _c.hash_to_g1(msg, dst)
    return _c.g1_compress(_c.g1_to_affine(_c.g1_mul((h[0], h[1], 1), sk)))


def verify(pk: bytes, msg: bytes, sig: bytes, dst: bytes = DST_SIG) -> bool:
    q = decompress_pubkey(pk)
    s = _decompress_sig(sig)
    if q is None or s is None:
        return False
    return _p.multi_pairing_check([(s, _p.NEG_G2_AFF),
                                   (_c.hash_to_g1(msg, dst), q)])


def aggregate(sigs) -> bytes:
    """Sum of G1 signatures.  Raises on a malformed input signature."""
    acc = _c.INF1
    for sig in sigs:
        s = _decompress_sig(sig)
        if s is None:
            raise ValueError("aggregate: invalid BLS signature input")
        acc = _c.g1_add(acc, (s[0], s[1], 1))
    return _c.g1_compress(_c.g1_to_affine(acc))


def aggregate_pubkeys(pks):
    key = tuple(pks)
    if key in _apk_cache:
        return _apk_cache[key]
    acc = _c.INF2
    ok = True
    for pk in pks:
        q = decompress_pubkey(pk)
        if q is None:
            ok = False
            break
        acc = _c.g2_add(acc, (q[0], q[1], (1, 0)))
    apk = _c.g2_to_affine(acc) if ok and acc[2] != (0, 0) else None
    _bound(_apk_cache)
    _apk_cache[key] = apk
    return apk


def fast_aggregate_verify(pks, msg: bytes, sig: bytes,
                          dst: bytes = DST_SIG) -> bool:
    """All of `pks` signed the same msg; `sig` is the aggregate."""
    if not pks:
        return False
    apk = aggregate_pubkeys(pks)
    s = _decompress_sig(sig)
    if apk is None or s is None:
        return False
    return _p.multi_pairing_check([(s, _p.NEG_G2_AFF),
                                   (_c.hash_to_g1(msg, dst), apk)])


# --- proof of possession ---------------------------------------------------

def pop_prove(sk: int) -> bytes:
    return sign(sk, sk_to_pk(sk), dst=DST_POP)


def pop_verify(pk: bytes, pop: bytes) -> bool:
    return verify(pk, pk, pop, dst=DST_POP)


def register_key(pk: bytes, pop: bytes) -> None:
    """Admit a BLS pubkey into the aggregation-eligible set.  Raises unless
    the proof of possession verifies — this is the rogue-key gate."""
    if pk in _pop_registered:
        return
    if not pop_verify(pk, pop):
        raise ValueError("BLS proof-of-possession verification failed")
    _pop_registered.add(pk)


def is_registered(pk: bytes) -> bool:
    return pk in _pop_registered
