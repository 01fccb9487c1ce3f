"""Pluggable key/signature interfaces (the seam from reference crypto/crypto.go:22-30).

`PubKey.verify_signature` is the scalar path; `BatchVerifier` (crypto/batch.py)
is the batched seam the reference lacks (SURVEY.md north star) — collect
(pk, msg, sig) tuples, verify all at once on the card, fall back to scalar
on the host.

Ed25519 and BLS12-381 keys; the secp256k1 and sr25519 key types raise
NotImplementedError until their slices are ported.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

from . import ed25519 as _ed

ADDRESS_SIZE = 20


def address_hash(b: bytes) -> bytes:
    """Address = first 20 bytes of SHA-256 (reference crypto/crypto.go:16)."""
    return hashlib.sha256(b).digest()[:ADDRESS_SIZE]


class PubKey:
    type_name: str = ""

    def address(self) -> bytes:
        raise NotImplementedError

    def bytes(self) -> bytes:
        raise NotImplementedError

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def __eq__(self, other):
        return isinstance(other, PubKey) and self.type_name == other.type_name \
            and self.bytes() == other.bytes()

    def __hash__(self):
        return hash((self.type_name, self.bytes()))


class PrivKey:
    type_name: str = ""

    def bytes(self) -> bytes:
        raise NotImplementedError

    def sign(self, msg: bytes) -> bytes:
        raise NotImplementedError

    def pub_key(self) -> PubKey:
        raise NotImplementedError


# --- ed25519 ---------------------------------------------------------------

ED25519_TYPE = "ed25519"

try:  # OpenSSL-backed fast scalar path, if present (it is in this image)
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey as _OSSLPub,
    )
    from cryptography.exceptions import InvalidSignature as _InvalidSig

    def _fast_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
        if len(sig) != 64 or len(pub) != 32:
            return False
        # OpenSSL accepts some encodings strict RFC-8032 rejects (non-canonical
        # A) and vice versa is not possible; re-check the cheap canonicality
        # rules here so decisions match ed25519.verify exactly.
        if int.from_bytes(sig[32:], "little") >= _ed.L:
            return False
        pub_int = int.from_bytes(pub, "little")
        y, x_sign = pub_int & ((1 << 255) - 1), pub_int >> 255
        if y >= _ed.P:
            return False
        # RFC 8032 §5.1.3: x=0 (y = ±1) with sign bit 1 is an invalid
        # encoding; OpenSSL accepts it, the strict spec and TPU path reject.
        if x_sign == 1 and y in (1, _ed.P - 1):
            return False
        try:
            _OSSLPub.from_public_bytes(pub).verify(sig, msg)
            return True
        except (_InvalidSig, ValueError):
            return False

    _HAVE_OSSL = True
except ImportError:  # pragma: no cover
    _fast_verify = None
    _HAVE_OSSL = False


@dataclass(frozen=True)
class Ed25519PubKey(PubKey):
    key: bytes
    type_name = ED25519_TYPE

    def address(self) -> bytes:
        return address_hash(self.key)

    def bytes(self) -> bytes:
        return self.key

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if _HAVE_OSSL:
            return _fast_verify(self.key, msg, sig)
        return _ed.verify(self.key, msg, sig)

    def __eq__(self, other):
        return PubKey.__eq__(self, other)

    def __hash__(self):
        return PubKey.__hash__(self)


@dataclass(frozen=True)
class Ed25519PrivKey(PrivKey):
    key: bytes  # 64 bytes: seed || pubkey
    type_name = ED25519_TYPE

    @staticmethod
    def generate(seed: Optional[bytes] = None) -> "Ed25519PrivKey":
        priv, _ = _ed.keygen(seed)
        return Ed25519PrivKey(priv)

    def bytes(self) -> bytes:
        return self.key

    def sign(self, msg: bytes) -> bytes:
        return _ed.sign(self.key, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self.key[32:])


# --- bls12-381 (min-sig: 96-byte G2 pubkeys, 48-byte G1 signatures) --------

BLS12381_TYPE = "bls12381"


@dataclass(frozen=True)
class Bls12381PubKey(PubKey):
    key: bytes  # compressed G2, 96 bytes
    type_name = BLS12381_TYPE

    def address(self) -> bytes:
        return address_hash(self.key)

    def bytes(self) -> bytes:
        return self.key

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        from . import bls12381 as _bls

        return _bls.verify(self.key, msg, sig)

    def __eq__(self, other):
        return PubKey.__eq__(self, other)

    def __hash__(self):
        return PubKey.__hash__(self)


def _bls_pubkey_bytes(sk_bytes: bytes) -> bytes:
    from . import bls12381 as _bls

    # keyed on a digest so the module-global memo never retains raw
    # secret-key bytes, and bounded so it cannot grow with key churn
    memo_key = hashlib.sha256(b"tmtpu-bls-pk-memo" + sk_bytes).digest()
    cached = _bls_pubkey_bytes._memo.get(memo_key)
    if cached is None:  # one G2 scalar mul (~15 ms) — memoize per secret
        if len(_bls_pubkey_bytes._memo) >= _BLS_PK_MEMO_MAX:
            _bls_pubkey_bytes._memo.clear()
        cached = _bls.sk_to_pk(_bls.sk_from_bytes(sk_bytes))
        _bls_pubkey_bytes._memo[memo_key] = cached
    return cached


_bls_pubkey_bytes._memo = {}
_BLS_PK_MEMO_MAX = 256


@dataclass(frozen=True)
class Bls12381PrivKey(PrivKey):
    key: bytes  # scalar mod r, 32 bytes big-endian
    type_name = BLS12381_TYPE

    @staticmethod
    def generate(seed: Optional[bytes] = None) -> "Bls12381PrivKey":
        import os

        from . import bls12381 as _bls

        sk = _bls.sk_from_seed(seed if seed is not None else os.urandom(32))
        return Bls12381PrivKey(_bls.sk_to_bytes(sk))

    def bytes(self) -> bytes:
        return self.key

    def sign(self, msg: bytes) -> bytes:
        from . import bls12381 as _bls

        return _bls.sign(_bls.sk_from_bytes(self.key), msg)

    def pub_key(self) -> Bls12381PubKey:
        return Bls12381PubKey(_bls_pubkey_bytes(self.key))

    def pop(self) -> bytes:
        """Proof of possession — required to register the pubkey for
        aggregation (see crypto/bls12381 rogue-key notes)."""
        from . import bls12381 as _bls

        return _bls.pop_prove(_bls.sk_from_bytes(self.key))


def pubkey_from_type_and_bytes(type_name: str, b: bytes) -> PubKey:
    if type_name == ED25519_TYPE:
        if len(b) != 32:
            raise ValueError(f"ed25519 pubkey must be 32 bytes, got {len(b)}")
        return Ed25519PubKey(b)
    if type_name == BLS12381_TYPE:
        if len(b) != 96:
            raise ValueError(f"bls12381 pubkey must be 96 bytes, got {len(b)}")
        return Bls12381PubKey(b)
    if type_name in ("secp256k1", "sr25519"):
        raise NotImplementedError(f"{type_name} keys: not yet ported")
    raise ValueError(f"unknown pubkey type {type_name!r}")
