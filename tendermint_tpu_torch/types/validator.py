"""Validator (reference types/validator.go).

`bytes_for_hash` is the SimpleValidator proto encoding merkle-ized by
ValidatorSet.Hash (reference types/validator.go:117-133).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .. import crypto
from ..libs import protowire as pw

MAX_TOTAL_VOTING_POWER = (2**63 - 1) // 8  # types/validator_set.go:25
PRIORITY_WINDOW_SIZE_FACTOR = 2  # types/validator_set.go:30

INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)


def safe_add_clip(a: int, b: int) -> int:
    c = a + b
    return min(max(c, INT64_MIN), INT64_MAX)


def safe_sub_clip(a: int, b: int) -> int:
    c = a - b
    return min(max(c, INT64_MIN), INT64_MAX)


def safe_mul(a: int, b: int) -> "tuple[int, bool]":
    c = a * b
    if c > INT64_MAX or c < INT64_MIN:
        return 0, True
    return c, False


def pubkey_proto_bytes(pub: crypto.PubKey) -> bytes:
    """tendermint.crypto.PublicKey oneof encoding (proto/tendermint/crypto/keys.proto).

    Cached on the key instance: PubKey objects are immutable and shared
    across Validator copies (Validator.copy passes the reference), while
    state persistence and valset hashing re-encode every validator several
    times per block — profiling showed this as the hottest proto call."""
    cached = getattr(pub, "_proto_bytes", None)
    if cached is not None:
        return cached
    w = pw.Writer()
    if pub.type_name == crypto.ED25519_TYPE:
        w.bytes(1, pub.bytes())
    elif pub.type_name == "secp256k1":
        w.bytes(2, pub.bytes())
    elif pub.type_name == crypto.BLS12381_TYPE:
        # same oneof field the ABCI codec uses for validator updates
        w.bytes(3, pub.bytes())
    else:
        raise ValueError(f"unsupported pubkey type {pub.type_name!r}")
    out = w.finish()
    try:
        # frozen-dataclass keys need the object.__setattr__ side door;
        # equality/hash use declared fields only, so the cache is invisible
        object.__setattr__(pub, "_proto_bytes", out)
    except AttributeError:
        pass  # __slots__ keys just skip the cache
    return out


def pubkey_from_proto(data: bytes) -> crypto.PubKey:
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            return crypto.Ed25519PubKey(v)
        if fn == 2:
            return crypto.pubkey_from_type_and_bytes("secp256k1", v)
        if fn == 3:
            return crypto.pubkey_from_type_and_bytes(crypto.BLS12381_TYPE, v)
    raise ValueError("empty PublicKey proto")


@dataclass
class Validator:
    address: bytes
    pub_key: crypto.PubKey
    voting_power: int
    proposer_priority: int = 0

    def copy(self) -> "Validator":
        return Validator(self.address, self.pub_key, self.voting_power, self.proposer_priority)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break to the lower address (validator.go:64)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def bytes_for_hash(self) -> bytes:
        """SimpleValidator proto encoding (validator.go:117)."""
        w = pw.Writer()
        w.message(1, pubkey_proto_bytes(self.pub_key))  # nullable ptr but always set
        w.varint(2, self.voting_power)
        return w.finish()

    def encode(self) -> bytes:
        """Full Validator proto (validator.proto:15-20) for wire/storage.

        The address/pubkey/power prefix is immutable for a validator's
        lifetime and cached; only the proposer-priority varint (which
        rotates every height) is re-encoded. State persistence encodes
        whole 1000-validator sets several times per block, so this is a
        measured hot path, not speculation."""
        # hold the pub_key OBJECT and compare with `is`: keying on
        # id(self.pub_key) is an id-recycling hazard — a replaced key object
        # can land on the freed key's address and silently serve the old
        # encoding. The stored reference also pins the object, so the id
        # can't be recycled while the cache lives.
        cached = self.__dict__.get("_enc_prefix")
        if (cached is None or cached[0] is not self.pub_key
                or cached[1] != self.voting_power):
            w = pw.Writer()
            w.bytes(1, self.address)
            w.message(2, pubkey_proto_bytes(self.pub_key))
            w.varint(3, self.voting_power)
            cached = (self.pub_key, self.voting_power, w.finish())
            self.__dict__["_enc_prefix"] = cached
        pp = self.proposer_priority
        if pp == 0:  # proto3 zero omission, like Writer.varint
            return cached[2]
        return cached[2] + pw.tag(4, pw.WIRE_VARINT) + pw.encode_varint(pp)

    @staticmethod
    def decode(data: bytes) -> "Validator":
        address = b""
        pub_key = None
        voting_power = 0
        priority = 0
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                address = v
            elif fn == 2:
                pub_key = pubkey_from_proto(v)
            elif fn == 3:
                voting_power = pw.varint_to_int64(v)
            elif fn == 4:
                priority = pw.varint_to_int64(v)
        if pub_key is None:
            raise ValueError("validator missing pubkey")
        return Validator(address, pub_key, voting_power, priority)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != crypto.ADDRESS_SIZE:
            raise ValueError("validator address is the wrong size")


def new_validator(pub_key: crypto.PubKey, voting_power: int) -> Validator:
    return Validator(pub_key.address(), pub_key, voting_power)
