"""Vote (reference types/vote.go).

Sign-bytes are the canonical length-delimited proto (canonical.py); `verify`
is THE scalar hot call the batched TPU path replaces (vote.go:147-152).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import crypto
from ..crypto import schemes
from ..libs import protowire as pw
from .basic import BlockID, SignedMsgType, ZERO_TIME_NS
from .canonical import vote_sign_bytes
from .errors import ErrVoteInvalidSignature, ErrVoteInvalidValidatorAddress

# MaxVotesCount bounds validator-set size for sanity checks (types/vote.go:24).
MAX_VOTES_COUNT = 10000

MAX_SIGNATURE_SIZE = 64


@dataclass
class Vote:
    type: SignedMsgType
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        ts = self.timestamp_ns
        if (self.type == SignedMsgType.PRECOMMIT
                and schemes.for_chain(chain_id).zero_precommit_ts):
            # aggregated chains sign one shared precommit payload; the real
            # timestamp still travels in the Vote for the commit's median
            ts = schemes.AGG_ZERO_TS_NS
        return vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id, ts
        )

    def verify(self, chain_id: str, pub_key: crypto.PubKey) -> None:
        if pub_key.address() != self.validator_address:
            raise ErrVoteInvalidValidatorAddress()
        if not pub_key.verify_signature(self.sign_bytes(chain_id), self.signature):
            raise ErrVoteInvalidSignature()

    def verify_with(self, chain_id: str, pub_key: crypto.PubKey,
                    verifier) -> None:
        """Same decisions as :meth:`verify`, signature check routed through a
        verifier (micro-batch cache / device path; vote_set.go:205 hot call)."""
        if pub_key.address() != self.validator_address:
            raise ErrVoteInvalidValidatorAddress()
        if not verifier.verify(pub_key, self.sign_bytes(chain_id), self.signature):
            raise ErrVoteInvalidSignature()

    def copy(self) -> "Vote":
        return Vote(self.type, self.height, self.round, self.block_id,
                    self.timestamp_ns, self.validator_address,
                    self.validator_index, self.signature)

    def validate_basic(self) -> None:
        if self.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got: {self.block_id}")
        if len(self.validator_address) != crypto.ADDRESS_SIZE:
            raise ValueError(
                f"expected ValidatorAddress size to be {crypto.ADDRESS_SIZE} bytes, "
                f"got {len(self.validator_address)} bytes"
            )
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if len(self.signature) == 0:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    # -- proto (types.proto Vote) -----------------------------------------

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, int(self.type))
        w.varint(2, self.height)
        w.varint(3, self.round)
        w.message(4, self.block_id.encode())
        w.message(5, pw.timestamp(self.timestamp_ns))
        w.bytes(6, self.validator_address)
        w.varint(7, self.validator_index)
        w.bytes(8, self.signature)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Vote":
        type_ = SignedMsgType.UNKNOWN
        height = round_ = val_index = 0
        block_id = BlockID()
        ts = ZERO_TIME_NS
        val_addr = sig = b""
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                type_ = SignedMsgType(v)
            elif fn == 2:
                height = pw.varint_to_int64(v)
            elif fn == 3:
                round_ = pw.varint_to_int64(v)
            elif fn == 4:
                block_id = BlockID.decode(v)
            elif fn == 5:
                ts = pw.parse_timestamp(v)
            elif fn == 6:
                val_addr = v
            elif fn == 7:
                val_index = pw.varint_to_int64(v)
            elif fn == 8:
                sig = v
        return Vote(type_, height, round_, block_id, ts, val_addr, val_index, sig)
