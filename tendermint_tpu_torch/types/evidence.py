"""Evidence of byzantine behaviour (reference types/evidence.go).

DuplicateVoteEvidence: two conflicting votes from one validator at one H/R.
LightClientAttackEvidence: a conflicting light block + byzantine validators.
EvidenceList hash merkle-izes the proto `Bytes()` of each item (evidence.go:431).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto import merkle
from ..libs import protowire as pw
from .basic import ZERO_TIME_NS
from .vote import Vote

MAX_EVIDENCE_BYTES = 444  # types/evidence.go MaxEvidenceBytes (duplicate vote)


class Evidence:
    """Common interface (types/evidence.go:22)."""

    def abci_evidence_type(self) -> str:
        raise NotImplementedError

    def height(self) -> int:
        raise NotImplementedError

    def time_ns(self) -> int:
        raise NotImplementedError

    def bytes(self) -> bytes:
        """UNWRAPPED proto encoding (reference Bytes() = ToProto().Marshal(),
        evidence.go:90-98 — no oneof envelope). This is what EvidenceList.Hash
        and Evidence.Hash consume."""
        raise NotImplementedError

    def wrapped(self) -> bytes:
        """Evidence oneof envelope, for the EvidenceList wire message."""
        raise NotImplementedError

    def hash(self) -> bytes:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError


@dataclass
class DuplicateVoteEvidence(Evidence):
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = ZERO_TIME_NS

    @staticmethod
    def new(vote1: Vote, vote2: Vote, block_time_ns: int, val_set) -> "Optional[DuplicateVoteEvidence]":
        """Orders votes by BlockID key (evidence.go:49)."""
        if vote1 is None or vote2 is None or val_set is None:
            return None
        idx, val = val_set.get_by_address(vote1.validator_address)
        if idx == -1:
            return None
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return DuplicateVoteEvidence(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp_ns=block_time_ns,
        )

    def abci_evidence_type(self) -> str:
        return "DUPLICATE_VOTE"

    def height(self) -> int:
        return self.vote_a.height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def bytes(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.vote_a.encode())
        w.message(2, self.vote_b.encode())
        w.varint(3, self.total_voting_power)
        w.varint(4, self.validator_power)
        w.message(5, pw.timestamp(self.timestamp_ns))
        return w.finish()

    def wrapped(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.bytes())  # oneof sum: field 1
        return w.finish()

    def hash(self) -> bytes:
        return hashlib.sha256(self.bytes()).digest()

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote evidence")
        if len(self.vote_a.signature) == 0 or len(self.vote_b.signature) == 0:
            raise ValueError("missing signature")
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    @staticmethod
    def decode_body(data: bytes) -> "DuplicateVoteEvidence":
        vote_a = vote_b = None
        tvp = vp = 0
        ts = ZERO_TIME_NS
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                vote_a = Vote.decode(v)
            elif fn == 2:
                vote_b = Vote.decode(v)
            elif fn == 3:
                tvp = pw.varint_to_int64(v)
            elif fn == 4:
                vp = pw.varint_to_int64(v)
            elif fn == 5:
                ts = pw.parse_timestamp(v)
        return DuplicateVoteEvidence(vote_a, vote_b, tvp, vp, ts)


@dataclass
class LightClientAttackEvidence(Evidence):
    """A conflicting light block shown to a light client (evidence.go:190)."""

    conflicting_block: object  # LightBlock (light module); needs .signed_header.header
    common_height: int
    byzantine_validators: List = field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = ZERO_TIME_NS

    def abci_evidence_type(self) -> str:
        return "LIGHT_CLIENT_ATTACK"

    def height(self) -> int:
        return self.common_height

    def time_ns(self) -> int:
        return self.timestamp_ns

    def conflicting_header_hash(self) -> bytes:
        return self.conflicting_block.signed_header.header.hash()

    def hash(self) -> bytes:
        """tmhash over block hash || varint(common height) (evidence.go:302)."""
        varint = _go_put_varint(self.common_height)
        bz = bytearray(32 + len(varint))
        h = self.conflicting_header_hash()
        bz[:31] = h[:31]  # reference copies into [:tmhash.Size-1] (quirk kept)
        bz[32:] = varint
        return hashlib.sha256(bytes(bz)).digest()

    def bytes(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.conflicting_block.encode())
        w.varint(2, self.common_height)
        for val in self.byzantine_validators:
            w.message(3, val.encode())
        w.varint(4, self.total_voting_power)
        w.message(5, pw.timestamp(self.timestamp_ns))
        return w.finish()

    def wrapped(self) -> bytes:
        w = pw.Writer()
        w.message(2, self.bytes())  # oneof sum: field 2
        return w.finish()

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")


def _go_put_varint(v: int) -> bytes:
    """encoding/binary PutVarint = zigzag varint."""
    return pw.encode_zigzag(v)


def evidence_list_hash(evidence: List[Evidence]) -> bytes:
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evidence])


def encode_evidence_list(evidence: List[Evidence]) -> bytes:
    """EvidenceList proto message (evidence.proto:37) — oneof-wrapped items."""
    w = pw.Writer()
    for ev in evidence:
        w.message(1, ev.wrapped())
    return w.finish()


def decode_evidence_list(data: bytes) -> List[Evidence]:
    out: List[Evidence] = []
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            out.append(decode_evidence(v))
    return out


def decode_evidence(data: bytes) -> Evidence:
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            return DuplicateVoteEvidence.decode_body(v)
        if fn == 2:
            return _decode_lcae(v)
    raise ValueError("unknown evidence type")


def _decode_lcae(data: bytes) -> LightClientAttackEvidence:
    from .light_block import LightBlock
    from .validator import Validator

    cb = None
    common_height = tvp = 0
    byz: List = []
    ts = ZERO_TIME_NS
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            cb = LightBlock.decode(v)
        elif fn == 2:
            common_height = pw.varint_to_int64(v)
        elif fn == 3:
            byz.append(Validator.decode(v))
        elif fn == 4:
            tvp = pw.varint_to_int64(v)
        elif fn == 5:
            ts = pw.parse_timestamp(v)
    return LightClientAttackEvidence(cb, common_height, byz, tvp, ts)
