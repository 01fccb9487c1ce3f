"""Proposal (reference types/proposal.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..libs import protowire as pw
from .basic import BlockID, SignedMsgType, ZERO_TIME_NS
from .canonical import proposal_sign_bytes
from .vote import MAX_SIGNATURE_SIZE


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int  # -1 if no POL round
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""
    type: SignedMsgType = SignedMsgType.PROPOSAL

    def sign_bytes(self, chain_id: str) -> bytes:
        return proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round, self.block_id, self.timestamp_ns
        )

    def validate_basic(self) -> None:
        if self.type != SignedMsgType.PROPOSAL:
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1:
            raise ValueError("negative POLRound (exception: -1)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError(f"expected a complete, non-empty BlockID, got: {self.block_id}")
        if len(self.signature) == 0:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, int(self.type))
        w.varint(2, self.height)
        w.varint(3, self.round)
        w.varint(4, self.pol_round)
        w.message(5, self.block_id.encode())
        w.message(6, pw.timestamp(self.timestamp_ns))
        w.bytes(7, self.signature)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Proposal":
        height = round_ = 0
        pol_round = 0
        block_id = BlockID()
        ts = ZERO_TIME_NS
        sig = b""
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 2:
                height = pw.varint_to_int64(v)
            elif fn == 3:
                round_ = pw.varint_to_int64(v)
            elif fn == 4:
                pol_round = pw.varint_to_int64(v)
            elif fn == 5:
                block_id = BlockID.decode(v)
            elif fn == 6:
                ts = pw.parse_timestamp(v)
            elif fn == 7:
                sig = v
        return Proposal(height, round_, pol_round, block_id, ts, sig)
