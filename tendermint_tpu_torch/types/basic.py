"""BlockID, PartSetHeader, signed-message enums, time constants.

Wire parity: proto/tendermint/types/types.proto (PartSetHeader field 1/2,
BlockID field 1/2 with non-nullable part_set_header — always emitted, see
types.pb.go:1233-1256).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..libs import protowire as pw

# Go's zero time.Time (Jan 1, year 1 UTC) in unix-nanoseconds; the timestamp
# carried by absent CommitSigs (reference types/block.go NewCommitSigAbsent).
ZERO_TIME_NS = -62_135_596_800 * 1_000_000_000

MAX_HASH_SIZE = 32
BLOCK_PART_SIZE_BYTES = 65536  # types/part_set.go:23


class SignedMsgType(IntEnum):
    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


class BlockIDFlag(IntEnum):
    UNKNOWN = 0
    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.total)
        w.bytes(2, self.hash)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "PartSetHeader":
        total, h = 0, b""
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                total = v & 0xFFFFFFFF  # uint32 on the wire; don't let an
                # oversized varint crash key() downstream
            elif fn == 2:
                h = v
        return PartSetHeader(total, h)

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        if len(self.hash) not in (0, MAX_HASH_SIZE):
            raise ValueError("wrong Hash size")


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        """Non-nil and fully specified (reference types/block.go BlockID.IsComplete)."""
        return (
            len(self.hash) == MAX_HASH_SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == MAX_HASH_SIZE
        )

    def encode(self) -> bytes:
        w = pw.Writer()
        w.bytes(1, self.hash)
        w.message(2, self.part_set_header.encode())  # non-nullable: always
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "BlockID":
        h, psh = b"", PartSetHeader()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                h = v
            elif fn == 2:
                psh = PartSetHeader.decode(v)
        return BlockID(h, psh)

    def validate_basic(self) -> None:
        if len(self.hash) not in (0, MAX_HASH_SIZE):
            raise ValueError("wrong Hash size")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key for vote tallies (reference types/block.go BlockID.Key)."""
        return self.hash + self.part_set_header.total.to_bytes(4, "big") + self.part_set_header.hash
