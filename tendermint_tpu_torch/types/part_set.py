"""PartSet: a block split into 65536-byte merkle-proven parts for gossip
(reference types/part_set.go:23,150,166).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..crypto import merkle
from ..libs import protowire as pw
from ..libs.bits import BitArray
from .basic import BLOCK_PART_SIZE_BYTES, PartSetHeader


def encode_proof(p: merkle.Proof) -> bytes:
    """tendermint.crypto.Proof (proto/tendermint/crypto/proof.proto)."""
    w = pw.Writer()
    w.varint(1, p.total)
    w.varint(2, p.index)
    w.bytes(3, p.leaf_hash)
    for aunt in p.aunts:
        w.bytes(4, aunt)
    return w.finish()


def decode_proof(data: bytes) -> merkle.Proof:
    total = index = 0
    leaf = b""
    aunts: List[bytes] = []
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            total = pw.varint_to_int64(v)
        elif fn == 2:
            index = pw.varint_to_int64(v)
        elif fn == 3:
            leaf = v
        elif fn == 4:
            aunts.append(v)
    return merkle.Proof(total=total, index=index, leaf_hash=leaf, aunts=aunts)


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(f"too big: {len(self.bytes_)} bytes, max: {BLOCK_PART_SIZE_BYTES}")
        if self.proof.total <= 0 or self.proof.index != self.index or len(self.proof.leaf_hash) != 32:
            raise ValueError("wrong proof")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.index)
        w.bytes(2, self.bytes_)
        w.message(3, encode_proof(self.proof))
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Part":
        index = 0
        bytes_ = b""
        proof = merkle.Proof(0, 0, b"")
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                index = pw.varint_to_int64(v)
            elif fn == 2:
                bytes_ = v
            elif fn == 3:
                proof = decode_proof(v)
        return Part(index, bytes_, proof)


class PartSet:
    """Either built complete from data, or assembled incrementally from a header."""

    def __init__(self, total: int, hash_: bytes):
        self.total = total
        self._hash = hash_
        self.parts: List[Optional[Part]] = [None] * total
        self.parts_bit_array = BitArray(total)
        self.count = 0
        self.byte_size = 0

    @staticmethod
    def from_data(data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split + merkle-prove (part_set.go:166 NewPartSetFromData)."""
        total = (len(data) + part_size - 1) // part_size
        if total == 0:
            total = 1
        chunks = [data[i * part_size:(i + 1) * part_size] for i in range(total)]
        proofs = merkle.proofs_from_byte_slices(chunks)
        root = proofs[0].compute_root() if proofs else merkle.hash_from_byte_slices([])
        ps = PartSet(total, root)
        for i, chunk in enumerate(chunks):
            part = Part(i, chunk, proofs[i])
            ps.parts[i] = part
            ps.parts_bit_array.set_index(i, True)
            ps.count += 1
            ps.byte_size += len(chunk)
        return ps

    @staticmethod
    def from_header(header: PartSetHeader) -> "PartSet":
        return PartSet(header.total, header.hash)

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self._hash)

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header() == header

    def hash(self) -> bytes:
        return self._hash

    def is_complete(self) -> bool:
        return self.count == self.total

    def add_part(self, part: Part) -> bool:
        """Merkle-verify then store (part_set.go AddPart). Duplicate → False."""
        if part.index >= self.total:
            raise ValueError("error part set unexpected index")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self._hash, part.bytes_):
            raise ValueError("error part set invalid proof")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, index: int) -> Optional[Part]:
        return self.parts[index]

    def get_reader(self) -> bytes:
        """Reassembled bytes; only valid when complete."""
        if not self.is_complete():
            raise ValueError("cannot read incomplete part set")
        return b"".join(p.bytes_ for p in self.parts)  # type: ignore[union-attr]
