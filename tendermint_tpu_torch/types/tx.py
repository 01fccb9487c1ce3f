"""Transactions (reference types/tx.go): Tx = raw bytes, hashed with SHA-256."""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from ..crypto import merkle


def tx_hash(tx: bytes) -> bytes:
    """tmhash.Sum (types/tx.go:29)."""
    return hashlib.sha256(tx).digest()


def txs_hash(txs: Sequence[bytes]) -> bytes:
    """Merkle root over per-tx hashes (types/tx.go:47)."""
    return merkle.hash_from_byte_slices([tx_hash(t) for t in txs])


def compute_proto_size_overhead(body_len: int, field_count: int = 1) -> int:
    """Varint framing overhead for a repeated bytes field (types/tx.go ComputeProtoSizeForTxs)."""
    from ..libs.protowire import encode_varint

    return field_count + len(encode_varint(body_len))


def txs_bytes_size(txs: Sequence[bytes]) -> int:
    """Proto-encoded size of the Data message holding these txs."""
    return sum(len(t) + compute_proto_size_overhead(len(t)) for t in txs)
