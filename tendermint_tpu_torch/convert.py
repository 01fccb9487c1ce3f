"""Carries state across from the JAX package.

Takes only bytes and numpy arrays — never objects or modules of
``tendermint_tpu`` — so the port stays importable where that package
cannot be:

* :func:`validator_set_from_reference` / :func:`commit_from_reference` /
  :func:`signed_header_from_reference` / :func:`light_block_from_reference`
  decode the JAX package's ``ValidatorSet.encode()`` / ``Commit.encode()``
  / ``SignedHeader.encode()`` / ``LightBlock.encode()`` bytes (the same
  proto wire format) into the port's types;
* :func:`block_from_reference` decodes a ``Block.encode()`` (the blocks
  a fast-sync replay carries);
* :func:`vote_from_reference`, :func:`proposal_from_reference` and
  :func:`part_from_reference` decode a ``Vote`` / ``Proposal`` / block
  ``Part`` ``encode()`` (what the consensus WAL and wire carry);
* :func:`evidence_from_reference` decodes an evidence item's
  ``wrapped()`` bytes (the Evidence oneof envelope) into the port's
  ``DuplicateVoteEvidence`` or ``LightClientAttackEvidence``;
* :func:`base_table_from_reference` converts the JAX fixed-base table
  (``curve._build_base_table``: (64, 16, 3, 17) u32, 17 limbs of 15 bits)
  into the port's (64, 16, 3, 10) layout of 26/25-bit limbs.
"""

from __future__ import annotations

import numpy as np

from .crypto.ed25519_cuda import field as F
from .types.block import Block, Commit
from .types.evidence import Evidence, decode_evidence
from .types.light_block import LightBlock, SignedHeader
from .types.part_set import Part
from .types.proposal import Proposal
from .types.validator_set import ValidatorSet
from .types.vote import Vote

_REF_NLIMBS = 17
_REF_RADIX = 15


def validator_set_from_reference(encoded: bytes) -> ValidatorSet:
    return ValidatorSet.decode(encoded)


def commit_from_reference(encoded: bytes) -> Commit:
    return Commit.decode(encoded)


def signed_header_from_reference(encoded: bytes) -> SignedHeader:
    return SignedHeader.decode(encoded)


def block_from_reference(encoded: bytes) -> Block:
    return Block.decode(encoded)


def light_block_from_reference(encoded: bytes) -> LightBlock:
    return LightBlock.decode(encoded)


def vote_from_reference(encoded: bytes) -> Vote:
    return Vote.decode(encoded)


def proposal_from_reference(encoded: bytes) -> Proposal:
    return Proposal.decode(encoded)


def part_from_reference(encoded: bytes) -> Part:
    return Part.decode(encoded)


def evidence_from_reference(encoded: bytes) -> Evidence:
    return decode_evidence(encoded)


def base_table_from_reference(table: np.ndarray) -> np.ndarray:
    """(64, 16, 3, 17) 15-bit limbs -> (64, 16, 3, 10) uint32 port limbs
    of the same field elements (reduced mod p)."""
    table = np.asarray(table)
    if table.shape != (64, 16, 3, _REF_NLIMBS):
        raise ValueError(f"expected a (64, 16, 3, {_REF_NLIMBS}) table, "
                         f"got {table.shape}")
    flat = table.reshape(-1, _REF_NLIMBS).astype(np.uint64)
    out = np.zeros((flat.shape[0], F.NLIMBS), dtype=np.uint32)
    for row in range(flat.shape[0]):
        x = sum(int(flat[row, i]) << (_REF_RADIX * i)
                for i in range(_REF_NLIMBS)) % F.P_INT
        out[row] = F.int_to_limbs(x)
    return out.reshape(64, 16, 3, F.NLIMBS)
