"""Seeded validator sets and signed commits built with the port's own types.

The host signer (crypto/ed25519.py) is pure Python, milliseconds a
signature, so keys and signatures are made in ``spawn`` worker processes.
Every validator's precommit carries its own timestamp with 9-digit nanos,
so all rows of a commit share one sign-bytes template (the columnar path).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..crypto import Ed25519PubKey
from ..crypto import ed25519 as ed
from ..types import (BlockID, BlockIDFlag, PartSetHeader, SignedMsgType,
                     ValidatorSet)
from ..types.block import Commit, CommitSig
from ..types.canonical import vote_sign_bytes
from ..types.validator import new_validator

BASE_TIME_S = 1_760_000_000


def _keygen_chunk(seeds: Sequence[bytes]) -> List[bytes]:
    return [ed.keygen(s)[1] for s in seeds]


def _sign_chunk(jobs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
    return [ed.sign(ed.keygen(seed)[0], msg) for seed, msg in jobs]


class Signer:
    """A pool of spawn workers for keygen and signing; close() (or a
    ``with`` block) stops them."""

    def __init__(self, workers: int = 0):
        self.workers = workers or max(1, min(8, os.cpu_count() or 1))
        self._pool = ProcessPoolExecutor(max_workers=self.workers,
                                         mp_context=get_context("spawn"))

    def _map(self, fn, items):
        size = max(1, -(-len(items) // (self.workers * 4)))
        out = []
        for part in self._pool.map(fn, [items[i:i + size] for i in
                                        range(0, len(items), size)]):
            out.extend(part)
        return out

    def pubkeys(self, seeds: Sequence[bytes]) -> List[bytes]:
        return self._map(_keygen_chunk, list(seeds))

    def sign(self, jobs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
        """jobs: (seed, message) pairs -> signatures."""
        return self._map(_sign_chunk, list(jobs))

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "Signer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def seeds(rng: np.random.Generator, n: int) -> List[bytes]:
    return [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            for _ in range(n)]


def sign_commit(signer: Signer, seed_of: Dict[bytes, bytes],
                valset: ValidatorSet, chain_id: str, height: int,
                block_id: BlockID, timestamps: Sequence[int]) -> Commit:
    """The commit of ``block_id`` at ``height`` in which every member of
    ``valset`` signed its precommit at its own timestamp; ``seed_of`` maps
    a validator address to its key seed."""
    jobs = [(seed_of[v.address],
             vote_sign_bytes(chain_id, SignedMsgType.PRECOMMIT, height, 0,
                             block_id, t))
            for v, t in zip(valset.validators, timestamps)]
    sigs = signer.sign(jobs)
    return Commit(height, 0, block_id,
                  [CommitSig(BlockIDFlag.COMMIT, v.address, t, s)
                   for v, t, s in zip(valset.validators, timestamps, sigs)])


class CommitFixture:
    """A validator set of equal power and a commit in which every validator
    signed the block, built from ``rng``: ``valset``, ``commit``,
    ``block_id``, ``height``, ``chain_id``, ``sigs`` (in validator order)."""

    def __init__(self, signer: Signer, rng: np.random.Generator, n: int,
                 chain_id: str, height: int, power: int = 10):
        key_seeds = seeds(rng, n)
        pubs = signer.pubkeys(key_seeds)
        vs = ValidatorSet([new_validator(Ed25519PubKey(p), power)
                           for p in pubs])
        seed_of = {Ed25519PubKey(p).address(): s
                   for s, p in zip(key_seeds, pubs)}
        self.block_id = BlockID(
            bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
            PartSetHeader(1, bytes(rng.integers(0, 256, 32, dtype=np.uint8))))
        self.timestamps = [BASE_TIME_S * 10**9 + int(x) for x in
                           rng.integers(300_000_000, 999_999_999, n)]
        self.valset, self.chain_id, self.height = vs, chain_id, height
        self.commit = sign_commit(signer, seed_of, vs, chain_id, height,
                                  self.block_id, self.timestamps)
        self.sigs = [cs.signature for cs in self.commit.signatures]

    def with_signatures(self, sigs: Sequence[bytes]) -> Commit:
        return Commit(self.height, 0, self.block_id,
                      [CommitSig(BlockIDFlag.COMMIT, v.address, t, s)
                       for v, t, s in zip(self.valset.validators,
                                          self.timestamps, sigs)])

    def verify(self, commit: Commit = None) -> None:
        self.valset.verify_commit(self.chain_id, self.block_id, self.height,
                                  self.commit if commit is None else commit)

    def verify_light(self) -> None:
        self.valset.verify_commit_light(self.chain_id, self.block_id,
                                        self.height, self.commit)
