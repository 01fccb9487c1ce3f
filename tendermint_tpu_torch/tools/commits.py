"""Seeded validator sets and signed commits built with the port's own types.

The host signers (crypto/ed25519.py, crypto/bls12381) are pure Python,
milliseconds a signature (BLS: ~20 ms a key, ~8 ms a signature), so keys
and signatures are made in ``spawn`` worker processes. Every validator's
Ed25519 precommit carries its own timestamp with 9-digit nanos, so all
rows of a commit share one sign-bytes template (the columnar path). A BLS
aggregated commit is shaped like the JAX package's bench
(``bench.py::_mk_bls_aggregated_commit``): every validator signs the same
zero-timestamp precommit payload, power 10, and the signatures fold into
one 48-byte aggregate.

``light_chain`` and ``bls_light_chain`` build header chains of
LightBlocks for the light client (each header's time is the chain's start
plus its height in seconds, like tests/test_light_client.py's builder),
signed by seeded Ed25519 sets or aggregated by a BLS fixture's set.

``duplicate_vote_evidence``, ``light_client_attack`` and ``signed_txs``
build evidence of both kinds and ``stx1`` signed-tx envelopes
(mempool/ingest.py) from seeded keys. ``Signer.verify`` runs the host
spec over (pubkey, message, signature) rows in the pool, and
``Signer.run`` any picklable function over items, one task each.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..crypto import Bls12381PubKey, Ed25519PubKey
from ..crypto import bls12381 as bls
from ..crypto import ed25519 as ed
from ..crypto import schemes
from ..libs.bits import BitArray
from ..mempool.ingest import signed_tx_head
from ..types import (BlockID, BlockIDFlag, PartSetHeader, SignedMsgType,
                     ValidatorSet)
from ..types.block import AggregatedCommit, Commit, CommitSig, Header
from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.light_block import LightBlock, SignedHeader
from ..types.params import SignatureParams
from ..types.canonical import vote_sign_bytes
from ..types.validator import new_validator
from ..types.vote import Vote

BASE_TIME_S = 1_760_000_000


def _keygen_chunk(seeds: Sequence[bytes]) -> List[bytes]:
    return [ed.keygen(s)[1] for s in seeds]


def _sign_chunk(jobs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
    # a key derivation costs a scalar multiplication, as a signature does:
    # derive each seed's key once per chunk (jobs that share a seed and sit
    # next to each other sign at half the cost); a 64-byte key (seed ||
    # public key) needs no derivation at all
    keys: Dict[bytes, bytes] = {}
    out = []
    for seed, msg in jobs:
        priv = seed if len(seed) == ed.PRIVKEY_SIZE else keys.get(seed)
        if priv is None:
            priv = keys[seed] = ed.keygen(seed)[0]
        out.append(ed.sign(priv, msg))
    return out


def _verify_chunk(rows: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    return [Ed25519PubKey(pk).verify_signature(msg, sig)
            for pk, msg, sig in rows]


def _bls_keygen_chunk(seeds: Sequence[bytes]) -> List[Tuple[bytes, bytes]]:
    """(pubkey, proof of possession) of each BLS key seed."""
    out = []
    for seed in seeds:
        sk = bls.sk_from_seed(seed)
        out.append((bls.sk_to_pk(sk), bls.pop_prove(sk)))
    return out


def _bls_aggregate_chunk(jobs: Sequence[Tuple[bytes, bytes]]) -> List[bytes]:
    """The aggregate of the BLS signatures of (seed, message) jobs."""
    return [bls.aggregate([bls.sign(bls.sk_from_seed(seed), msg)
                           for seed, msg in jobs])]


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
        """jobs: (key, message) pairs -> signatures; a key is a 32-byte
        seed or the 64-byte private key (seed || public key)."""
        return self._map(_sign_chunk, list(jobs))

    def verify(self, rows: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        """(pubkey, message, signature) rows -> the host spec's verdicts
        (``Ed25519PubKey.verify_signature``)."""
        return self._map(_verify_chunk, list(rows))

    def run(self, fn, items: Sequence) -> list:
        """``fn`` (a picklable module-level function) over ``items``, one
        pool task each, results in order."""
        return list(self._pool.map(fn, items))

    def bls_keys(self, seeds: Sequence[bytes]) -> List[Tuple[bytes, bytes]]:
        """BLS key seeds -> (pubkey, proof of possession) pairs."""
        return self._map(_bls_keygen_chunk, list(seeds))

    def bls_aggregate(self, jobs: Sequence[Tuple[bytes, bytes]]) -> bytes:
        """jobs: (BLS key seed, message) pairs -> the aggregate of their
        signatures (each worker folds its share, the host folds those)."""
        return bls.aggregate(self._map(_bls_aggregate_chunk, list(jobs)))

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
    a validator address to its key seed or its 64-byte private key (which
    signs at half the cost: nothing is derived)."""
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
    ``block_id``, ``height``, ``chain_id``, ``sigs`` (in validator order)
    and ``seed_of`` (address -> key seed)."""

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
        self.seed_of = seed_of
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


class BlsCommitFixture:
    """A bls12381 validator set of equal power on a chain registered for
    aggregated commits, and the aggregated commit in which every validator
    signed the block, built from ``rng``: ``valset``, ``commit``,
    ``block_id``, ``height``, ``chain_id``, ``seed_of`` (address -> key
    seed) and ``pops`` (in validator order)."""

    TIMESTAMP_NS = BASE_TIME_S * 10**9

    def __init__(self, signer: Signer, rng: np.random.Generator, n: int,
                 chain_id: str, height: int, power: int = 10):
        schemes.register_chain(chain_id, SignatureParams("bls12381", True))
        key_seeds = seeds(rng, n)
        keys = signer.bls_keys(key_seeds)
        vs = ValidatorSet([new_validator(Bls12381PubKey(pk), power)
                           for pk, _ in keys])
        self.seed_of = {Bls12381PubKey(pk).address(): s
                        for s, (pk, _) in zip(key_seeds, keys)}
        pop_of = {pk: pop for pk, pop in keys}
        self.pops = [pop_of[v.pub_key.bytes()] for v in vs.validators]
        self.block_id = BlockID(
            bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
            PartSetHeader(1, bytes(rng.integers(0, 256, 32, dtype=np.uint8))))
        self.signer = signer
        self.valset, self.chain_id, self.height = vs, chain_id, height
        self.commit = self.make_commit(range(n))

    def message(self, height: int = None) -> bytes:
        """The zero-timestamp precommit payload every signer signs."""
        return vote_sign_bytes(self.chain_id, SignedMsgType.PRECOMMIT,
                               self.height if height is None else height, 0,
                               self.block_id, schemes.AGG_ZERO_TS_NS)

    def make_commit(self, signer_idxs, msg: bytes = None, height: int = None,
                    block_id: BlockID = None) -> AggregatedCommit:
        """The commit whose bitmap holds ``signer_idxs`` and whose aggregate
        folds their signatures over ``msg`` (the block's payload unless
        given), for ``block_id`` at ``height`` (the fixture's unless
        given)."""
        idxs = sorted(signer_idxs)
        height = self.height if height is None else height
        block_id = self.block_id if block_id is None else block_id
        if msg is None:
            msg = vote_sign_bytes(self.chain_id, SignedMsgType.PRECOMMIT,
                                  height, 0, block_id, schemes.AGG_ZERO_TS_NS)
        vals = self.valset.validators
        agg = self.signer.bls_aggregate([(self.seed_of[vals[i].address], msg)
                                         for i in idxs])
        bits = BitArray(self.valset.size())
        for i in idxs:
            bits.set_index(i, True)
        return AggregatedCommit(height, 0, block_id, [],
                                signers=bits, agg_sig=agg,
                                timestamp_ns=self.TIMESTAMP_NS)

    def verify(self, commit: AggregatedCommit = None) -> None:
        self.valset.verify_commit(self.chain_id, self.block_id, self.height,
                                  self.commit if commit is None else commit)

    def verify_light(self) -> None:
        self.valset.verify_commit_light(self.chain_id, self.block_id,
                                        self.height, self.commit)

    def verify_light_trusting(self, trust_level=(1, 3)) -> None:
        self.valset.verify_commit_light_trusting(
            self.chain_id, self.commit, trust_level, commit_vals=self.valset)


# -- header chains for the light client --------------------------------------

#: a validator set of a height and its signers' seeds (address -> seed)
KeySet = Tuple[ValidatorSet, Dict[bytes, bytes]]


def light_header(chain_id: str, height: int, time_ns: int,
                 last_block_id: BlockID, vals: ValidatorSet,
                 next_vals: ValidatorSet,
                 app_hash: bytes = b"\x04" * 32) -> Header:
    """A header at ``height`` whose set is ``vals`` and whose next set is
    ``next_vals`` (constant hashes elsewhere, as tests/test_light_client.py
    builds them)."""
    return Header(
        chain_id=chain_id, height=height, time_ns=time_ns,
        last_block_id=last_block_id,
        last_commit_hash=b"\x01" * 32, data_hash=b"\x02" * 32,
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=b"\x03" * 32, app_hash=app_hash,
        last_results_hash=b"\x05" * 32, evidence_hash=b"\x06" * 32,
        proposer_address=vals.validators[0].address)


def _block_id(header: Header) -> BlockID:
    return BlockID(header.hash(), PartSetHeader(1, b"\x07" * 32))


def light_chain(signer: Signer, chain_id: str, sets: Callable[[int], KeySet],
                heights: Sequence[int], t0_ns: int,
                base: Optional[Dict[int, LightBlock]] = None,
                app_hash: bytes = b"\x04" * 32) -> Dict[int, LightBlock]:
    """LightBlocks at the consecutive ``heights``, continuing ``base`` (the
    blocks below them, which it also returns). Height h's header is at
    ``t0_ns`` + h seconds, its set ``sets(h)``, its next set
    ``sets(h + 1)``; every validator signs its precommit at the header's
    time + 0.1 s + i us (9-digit nanos: one sign-bytes template a commit).
    All signatures are made in one pass of the pool."""
    blocks = dict(base or {})
    prev = blocks.get(heights[0] - 1)
    last = prev.signed_header.commit.block_id if prev else BlockID()
    heads = []
    for h in heights:
        vals, next_vals = sets(h)[0], sets(h + 1)[0]
        hdr = light_header(chain_id, h, t0_ns + h * 10**9, last, vals,
                           next_vals, app_hash)
        last = _block_id(hdr)
        stamps = [hdr.time_ns + 100_000_000 + 1_000 * i
                  for i in range(vals.size())]
        heads.append((hdr, last, stamps))
    # validator-major order: a worker's chunk holds one key's signatures
    # over many heights (see _sign_chunk)
    jobs, where = [], []
    n_max = max(sets(h)[0].size() for h in heights)
    for i in range(n_max):
        for k, h in enumerate(heights):
            vals, seed_of = sets(h)
            if i < vals.size():
                hdr, bid, stamps = heads[k]
                jobs.append((seed_of[vals.validators[i].address],
                             vote_sign_bytes(chain_id, SignedMsgType.PRECOMMIT,
                                             h, 0, bid, stamps[i])))
                where.append((k, i))
    sigs = [[None] * sets(h)[0].size() for h in heights]
    for (k, i), sig in zip(where, signer.sign(jobs)):
        sigs[k][i] = sig
    for k, h in enumerate(heights):
        vals = sets(h)[0]
        hdr, bid, stamps = heads[k]
        commit = Commit(h, 0, bid, [
            CommitSig(BlockIDFlag.COMMIT, v.address, t, sg)
            for v, t, sg in zip(vals.validators, stamps, sigs[k])])
        blocks[h] = LightBlock(SignedHeader(hdr, commit), vals)
    return blocks


def bls_light_chain(fixture: "BlsCommitFixture", heights: Sequence[int],
                    t0_ns: int) -> Dict[int, LightBlock]:
    """LightBlocks at the consecutive ``heights`` of ``fixture``'s chain,
    whose set never changes: each commit is the aggregate of every
    validator's signature over the zero-timestamp precommit payload."""
    blocks, last = {}, BlockID()
    vs = fixture.valset
    for h in heights:
        hdr = light_header(fixture.chain_id, h, t0_ns + h * 10**9, last, vs,
                           vs)
        last = _block_id(hdr)
        commit = fixture.make_commit(range(vs.size()), height=h,
                                     block_id=last)
        blocks[h] = LightBlock(SignedHeader(hdr, commit), vs)
    return blocks


# -- evidence and signed txs --------------------------------------------------

def duplicate_vote_evidence(signer: Signer, seed_of: Dict[bytes, bytes],
                            valset: ValidatorSet, chain_id: str,
                            items: Sequence[Tuple[int, int, int]],
                            rng: np.random.Generator
                            ) -> List[DuplicateVoteEvidence]:
    """One DuplicateVoteEvidence per ``(height, validator index, block time
    ns)`` item: the validator's two round-0 precommits at that height for
    two random block IDs, each stamped a second after the block time,
    signed in one pass of the pool; the evidence carries the block's time
    and orders its votes by block ID."""
    pairs, jobs = [], []
    for height, idx, block_ns in items:
        val = valset.validators[idx]
        pair = []
        for _ in range(2):
            bid = BlockID(bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                          PartSetHeader(1, bytes(rng.integers(
                              0, 256, 32, dtype=np.uint8))))
            v = Vote(SignedMsgType.PRECOMMIT, height, 0, bid,
                     block_ns + 10**9, val.address, idx)
            pair.append(v)
            jobs.append((seed_of[val.address], v.sign_bytes(chain_id)))
        pairs.append(pair)
    sigs = iter(signer.sign(jobs))
    out = []
    for (height, _idx, block_ns), (va, vb) in zip(items, pairs):
        va.signature, vb.signature = next(sigs), next(sigs)
        out.append(DuplicateVoteEvidence.new(va, vb, block_ns, valset))
    return out


def light_client_attack(signer: Signer, chain_id: str, keyset: KeySet,
                        height: int, common_height: int, t0_ns: int,
                        total_power: int, timestamp_ns: int,
                        app_hash: bytes) -> LightClientAttackEvidence:
    """Evidence of a light-client attack: a conflicting LightBlock at
    ``height`` (a ``light_chain`` header with ``app_hash``, signed by every
    member of ``keyset``) against the chain's common height. A common
    height below ``height`` is a lunatic attack; equal to it, an
    equivocation (the header must then hash to its commit's block ID, as
    ``light_chain`` makes it). No byzantine validators are listed."""
    cb = light_chain(signer, chain_id, lambda h: keyset, [height], t0_ns,
                     app_hash=app_hash)[height]
    return LightClientAttackEvidence(cb, common_height, [], total_power,
                                     timestamp_ns)


def signed_txs(signer: Signer, seeds_: Sequence[bytes],
               pubs: Sequence[bytes],
               specs: Sequence[Tuple[int, bytes, int, int]]) -> List[bytes]:
    """``stx1`` envelopes (mempool/ingest.py ``signed_tx_head`` plus the
    signature) for ``(sender index, payload, nonce, fee)`` specs, the sender
    being ``seeds_[i]`` / ``pubs[i]``; signed in one pass of the pool,
    sender-major so a worker derives each key once per chunk."""
    heads = [signed_tx_head(pubs[i], payload, nonce, fee)
             for i, payload, nonce, fee in specs]
    order = sorted(range(len(specs)), key=lambda k: specs[k][0])
    sigs = signer.sign([(seeds_[specs[k][0]], heads[k]) for k in order])
    out = [b""] * len(specs)
    for k, sig in zip(order, sigs):
        out[k] = heads[k] + sig
    return out
