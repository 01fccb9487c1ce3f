"""Evidence pool (reference evidence/pool.go:28): persists pending/committed
evidence, buffers consensus-reported conflicting votes until height advances,
prunes expired evidence on update.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from ..libs.db import DB
from ..types import DuplicateVoteEvidence, Evidence
from ..types.evidence import decode_evidence
from ..types.vote import Vote
from .verify import verify_evidence

logger = logging.getLogger("tmtpu.evidence")

_PENDING_PREFIX = b"ev-pending:"
_COMMITTED_PREFIX = b"ev-committed:"


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + ev.height().to_bytes(8, "big") + ev.hash()


class EvidencePool:
    def __init__(self, db: DB, state_store, block_store):
        self._db = db
        self.state_store = state_store
        self.block_store = block_store
        self._mtx = threading.Lock()
        # votes reported by consensus before their height is committed
        # (pool.go:459 consensusBuffer)
        self._consensus_buffer: List[Tuple[Vote, Vote]] = []
        self._pending_bytes = 0
        self.state = None  # set by set_state/update

    def set_state(self, state) -> None:
        self.state = state

    # -- queries -----------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        """(pool.go:80 PendingEvidence)"""
        out: List[Evidence] = []
        size = 0
        for _k, v in self._db.iterate_prefix(_PENDING_PREFIX):
            ev = decode_evidence(v)
            # EvidenceList wire overhead per item
            item_size = len(ev.wrapped()) + 4
            if max_bytes >= 0 and size + item_size > max_bytes:
                break
            out.append(ev)
            size += item_size
        return out, size

    def is_pending(self, ev: Evidence) -> bool:
        return self._db.has(_key(_PENDING_PREFIX, ev))

    def is_committed(self, ev: Evidence) -> bool:
        return self._db.has(_key(_COMMITTED_PREFIX, ev))

    # -- adding ------------------------------------------------------------

    def add_evidence(self, ev: Evidence) -> None:
        """(pool.go:134 AddEvidence)"""
        with self._mtx:
            if self.is_pending(ev) or self.is_committed(ev):
                return
            ev.validate_basic()
            verify_evidence(ev, self.state, self.state_store, self.block_store)
            self._db.set(_key(_PENDING_PREFIX, ev), ev.wrapped())
            logger.info("verified new evidence of byzantine behaviour: %s h=%d",
                        ev.abci_evidence_type(), ev.height())

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """(pool.go:179) — buffered until the next Update."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, evidence: List[Evidence]) -> None:
        """Validate a block's evidence list (pool.go:192 CheckEvidence)."""
        seen = set()
        for ev in evidence:
            if not self.is_pending(ev) and not self.is_committed(ev):
                ev.validate_basic()
                verify_evidence(ev, self.state, self.state_store, self.block_store)
            if self.is_committed(ev):
                raise ValueError(f"evidence was already committed: {ev.hash().hex()}")
            if ev.hash() in seen:
                raise ValueError(f"duplicate evidence in block: {ev.hash().hex()}")
            seen.add(ev.hash())

    # -- update on commit ---------------------------------------------------

    def update(self, state, evidence: List[Evidence]) -> None:
        """Mark committed, flush consensus buffer, prune expired (pool.go:105)."""
        with self._mtx:
            self.state = state
            # mark committed + remove from pending
            sets, deletes = [], []
            for ev in evidence:
                sets.append((_key(_COMMITTED_PREFIX, ev),
                             ev.height().to_bytes(8, "big")))
                deletes.append(_key(_PENDING_PREFIX, ev))
            if sets or deletes:
                self._db.write_batch(sets, deletes)
            # flush buffered conflicting votes into real evidence
            buffered, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buffered:
            self._process_conflicting_votes(vote_a, vote_b)
        self._prune_expired()

    def _process_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        val_set = self.state_store.load_validators(vote_a.height)
        if val_set is None:
            logger.error("no validator set at height %d for conflicting votes",
                         vote_a.height)
            return
        block_meta = self.block_store.load_block_meta(vote_a.height)
        if block_meta is None:
            logger.error("no block meta at height %d for conflicting votes",
                         vote_a.height)
            return
        ev = DuplicateVoteEvidence.new(vote_a, vote_b, block_meta.header.time_ns,
                                       val_set)
        if ev is None:
            return
        try:
            self.add_evidence(ev)
        except ValueError as e:
            logger.error("failed to add duplicate-vote evidence: %s", e)

    def _prune_expired(self) -> None:
        """(pool.go:450 removeExpiredPendingEvidence)"""
        if self.state is None:
            return
        params = self.state.consensus_params.evidence
        height = self.state.last_block_height
        now = self.state.last_block_time_ns
        deletes = []
        for k, v in self._db.iterate_prefix(_PENDING_PREFIX):
            ev = decode_evidence(v)
            expired_blocks = ev.height() + params.max_age_num_blocks < height
            expired_time = ev.time_ns() + params.max_age_duration_ns < now
            if expired_blocks and expired_time:
                deletes.append(k)
        if deletes:
            self._db.write_batch([], deletes)

    def abci_evidence(self, evidence: List[Evidence]):
        from ..state.execution import ev_to_abci

        return [ev_to_abci(ev) for ev in evidence]
