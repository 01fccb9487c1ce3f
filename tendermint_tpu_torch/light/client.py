"""Light client: trusted store + primary/witness providers, sequential and
skipping (bisection) verification, divergence detection
(reference light/client.go:133,613,706; light/detector.go).

Every commit verification inside runs on the batched device verifier via
ValidatorSet.verify_commit_light{,_trusting} — BASELINE config #3's hot
path.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

from ..libs.db import MemDB
from ..types.light_block import LightBlock
from .provider import Provider
from .store import LightStore
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    LightError,
    header_expired,
    validate_trust_level,
    verify_adjacent,
    verify_non_adjacent,
)

logger = logging.getLogger("tmtpu.light")

DEFAULT_MAX_CLOCK_DRIFT_S = 10.0


class DivergenceError(LightError):
    """A witness disagrees with the primary about a verified header — a
    possible light-client attack (light/detector.go)."""

    def __init__(self, witness_id: str, height: int, primary_hash: bytes,
                 witness_hash: bytes):
        super().__init__(
            f"witness {witness_id} diverges at height {height}: "
            f"{witness_hash.hex()[:16]} != primary {primary_hash.hex()[:16]}")
        self.witness_id = witness_id
        self.height = height
        self.primary_hash = primary_hash
        self.witness_hash = witness_hash


@dataclass
class TrustOptions:
    """(light/client.go TrustOptions) the subjective-initialization root."""

    period_s: float
    height: int
    hash: bytes


class LightClient:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: List[Provider],
                 store: Optional[LightStore] = None,
                 trust_level=DEFAULT_TRUST_LEVEL,
                 max_clock_drift_s: float = DEFAULT_MAX_CLOCK_DRIFT_S,
                 skipping: bool = True,
                 scoreboard=None):
        validate_trust_level(trust_level)
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store or LightStore(MemDB())
        self.trust_level = trust_level
        self.max_clock_drift_s = max_clock_drift_s
        self.skipping = skipping
        self._initialized = False
        # untrusted-provider bookkeeping (libs/peerscore.PeerScoreboard):
        # a diverging witness is struck and, once banned, skipped on later
        # cross-checks; an unavailable one backs off. The statesync state
        # provider injects its scoreboard so witness lies land on the same
        # peer_bans_total{reason="divergence"} series chunk lies do.
        if scoreboard is None:
            from ..libs.peerscore import PeerScoreboard

            scoreboard = PeerScoreboard(name="light")
        self.scoreboard = scoreboard

    # -- initialization (light/client.go initializeWithTrustOptions) --------

    async def _initialize(self) -> None:
        if self._initialized:
            return
        if self.store.latest_height() >= self.trust_options.height:
            self._initialized = True
            return
        lb = await self.primary.light_block(self.trust_options.height)
        lb.validate_basic(self.chain_id)
        if lb.signed_header.header.hash() != self.trust_options.hash:
            raise LightError(
                f"expected header hash {self.trust_options.hash.hex()} at trust "
                f"height, got {lb.signed_header.header.hash().hex()}")
        # 2/3 of that header's own validator set must have signed (subjective
        # root is checked as hard as any other header)
        lb.validator_set.verify_commit_light(
            self.chain_id, lb.signed_header.commit.block_id,
            lb.signed_header.header.height, lb.signed_header.commit)
        self.store.save(lb)
        self._initialized = True

    # -- public API ----------------------------------------------------------

    async def verify_light_block_at_height(self, height: int,
                                           now_ns: Optional[int] = None
                                           ) -> LightBlock:
        """(light/client.go:474 VerifyLightBlockAtHeight)"""
        now_ns = now_ns or time.time_ns()
        await self._initialize()
        got = self.store.get(height)
        if got is not None:
            return got
        new_lb = await self.primary.light_block(height)
        new_lb.validate_basic(self.chain_id)
        await self._verify_light_block(new_lb, now_ns)
        self.store.save(new_lb)
        await self._detect_divergence(new_lb, now_ns)
        return new_lb

    async def update(self, now_ns: Optional[int] = None) -> Optional[LightBlock]:
        """Verify the primary's latest header (light/client.go Update)."""
        now_ns = now_ns or time.time_ns()
        await self._initialize()
        latest = await self.primary.light_block(0)
        latest.validate_basic(self.chain_id)
        if latest.signed_header.header.height <= self.store.latest_height():
            return None
        await self._verify_light_block(latest, now_ns)
        self.store.save(latest)
        await self._detect_divergence(latest, now_ns)
        return latest

    # -- verification paths --------------------------------------------------

    async def _verify_light_block(self, new_lb: LightBlock, now_ns: int) -> None:
        latest = self.store.latest()
        if latest is None:
            raise LightError("store empty; initialization failed?")
        target_h = new_lb.signed_header.header.height
        if target_h < self.store.first_height():
            raise LightError(
                f"backwards verification below {self.store.first_height()} "
                "not supported yet")
        # choose the closest trusted block BELOW the target
        base = None
        for h in reversed(self.store.heights()):
            if h <= target_h:
                base = self.store.get(h)
                break
        if base is None:
            raise LightError("no trusted block below the target height")
        if self.skipping:
            await self._verify_skipping(base, new_lb, now_ns)
        else:
            await self._verify_sequential(base, new_lb, now_ns)

    async def _verify_sequential(self, trusted: LightBlock, new_lb: LightBlock,
                                 now_ns: int) -> None:
        """(light/client.go:613 verifySequential) — the whole
        range is fetched, then every commit signature across it rides ONE
        batched device call (verifier.verify_chain_batched)."""
        from .verifier import verify_chain_batched

        chain = []
        for h in range(trusted.signed_header.header.height + 1,
                       new_lb.signed_header.header.height):
            inter = await self.primary.light_block(h)
            inter.validate_basic(self.chain_id)
            chain.append(inter)
        chain.append(new_lb)
        verify_chain_batched(trusted, chain, self.trust_options.period_s,
                             now_ns, self.max_clock_drift_s, self.trust_level)
        for lb in chain[:-1]:
            self.store.save(lb)

    async def _verify_skipping(self, trusted: LightBlock, new_lb: LightBlock,
                               now_ns: int) -> None:
        """(light/client.go:706 verifySkipping) bisection: try to skip
        straight to the target; on ErrNewValSetCantBeTrusted, fetch the
        midpoint, verify it, and retry from there."""
        depth = 0
        pivots = [new_lb]
        while pivots:
            target = pivots[-1]
            try:
                if target.signed_header.header.height == \
                        trusted.signed_header.header.height + 1:
                    verify_adjacent(trusted.signed_header, target.signed_header,
                                    target.validator_set,
                                    self.trust_options.period_s, now_ns,
                                    self.max_clock_drift_s)
                else:
                    verify_non_adjacent(trusted.signed_header,
                                        trusted.validator_set,
                                        target.signed_header,
                                        target.validator_set,
                                        self.trust_options.period_s, now_ns,
                                        self.max_clock_drift_s,
                                        self.trust_level)
            except ErrNewValSetCantBeTrusted:
                depth += 1
                if depth > 60:
                    raise LightError("bisection exceeded max depth")
                mid = (trusted.signed_header.header.height
                       + target.signed_header.header.height) // 2
                if mid == trusted.signed_header.header.height:
                    raise LightError("bisection cannot make progress")
                mid_lb = await self.primary.light_block(mid)
                mid_lb.validate_basic(self.chain_id)
                pivots.append(mid_lb)
                continue
            # verified: this pivot becomes trusted, pop it
            self.store.save(target)
            trusted = target
            pivots.pop()

    # -- divergence detection (light/detector.go) ----------------------------

    async def _detect_divergence(self, verified: LightBlock, now_ns: int) -> None:
        h = verified.signed_header.header.height
        primary_hash = verified.signed_header.header.hash()
        for w in self.witnesses:
            if self.scoreboard.banned(w.id()):
                continue  # a proven liar's opinion is worthless either way
            try:
                wlb = await w.light_block(h)
            except Exception as e:
                # transient unavailability is NOT evidence of lying: skip
                # this round and retry at the next height — only proven
                # divergence (below) strikes the scoreboard, so a flaky
                # witness can never be banned into a zero-witness check
                logger.warning("witness %s unavailable at %d: %s", w.id(), h, e)
                continue
            whash = wlb.signed_header.header.hash()
            if whash == primary_hash:
                self.scoreboard.record_success(w.id())
            else:
                # conflicting header: report to the witness and raise; the
                # caller decides whether to switch primaries
                self.scoreboard.record_failure(w.id(), "divergence",
                                               severe=True)
                try:
                    await w.report_evidence(
                        {"type": "light-client-attack", "height": h,
                         "primary": primary_hash.hex(),
                         "witness": whash.hex()})
                except Exception:
                    pass
                raise DivergenceError(w.id(), h, primary_hash, whash)
