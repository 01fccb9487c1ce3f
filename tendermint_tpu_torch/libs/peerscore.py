"""Untrusted-peer scoring for the sync planes — ban-after-K with
exponential backoff.

A bootstrapping node talks to peers it has no reason to trust: a snapshot
advertiser can lie about hashes, a chunk server can return garbage, a
block server can tamper a commit, a light-client witness can diverge from
the primary ("Practical Light Clients for Committee-Based Blockchains",
arXiv 2410.03347, assumes exactly this adversary). The p2p trust store
(p2p/trust.py) guards the CONNECTION layer; this scoreboard guards the
SYNC layer — which peer do I ask for the next chunk/block/header — where
the caller wants graded responses, not just connect/refuse:

* a failure puts the peer in exponential backoff (base doubling per
  consecutive failure, seeded jitter so herds of retries don't align);
* ``ban_threshold`` consecutive failures ban it outright;
* a success clears the consecutive count (honest-but-slow peers recover).

In the port it serves ``light/client.py`` (diverging witnesses) and
``light/serve.py`` (abusive clients); the statesync and blocksync planes
that share it in the reference package are not ported yet. Metrics are
injected counters (``peer_bans_total{reason}``, ``sync_retries_total``)
so each plane's series land on its own subsystem.

Determinism: jitter draws come from one ``random.Random`` seeded by
(seed, name), and ``eligible()`` order is the caller-supplied order (use
sorted peer ids) — a chaos run with a fixed ``TMTPU_FAULTS_SEED`` replays
its ban/backoff schedule exactly.
"""

from __future__ import annotations

import random
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional


class _PeerScore:
    __slots__ = ("consecutive_failures", "total_failures", "successes",
                 "banned", "ban_reason", "next_eligible_ts")

    def __init__(self):
        self.consecutive_failures = 0
        self.total_failures = 0
        self.successes = 0
        self.banned = False
        self.ban_reason = ""
        self.next_eligible_ts = 0.0


class PeerScoreboard:
    """Per-peer failure bookkeeping with backoff + ban-after-K."""

    def __init__(self, ban_threshold: int = 3, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0, jitter: float = 0.25,
                 seed: int = 0, name: str = "sync",
                 bans_counter=None, retries_counter=None,
                 clock: Callable[[], float] = time.monotonic):
        if ban_threshold < 1:
            raise ValueError("ban_threshold must be >= 1")
        self.ban_threshold = ban_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.name = name
        self.bans_counter = bans_counter        # Counter with ["reason"]
        self.retries_counter = retries_counter  # plain Counter
        self._clock = clock
        self._rng = random.Random(zlib.crc32(f"{seed}|{name}|score".encode()))
        self._peers: Dict[str, _PeerScore] = {}

    # -- event recording -----------------------------------------------------

    def record_failure(self, peer_id: str, reason: str = "error",
                       severe: bool = False) -> bool:
        """One bad response from `peer_id`; returns True when the peer is
        now (or already was) banned. Backoff doubles per consecutive
        failure, with seeded jitter on top.

        ``severe=True`` is for PROVEN lies — an app-verified corrupted
        chunk, a snapshot failing its trusted hash, a diverging witness —
        and bans immediately: cryptographic evidence doesn't need K
        repetitions, while circumstantial failures (timeouts,
        unavailability) accumulate toward ban_threshold."""
        s = self._peers.setdefault(peer_id, _PeerScore())
        if s.banned:
            return True
        s.consecutive_failures += self.ban_threshold if severe else 1
        s.total_failures += 1
        backoff = min(self.backoff_base_s * 2 ** (s.consecutive_failures - 1),
                      self.backoff_max_s)
        backoff *= 1.0 + self.jitter * self._rng.random()
        s.next_eligible_ts = self._clock() + backoff
        if s.consecutive_failures >= self.ban_threshold:
            s.banned = True
            s.ban_reason = reason
            if self.bans_counter is not None:
                self.bans_counter.labels(reason).inc()
        return s.banned

    def record_success(self, peer_id: str) -> None:
        s = self._peers.setdefault(peer_id, _PeerScore())
        s.successes += 1
        if not s.banned:
            s.consecutive_failures = 0
            s.next_eligible_ts = 0.0

    def note_retry(self) -> None:
        """Count one retried fetch (chunk refetch, block redo, snapshot
        re-discovery round) on the injected sync_retries_total counter."""
        if self.retries_counter is not None:
            self.retries_counter.inc()

    # -- queries -------------------------------------------------------------

    def banned(self, peer_id: str) -> bool:
        s = self._peers.get(peer_id)
        return s is not None and s.banned

    def in_backoff(self, peer_id: str) -> bool:
        s = self._peers.get(peer_id)
        return (s is not None and not s.banned
                and self._clock() < s.next_eligible_ts)

    def eligible(self, peer_ids: Iterable[str],
                 allow_backoff: bool = False) -> List[str]:
        """Filter to peers we may ask right now, preserving caller order.
        ``allow_backoff=True`` re-admits backing-off (not banned) peers —
        the last-resort pool when every eligible peer is exhausted."""
        now = self._clock()
        out = []
        for pid in peer_ids:
            s = self._peers.get(pid)
            if s is None:
                out.append(pid)
                continue
            if s.banned:
                continue
            if not allow_backoff and now < s.next_eligible_ts:
                continue
            out.append(pid)
        return out

    def ban_count(self) -> int:
        return sum(1 for s in self._peers.values() if s.banned)

    # -- maintenance / introspection -----------------------------------------

    def forget(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)

    def reset(self) -> None:
        self._peers.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-safe per-peer view for debugdump bundles."""
        now = self._clock()
        return {
            pid: {
                "consecutive_failures": s.consecutive_failures,
                "total_failures": s.total_failures,
                "successes": s.successes,
                "banned": s.banned,
                "ban_reason": s.ban_reason,
                "backoff_remaining_s": round(
                    max(0.0, s.next_eligible_ts - now), 3),
            }
            for pid, s in self._peers.items()
        }
