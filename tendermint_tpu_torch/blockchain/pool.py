"""BlockPool: schedules block downloads from peers during fast sync
(reference blockchain/v0/pool.go:63 BlockPool, :193 per-height bpRequester).

Redesigned for asyncio: instead of one goroutine per height, a single
scheduler pass (driven by the reactor's pool routine) keeps up to
``max_pending`` outstanding height requests assigned across known peers,
re-assigning on timeout or peer failure. Downloaded blocks accumulate until
the reactor pops contiguous runs for windowed (batched) commit verification.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..types.block import Block

logger = logging.getLogger("tmtpu.blockchain")

# Reference pool.go consts (requestIntervalMS, maxTotalRequesters=600,
# maxPendingRequestsPerPeer=20); sized down for asyncio polling granularity.
MAX_PENDING = 64
MAX_PENDING_PER_PEER = 16
REQUEST_TIMEOUT = 15.0  # seconds before a pending request is re-assigned
MIN_RECV_RATE = 0  # rate-based peer ban not enforced in-proc


@dataclass
class _PeerInfo:
    base: int = 0
    height: int = 0
    pending: int = 0
    timeouts: int = 0


@dataclass
class _Request:
    height: int
    peer_id: str
    sent_at: float
    block: Optional[Block] = None


class BlockPool:
    def __init__(self, start_height: int):
        self.height = start_height  # next height to pop
        self._peers: Dict[str, _PeerInfo] = {}
        self._requests: Dict[int, _Request] = {}
        self._max_peer_height = 0
        self._started_at = time.monotonic()

    # -- peer bookkeeping (pool.go:290 SetPeerRange) ------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        info = self._peers.setdefault(peer_id, _PeerInfo())
        info.base, info.height = base, height
        self._max_peer_height = max(self._max_peer_height, height)

    def remove_peer(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)
        for h, req in list(self._requests.items()):
            if req.peer_id == peer_id and req.block is None:
                del self._requests[h]

    def max_peer_height(self) -> int:
        return self._max_peer_height

    def is_caught_up(self) -> bool:
        """(pool.go:168 IsCaughtUp)"""
        if not self._peers:
            return False
        # reference: caught up when within 1 of the best peer
        # (pool.go IsCaughtUp: height >= maxPeerHeight - 1)
        return self.height >= max(1, self._max_peer_height - 1)

    # -- scheduling ---------------------------------------------------------

    def schedule_requests(self) -> List[Tuple[str, int]]:
        """One scheduler pass; -> [(peer_id, height)] requests to send now.

        Covers [self.height, ..) up to MAX_PENDING outstanding, re-assigning
        requests that timed out. Peers are chosen randomly among those whose
        advertised range covers the height and that have pending capacity.
        """
        now = time.monotonic()
        to_send: List[Tuple[str, int]] = []

        # re-assign timed-out requests
        for h, req in list(self._requests.items()):
            if req.block is None and now - req.sent_at > REQUEST_TIMEOUT:
                info = self._peers.get(req.peer_id)
                if info is not None:
                    info.pending -= 1
                    info.timeouts += 1
                del self._requests[h]

        horizon = self.height + MAX_PENDING
        if self._max_peer_height:
            horizon = min(horizon, self._max_peer_height + 1)
        for h in range(self.height, horizon):
            if h in self._requests:
                continue
            peer_id = self._pick_peer(h)
            if peer_id is None:
                continue
            self._requests[h] = _Request(h, peer_id, now)
            self._peers[peer_id].pending += 1
            to_send.append((peer_id, h))
        return to_send

    def _pick_peer(self, height: int) -> Optional[str]:
        candidates = [
            pid for pid, info in self._peers.items()
            if info.base <= height <= info.height
            and info.pending < MAX_PENDING_PER_PEER
        ]
        return random.choice(candidates) if candidates else None

    # -- block arrival (pool.go AddBlock) -----------------------------------

    def add_block(self, peer_id: str, block: Block) -> str:
        """Accept a block matching an outstanding request from peer_id.

        Returns "added", "stale" (a legitimate-but-late response: the height
        was processed already or the request timed out and was reassigned —
        NOT a peer fault), or "unsolicited" (we never asked this peer for
        anything near this height — a spam/bandwidth fault, reference
        reactor stops the peer).
        """
        h = block.header.height
        req = self._requests.get(h)
        if req is None or req.peer_id != peer_id or req.block is not None:
            # reference pool.go AddBlock: only a height far (>100) from the
            # pool's cursor is a peer fault; anything near it is a late
            # response to a request we timed out/deleted/reassigned
            if abs(h - self.height) > 100:
                return "unsolicited"
            return "stale"
        req.block = block
        info = self._peers.get(peer_id)
        if info is not None:
            info.pending -= 1
        return "added"

    def no_block(self, peer_id: str, height: int) -> None:
        req = self._requests.get(height)
        if req is not None and req.peer_id == peer_id and req.block is None:
            info = self._peers.get(peer_id)
            if info is not None:
                info.pending -= 1
            del self._requests[height]

    # -- consumption --------------------------------------------------------

    def peek_window(self, max_blocks: int) -> List[Tuple[Block, str]]:
        """Contiguous (block, provider peer) run starting at self.height."""
        return self.peek_from(self.height, max_blocks)

    def peek_from(self, start_height: int, max_blocks: int) -> List[Tuple[Block, str]]:
        """Contiguous (block, provider peer) run starting at an arbitrary
        height ≥ self.height — the apply pipeline peeks the NEXT window's
        blocks while the current one is still applying."""
        out: List[Tuple[Block, str]] = []
        h = start_height
        while len(out) < max_blocks:
            req = self._requests.get(h)
            if req is None or req.block is None:
                break
            out.append((req.block, req.peer_id))
            h += 1
        return out

    def pop(self) -> None:
        """(pool.go PopRequest) advance past self.height."""
        self._requests.pop(self.height, None)
        self.height += 1

    def redo(self, height: int) -> Set[str]:
        """(pool.go RedoRequest) drop all blocks from the peers that served
        [height..] and re-request; -> peer ids to punish."""
        bad: Set[str] = set()
        for h, req in list(self._requests.items()):
            if h >= height and req.block is not None:
                bad.add(req.peer_id)
        for h, req in list(self._requests.items()):
            if req.peer_id in bad:
                if req.block is None:
                    info = self._peers.get(req.peer_id)
                    if info is not None:
                        info.pending -= 1
                del self._requests[h]
        for pid in bad:
            self._peers.pop(pid, None)
        return bad
