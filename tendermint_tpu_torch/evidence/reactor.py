"""Evidence reactor: gossips pending evidence on channel 0x38
(reference evidence/reactor.go:16,30).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List

from ..libs import protowire as pw
from ..p2p import EVIDENCE_CHANNEL
from ..p2p.base import ChannelDescriptor, Peer, Reactor
from ..types.evidence import decode_evidence
from .pool import EvidencePool

logger = logging.getLogger("tmtpu.evidence.reactor")


def encode_evidence_list_msg(evs) -> bytes:
    """evidence.proto List message: repeated Evidence (oneof-wrapped)."""
    w = pw.Writer()
    for ev in evs:
        w.message(1, ev.wrapped())
    return w.finish()


def decode_evidence_list_msg(data: bytes):
    return [decode_evidence(v) for fn, _wt, v in pw.iter_fields(data) if fn == 1]


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool, gossip_sleep: float = 0.1):
        super().__init__("EVIDENCE")
        self.pool = pool
        self._gossip_sleep = gossip_sleep
        self._tasks: Dict[str, asyncio.Task] = {}

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6)]

    async def add_peer(self, peer: Peer) -> None:
        self._tasks[peer.id] = asyncio.create_task(self._broadcast_routine(peer))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        t = self._tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    async def stop(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        from .verify import ErrNoEvidenceData

        for ev in decode_evidence_list_msg(msg_bytes):
            try:
                self.pool.add_evidence(ev)
            except ErrNoEvidenceData as e:
                # we're behind or pruned: can't judge — don't punish the peer
                # (reference evidence/reactor.go only bans on ErrInvalidEvidence)
                logger.debug("cannot verify evidence from %s yet: %s", peer.id[:8], e)
            except ValueError as e:
                logger.info("invalid evidence from %s: %s", peer.id[:8], e)
                await self.switch.stop_peer_for_error(peer, str(e))
                return

    async def _broadcast_routine(self, peer: Peer) -> None:
        """(evidence/reactor.go:30 broadcastEvidenceRoutine)"""
        sent: set = set()
        try:
            while peer.is_running():
                pending, _ = self.pool.pending_evidence(-1)
                live = set()
                for ev in pending:
                    h = ev.hash()
                    live.add(h)
                    if h in sent:
                        continue
                    if peer.try_send(EVIDENCE_CHANNEL, encode_evidence_list_msg([ev])):
                        sent.add(h)
                sent &= live
                await asyncio.sleep(self._gossip_sleep)
        except asyncio.CancelledError:
            pass
