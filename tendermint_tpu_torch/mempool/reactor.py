"""Mempool reactor: tx gossip on channel 0x30 (reference mempool/v0/reactor.go:23).

One async broadcast task per peer walks the mempool in insertion order and
skips peers that already sent us the tx (memTx.senders).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List

from ..libs import protowire as pw
from ..p2p import MEMPOOL_CHANNEL
from ..p2p.base import ChannelDescriptor, Peer, Reactor
from .clist_mempool import CListMempool, ErrTxInCache, MempoolError

logger = logging.getLogger("tmtpu.mempool.reactor")


def encode_txs(txs: List[bytes]) -> bytes:
    """mempool Message{Txs} (proto/tendermint/mempool/types.proto)."""
    inner = pw.Writer()
    for tx in txs:
        inner.bytes(1, tx)
    w = pw.Writer()
    w.message(1, inner.finish())
    return w.finish()


def decode_txs(data: bytes) -> List[bytes]:
    out: List[bytes] = []
    for fn, _wt, v in pw.iter_fields(data):
        if fn == 1:
            for ifn, _iwt, iv in pw.iter_fields(v):
                if ifn == 1:
                    out.append(iv)
    return out


class MempoolReactor(Reactor):
    def __init__(self, mempool: CListMempool, broadcast: bool = True,
                 gossip_sleep: float = 0.01):
        super().__init__("MEMPOOL")
        self.mempool = mempool
        self.broadcast_enabled = broadcast
        self._gossip_sleep = gossip_sleep
        self._tasks: Dict[str, asyncio.Task] = {}

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5)]

    async def add_peer(self, peer: Peer) -> None:
        if self.broadcast_enabled:
            self._tasks[peer.id] = asyncio.create_task(
                self._broadcast_tx_routine(peer))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        t = self._tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    async def stop(self) -> None:
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        for tx in decode_txs(msg_bytes):
            try:
                self.mempool.check_tx(tx, sender=peer.id)
            except ErrTxInCache:
                pass
            except MempoolError as e:
                logger.debug("rejected gossiped tx: %s", e)

    async def _broadcast_tx_routine(self, peer: Peer) -> None:
        """(mempool/v0/reactor.go:216 broadcastTxRoutine)

        Tracks sent tx hashes per peer (positional cursors shift when commits
        evict txs); resends are deduped by the remote's tx cache anyway.
        """
        sent: set = set()
        try:
            while peer.is_running():
                entries, _ = self.mempool.entries_after(0)
                live = set()
                sent_any = False
                for mem_tx in entries:
                    live.add(mem_tx.key)
                    if mem_tx.key in sent or peer.id in mem_tx.senders:
                        continue
                    if peer.try_send(MEMPOOL_CHANNEL, encode_txs([mem_tx.tx])):
                        sent.add(mem_tx.key)
                        sent_any = True
                        tl = getattr(self.mempool, "txlife", None)
                        if tl is not None:
                            # first stamp wins: per-peer routines racing
                            # here still record the FIRST outbound gossip
                            tl.mark(mem_tx.key, "first_gossip")
                sent &= live  # forget evicted txs
                await asyncio.sleep(0 if sent_any else self._gossip_sleep)
        except asyncio.CancelledError:
            pass
