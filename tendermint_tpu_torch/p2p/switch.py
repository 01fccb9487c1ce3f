"""Switch: reactor registry + peer lifecycle (reference p2p/switch.go:69)."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from .base import ChannelDescriptor, Peer, Reactor

logger = logging.getLogger("tmtpu.p2p")


class Switch:
    def __init__(self, node_id: str, transport=None, trust_store=None):
        self.node_id = node_id
        self.transport = transport  # TCPTransport or None (in-proc)
        self.reactors: Dict[str, Reactor] = {}
        self._reactors_by_ch: Dict[int, Reactor] = {}
        self.peers: Dict[str, Peer] = {}
        self._running = False
        self._dial_tasks: Dict[str, asyncio.Task] = {}  # persistent redials
        # optional p2p.trust.TrustMetricStore (reference p2p/trust/store.go):
        # good/bad events feed EWMA scores; quarantined peers are refused on
        # dial AND accept until their ban lapses
        self.trust_store = trust_store
        # persistent peers are exempt from trust-quarantine refusals: they
        # are operator-configured (the reference treats persistent peers as
        # unconditional), and a transient flap must not 10-minute-ban the
        # validator we are told to stay connected to. Their events still
        # feed the metric for observability.
        self._persistent_ids: set = set()

    def _quarantined(self, peer_id: str) -> bool:
        return (self.trust_store is not None
                and peer_id not in self._persistent_ids
                and self.trust_store.banned(peer_id))

    # -- reactors (switch.go:163 AddReactor) -------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for ch in reactor.get_channels():
            if ch.id in self._reactors_by_ch:
                raise ValueError(
                    f"channel {ch.id:#x} already registered by "
                    f"{self._reactors_by_ch[ch.id].name}")
            self._reactors_by_ch[ch.id] = reactor
        self.reactors[name] = reactor
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Optional[Reactor]:
        return self.reactors.get(name)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        for reactor in self.reactors.values():
            await reactor.start()

    async def stop(self) -> None:
        self._running = False
        for t in self._dial_tasks.values():
            t.cancel()
        self._dial_tasks.clear()
        # peers BEFORE transport: Server.wait_closed (py3.12) blocks until
        # every accepted connection is closed, and those sockets are owned by
        # the peers' SecretConnections
        for peer in list(self.peers.values()):
            await self.stop_peer_gracefully(peer)
        if self.transport is not None:
            await self.transport.close()
        for reactor in self.reactors.values():
            await reactor.stop()
        if self.trust_store is not None:
            self.trust_store.save()

    # -- TCP transport wiring (switch.go:665 acceptRoutine, :430 reconnect) --

    async def listen(self, host: str, port: int):
        """Start the transport's accept loop; inbound peers auto-register."""
        if self.transport is None:
            raise RuntimeError("switch has no transport")
        return await self.transport.listen(host, port, self._on_inbound_peer)

    async def _on_inbound_peer(self, peer) -> None:
        if not self._running or peer.id in self.peers or peer.id == self.node_id:
            await peer.stop()
            return
        if self._quarantined(peer.id):
            logger.info("%s: refusing quarantined peer %s", self.node_id[:8],
                        peer.id[:8])
            await peer.stop()
            return
        peer.bind(self)
        peer.start()
        await self.add_peer(peer)

    async def dial_peer(self, addr, persistent: bool = False) -> bool:
        """One dial attempt; -> True when the peer is registered."""
        if self.transport is None:
            raise RuntimeError("switch has no transport")
        if addr.id in self.peers or addr.id == self.node_id:
            return False
        if persistent:
            self._persistent_ids.add(addr.id)
        if self._quarantined(addr.id):
            logger.debug("%s: not dialing quarantined peer %s",
                         self.node_id[:8], addr.id[:8])
            return False
        try:
            peer = await self.transport.dial(addr, persistent=persistent)
        except Exception as e:
            logger.debug("%s: dial %s failed: %s", self.node_id[:8], addr, e)
            return False
        if peer.id in self.peers:  # simultaneous connect race: keep existing
            await peer.stop()
            return False
        peer.bind(self)
        peer.start()
        await self.add_peer(peer)
        return True

    def dial_peers_async(self, addrs, persistent: bool = False) -> None:
        """(switch.go DialPeersAsync) fire-and-forget with reconnect for
        persistent peers (exponential backoff, switch.go:430)."""
        for addr in addrs:
            if persistent:
                # register before the first dial so an inbound connection
                # from the same peer is already exempt from quarantine
                self._persistent_ids.add(addr.id)
            if addr.id in self._dial_tasks:
                continue
            t = asyncio.create_task(self._dial_loop(addr, persistent))
            self._dial_tasks[addr.id] = t

    async def _dial_loop(self, addr, persistent: bool) -> None:
        backoff = 1.0
        try:
            while self._running if persistent else True:
                if addr.id in self.peers:
                    if not persistent:
                        return
                    await asyncio.sleep(1.0)
                    continue
                ok = await self.dial_peer(addr, persistent=persistent)
                if ok:
                    if not persistent:
                        return
                    backoff = 1.0
                    await asyncio.sleep(1.0)
                    continue
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 30.0)
                if not persistent and backoff > 8.0:
                    return
        except asyncio.CancelledError:
            raise
        finally:
            self._dial_tasks.pop(addr.id, None)

    # -- peers -------------------------------------------------------------

    async def add_peer(self, peer: Peer) -> None:
        """(switch.go:684 addPeer)"""
        for reactor in self.reactors.values():
            peer = reactor.init_peer(peer)
        self.peers[peer.id] = peer
        for reactor in self.reactors.values():
            await reactor.add_peer(peer)
        if self.trust_store is not None:
            self.trust_store.peer_good(peer.id)
        logger.debug("%s: added peer %s (%d total)", self.node_id[:8], peer.id[:8],
                     len(self.peers))

    async def stop_peer_for_error(self, peer: Peer, reason: str) -> None:
        """(switch.go:367)"""
        logger.info("%s: stopping peer %s for error: %s", self.node_id[:8],
                    peer.id[:8], reason)
        if self.trust_store is not None:
            self.trust_store.peer_bad(peer.id)
        await self._stop_and_remove_peer(peer, reason)

    async def stop_peer_gracefully(self, peer: Peer) -> None:
        await self._stop_and_remove_peer(peer, "graceful stop")

    async def _stop_and_remove_peer(self, peer: Peer, reason: str) -> None:
        if peer.id not in self.peers:
            return
        del self.peers[peer.id]
        await peer.stop()
        for reactor in self.reactors.values():
            await reactor.remove_peer(peer, reason)

    def num_peers(self) -> int:
        return len(self.peers)

    # -- broadcast (switch.go:272) -----------------------------------------

    def broadcast(self, channel_id: int, msg: bytes) -> None:
        for peer in list(self.peers.values()):
            peer.try_send(channel_id, msg)

    # -- inbound dispatch (called by transports) ---------------------------

    async def dispatch(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        reactor = self._reactors_by_ch.get(channel_id)
        if reactor is None:
            logger.warning("no reactor for channel %#x", channel_id)
            return
        try:
            await reactor.receive(channel_id, peer, msg_bytes)
        except Exception as e:
            logger.exception("reactor %s receive error from %s", reactor.name, peer.id[:8])
            await self.stop_peer_for_error(peer, str(e))
