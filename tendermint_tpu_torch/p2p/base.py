"""Reactor/Peer interfaces (reference p2p/base_reactor.go:15, p2p/peer.go:23)."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ChannelDescriptor:
    """(p2p/conn/connection.go:746 ChannelDescriptor)"""

    id: int
    priority: int = 1
    send_queue_capacity: int = 100
    recv_message_capacity: int = 1048576


@dataclass
class Envelope:
    channel_id: int
    message: bytes
    sender: str = ""


class Peer:
    """A connected peer (p2p/peer.go:23). Implementations: inproc, tcp."""

    def __init__(self, peer_id: str, outbound: bool = False,
                 persistent: bool = False):
        self.id = peer_id
        self.outbound = outbound
        self.persistent = persistent
        # reactors hang per-peer state here (reference peer.Set/Get)
        self.data: Dict[str, Any] = {}

    def send(self, channel_id: int, msg: bytes) -> bool:
        """Queue msg; blocks-by-dropping if the channel is saturated (TrySend
        semantics — asyncio reactors use the async send path below)."""
        raise NotImplementedError

    def try_send(self, channel_id: int, msg: bytes) -> bool:
        raise NotImplementedError

    def is_running(self) -> bool:
        raise NotImplementedError

    async def stop(self) -> None:
        raise NotImplementedError

    def set(self, key: str, value: Any) -> None:
        self.data[key] = value

    def get(self, key: str) -> Any:
        return self.data.get(key)

    def __repr__(self):
        return f"Peer({self.id[:12]})"


class Reactor:
    """(p2p/base_reactor.go:15)"""

    def __init__(self, name: str):
        self.name = name
        self.switch = None  # set by Switch.add_reactor

    def get_channels(self) -> List[ChannelDescriptor]:
        return []

    def set_switch(self, switch) -> None:
        self.switch = switch

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    def init_peer(self, peer: Peer) -> Peer:
        return peer

    async def add_peer(self, peer: Peer) -> None:
        pass

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        pass

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        pass
