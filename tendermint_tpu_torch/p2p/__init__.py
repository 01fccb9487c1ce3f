"""Peer-to-peer interfaces (reference p2p/, SURVEY.md §2.4).

The Reactor / Peer / ChannelDescriptor / Envelope interfaces (``base``),
the ``Switch`` (reactor registry and peer lifecycle) and the in-process
transport (``InProcNetwork``: whole networks in one asyncio loop, the
reference's own test transport) are ported. The TCP transport, secret
connection, node keys, addresses and node info come with the node.
"""

from .base import ChannelDescriptor, Envelope, Peer, Reactor  # noqa: F401
from .switch import Switch  # noqa: F401
from .inproc import InProcNetwork  # noqa: F401

# Channel IDs (reference consensus/reactor.go:26-29, mempool/mempool.go:14,
# evidence/reactor.go:16, blockchain/v0/reactor.go, statesync/reactor.go:22)
PEX_CHANNEL = 0x00
STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23
MEMPOOL_CHANNEL = 0x30
EVIDENCE_CHANNEL = 0x38
BLOCKCHAIN_CHANNEL = 0x40
SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
