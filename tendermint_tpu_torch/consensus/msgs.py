"""Consensus wire messages (reference consensus/msgs.go;
proto/tendermint/consensus/types.proto Message oneof, fields 1-9).

``WireEncodeCache`` deduplicates ``encode_msg`` work across the reactor's
per-peer gossip routines: the same vote or block part is sent to every peer
and re-considered every loop iteration, but its wire bytes depend only on
content, so one encode serves all sends.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from ..libs import protowire as pw
from ..libs.bits import BitArray
from ..types.basic import BlockID, PartSetHeader, SignedMsgType
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote


@dataclass
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int
    last_commit_round: int


@dataclass
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: PartSetHeader
    block_parts: BitArray
    is_commit: bool


@dataclass
class ProposalMessageWire:
    proposal: Proposal


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray


@dataclass
class BlockPartMessageWire:
    height: int
    round: int
    part: Part


@dataclass
class VoteMessageWire:
    vote: Vote


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: SignedMsgType
    index: int


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: SignedMsgType
    block_id: BlockID
    votes: BitArray


def encode_msg(msg) -> bytes:
    """Message oneof envelope."""
    w = pw.Writer()
    if isinstance(msg, NewRoundStepMessage):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.varint(3, msg.step)
        b.varint(4, msg.seconds_since_start_time)
        b.varint(5, msg.last_commit_round)
        w.message(1, b.finish())
    elif isinstance(msg, NewValidBlockMessage):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.message(3, msg.block_part_set_header.encode())
        b.message_opt(4, msg.block_parts.encode() if msg.block_parts else None)
        b.bool(5, msg.is_commit)
        w.message(2, b.finish())
    elif isinstance(msg, ProposalMessageWire):
        b = pw.Writer()
        b.message(1, msg.proposal.encode())
        w.message(3, b.finish())
    elif isinstance(msg, ProposalPOLMessage):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.proposal_pol_round)
        b.message(3, msg.proposal_pol.encode())
        w.message(4, b.finish())
    elif isinstance(msg, BlockPartMessageWire):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.message(3, msg.part.encode())
        w.message(5, b.finish())
    elif isinstance(msg, VoteMessageWire):
        b = pw.Writer()
        b.message(1, msg.vote.encode())
        w.message(6, b.finish())
    elif isinstance(msg, HasVoteMessage):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.varint(3, int(msg.type))
        b.varint(4, msg.index)
        w.message(7, b.finish())
    elif isinstance(msg, VoteSetMaj23Message):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.varint(3, int(msg.type))
        b.message(4, msg.block_id.encode())
        w.message(8, b.finish())
    elif isinstance(msg, VoteSetBitsMessage):
        b = pw.Writer()
        b.varint(1, msg.height)
        b.varint(2, msg.round)
        b.varint(3, int(msg.type))
        b.message(4, msg.block_id.encode())
        b.message(5, msg.votes.encode())
        w.message(9, b.finish())
    else:
        raise ValueError(f"unknown consensus message {type(msg)}")
    return w.finish()


class WireEncodeCache:
    """Content-keyed cache of ``encode_msg`` outputs, shared across peers
    and gossip-loop iterations.

    Keys carry full message identity — (height, round, part-set-header
    hash, part index) for block parts, the signature for votes and
    proposals (a signature pins the exact signed content, so even
    equivocating votes at the same H/R/type/index key separately) — so a
    stale entry can never serve bytes for different content. Eviction is
    therefore pure memory management: LRU-bounded, plus the reactor
    explicitly prunes heights that fell out of the live gossip window on
    every height advance.
    """

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0}
        self.metrics = None  # ConsensusMetrics, wired by the node

    def get(self, kind: str, height: int, key: Tuple,
            build: Callable[[], bytes]) -> bytes:
        k = (kind, height, key)
        buf = self._entries.get(k)
        m = self.metrics
        if buf is not None:
            self._entries.move_to_end(k)
            self.stats["hits"] += 1
            if m is not None:
                m.encode_cache_hits_total.labels(kind).inc()
            return buf
        buf = build()
        self.stats["misses"] += 1
        if m is not None:
            m.encode_cache_misses_total.labels(kind).inc()
        self._entries[k] = buf
        if len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return buf

    def vote(self, vote) -> bytes:
        return self.get(
            "vote", vote.height,
            (vote.round, int(vote.type), vote.validator_index, vote.signature),
            lambda: encode_msg(VoteMessageWire(vote)))

    def block_part(self, height: int, round_: int, psh_hash: bytes,
                   part) -> bytes:
        return self.get(
            "block_part", height, (round_, psh_hash, part.index),
            lambda: encode_msg(BlockPartMessageWire(height, round_, part)))

    def proposal(self, proposal) -> bytes:
        return self.get(
            "proposal", proposal.height, (proposal.round, proposal.signature),
            lambda: encode_msg(ProposalMessageWire(proposal)))

    def prune_below(self, height: int) -> int:
        """Drop entries below `height` (called on height advance; lagging
        catchup peers below the cutoff re-encode — LRU already bounds them)."""
        dead = [k for k in self._entries if k[1] < height]
        for k in dead:
            del self._entries[k]
        return len(dead)

    def __len__(self) -> int:
        return len(self._entries)


def decode_msg(data: bytes):
    fields = list(pw.iter_fields(data))
    if len(fields) != 1:
        raise ValueError("consensus Message must have exactly one oneof field")
    fn, _wt, body = fields[0]
    d = pw.fields_dict(body)

    def iv(n, default=0):
        vals = d.get(n)
        return pw.varint_to_int64(vals[0]) if vals else default

    def bv(n):
        vals = d.get(n)
        return vals[0] if vals else b""

    if fn == 1:
        return NewRoundStepMessage(iv(1), iv(2), iv(3), iv(4), iv(5))
    if fn == 2:
        return NewValidBlockMessage(
            iv(1), iv(2), PartSetHeader.decode(bv(3)),
            BitArray.decode(bv(4)) if d.get(4) else BitArray(0), bool(iv(5)))
    if fn == 3:
        return ProposalMessageWire(Proposal.decode(bv(1)))
    if fn == 4:
        return ProposalPOLMessage(iv(1), iv(2), BitArray.decode(bv(3)))
    if fn == 5:
        return BlockPartMessageWire(iv(1), iv(2), Part.decode(bv(3)))
    if fn == 6:
        return VoteMessageWire(Vote.decode(bv(1)))
    if fn == 7:
        return HasVoteMessage(iv(1), iv(2), SignedMsgType(iv(3)), iv(4))
    if fn == 8:
        return VoteSetMaj23Message(iv(1), iv(2), SignedMsgType(iv(3)),
                                   BlockID.decode(bv(4)))
    if fn == 9:
        return VoteSetBitsMessage(iv(1), iv(2), SignedMsgType(iv(3)),
                                  BlockID.decode(bv(4)), BitArray.decode(bv(5)))
    raise ValueError(f"unknown consensus Message field {fn}")
