"""Consensus reactor: gossips round state, block parts, and votes over four
p2p channels (reference consensus/reactor.go — State=0x20 Data=0x21 Vote=0x22
VoteSetBits=0x23, three gossip tasks per peer + broadcast listeners).

Each gossiped vote is preverified through the state machine's vote batcher
(``crypto/vote_batcher.py``) before it is forwarded. A fault of the card in
that preverify (a running kernel's fault, the armed ``device.vote_flush``
site, ``KernelUnavailable``, ``DeviceFlushTimeout``) reaches the reactor: it
counts ``stats["preverify_device_errors"]`` once a fault (the batcher
counted it on ``crypto_device_errors_total`` already) and drops that
delivery of each vote the fault reached (``preverify_dropped_votes``): the
vote never reaches ``VoteSet.add_vote``'s host miss path. The JAX package swallows the fault and forwards the vote, which its VoteSet
then verifies on the host. The other early returns of the preverify
(unknown height or index, an address mismatch) keep the JAX behaviour: the
vote is forwarded unverified and its VoteSet verifies it on the host.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from ..device import is_device_fault
from ..libs.bits import BitArray
from ..libs.trace import tracer
from ..p2p import (
    DATA_CHANNEL,
    STATE_CHANNEL,
    VOTE_CHANNEL,
    VOTE_SET_BITS_CHANNEL,
)
from ..p2p.base import ChannelDescriptor, Peer, Reactor
from ..types.basic import BlockID, PartSetHeader, SignedMsgType
from ..types.vote import Vote
from .msgs import (
    BlockPartMessageWire,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessageWire,
    ProposalPOLMessage,
    VoteMessageWire,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    WireEncodeCache,
    decode_msg,
    encode_msg,
)
from .round_state import RoundState, RoundStep
from .state import BlockPartMessage, ConsensusState, ProposalMessage, VoteMessage

logger = logging.getLogger("tmtpu.cs.reactor")

# cap on detached preverify-and-forward tasks before peer backpressure kicks in
MAX_INFLIGHT_PREVERIFY = 1024


class _Waker:
    """Level-triggered wakeup for one gossip routine.

    ``wake()`` sets the event; ``wait()`` returns True as soon as any wake
    since the last wait fired (including during the routine's preceding
    work burst — no lost wakeups), or False when the fallback sleep cap
    expired with no signal. The configured peer_gossip_sleep_duration thus
    becomes an upper bound on gossip staleness instead of its clock.
    """

    __slots__ = ("_event",)

    def __init__(self):
        self._event = asyncio.Event()

    def wake(self) -> None:
        self._event.set()

    async def wait(self, timeout: float) -> bool:
        if not self._event.is_set():
            try:
                await asyncio.wait_for(self._event.wait(), timeout)
            except asyncio.TimeoutError:
                return False
        self._event.clear()
        return True


class PeerRoundState:
    """What we know about a peer's consensus state (consensus/types/peer_round_state.go)."""

    def __init__(self):
        self.height = 0
        self.round = -1
        self.step = RoundStep.NEW_HEIGHT
        self.start_time_ns = 0
        self.proposal = False
        self.proposal_block_part_set_header = PartSetHeader()
        self.proposal_block_parts: Optional[BitArray] = None
        self.proposal_pol_round = -1
        self.proposal_pol: Optional[BitArray] = None
        self.prevotes: Optional[BitArray] = None
        self.precommits: Optional[BitArray] = None
        self.last_commit_round = -1
        self.last_commit: Optional[BitArray] = None
        self.catchup_commit_round = -1
        self.catchup_commit: Optional[BitArray] = None


class PeerState:
    """(consensus/reactor.go:1028 PeerState)"""

    def __init__(self, peer: Peer):
        self.peer = peer
        self.prs = PeerRoundState()
        self.last_recv_t = time.monotonic()

    def note_recv(self) -> None:
        self.last_recv_t = time.monotonic()

    def refresh_if_stalled(self, stall_s: float) -> bool:
        """Self-healing gossip: downgrade a silent peer's delivery bitmaps
        from facts to guesses. Gossip marks a vote/part as delivered when
        it SENDS it (reactor.go PickSendVote semantics) — sound over the
        reliable TCP transport, but a lossy or blackholed link (partition,
        dying relay, chaos LinkPolicy) eats sends silently and the bitmaps
        then claim the peer has data it never saw: catchup stops and the
        link wedges permanently. After ``stall_s`` without a single
        message from the peer, clear what we think we delivered so the
        gossip routines re-send — duplicates are cheap (PartSet/VoteSet
        dedup), a poisoned bitmap is a liveness hole. Height/round/step
        are kept: those came FROM the peer."""
        if stall_s <= 0:
            return False
        now = time.monotonic()
        if now - self.last_recv_t < stall_s:
            return False
        self.last_recv_t = now  # one refresh per silent interval
        prs = self.prs
        prs.proposal = False
        if prs.proposal_block_parts is not None:
            prs.proposal_block_parts = BitArray(
                prs.proposal_block_parts.size())
        for name in ("prevotes", "precommits", "last_commit",
                     "catchup_commit", "proposal_pol"):
            ba = getattr(prs, name)
            if ba is not None:
                setattr(prs, name, BitArray(ba.size()))
        return True

    # -- updates from messages --------------------------------------------

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        prs = self.prs
        # Ignore duplicates or decreases (reactor.go ApplyNewRoundStepMessage
        # CompareHRS guard) — otherwise a byzantine peer can wipe our
        # bookkeeping and trigger bandwidth-amplifying re-gossip.
        if _compare_hrs(msg.height, msg.round,
                        RoundStep(msg.step) if msg.step else RoundStep.NEW_HEIGHT,
                        prs.height, prs.round, prs.step) <= 0:
            return
        ps_height, ps_round = prs.height, prs.round
        ps_catchup_commit_round = prs.catchup_commit_round
        ps_catchup_commit = prs.catchup_commit

        prs.height = msg.height
        prs.round = msg.round
        prs.step = RoundStep(msg.step) if msg.step else RoundStep.NEW_HEIGHT
        prs.start_time_ns = time.time_ns() - msg.seconds_since_start_time * 1_000_000_000
        if ps_height != msg.height or ps_round != msg.round:
            prs.proposal = False
            prs.proposal_block_part_set_header = PartSetHeader()
            prs.proposal_block_parts = None
            prs.proposal_pol_round = -1
            prs.proposal_pol = None
            prs.prevotes = None
            prs.precommits = None
        if (ps_height == msg.height and ps_round != msg.round
                and msg.round == ps_catchup_commit_round):
            prs.precommits = ps_catchup_commit
        if ps_height != msg.height:
            if ps_height + 1 == msg.height and ps_round == msg.last_commit_round:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = prs.precommits
            else:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = None
            prs.catchup_commit_round = -1
            prs.catchup_commit = None

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.round != msg.round and not msg.is_commit:
            return
        prs.proposal_block_part_set_header = msg.block_part_set_header
        prs.proposal_block_parts = msg.block_parts

    def set_has_proposal(self, proposal) -> None:
        prs = self.prs
        if prs.height != proposal.height or prs.round != proposal.round:
            return
        if prs.proposal:
            return
        prs.proposal = True
        if prs.proposal_block_parts is not None:
            return  # NewValidBlock already set this
        prs.proposal_block_part_set_header = proposal.block_id.part_set_header
        prs.proposal_block_parts = BitArray(proposal.block_id.part_set_header.total)
        prs.proposal_pol_round = proposal.pol_round
        prs.proposal_pol = None

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        prs = self.prs
        if prs.height != msg.height or prs.proposal_pol_round != msg.proposal_pol_round:
            return
        prs.proposal_pol = msg.proposal_pol

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        prs = self.prs
        if prs.height != height or prs.round != round_:
            return
        if prs.proposal_block_parts is not None:
            prs.proposal_block_parts.set_index(index, True)

    def apply_has_vote(self, msg: HasVoteMessage) -> None:
        if self.prs.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def set_has_vote(self, height: int, round_: int, type_: SignedMsgType,
                     index: int) -> None:
        ba = self._votes_bit_array(height, round_, type_)
        if ba is not None:
            ba.set_index(index, True)

    def _votes_bit_array(self, height: int, round_: int,
                         type_: SignedMsgType) -> Optional[BitArray]:
        """(reactor.go PeerState.getVoteBitArray)"""
        prs = self.prs
        is_prevote = type_ == SignedMsgType.PREVOTE
        if prs.height == height:
            if prs.round == round_:
                return prs.prevotes if is_prevote else prs.precommits
            if prs.catchup_commit_round == round_ and not is_prevote:
                return prs.catchup_commit
            if prs.proposal_pol_round == round_ and is_prevote:
                return prs.proposal_pol
            return None
        if prs.height == height + 1 and prs.last_commit_round == round_ \
                and not is_prevote:
            return prs.last_commit
        return None

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        prs = self.prs
        if prs.height == height:
            if prs.prevotes is None:
                prs.prevotes = BitArray(num_validators)
            if prs.precommits is None:
                prs.precommits = BitArray(num_validators)
            if prs.catchup_commit is None:
                prs.catchup_commit = BitArray(num_validators)
            if prs.proposal_pol is None:
                prs.proposal_pol = BitArray(num_validators)
        elif prs.height == height + 1:
            if prs.last_commit is None:
                prs.last_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(self, height: int, round_: int,
                                    num_validators: int) -> None:
        prs = self.prs
        if prs.height != height:
            return
        if prs.catchup_commit_round == round_:
            return
        prs.catchup_commit_round = round_
        if round_ == prs.round:
            prs.catchup_commit = prs.precommits
        else:
            prs.catchup_commit = BitArray(num_validators)

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage, our_votes: Optional[BitArray]) -> None:
        """(reactor.go ApplyVoteSetBitsMessage): keep what we know the peer has
        beyond our own votes, and take the peer's word for the overlap —
        NEVER credit the peer with our votes."""
        ba = self._votes_bit_array(msg.height, msg.round, msg.type)
        if ba is not None:
            if our_votes is not None:
                other_votes = ba.sub(our_votes)
                ba.update(other_votes.or_(msg.votes))
            else:
                ba.update(msg.votes)

    # -- vote picking (reactor.go:1149 PickSendVote) -----------------------

    def pick_vote_to_send(self, votes: "_VoteSetReader") -> Optional[Vote]:
        """(reactor.go:1169 PickVoteToSend) — lazily sets up catchup-commit
        and vote bit arrays from the reader before picking."""
        if votes.size() == 0:
            return None
        height, round_, type_ = votes.height, votes.round, votes.type_
        if votes.is_commit():
            self.ensure_catchup_commit_round(height, round_, votes.size())
        self.ensure_vote_bit_arrays(height, votes.size())
        ba = self._votes_bit_array(height, round_, type_)
        if ba is None:
            return None
        missing = votes.bit_array().sub(ba)
        idx, ok = missing.pick_random()
        if not ok:
            return None
        return votes.get_by_index(idx)


class _VoteSetReader:
    """Uniform view over VoteSet and Commit for gossip (reference VoteSetReader)."""

    def __init__(self, height: int, round_: int, type_: SignedMsgType, vote_set=None,
                 commit=None):
        self.height = height
        self.round = round_
        self.type_ = type_
        self._vote_set = vote_set
        self._commit = commit

    @staticmethod
    def from_vote_set(vs) -> "_VoteSetReader":
        return _VoteSetReader(vs.height, vs.round, vs.signed_msg_type, vote_set=vs)

    @staticmethod
    def from_commit(commit) -> "_VoteSetReader":
        return _VoteSetReader(commit.height, commit.round, SignedMsgType.PRECOMMIT,
                              commit=commit)

    def size(self) -> int:
        if self._vote_set is not None:
            return self._vote_set.size()
        return self._commit.size()

    def is_commit(self) -> bool:
        return self._commit is not None

    def bit_array(self) -> BitArray:
        if self._vote_set is not None:
            return self._vote_set.bit_array()
        if hasattr(self._commit, "agg_sig"):
            # no per-validator votes to offer — peers catch up via block sync
            return BitArray(self._commit.size())
        ba = BitArray(len(self._commit.signatures))
        for i, cs in enumerate(self._commit.signatures):
            ba.set_index(i, not cs.absent())
        return ba

    def get_by_index(self, idx: int) -> Optional[Vote]:
        if self._vote_set is not None:
            return self._vote_set.get_by_index(idx)
        if hasattr(self._commit, "agg_sig"):
            return None
        if self._commit.signatures[idx].absent():
            return None
        return self._commit.get_vote(idx)


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState, wait_sync: bool = False):
        super().__init__("CONSENSUS")
        self.cs = cs
        self.wait_sync = wait_sync  # True while fast sync runs
        self._peer_states: Dict[str, PeerState] = {}
        self._gossip_tasks: Dict[str, List[asyncio.Task]] = {}
        # strong refs to detached preverify-and-forward tasks (the loop keeps
        # only weak refs; a GC'd task would drop the vote silently)
        self._inflight: set = set()
        # event-driven gossip: per-peer wakers for the data/votes routines,
        # signaled on round-state transitions, new proposal data, and new
        # votes (and on inbound peer-state changes for that peer)
        self._wakers: Dict[str, Dict[str, _Waker]] = {}
        # one encode per message content, shared across peers and iterations
        self._encode_cache = WireEncodeCache()
        self._prune_height = 0
        # preverify_device_errors: faults of the card met by preverifies
        # (one a failed flush, however many votes it held);
        # preverify_dropped_votes: the vote deliveries they dropped
        self.stats = collections.Counter()
        self._recent_faults: "collections.deque" = collections.deque(maxlen=8)
        # subscribe to internal state events for broadcasts
        cs.new_round_step_listeners.append(self._broadcast_new_round_step)
        cs.valid_block_listeners.append(self._broadcast_new_valid_block)
        cs.vote_listeners.append(self._broadcast_has_vote)
        cs.equivocation_listeners.append(self._broadcast_vote_directly)
        cs.proposal_data_listeners.append(self._wake_data_routines)

    def set_metrics(self, metrics) -> None:
        """Wire ConsensusMetrics into the reactor-side hot paths. The gossip
        wakeup/poll counters read ``cs.metrics`` directly; the encode cache
        keeps its own hook because it has no cs reference."""
        self._encode_cache.metrics = metrics

    def get_channels(self) -> List[ChannelDescriptor]:
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6),
            ChannelDescriptor(DATA_CHANNEL, priority=10),
            ChannelDescriptor(VOTE_CHANNEL, priority=7),
            ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1),
        ]

    # -- peer lifecycle ----------------------------------------------------

    def init_peer(self, peer: Peer) -> Peer:
        self._peer_states[peer.id] = PeerState(peer)
        return peer

    async def add_peer(self, peer: Peer) -> None:
        ps = self._peer_states[peer.id]
        if self.cs.config.peer_gossip_event_wakeups:
            self._wakers[peer.id] = {"data": _Waker(), "votes": _Waker()}
        tasks = [
            asyncio.create_task(self._gossip_data_routine(peer, ps)),
            asyncio.create_task(self._gossip_votes_routine(peer, ps)),
            asyncio.create_task(self._query_maj23_routine(peer, ps)),
        ]
        self._gossip_tasks[peer.id] = tasks
        if not self.wait_sync:
            self._send_new_round_step(peer)

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        for t in self._gossip_tasks.pop(peer.id, []):
            t.cancel()
        self._peer_states.pop(peer.id, None)
        self._wakers.pop(peer.id, None)

    async def stop(self) -> None:
        for tasks in self._gossip_tasks.values():
            for t in tasks:
                t.cancel()
        self._gossip_tasks.clear()
        self._wakers.clear()

    # -- gossip wakeups ----------------------------------------------------

    def _wake_gossip(self, routine: Optional[str] = None) -> None:
        """Wake every peer's gossip routines (or just one routine kind)."""
        for wakers in self._wakers.values():
            if routine is None:
                for w in wakers.values():
                    w.wake()
            else:
                w = wakers.get(routine)
                if w is not None:
                    w.wake()

    def _wake_data_routines(self) -> None:
        self._wake_gossip("data")

    def _wake_peer(self, peer_id: str) -> None:
        """An inbound message changed what this peer is known to have."""
        for w in self._wakers.get(peer_id, {}).values():
            w.wake()

    def _maybe_refresh_peer(self, ps: PeerState) -> None:
        """Self-healing gossip: if the peer has been silent past
        gossip_stall_refresh_s AND could still need something from us,
        clear its delivery bitmaps so both gossip routines re-send (see
        PeerState.refresh_if_stalled). A peer behind our height always
        qualifies (the classic post-heal catchup case). A peer AT our
        height qualifies only while we are inside an active round
        ourselves: a healed quorum-loss window leaves every node wedged
        at the same height in PREVOTE/PRECOMMIT — a step with NO timeout
        until 2/3-any arrives, so the "round timeouts reset the vote
        bitmaps via NewRoundStep" escape hatch never fires and the
        delivery bitmaps (poisoned by sends the blocked links ate) wedge
        the fleet permanently. The NEW_HEIGHT/COMMIT exclusion keeps a
        healthy net that idles between txs quiet: idle peers sit at
        NEW_HEIGHT needing nothing re-sent."""
        rs = self.cs.rs
        if ps.prs.height > rs.height:
            return
        if (ps.prs.height == rs.height
                and rs.step in (RoundStep.NEW_HEIGHT, RoundStep.COMMIT)):
            return
        if ps.refresh_if_stalled(self.cs.config.gossip_stall_refresh_s):
            m = self.cs.metrics
            if m is not None:
                m.gossip_peer_refreshes_total.inc()
            self._wake_peer(ps.peer.id)

    async def _gossip_idle(self, waker: Optional[_Waker], sleep: float,
                           routine: str) -> None:
        """Idle until an event wakeup or the fallback sleep cap."""
        if waker is None:
            await asyncio.sleep(sleep)
            return
        if tracer.enabled:
            with tracer.span("gossip_idle", routine=routine,
                             height=self.cs.rs.height):
                woke = await waker.wait(sleep)
        else:
            woke = await waker.wait(sleep)
        m = self.cs.metrics
        if m is not None:
            (m.gossip_wakeups_total if woke
             else m.gossip_polls_total).labels(routine).inc()

    # -- switch-to-consensus (reactor.go:108) ------------------------------

    def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        if state.last_block_height > 0:
            self.cs.reconstruct_last_commit(state)
        self.cs.update_to_state(state)
        self.wait_sync = False
        self._broadcast_new_round_step(self.cs.rs)
        if self.cs._receive_task is None:
            # the state machine was held back while sync ran (reference
            # reactor.go:108 SwitchToConsensus → conS.Start). Keep a strong
            # reference: the event loop holds only weak refs to tasks, and a
            # GC'd wrapper would silently drop consensus startup.
            self._start_task = asyncio.create_task(self.cs.start())

    # -- inbound -----------------------------------------------------------

    def _broadcast_vote_directly(self, vote) -> None:
        """Maverick support: push a (possibly equivocating) vote to every
        peer on the vote channel, bypassing vote-set gossip."""
        if self.switch is not None:
            self.switch.broadcast(VOTE_CHANNEL, self._encode_cache.vote(vote))

    async def _preverify_and_forward(self, vote, peer_id: str) -> None:
        """Pre-verify then enqueue to the state machine. Vote delivery order
        is irrelevant (VoteSet is a set keyed by validator index). A fault
        of the card drops this delivery: the vote is not verified on the
        host instead."""
        try:
            await self._preverify_vote(vote)
        except Exception as e:
            # a failed flush hands one exception to each of its votes
            if not any(e is f for f in self._recent_faults):
                self._recent_faults.append(e)
                self.stats["preverify_device_errors"] += 1
                logger.warning("vote preverify met a fault of the card; its "
                               "votes are dropped, not verified on the host: "
                               "%s", e)
            self.stats["preverify_dropped_votes"] += 1
            return
        await self.cs.add_peer_msg(VoteMessage(vote), peer_id)

    async def _preverify_vote(self, vote) -> None:
        """Feed the vote's signature into the micro-batch verifier so the
        state machine's VoteSet.add_vote hits the verdict cache. A miss
        (unknown height/index) falls back to the host scalar path inside
        VoteSet — decisions are identical either way. A fault of the card
        (``device.is_device_fault``) is raised to the caller; any other
        exception is logged and the vote goes on unverified."""
        try:
            rs = self.cs.rs
            if vote.height == rs.height and rs.validators is not None:
                vals = rs.validators
            elif (vote.height == rs.height - 1
                  and rs.last_commit is not None):
                vals = rs.last_commit.val_set
            else:
                return
            if not (0 <= vote.validator_index < vals.size()):
                return
            _addr, val = vals.get_by_index(vote.validator_index)
            if val is None or val.pub_key.address() != vote.validator_address:
                return
            await self.cs.vote_verifier.preverify(
                val.pub_key, vote.sign_bytes(self.cs.state.chain_id),
                vote.signature)
        except Exception as e:  # never let pre-verification break gossip
            if is_device_fault(e):
                raise
            logger.debug("vote preverify skipped", exc_info=True)

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        msg = decode_msg(msg_bytes)
        ps = self._peer_states.get(peer.id)
        if ps is None:
            return
        ps.note_recv()
        rs = self.cs.rs

        if channel_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                _validate_nrs(msg, self.cs.state.initial_height)
                ps.apply_new_round_step(msg)
                # the peer moved: what we can usefully send it changed
                self._wake_peer(peer.id)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
                self._wake_peer(peer.id)
            elif isinstance(msg, HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, VoteSetMaj23Message):
                if rs.height != msg.height:
                    return
                try:
                    # creates the round's vote sets if absent (HeightVoteSet
                    # SetPeerMaj23, like the reference's cs.Votes path)
                    rs.votes.set_peer_maj23(msg.round, msg.type, peer.id,
                                            msg.block_id)
                except Exception as e:
                    await self.switch.stop_peer_for_error(peer, str(e))
                    return
                vote_set = (rs.votes.prevotes(msg.round)
                            if msg.type == SignedMsgType.PREVOTE
                            else rs.votes.precommits(msg.round))
                # respond with VoteSetBits on the VoteSetBits channel
                if vote_set is not None:
                    our = vote_set.bit_array_by_block_id(msg.block_id)
                    peer.try_send(VOTE_SET_BITS_CHANNEL, encode_msg(VoteSetBitsMessage(
                        msg.height, msg.round, msg.type, msg.block_id,
                        our or BitArray(0))))
        elif channel_id == DATA_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, ProposalMessageWire):
                ps.set_has_proposal(msg.proposal)
                # stage-timeline aux mark at WIRE receipt: the gap to the
                # state machine's proposal_received mark is queue delay
                self.cs.timeline.note_wire_proposal(msg.proposal.height)
                await self.cs.add_peer_msg(ProposalMessage(msg.proposal), peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
                self._wake_peer(peer.id)
            elif isinstance(msg, BlockPartMessageWire):
                ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
                await self.cs.add_peer_msg(
                    BlockPartMessage(msg.height, msg.round, msg.part), peer.id)
        elif channel_id == VOTE_CHANNEL:
            if self.wait_sync:
                return
            if isinstance(msg, VoteMessageWire):
                height = self.cs.rs.height
                val_size = self.cs.rs.validators.size() if self.cs.rs.validators else 0
                last_size = (self.cs.rs.last_commit.size()
                             if self.cs.rs.last_commit else 0)
                ps.ensure_vote_bit_arrays(height, val_size)
                ps.ensure_vote_bit_arrays(height - 1, last_size)
                ps.set_has_vote(msg.vote.height, msg.vote.round, msg.vote.type,
                                msg.vote.validator_index)
                # HOT LOOP #1: pre-verify the signature, then forward — as a
                # detached task so this peer's dispatch loop keeps reading
                # while the verifier accumulates a batch across peers
                # (vote_set.go:205 equivalent; crypto/vote_batcher.py).
                # Correctness never depends on it: a cache miss in VoteSet
                # falls back to the host scalar verify.
                if len(self._inflight) < MAX_INFLIGHT_PREVERIFY:
                    t = asyncio.create_task(
                        self._preverify_and_forward(msg.vote, peer.id))
                    self._inflight.add(t)
                    t.add_done_callback(self._inflight.discard)
                else:
                    # backpressure: a vote-flooding peer must not grow the
                    # task set unboundedly — block its dispatch loop (the
                    # bounded cs queue then applies, as before the change)
                    await self._preverify_and_forward(msg.vote, peer.id)
        elif channel_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage):
                if rs.height == msg.height:
                    vote_set = (rs.votes.prevotes(msg.round)
                                if msg.type == SignedMsgType.PREVOTE
                                else rs.votes.precommits(msg.round))
                    our = vote_set.bit_array_by_block_id(msg.block_id) if vote_set else None
                    ps.apply_vote_set_bits(msg, our)
                else:
                    ps.apply_vote_set_bits(msg, None)

    # -- broadcasts (reactor.go:430 subscribeToBroadcastEvents) ------------

    def _nrs_message(self, rs) -> NewRoundStepMessage:
        return NewRoundStepMessage(
            height=rs.height, round=rs.round, step=int(rs.step),
            seconds_since_start_time=max(0, (time.time_ns() - rs.start_time_ns)
                                         // 1_000_000_000),
            last_commit_round=(rs.last_commit.round if rs.last_commit is not None
                               else -1),
        )

    def _broadcast_new_round_step(self, rs) -> None:
        if rs.height > self._prune_height:
            # height advanced: drop encode-cache entries that fell out of
            # the live gossip window (height-keyed invalidation)
            self._prune_height = rs.height
            self._encode_cache.prune_below(rs.height - 1)
        self._wake_gossip()
        if self.switch is not None:
            self.switch.broadcast(STATE_CHANNEL, encode_msg(self._nrs_message(rs)))

    def _broadcast_new_valid_block(self, rs) -> None:
        self._wake_gossip()
        if self.switch is None:
            return
        psh = (rs.proposal_block_parts.header() if rs.proposal_block_parts
               else PartSetHeader())
        ba = (rs.proposal_block_parts.parts_bit_array.copy()
              if rs.proposal_block_parts else BitArray(0))
        self.switch.broadcast(STATE_CHANNEL, encode_msg(NewValidBlockMessage(
            rs.height, rs.round, psh, ba, rs.step == RoundStep.COMMIT)))

    def _broadcast_has_vote(self, vote: Vote) -> None:
        self._wake_gossip("votes")
        if self.switch is not None:
            self.switch.broadcast(STATE_CHANNEL, encode_msg(HasVoteMessage(
                vote.height, vote.round, vote.type, vote.validator_index)))

    def _send_new_round_step(self, peer: Peer) -> None:
        peer.try_send(STATE_CHANNEL, encode_msg(self._nrs_message(self.cs.rs)))

    # -- gossip: data (reactor.go:559 gossipDataRoutine) -------------------

    async def _gossip_data_routine(self, peer: Peer, ps: PeerState) -> None:
        sleep = self.cs.config.peer_gossip_sleep_duration
        waker = self._wakers.get(peer.id, {}).get("data")
        try:
            while peer.is_running():
                self._maybe_refresh_peer(ps)
                rs = self.cs.rs
                prs = ps.prs

                # send proposal block parts the peer lacks
                if (rs.proposal_block_parts is not None
                        and rs.proposal_block_parts.header() == prs.proposal_block_part_set_header
                        and prs.proposal_block_parts is not None):
                    missing = rs.proposal_block_parts.parts_bit_array.sub(
                        prs.proposal_block_parts)
                    index, ok = missing.pick_random()
                    if ok:
                        part = rs.proposal_block_parts.get_part(index)
                        if peer.try_send(DATA_CHANNEL, self._encode_cache.block_part(
                                rs.height, rs.round,
                                prs.proposal_block_part_set_header.hash, part)):
                            ps.set_has_proposal_block_part(prs.height, prs.round, index)
                        await asyncio.sleep(0)
                        continue

                # peer is on an earlier height: catch them up from block store
                block_store_base = self.cs.block_store.base()
                if (0 < prs.height < rs.height
                        and prs.height >= block_store_base):
                    if await self._gossip_catchup_part(peer, ps):
                        continue
                    await self._gossip_idle(waker, sleep, "data")
                    continue

                if rs.height != prs.height or rs.round != prs.round:
                    await self._gossip_idle(waker, sleep, "data")
                    continue

                # send the Proposal (+ POL) if the peer lacks it
                if rs.proposal is not None and not prs.proposal:
                    if peer.try_send(DATA_CHANNEL,
                                     self._encode_cache.proposal(rs.proposal)):
                        ps.set_has_proposal(rs.proposal)
                    if 0 <= rs.proposal.pol_round:
                        pol = rs.votes.prevotes(rs.proposal.pol_round)
                        if pol is not None:
                            peer.try_send(DATA_CHANNEL, encode_msg(ProposalPOLMessage(
                                rs.height, rs.proposal.pol_round, pol.bit_array())))
                    await asyncio.sleep(0)
                    continue

                await self._gossip_idle(waker, sleep, "data")
        except asyncio.CancelledError:
            pass

    async def _gossip_catchup_part(self, peer: Peer, ps: PeerState) -> bool:
        """Send one missing part of an old block (reactor.go gossipDataForCatchup)."""
        prs = ps.prs
        if prs.proposal_block_parts is None:
            # init from stored block meta
            meta = self.cs.block_store.load_block_meta(prs.height)
            if meta is None:
                return False
            ps.prs.proposal_block_part_set_header = meta.block_id.part_set_header
            ps.prs.proposal_block_parts = BitArray(meta.block_id.part_set_header.total)
        missing = BitArray(prs.proposal_block_part_set_header.total)
        missing.update(prs.proposal_block_parts.not_())
        index, ok = missing.pick_random()
        if not ok:
            return False
        part = self.cs.block_store.load_block_part(prs.height, index)
        if part is None:
            return False
        if peer.try_send(DATA_CHANNEL, self._encode_cache.block_part(
                prs.height, prs.round,
                prs.proposal_block_part_set_header.hash, part)):
            prs.proposal_block_parts.set_index(index, True)
            return True
        return False

    # -- gossip: votes (reactor.go:716 gossipVotesRoutine) -----------------

    async def _gossip_votes_routine(self, peer: Peer, ps: PeerState) -> None:
        sleep = self.cs.config.peer_gossip_sleep_duration
        waker = self._wakers.get(peer.id, {}).get("votes")
        try:
            while peer.is_running():
                self._maybe_refresh_peer(ps)
                rs = self.cs.rs
                prs = ps.prs
                if rs.height == prs.height:
                    if self._gossip_votes_for_height(rs, ps, peer):
                        await asyncio.sleep(0)
                        continue
                elif (prs.height != 0 and rs.height == prs.height + 1
                      and rs.last_commit is not None):
                    if self._pick_send_vote(
                            peer, ps, _VoteSetReader.from_vote_set(rs.last_commit)):
                        await asyncio.sleep(0)
                        continue
                elif (prs.height != 0 and rs.height >= prs.height + 2
                      and self.cs.block_store.base() <= prs.height
                      <= self.cs.block_store.height()):
                    commit = self.cs.block_store.load_block_commit(prs.height)
                    if commit is not None and self._pick_send_vote(
                            peer, ps, _VoteSetReader.from_commit(commit)):
                        await asyncio.sleep(0)
                        continue
                await self._gossip_idle(waker, sleep, "votes")
        except asyncio.CancelledError:
            pass

    def _gossip_votes_for_height(self, rs, ps: PeerState, peer: Peer) -> bool:
        """(reactor.go:789)"""
        prs = ps.prs
        val_size = rs.validators.size() if rs.validators else 0
        ps.ensure_vote_bit_arrays(prs.height, val_size)

        # last commit while peer catches up to NewHeight
        if (prs.step == RoundStep.NEW_HEIGHT and rs.last_commit is not None
                and self._pick_send_vote(
                    peer, ps, _VoteSetReader.from_vote_set(rs.last_commit))):
            return True
        # POL prevotes
        if prs.step <= RoundStep.PROPOSE and 0 <= prs.proposal_pol_round:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._pick_send_vote(
                    peer, ps, _VoteSetReader.from_vote_set(pol)):
                return True
        # prevotes for peer's round
        if prs.step <= RoundStep.PREVOTE_WAIT and 0 <= prs.round <= rs.round:
            pv = rs.votes.prevotes(prs.round)
            if pv is not None and self._pick_send_vote(
                    peer, ps, _VoteSetReader.from_vote_set(pv)):
                return True
        # precommits for peer's round
        if prs.step <= RoundStep.PRECOMMIT_WAIT and 0 <= prs.round <= rs.round:
            pc = rs.votes.precommits(prs.round)
            if pc is not None and self._pick_send_vote(
                    peer, ps, _VoteSetReader.from_vote_set(pc)):
                return True
        if 0 <= prs.proposal_pol_round:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._pick_send_vote(
                    peer, ps, _VoteSetReader.from_vote_set(pol)):
                return True
        return False

    def _pick_send_vote(self, peer: Peer, ps: PeerState,
                        reader: _VoteSetReader) -> bool:
        vote = ps.pick_vote_to_send(reader)
        if vote is None:
            return False
        if peer.try_send(VOTE_CHANNEL, self._encode_cache.vote(vote)):
            ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
            return True
        return False

    # -- maj23 queries (reactor.go:849 queryMaj23Routine) ------------------

    async def _query_maj23_routine(self, peer: Peer, ps: PeerState) -> None:
        sleep = self.cs.config.peer_query_maj23_sleep_duration
        try:
            while peer.is_running():
                await asyncio.sleep(sleep)
                rs = self.cs.rs
                prs = ps.prs
                if rs.height != prs.height or rs.votes is None:
                    continue
                for type_, vs in ((SignedMsgType.PREVOTE, rs.votes.prevotes(prs.round)),
                                  (SignedMsgType.PRECOMMIT, rs.votes.precommits(prs.round))):
                    if vs is None or prs.round < 0:
                        continue
                    maj23, ok = vs.two_thirds_majority()
                    if ok:
                        peer.try_send(STATE_CHANNEL, encode_msg(VoteSetMaj23Message(
                            prs.height, prs.round, type_, maj23)))
        except asyncio.CancelledError:
            pass


def _compare_hrs(h1: int, r1: int, s1: RoundStep,
                 h2: int, r2: int, s2: RoundStep) -> int:
    """(consensus/types/peer_round_state.go CompareHRS semantics)"""
    if (h1, r1, int(s1)) < (h2, r2, int(s2)):
        return -1
    if (h1, r1, int(s1)) == (h2, r2, int(s2)):
        return 0
    return 1


def _validate_nrs(msg: NewRoundStepMessage, initial_height: int) -> None:
    if msg.height < initial_height and msg.height != 0:
        raise ValueError(f"invalid NewRoundStep height {msg.height}")
    if msg.round < 0 or int(msg.step) < 1 or int(msg.step) > 8:
        raise ValueError("invalid NewRoundStep round/step")
