"""The consensus state machine (reference consensus/state.go:78).

A single async task (`receive_routine`) serializes every input — peer
messages, our own signed messages, timeouts — exactly like the reference's
single-goroutine receiveRoutine (state.go:707). State transitions happen only
inside it. WAL-before-act discipline: every message is logged (fsync for our
own) before it mutates the round state.

All enter* transitions are synchronous functions: one message is processed
atomically from queue-pop to quiescence, which is the asyncio equivalent of
the reference's per-message mutex hold.

A fault of the card is no verdict about a block. ``validate_block``
verifies the proposal's LastCommit on the card (the vote batcher's sibling
plane, ``crypto/batch.py``); what ``device.is_device_fault`` names is
re-raised at each of its call sites and counted once on
``crypto_device_errors_total{reason, plane}``:

* the prevote step casts no prevote from it (the JAX package prevotes nil,
  "ProposalBlock is invalid"); the pending propose timeout enters the
  prevote step again;
* the precommit lock casts no precommit from it;
* ``_finalize_commit``'s own check leaves the height in COMMIT and
  schedules a COMMIT timeout that tries the finalize again (the JAX package
  has no such trigger). A fault out of ``apply_block`` is not retried: it
  may come after the app executed the block (the Merkle app's commit hashes
  on the card), and a second finalize would execute it again. It is
  counted and raised, as the JAX package raises it.

A malformed block keeps the JAX behaviour: a nil prevote.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..crypto.breaker import count_device_error
from ..device import is_device_fault
from ..libs.trace import tracer
from ..state import BlockExecutor, State
from ..state.store import StateStore
from ..store import BlockStore
from ..types import PrivValidator, ValidatorSet
from ..types.basic import BlockID, PartSetHeader, SignedMsgType
from ..types.block import Block, Commit
from ..types.errors import ErrVoteConflictingVotes
from ..types.event_bus import (
    EventBus,
    EventDataCompleteProposal,
    EventDataNewRound,
    EventDataRoundState,
)
from ..types.part_set import Part, PartSet
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..types.vote_set import VoteSetError
from .aggregated import check_aggregated_commit_time
from .config import ConsensusConfig
from .round_state import (
    HeightVoteSet,
    RoundState,
    RoundStep,
    commit_to_vote_set,
)
from .wal import WAL, NilWAL, TimeoutInfo

logger = logging.getLogger("tmtpu.consensus")


# --- messages (consensus/msgs.go domain side) ------------------------------

@dataclass
class ProposalMessage:
    proposal: Proposal


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass
class VoteMessage:
    vote: Vote


@dataclass
class _MsgInfo:
    msg: object
    peer_id: str  # "" == internal


def now_ns() -> int:
    return time.time_ns()


class ConsensusState:
    def __init__(self, config: ConsensusConfig, state: State,
                 block_exec: BlockExecutor, block_store: BlockStore,
                 tx_notifier=None, evpool=None,
                 wal: Optional[WAL] = None):
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.tx_notifier = tx_notifier
        self.evpool = evpool if evpool is not None else block_exec.evpool
        self.wal: WAL = wal or NilWAL()

        self.rs = RoundState()
        self.state: State = State()  # set via update_to_state

        self.priv_validator: Optional[PrivValidator] = None
        self.priv_validator_pub_key = None

        self.event_bus: Optional[EventBus] = None
        # internal event switch (reference evsw): reactor hooks
        self.new_round_step_listeners: List[Callable[[RoundState], None]] = []
        self.valid_block_listeners: List[Callable[[RoundState], None]] = []
        self.vote_listeners: List[Callable[[Vote], None]] = []
        # fired when new gossip-able proposal data lands (proposal accepted /
        # block part added) — the reactor wakes per-peer data routines here
        # instead of them polling on peer_gossip_sleep_duration
        self.proposal_data_listeners: List[Callable[[], None]] = []
        # maverick hook: votes pushed STRAIGHT to peers, bypassing our own
        # VoteSet (which rightly rejects equivocations)
        self.equivocation_listeners: List[Callable[[Vote], None]] = []

        # HOT LOOP #1 seam: gossiped-vote signature checks go through a
        # micro-batching verifier (crypto/vote_batcher.py). The reactor
        # pre-verifies concurrently in batches; the single-writer loop then
        # consumes cached verdicts via VoteSet.add_vote.
        from ..crypto.vote_batcher import BatchVoteVerifier
        self.vote_verifier = BatchVoteVerifier()
        self.metrics = None  # ConsensusMetrics, wired by the node
        # per-height stage timeline (consensus/timeline.py): wall-clock
        # marks at each stage of every height, sealed at commit into
        # stage_seconds histograms + height-tagged trace spans + a bounded
        # ring served over RPC/debugdump. Always on — a mark is a couple of
        # clock reads and dict stores per stage per height.
        from .timeline import StageTimeline
        self.timeline = StageTimeline()
        # adaptive round timeouts (opt-in, config.timeout_mode): a pure
        # EWMA fold over the timeline's sealed per-height durations —
        # spec mode leaves self.adaptive None and every timeout lookup
        # byte-identical to the fixed schedule
        config.validate_timeout_mode()
        self.adaptive = None
        if config.timeout_mode == "adaptive":
            from .config import AdaptiveTimeouts
            self.adaptive = AdaptiveTimeouts(config)
            self.timeline.on_seal = self.adaptive.observe
        # seeded clock-skew plane (libs/faults.py "clock.skew"): this
        # node's deterministic wall-clock offset, threaded through the
        # consensus-visible timestamps via _now_ns; assigned when the priv
        # validator is wired (its address is the stable per-node identity)
        self.clock_skew_ns = 0
        # byzantine test hooks (the reference's maverick node,
        # test/maverick/consensus/misbehavior.go): height -> behavior name.
        # Supported: "double-prevote" (equivocate at prevote). Only MockPV
        # signers cooperate — FilePV's double-sign protection refuses.
        self.misbehaviors: dict = {}

        self._queue: "asyncio.Queue" = asyncio.Queue(maxsize=1000)
        self.wal.sync_deadline_s = config.wal_sync_deadline
        self._timeout_task: Optional[asyncio.Task] = None
        self._pending_timeout: Optional[TimeoutInfo] = None
        self._receive_task: Optional[asyncio.Task] = None
        self._stopped = False
        self.n_steps = 0
        self._replay_mode = False

        # reconstruct BEFORE update: updateToState requires rs.last_commit
        # when starting on an existing chain (reference state.go NewState)
        self.reconstruct_last_commit(state)
        self.update_to_state(state)

    # -- wiring ------------------------------------------------------------

    def set_priv_validator(self, pv: Optional[PrivValidator]) -> None:
        self.priv_validator = pv
        if pv is not None:
            self.priv_validator_pub_key = pv.get_pub_key()
            from ..libs.faults import faults
            if faults.armed("clock.skew"):
                ident = self.priv_validator_pub_key.address().hex()
                self.clock_skew_ns = faults.skew_ns("clock.skew", ident)

    def set_event_bus(self, bus: EventBus) -> None:
        self.event_bus = bus

    def _now_ns(self) -> int:
        """Wall clock as THIS node sees it: now_ns() plus the node's
        deterministic clock.skew offset. Only consensus-VISIBLE timestamps
        (votes, proposals, commit time) read the skewed clock — WAL
        records and timeout scheduling stay on the unskewed local clock,
        mirroring a real deployment where a skewed clock changes what a
        node claims, not how fast its timers run."""
        return now_ns() + self.clock_skew_ns

    def _round_timeout_s(self, kind: str, round_: int) -> float:
        """Round timeout per config.timeout_mode: the fixed spec schedule
        (``config.propose/prevote/precommit``) or the adaptive
        controller's clamped EWMA baseline plus the same per-round delta."""
        if self.adaptive is not None:
            return self.adaptive.timeout(kind, round_)
        return getattr(self.config, kind)(round_)

    def _note_round_advance(self, reason: str) -> None:
        """Degraded-network telemetry: count a round-escalation event
        (series tendermint_consensus_round_advances_total{reason})."""
        if self.metrics is not None:
            self.metrics.round_advances_total.labels(reason).inc()

    # -- external input (reactor → queues) ---------------------------------

    async def add_peer_msg(self, msg, peer_id: str) -> None:
        await self._queue.put(_MsgInfo(msg, peer_id))

    def send_internal(self, msg) -> None:
        """Internal messages must not be dropped (state.go sendInternalMessage)."""
        self._queue.put_nowait(_MsgInfo(msg, ""))

    async def set_proposal_and_block(self, proposal: Proposal, parts: PartSet,
                                     peer_id: str) -> None:
        """Test/replay helper mirroring the reference's blocking variant."""
        await self.add_peer_msg(ProposalMessage(proposal), peer_id)
        for i in range(parts.total):
            await self.add_peer_msg(
                BlockPartMessage(proposal.height, proposal.round, parts.get_part(i)),
                peer_id)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """(state.go:299 OnStart — minus WAL catchup, see replay.py)"""
        self._receive_task = asyncio.create_task(self.receive_routine(),
                                                 name=f"cs-receive-{id(self)}")
        self._schedule_round0()

    async def stop(self) -> None:
        self._stopped = True
        if self._timeout_task is not None:
            self._timeout_task.cancel()
        if self._receive_task is not None:
            self._receive_task.cancel()
            try:
                await self._receive_task
            except asyncio.CancelledError:
                pass
        self.wal.close()

    def _record_commit_metrics(self, block) -> None:
        """(consensus/metrics.go series recorded at commit)"""
        m = self.metrics
        m.height.set(block.header.height)
        m.rounds.set(self.rs.round)
        vals = self.rs.validators
        if vals is not None:
            m.validators.set(vals.size())
            m.validators_power.set(vals.total_voting_power())
        if block.last_commit is not None and self.rs.last_validators is not None:
            lvals = self.rs.last_validators
            missing = missing_power = 0
            our_addr = (self.priv_validator.get_pub_key().address()
                        if self.priv_validator is not None else None)
            aggregated = hasattr(block.last_commit, "agg_sig")
            for i in range(block.last_commit.size()):
                if aggregated:
                    absent = not block.last_commit.signers.get_index(i)
                else:
                    absent = block.last_commit.signatures[i].absent()
                _, val = lvals.get_by_index(i)
                if absent:
                    missing += 1
                    if val is not None:
                        missing_power += val.voting_power
                        if our_addr is not None and val.address == our_addr:
                            m.validator_missed_blocks.inc()
                elif (val is not None and our_addr is not None
                        and val.address == our_addr):
                    m.validator_last_signed_height.set(
                        block.header.height - 1)
            m.missing_validators.set(missing)
            m.missing_validators_power.set(missing_power)
        if vals is not None and self.priv_validator is not None:
            _, us = vals.get_by_address(
                self.priv_validator.get_pub_key().address())
            m.validator_power.set(us.voting_power if us is not None else 0)
        m.committed_height.set(block.header.height)
        m.latest_block_height.set(block.header.height)
        m.num_txs.set(len(block.data.txs))
        # block size from the part set already in hand — re-encoding a
        # potentially huge block inside the single-writer loop just for a
        # gauge would delay the next height
        parts = self.rs.proposal_block_parts
        if parts is not None:
            m.block_size_bytes.set(parts.byte_size)
        m.total_txs.inc(len(block.data.txs))
        # (reference state.go recordMetrics) byzantine gauges count the
        # EQUIVOCATING VALIDATORS, not evidence items: LightClientAttack
        # carries its validator list; DuplicateVote names one validator by
        # address, resolved against the current set for its power
        byz_power = 0
        byz_validators = set()
        for ev in block.evidence:
            lc_vals = getattr(ev, "byzantine_validators", None)
            if lc_vals:
                for v in lc_vals:
                    if v.address not in byz_validators:  # dedup across items
                        byz_validators.add(v.address)
                        byz_power += getattr(v, "voting_power", 0)
                continue
            vote_a = getattr(ev, "vote_a", None)
            if vote_a is not None:
                addr = vote_a.validator_address
                if addr not in byz_validators:
                    byz_validators.add(addr)
                    if vals is not None:
                        _, val = vals.get_by_address(addr)
                        if val is not None:
                            byz_power += val.voting_power
        m.byzantine_validators.set(len(byz_validators))
        m.byzantine_validators_power.set(byz_power)
        if self.state.last_block_time_ns:
            m.block_interval_seconds.observe(
                max(0.0, (block.header.time_ns - self.state.last_block_time_ns)
                    / 1e9))

    def _schedule_round0(self) -> None:
        sleep_s = max(0.0, (self.rs.start_time_ns - now_ns()) / 1e9)
        self._schedule_timeout(sleep_s, self.rs.height, 0, RoundStep.NEW_HEIGHT)

    # -- timeout ticker (consensus/ticker.go: one timeout at a time) -------

    def _schedule_timeout(self, duration_s: float, height: int, round_: int,
                          step: RoundStep) -> None:
        ti = TimeoutInfo(duration_s, height, round_, int(step))
        old = self._pending_timeout
        # ignore timeouts for an earlier-or-equal (H,R,S) than the last one
        # scheduled (ticker.go:94 timeoutRoutine) — a stray earlier-step
        # schedule must not cancel a later-step timeout (liveness hazard)
        if old is not None:
            if ti.height < old.height:
                return
            if ti.height == old.height:
                if ti.round < old.round:
                    return
                if ti.round == old.round and old.step > 0 and ti.step <= old.step:
                    return
        if self._timeout_task is not None:
            self._timeout_task.cancel()
        self._pending_timeout = ti
        self._timeout_task = asyncio.create_task(self._fire_timeout(ti))

    async def _fire_timeout(self, ti: TimeoutInfo) -> None:
        try:
            await asyncio.sleep(ti.duration_s)
        except asyncio.CancelledError:
            return
        await self._queue.put(ti)

    # -- the single-writer loop (state.go:707) -----------------------------

    async def receive_routine(self) -> None:
        grouped = self.config.wal_group_commit
        max_batch = (max(1, self.config.wal_group_commit_max_batch)
                     if grouped else 1)
        while not self._stopped:
            # queue.get() on a non-empty queue does not suspend; without this
            # yield a busy chain (internal msgs re-enqueue forever) starves
            # every other task and timer on the loop.
            await asyncio.sleep(0)
            item = await self._queue.get()
            batch = [item]
            while len(batch) < max_batch and not self._queue.empty():
                batch.append(self._queue.get_nowait())
            # phase 1 — WAL every record in the batch under ONE group commit
            # (a single fsync covers all own messages), BEFORE any of them
            # acts on the round state: an own message is always durable
            # before the transition that exposes it to gossip, exactly the
            # reference's per-record write-sync-then-handle guarantee with
            # the syncs coalesced. A record that fails to write drops its
            # message from phase 2 (as a failed write always skipped the
            # handle), without dropping the rest of the batch.
            loggable = []
            try:
                # with group commit disabled this is the exact legacy path:
                # batch size 1, no group() — own records fsync per record,
                # peer records are flushed but never fsynced
                ctx = (self.wal.group() if grouped
                       else contextlib.nullcontext())
                with tracer.span("wal_group", n=len(batch),
                                 height=self.rs.height), ctx:
                    for it in batch:
                        try:
                            if isinstance(it, TimeoutInfo):
                                self.wal.write_timeout(it, now_ns())
                            elif isinstance(it, _MsgInfo):
                                self.wal.write_msg_info(
                                    it.msg, it.peer_id, now_ns(),
                                    internal=it.peer_id == "")
                            loggable.append(it)
                        except asyncio.CancelledError:
                            raise
                        except Exception:
                            logger.exception(
                                "error writing consensus WAL record "
                                "(height=%d round=%d step=%s)",
                                self.rs.height, self.rs.round, self.rs.step)
            except asyncio.CancelledError:
                raise
            except Exception:
                # the group's deferred flush/fsync failed (disk full, EIO):
                # the batch's records may not be durable. Match the
                # per-record behavior — a failed sync skipped that message —
                # by dropping OWN messages from handling (their durability
                # rule would be violated) while peer messages, which were
                # never synced in the reference either, still proceed. The
                # loop itself must survive: it is an unsupervised task.
                logger.exception(
                    "consensus WAL group commit failed "
                    "(height=%d round=%d step=%s); dropping own messages "
                    "from this batch", self.rs.height, self.rs.round,
                    self.rs.step)
                loggable = [it for it in loggable
                            if not (isinstance(it, _MsgInfo)
                                    and it.peer_id == "")]
            # phase 2 — handle in arrival order. A commit inside the batch
            # writes its #ENDHEIGHT marker AFTER records phase 1 already
            # appended, and crash replay reads only messages after the LAST
            # marker — so any not-yet-handled records of this batch would be
            # invisible to recovery. Re-log the remainder after the marker:
            # replay skips the pre-marker copies and sees exactly the record
            # sequence per-record sync would have produced. (Own messages
            # for the new height cannot be in the remainder — the state
            # machine only enqueues them after the commit ran, i.e. into a
            # later batch — so the re-log needs no fsync of its own.)
            for i, it in enumerate(loggable):
                committed_h = self.state.last_block_height
                try:
                    if isinstance(it, TimeoutInfo):
                        self._handle_timeout(it)
                    elif isinstance(it, _MsgInfo):
                        self._handle_msg(it)
                    elif it == "txs_available":
                        self._handle_txs_available()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("error in consensus receive routine "
                                     "(height=%d round=%d step=%s)",
                                     self.rs.height, self.rs.round, self.rs.step)
                rest = loggable[i + 1:]
                if self.state.last_block_height == committed_h or not rest:
                    continue
                try:
                    with self.wal.group():
                        for rem in rest:
                            if isinstance(rem, TimeoutInfo):
                                self.wal.write_timeout(rem, now_ns())
                            elif isinstance(rem, _MsgInfo):
                                self.wal.write_msg_info(
                                    rem.msg, rem.peer_id, now_ns(),
                                    internal=rem.peer_id == "")
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # the pre-marker copies are still on disk (just not
                    # replayed after a crash) and any own record was already
                    # fsynced in phase 1 — keep handling
                    logger.exception(
                        "error re-logging batch remainder after commit "
                        "(height=%d)", self.state.last_block_height)

    def _handle_msg(self, mi: _MsgInfo) -> None:
        """(state.go:799 handleMsg)"""
        msg, peer_id = mi.msg, mi.peer_id
        if isinstance(msg, ProposalMessage):
            self._set_proposal(msg.proposal)
        elif isinstance(msg, BlockPartMessage):
            added = self._add_proposal_block_part(msg, peer_id)
            if added and self.rs.proposal_block_parts.is_complete():
                self._handle_complete_proposal(msg.height)
        elif isinstance(msg, VoteMessage):
            self._try_add_vote(msg.vote, peer_id)
        else:
            logger.error("unknown msg type %s", type(msg))

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """(state.go:890 handleTimeout)"""
        rs = self.rs
        if (ti.height != rs.height or ti.round < rs.round
                or (ti.round == rs.round and ti.step < int(rs.step))):
            return
        step = RoundStep(ti.step)
        if step == RoundStep.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif step == RoundStep.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif step == RoundStep.PROPOSE:
            if self.event_bus:
                self.event_bus.publish_event_timeout_propose(self._round_state_event())
            self._note_round_advance("timeout_propose")
            self._enter_prevote(ti.height, ti.round)
        elif step == RoundStep.PREVOTE_WAIT:
            if self.event_bus:
                self.event_bus.publish_event_timeout_wait(self._round_state_event())
            self._note_round_advance("timeout_prevote")
            self._enter_precommit(ti.height, ti.round)
        elif step == RoundStep.PRECOMMIT_WAIT:
            if self.event_bus:
                self.event_bus.publish_event_timeout_wait(self._round_state_event())
            self._note_round_advance("timeout_precommit")
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        elif step == RoundStep.COMMIT:
            # scheduled by a finalize that a fault of the card stopped
            self._try_finalize_commit(ti.height)
        else:
            raise ValueError(f"invalid timeout step: {step}")

    def _handle_txs_available(self) -> None:
        """(state.go:939 handleTxsAvailable)"""
        if self.rs.round != 0:
            return
        if self.rs.step == RoundStep.NEW_HEIGHT:
            if self._need_proof_block(self.rs.height):
                return
            timeout_commit = (self.rs.start_time_ns - now_ns()) / 1e9 + 0.001
            self._schedule_timeout(max(timeout_commit, 0.001), self.rs.height, 0,
                                   RoundStep.NEW_ROUND)
        elif self.rs.step == RoundStep.NEW_ROUND:
            self._enter_propose(self.rs.height, 0)

    def notify_txs_available(self) -> None:
        self._queue.put_nowait("txs_available")

    # -- state update ------------------------------------------------------

    def update_to_state(self, state: State) -> None:
        """(state.go:574 updateToState)"""
        from ..crypto import schemes

        # idempotent: keeps the scheme registry current with the chain's
        # consensus params (they can change via EndBlock updates)
        schemes.register_chain(state.chain_id,
                               state.consensus_params.signature)
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState() expected state height of {rs.height} but found "
                f"{state.last_block_height}")
        if not self.state.is_empty():
            if (self.state.last_block_height > 0
                    and self.state.last_block_height + 1 != rs.height):
                raise RuntimeError(
                    f"inconsistent cs.state.LastBlockHeight+1 "
                    f"{self.state.last_block_height + 1} vs cs.Height {rs.height}")
            if state.last_block_height <= self.state.last_block_height:
                self._new_step()
                return

        if state.last_block_height == 0:
            rs.last_commit = None
        elif rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if not precommits.has_two_thirds_majority():
                raise RuntimeError(
                    f"wanted to form a commit, but precommits (H/R: "
                    f"{state.last_block_height}/{rs.commit_round}) didn't have 2/3+")
            rs.last_commit = precommits
        elif rs.last_commit is None:
            raise RuntimeError(
                f"last commit cannot be empty after initial block "
                f"(H:{state.last_block_height + 1})")

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        rs.height = height
        rs.round = 0
        rs.step = RoundStep.NEW_HEIGHT
        if rs.commit_time_ns == 0:
            rs.start_time_ns = self.config.commit_time_ns(now_ns())
        else:
            rs.start_time_ns = self.config.commit_time_ns(rs.commit_time_ns)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, state.validators,
                                 verifier=self.vote_verifier)
        rs.commit_round = -1
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state
        self.timeline.begin_height(height)
        self._new_step()

    def reconstruct_last_commit(self, state: State) -> None:
        """(state.go:550 reconstructLastCommit)"""
        if state.last_block_height == 0:
            return
        seen_commit = self.block_store.load_seen_commit(state.last_block_height)
        if seen_commit is None:
            raise RuntimeError(
                f"failed to reconstruct last commit; seen commit for height "
                f"{state.last_block_height} not found")
        last_precommits = commit_to_vote_set(state.chain_id, seen_commit,
                                             state.last_validators)
        if not last_precommits.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit; does not have +2/3 maj")
        self.rs.last_commit = last_precommits

    def _new_step(self) -> None:
        rs_event = self._round_state_event()
        self.wal.write_round_step(self.rs.height, self.rs.round, int(self.rs.step),
                                  now_ns())
        self.n_steps += 1
        if self.event_bus is not None:
            self.event_bus.publish_event_new_round_step(rs_event)
        for listener in self.new_round_step_listeners:
            listener(self.rs)

    def _round_state_event(self) -> EventDataRoundState:
        return EventDataRoundState(self.rs.height, self.rs.round,
                                   self.rs.step.short_name())

    # -- step transitions --------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        """(state.go:976)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT)):
            return
        logger.debug("entering new round %d/%d", height, round_)

        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)

        rs.round = round_
        rs.step = RoundStep.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track next round for skipping
        rs.triggered_timeout_precommit = False

        if self.event_bus:
            proposer = validators.get_proposer()
            idx, _ = validators.get_by_address(proposer.address)
            self.event_bus.publish_event_new_round(EventDataNewRound(
                height, round_, rs.step.short_name(), proposer.address, idx))

        wait_for_txs = (self.config.wait_for_txs() and round_ == 0
                        and not self._need_proof_block(height))
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(self.config.create_empty_blocks_interval,
                                       height, round_, RoundStep.NEW_ROUND)
            # else wait for notify_txs_available
        else:
            self._enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        if height == self.state.initial_height:
            return True
        last_meta = self.block_store.load_block_meta(height - 1)
        if last_meta is None:
            raise RuntimeError(f"needProofBlock: last block meta for height {height - 1} not found")
        return self.state.app_hash != last_meta.header.app_hash

    def _enter_propose(self, height: int, round_: int) -> None:
        """(state.go:1060)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= RoundStep.PROPOSE)):
            return
        logger.debug("entering propose %d/%d", height, round_)
        try:
            self._schedule_timeout(self._round_timeout_s("propose", round_),
                                   height, round_, RoundStep.PROPOSE)
            if self.priv_validator is None or self.priv_validator_pub_key is None:
                return
            address = self.priv_validator_pub_key.address()
            if not rs.validators.has_address(address):
                return
            if rs.validators.get_proposer().address == address:
                self._decide_proposal(height, round_)
        finally:
            rs.round = round_
            rs.step = RoundStep.PROPOSE
            self._new_step()
            if self._is_proposal_complete():
                self._enter_prevote(height, rs.round)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """(state.go:1124 defaultDecideProposal)"""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            commit: Optional[Commit]
            if height == self.state.initial_height:
                commit = Commit(0, 0, BlockID(), [])
            elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
                commit = rs.last_commit.make_commit()
            else:
                logger.error("propose step; cannot propose anything without commit for the previous block")
                return
            proposer_addr = self.priv_validator_pub_key.address()
            block, block_parts = self.block_exec.create_proposal_block(
                height, self.state, commit, proposer_addr)

        block_id = BlockID(block.hash(), block_parts.header())
        proposal = Proposal(height, round_, rs.valid_round, block_id,
                            self._now_ns())
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:
            if not self._replay_mode:
                logger.error("propose step; failed signing proposal: %s", e)
            return
        self.send_internal(ProposalMessage(proposal))
        for i in range(block_parts.total):
            self.send_internal(BlockPartMessage(rs.height, round_, block_parts.get_part(i)))
        # ingestion-plane lifecycle: the proposer stamps proposal_included
        # at creation (followers stamp at complete-proposal decode)
        tl = self._txlife()
        if tl is not None and tl.tracking():
            for tx in block.data.txs:
                tl.mark_tx(tx, "proposal_included", height=height)
        logger.info("signed proposal %d/%d", height, round_)

    def _txlife(self):
        """The per-node tx lifecycle tracker (libs/txlife.py), reached
        through the mempool it is wired onto (NoOpMempool and bare test
        mempools simply have none)."""
        return getattr(getattr(self.block_exec, "mempool", None),
                       "txlife", None)

    def _is_proposal_complete(self) -> bool:
        """(state.go isProposalComplete)"""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    def _enter_prevote(self, height: int, round_: int) -> None:
        """(state.go:1226)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= RoundStep.PREVOTE)):
            return
        logger.debug("entering prevote %d/%d", height, round_)
        self._do_prevote(height, round_)
        rs.round = round_
        rs.step = RoundStep.PREVOTE
        self._new_step()

    def _do_prevote(self, height: int, round_: int) -> None:
        """(state.go:1252 defaultDoPrevote; maverick hook at the top —
        misbehavior.go PrevoteForBlockAndNil)"""
        rs = self.rs
        if self.misbehaviors.get(height) == "double-prevote" \
                and rs.proposal_block is not None \
                and self.priv_validator is not None:
            logger.warning("MISBEHAVIOR double-prevote at height %d", height)
            self._sign_add_vote(SignedMsgType.PREVOTE, rs.proposal_block.hash(),
                                rs.proposal_block_parts.header())
            try:
                # equivocate: a second, conflicting nil prevote straight to
                # the reactors (our own VoteSet would reject it; peers must
                # see it). A refusing signer (FilePV) must not abort the
                # step transition — misbehaving is best-effort.
                nil_vote = self._sign_vote(SignedMsgType.PREVOTE, b"",
                                           PartSetHeader())
                for listener in self.equivocation_listeners:
                    listener(nil_vote)
            except Exception as e:
                logger.error("double-prevote equivocation refused: %s", e)
            return
        if rs.locked_block is not None:
            self._sign_add_vote(SignedMsgType.PREVOTE, rs.locked_block.hash(),
                                rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
            self._check_aggregated_commit_time(rs.proposal_block)
        except Exception as e:
            if is_device_fault(e):
                # the card failed, not the block: no nil prevote from it
                count_device_error(e, "votes")
                raise
            logger.error("prevote step: ProposalBlock is invalid: %s", e)
            self._sign_add_vote(SignedMsgType.PREVOTE, b"", PartSetHeader())
            return
        self._sign_add_vote(SignedMsgType.PREVOTE, rs.proposal_block.hash(),
                            rs.proposal_block_parts.header())

    def _check_aggregated_commit_time(self, block) -> None:
        """Subjective BFT-time guard for aggregated commits, prevote-only.

        Aggregated precommits sign zero-timestamp bytes (schemes
        AGG_ZERO_TS_NS), so AggregatedCommit.timestamp_ns — and with it
        header.time_ns, which validate_block pins to it — is
        proposer-assembled and covered by NO signature.  Deterministic
        validation can only enforce monotonicity; the rest of BFT time is
        recovered here, subjectively, before prevoting: the proposed
        last-commit timestamp must sit within agg_commit_time_drift_s of
        the precommit timestamps this node itself recorded for the previous
        height (when it tracked them) and never run ahead of the local
        clock by more than the drift.  A proposer-invented future time then
        draws nil prevotes from every honest validator and cannot reach a
        quorum.  Plain CommitSig commits carry signed per-vote timestamps
        and need none of this."""
        commit = block.last_commit
        if commit is None or not hasattr(commit, "agg_sig"):
            return
        drift_s = self.config.agg_commit_time_drift_s
        if drift_s <= 0:
            return
        seen_ts = []
        if self.rs.last_commit is not None:
            seen_ts = [v.timestamp_ns for v in self.rs.last_commit.list_votes()
                       if v.block_id == commit.block_id
                       and commit.signers.get_index(v.validator_index)]
        check_aggregated_commit_time(commit, seen_ts, self._now_ns(),
                                     int(drift_s * 1e9))

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        """(state.go:1286)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT)):
            return
        if not rs.votes.prevotes(round_).has_two_thirds_any():
            raise RuntimeError(
                f"entering prevote wait step ({height}/{round_}), but prevotes "
                f"does not have any +2/3 votes")
        logger.debug("entering prevote wait %d/%d", height, round_)
        rs.round = round_
        rs.step = RoundStep.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(self._round_timeout_s("prevote", round_),
                               height, round_, RoundStep.PREVOTE_WAIT)

    def _enter_precommit(self, height: int, round_: int) -> None:
        """(state.go:1322)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.step >= RoundStep.PRECOMMIT)):
            return
        logger.debug("entering precommit %d/%d", height, round_)

        def done():
            rs.round = round_
            rs.step = RoundStep.PRECOMMIT
            self._new_step()

        block_id, ok = rs.votes.prevotes(round_).two_thirds_majority()

        if not ok:
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
            done()
            return

        if self.event_bus:
            self.event_bus.publish_event_polka(self._round_state_event())

        pol_round, _ = rs.votes.pol_info()
        if pol_round < round_:
            raise RuntimeError(f"this POLRound should be {round_} but got {pol_round}")

        # +2/3 prevoted nil: unlock and precommit nil
        if len(block_id.hash) == 0:
            if rs.locked_block is not None:
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
                if self.event_bus:
                    self.event_bus.publish_event_unlock(self._round_state_event()) \
                        if hasattr(self.event_bus, "publish_event_unlock") else None
            self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
            done()
            return

        # already locked on this block: relock
        if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
            rs.locked_round = round_
            if self.event_bus:
                self.event_bus.publish_event_relock(self._round_state_event())
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                block_id.part_set_header)
            done()
            return

        # +2/3 prevoted our proposal block: lock it
        if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
            try:
                self.block_exec.validate_block(self.state, rs.proposal_block)  # panics on bad
            except Exception as e:
                if is_device_fault(e):
                    # no precommit from a fault of the card
                    count_device_error(e, "votes")
                raise
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            if self.event_bus:
                self.event_bus.publish_event_lock(self._round_state_event())
            self._sign_add_vote(SignedMsgType.PRECOMMIT, block_id.hash,
                                block_id.part_set_header)
            done()
            return

        # polka for a block we don't have: unlock, fetch, precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.part_set_header):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
        self._sign_add_vote(SignedMsgType.PRECOMMIT, b"", PartSetHeader())
        done()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        """(state.go:1439)"""
        rs = self.rs
        if (rs.height != height or round_ < rs.round
                or (rs.round == round_ and rs.triggered_timeout_precommit)):
            return
        if not rs.votes.precommits(round_).has_two_thirds_any():
            raise RuntimeError(
                f"entering precommit wait step ({height}/{round_}), but precommits "
                f"does not have any +2/3 votes")
        logger.debug("entering precommit wait %d/%d", height, round_)
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(self._round_timeout_s("precommit", round_),
                               height, round_, RoundStep.PRECOMMIT_WAIT)

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """(state.go:1476)"""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        logger.debug("entering commit %d/%d", height, commit_round)

        try:
            block_id, ok = rs.votes.precommits(commit_round).two_thirds_majority()
            if not ok:
                raise RuntimeError("enterCommit expects +2/3 precommits")

            if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts

            if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
                if (rs.proposal_block_parts is None
                        or not rs.proposal_block_parts.has_header(block_id.part_set_header)):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
                    if self.event_bus:
                        self.event_bus.publish_event_valid_block(self._round_state_event())
                    for listener in self.valid_block_listeners:
                        listener(rs)
        finally:
            # keep rs.round; commit_round points at the right precommit set
            rs.step = RoundStep.COMMIT
            rs.commit_round = commit_round
            rs.commit_time_ns = self._now_ns()
            self._new_step()
            self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        """(state.go:1539)"""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError(f"tryFinalizeCommit() cs.Height: {rs.height} vs {height}")
        block_id, ok = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if not ok or len(block_id.hash) == 0:
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """(state.go:1567)"""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        block_id, ok = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not ok:
            raise RuntimeError("cannot finalize commit; commit does not have 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise RuntimeError("expected ProposalBlockParts header to be commit header")
        if block.hash() != block_id.hash:
            raise RuntimeError("cannot finalize commit; proposal block does not hash to commit hash")
        try:
            self.block_exec.validate_block(self.state, block)
        except Exception as e:
            # a fault of the card before any ABCI call: the height stays in
            # COMMIT, and a COMMIT timeout tries the finalize again
            if is_device_fault(e):
                count_device_error(e, "votes")
                self._schedule_timeout(self.config.timeout_commit, height,
                                       rs.round, RoundStep.COMMIT)
            raise

        logger.info("finalizing commit of block height=%d hash=%s txs=%d",
                    height, block.hash().hex()[:12], len(block.data.txs))

        # seals the height's stage timeline: observes stage_seconds and
        # emits the per-stage trace spans (consensus/timeline.py)
        self.timeline.mark(height, rs.commit_round, "commit_finalized")

        # seal sampled tx lifecycles at the consensus commit point; the
        # mempool.update() mark inside apply_block is the fallback for
        # blocks applied off the consensus path (fast sync)
        tl = self._txlife()
        if tl is not None and tl.tracking():
            for tx in block.data.txs:
                tl.mark_tx(tx, "committed", height=height)

        if self.metrics is not None:
            self._record_commit_metrics(block)
            self.metrics.rounds_per_height.observe(rs.commit_round + 1)

        if self.block_store.height() < block.header.height:
            seen_commit = rs.votes.precommits(rs.commit_round).make_commit()
            self.block_store.save_block(block, block_parts, seen_commit)

        from ..libs.fail import fail_point

        fail_point("consensus.commit.before_end_height")  # (consensus/state.go:776 fail.Fail precommit->commit)
        # EndHeight implies blockstore has the block (crash recovery pivot).
        self.wal.write_end_height(height, now_ns())

        state_copy = self.state.copy()
        try:
            state_copy, retain_height = self.block_exec.apply_block(
                state_copy, BlockID(block.hash(), block_parts.header()),
                block)
        except Exception as e:
            # no retry: the app may have executed the block already
            if is_device_fault(e):
                count_device_error(e, "votes")
            raise

        if retain_height > 0:
            try:
                pruned = self.block_store.prune_blocks(retain_height)
                self.block_exec.state_store.prune_states(retain_height)
                logger.debug("pruned %d blocks to retain height %d", pruned, retain_height)
            except Exception as e:
                logger.error("failed to prune blocks: %s", e)

        self.update_to_state(state_copy)
        if self.priv_validator is not None:
            self.priv_validator_pub_key = self.priv_validator.get_pub_key()
        self._schedule_round0()

    # -- proposals ---------------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """(state.go:1808 defaultSetProposal)"""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (0 <= proposal.pol_round >= proposal.round):
            raise ValueError("error invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
                proposal.sign_bytes(self.state.chain_id), proposal.signature):
            raise ValueError("error invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.from_header(proposal.block_id.part_set_header)
        self.timeline.mark(proposal.height, proposal.round,
                           "proposal_received")
        logger.info("received proposal %d/%d", proposal.height, proposal.round)
        for listener in self.proposal_data_listeners:
            listener()

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> bool:
        """(state.go:1850)"""
        rs = self.rs
        if rs.height != msg.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if added:
            for listener in self.proposal_data_listeners:
                listener()
        if rs.proposal_block_parts.byte_size > self.state.consensus_params.block.max_bytes:
            raise ValueError(
                f"total size of proposal block parts exceeds maximum block bytes "
                f"({rs.proposal_block_parts.byte_size} > "
                f"{self.state.consensus_params.block.max_bytes})")
        if added and rs.proposal_block_parts.is_complete():
            rs.proposal_block = Block.decode(rs.proposal_block_parts.get_reader())
            logger.info("received complete proposal block height=%d hash=%s",
                        rs.proposal_block.header.height,
                        (rs.proposal_block.hash() or b"").hex()[:12])
            # followers stamp proposal_included when the block decodes —
            # the earliest point this node can attribute txs to a height
            tl = self._txlife()
            if tl is not None and tl.tracking():
                for tx in rs.proposal_block.data.txs:
                    tl.mark_tx(tx, "proposal_included",
                               height=rs.proposal_block.header.height)
            if self.event_bus:
                self.event_bus.publish_event_complete_proposal(
                    EventDataCompleteProposal(
                        rs.height, rs.round, rs.step.short_name(),
                        BlockID(rs.proposal_block.hash(),
                                rs.proposal_block_parts.header())))
        return added

    def _handle_complete_proposal(self, block_height: int) -> None:
        """(state.go:1911)"""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        block_id, has_two_thirds = (prevotes.two_thirds_majority()
                                    if prevotes else (BlockID(), False))
        if (has_two_thirds and not block_id.is_zero() and rs.valid_round < rs.round
                and rs.proposal_block.hash() == block_id.hash):
            rs.valid_round = rs.round
            rs.valid_block = rs.proposal_block
            rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= RoundStep.PROPOSE and self._is_proposal_complete():
            self._enter_prevote(block_height, rs.round)
            if has_two_thirds:
                self._enter_precommit(block_height, rs.round)
        elif rs.step == RoundStep.COMMIT:
            self._try_finalize_commit(block_height)

    # -- votes -------------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """(state.go:1947)"""
        try:
            return self._add_vote(vote, peer_id)
        except ErrVoteConflictingVotes as e:
            if self.priv_validator_pub_key is not None and \
                    vote.validator_address == self.priv_validator_pub_key.address():
                logger.error(
                    "found conflicting vote from ourselves; did you unsafe_reset a validator? "
                    "height=%d round=%d", vote.height, vote.round)
                return False
            if self.evpool is not None:
                self.evpool.report_conflicting_votes(e.vote_a, e.vote_b)
            logger.debug("found and sent conflicting votes to the evidence pool")
            return False
        except VoteSetError as e:
            logger.info("failed attempting to add vote: %s", e)
            return False
        except Exception as e:
            logger.info("failed attempting to add vote: %s", e)
            return False

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """(state.go:1995)"""
        rs = self.rs

        # A precommit for the previous height (during timeoutCommit wait)
        if vote.height + 1 == rs.height and vote.type == SignedMsgType.PRECOMMIT:
            if rs.step != RoundStep.NEW_HEIGHT:
                return False
            added = rs.last_commit.add_vote(vote)
            if not added:
                return False
            if self.event_bus:
                from ..types.event_bus import EventDataVote

                self.event_bus.publish_event_vote(vote)
            for listener in self.vote_listeners:
                listener(vote)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return True

        if vote.height != rs.height:
            return False

        height = rs.height
        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        if self.event_bus:
            self.event_bus.publish_event_vote(vote)
        for listener in self.vote_listeners:
            listener(vote)

        if vote.type == SignedMsgType.PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            if (not self.timeline.marked(height, "prevote_quorum")
                    and prevotes.has_two_thirds_any()):
                self.timeline.mark(height, vote.round, "prevote_quorum")
            block_id, ok = prevotes.two_thirds_majority()
            if ok:
                # unlock on newer POL for a different block
                if (rs.locked_block is not None and rs.locked_round < vote.round
                        and vote.round <= rs.round
                        and rs.locked_block.hash() != block_id.hash):
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                # update Valid*
                if (len(block_id.hash) != 0 and rs.valid_round < vote.round
                        and vote.round == rs.round):
                    if (rs.proposal_block is not None
                            and rs.proposal_block.hash() == block_id.hash):
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if (rs.proposal_block_parts is None
                            or not rs.proposal_block_parts.has_header(
                                block_id.part_set_header)):
                        rs.proposal_block_parts = PartSet.from_header(
                            block_id.part_set_header)
                    for listener in self.valid_block_listeners:
                        listener(rs)
                    if self.event_bus:
                        self.event_bus.publish_event_valid_block(self._round_state_event())

            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self._note_round_advance("polka_skip")
                self._enter_new_round(height, vote.round)
            elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and (self._is_proposal_complete() or len(block_id.hash) == 0):
                    self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vote.round)
            elif (rs.proposal is not None and 0 <= rs.proposal.pol_round
                  and rs.proposal.pol_round == vote.round):
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)

        elif vote.type == SignedMsgType.PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            if (not self.timeline.marked(height, "precommit_quorum")
                    and precommits.has_two_thirds_any()):
                self.timeline.mark(height, vote.round, "precommit_quorum")
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if len(block_id.hash) != 0:
                    self._enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        self._enter_new_round(rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                if rs.round < vote.round:
                    self._note_round_advance("polka_skip")
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)
        else:
            raise ValueError(f"unexpected vote type {vote.type}")
        return True

    # -- signing -----------------------------------------------------------

    def _vote_time_ns(self) -> int:
        """(state.go:2204 voteTime) — BFT time monotonicity. Reads the
        skewed clock (_now_ns): a node with a fast/slow wall clock stamps
        its votes accordingly, and the max() against the locked/proposal
        block time keeps BFT-time monotone regardless of the skew sign."""
        now = self._now_ns()
        min_vote_time = now
        time_iota_ns = self.state.consensus_params.block.time_iota_ms * 1_000_000
        if self.rs.locked_block is not None:
            min_vote_time = self.rs.locked_block.header.time_ns + time_iota_ns
        elif self.rs.proposal_block is not None:
            min_vote_time = self.rs.proposal_block.header.time_ns + time_iota_ns
        return now if now > min_vote_time else min_vote_time

    def _sign_vote(self, msg_type: SignedMsgType, hash_: bytes,
                   header: PartSetHeader) -> Vote:
        """(state.go:2172 signVote)"""
        self.wal.flush_and_sync()
        addr = self.priv_validator_pub_key.address()
        val_idx, _ = self.rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type,
            height=self.rs.height,
            round=self.rs.round,
            block_id=BlockID(hash_, header),
            timestamp_ns=self._vote_time_ns(),
            validator_address=addr,
            validator_index=val_idx,
        )
        self.priv_validator.sign_vote(self.state.chain_id, vote)
        return vote

    def _sign_add_vote(self, msg_type: SignedMsgType, hash_: bytes,
                       header: PartSetHeader) -> Optional[Vote]:
        """(state.go:2227 signAddVote)"""
        if self.priv_validator is None or self.priv_validator_pub_key is None:
            return None
        if not self.rs.validators.has_address(self.priv_validator_pub_key.address()):
            return None
        try:
            vote = self._sign_vote(msg_type, hash_, header)
        except Exception as e:
            if not self._replay_mode:
                logger.error("failed signing vote height=%d round=%d: %s",
                             self.rs.height, self.rs.round, e)
            return None
        self.send_internal(VoteMessage(vote))
        self.timeline.mark(self.rs.height, self.rs.round,
                           "prevote_sent" if msg_type == SignedMsgType.PREVOTE
                           else "precommit_sent")
        return vote
