"""Crash recovery (reference consensus/replay.go).

Two mechanisms:
1. WAL catch-up replay (replay.go:93 catchupReplay): re-feed logged inputs for
   the in-flight height into the state machine before going live.
2. ABCI handshake (replay.go:200 Handshaker): replay blockstore blocks into
   the app until app height == store height.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..abci import types as abci
from ..abci.client import Client
from ..crypto import phases
from ..state import BlockExecutor, State, state_from_genesis
from ..state.execution import exec_commit_block, validator_update_to_validator
from ..state.store import StateStore
from ..store import BlockStore
from ..types import GenesisDoc
from ..types.basic import BlockID
from ..types.block import BLOCK_PROTOCOL
from ..types.event_bus import EventBus
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote
from .state import BlockPartMessage, ConsensusState, ProposalMessage, VoteMessage
from .wal import TimeoutInfo, WALMessage

logger = logging.getLogger("tmtpu.replay")


# --- WAL catch-up (replay.go:38-163) ---------------------------------------

def catchup_replay(cs: ConsensusState, height: int) -> int:
    """Replay WAL messages for `height` into the paused state machine;
    returns the number of records replayed (the recovery-plane metric
    wal_records_replayed)."""
    cs._replay_mode = True
    # replayed marks would be microseconds apart at replay time — not a
    # consensus-stage decomposition; the first live mark reopens the record
    cs.timeline.enabled = False
    try:
        if cs.wal.search_for_end_height(height):
            raise RuntimeError(
                f"WAL should not contain #ENDHEIGHT {height}; block {height} was "
                f"already committed — possible data corruption")
        msgs = cs.wal.messages_after_end_height(height - 1)
        for m in msgs:
            _replay_message(cs, m)
        return len(msgs)
    finally:
        cs._replay_mode = False
        cs.timeline.enabled = True


def _replay_message(cs: ConsensusState, m: WALMessage) -> None:
    """(replay.go:38 readReplayMessage semantics)"""
    if m.type == "round_step":
        return  # informational
    if m.type == "timeout":
        d = m.data
        cs._handle_timeout(TimeoutInfo(d["duration_s"], d["height"], d["round"], d["step"]))
        return
    if m.type == "vote":
        vote = Vote.decode(bytes.fromhex(m.data["vote"]))
        cs._try_add_vote(vote, m.data.get("peer", ""))
        return
    if m.type == "proposal":
        proposal = Proposal.decode(bytes.fromhex(m.data["proposal"]))
        try:
            cs._set_proposal(proposal)
        except ValueError as e:
            logger.debug("replay: proposal rejected: %s", e)
        return
    if m.type == "block_part":
        part = Part.decode(bytes.fromhex(m.data["part"]))
        msg = BlockPartMessage(m.data["height"], m.data["round"], part)
        added = cs._add_proposal_block_part(msg, m.data.get("peer", ""))
        if added and cs.rs.proposal_block_parts.is_complete():
            cs._handle_complete_proposal(msg.height)
        return
    if m.type == "end_height":
        return
    logger.warning("replay: unknown WAL message type %r", m.type)


# --- ABCI handshake (replay.go:200) ----------------------------------------

class Handshaker:
    def __init__(self, state_store: StateStore, state: State,
                 block_store: BlockStore, genesis: GenesisDoc,
                 event_bus: Optional[EventBus] = None, exec_config=None):
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis = genesis
        self.event_bus = event_bus
        # the node's [execution] config: recovery's final apply_block goes
        # through the same executor version the live node will use, so a
        # crash mid-parallel-apply replays to the identical hash it would
        # have produced serially (state/parallel.py byte-parity invariant)
        self.exec_config = exec_config
        self.n_blocks = 0

    def handshake(self, proxy_app_consensus: Client, proxy_app_query: Client) -> State:
        """(replay.go:241 Handshake) — returns the possibly-updated state."""
        res = proxy_app_query.info(abci.RequestInfo(
            version="0.1.0-tpu", block_version=BLOCK_PROTOCOL, p2p_version=8))
        app_height = res.last_block_height
        app_hash = res.last_block_app_hash
        if app_height < 0:
            raise ValueError(f"got a negative last block height ({app_height}) from the app")
        logger.info("ABCI handshake: app height=%d hash=%s", app_height, app_hash.hex())

        state = self.replay_blocks(self.initial_state, app_hash, app_height,
                                   proxy_app_consensus, proxy_app_query)
        logger.info("completed ABCI handshake; replayed %d blocks, app height now %d",
                    self.n_blocks, state.last_block_height)
        return state

    def replay_blocks(self, state: State, app_hash: bytes, app_block_height: int,
                      consensus_conn: Client, query_conn: Client) -> State:
        """(replay.go:284 ReplayBlocks)"""
        store_height = self.block_store.height()
        store_base = self.block_store.base()
        state_height = state.last_block_height

        # InitChain at genesis (replay.go:303-356)
        if app_block_height == 0:
            # pop rides along so an app that echoes the set back in
            # ResponseInitChain passes the bls12381 admission gate
            val_updates = [abci.ValidatorUpdate(v.pub_key.type_name,
                                                v.pub_key.bytes(),
                                                v.power, pop=v.pop)
                           for v in self.genesis.validators]
            params = state.consensus_params
            req = abci.RequestInitChain(
                time_ns=self.genesis.genesis_time_ns,
                chain_id=self.genesis.chain_id,
                consensus_params=None,
                validators=val_updates,
                app_state_bytes=self.genesis.app_state,
                initial_height=self.genesis.initial_height,
            )
            res = consensus_conn.init_chain(req)
            app_hash = res.app_hash or app_hash

            if state_height == 0:  # only apply initchain results if we're at genesis
                state = state.copy()
                state.app_hash = app_hash
                if res.validators:
                    # same admission rules as EndBlock updates — in
                    # particular the bls12381 proof-of-possession gate
                    from ..state.execution import validate_validator_updates

                    validate_validator_updates(res.validators,
                                               state.consensus_params)
                    vals = [validator_update_to_validator(vu) for vu in res.validators]
                    from ..types import ValidatorSet

                    state.validators = ValidatorSet(vals)
                    state.next_validators = state.validators.copy_increment_proposer_priority(1)
                elif not self.genesis.validators:
                    raise ValueError("validator set is nil in genesis and still empty after InitChain")
                self.state_store.save(state)

        # Figure out replay needs (replay.go:360-470)
        if store_height == 0:
            _assert_app_hash_eq(app_hash, state.app_hash)
            return state

        if store_height < app_block_height:
            raise ValueError(
                f"the app block height {app_block_height} is ahead of the store {store_height}")
        if store_height < state_height:
            raise ValueError(
                f"state height {state_height} is ahead of the store {store_height}")

        if store_height == state_height:
            # tendermint is in sync with itself; maybe replay into app
            if app_block_height < store_height:
                return self._replay_range(state, consensus_conn, query_conn,
                                          app_block_height, store_height, mutate_state=False)
            _assert_app_hash_eq(app_hash, state.app_hash)
            return state

        if store_height == state_height + 1:
            # we saved the block but crashed before ApplyBlock
            if app_block_height < state_height:
                # the app is further behind: replay up to state height then the final block
                state = self._replay_range(state, consensus_conn, query_conn,
                                           app_block_height, state_height, mutate_state=False)
                return self._apply_final_block(state, consensus_conn)
            if app_block_height == state_height:
                return self._apply_final_block(state, consensus_conn)
            if app_block_height == store_height:
                # app already has the final block; sync tendermint state
                block = self.block_store.load_block(store_height)
                from ..state.execution import update_state as _update_state
                # Re-derive state by applying block without re-executing txs:
                # exec responses were persisted before crash? If not, re-apply.
                return self._apply_final_block(state, consensus_conn)
        raise ValueError(
            f"uncovered state/store heights: state={state_height} store={store_height} "
            f"app={app_block_height}")

    def _replay_range(self, state: State, consensus_conn: Client, query_conn: Client,
                      app_block_height: int, final_height: int,
                      mutate_state: bool) -> State:
        """Replay blocks [app_height+1, final_height] into the app
        (replay.go:428 replayBlocks)."""
        first = app_block_height + 1
        if first == 1:
            first = state.initial_height
        for h in range(first, final_height + 1):
            logger.info("replaying block height=%d", h)
            block = self.block_store.load_block(h)
            # exec-plane segment per replayed block: handshake replay shows
            # up in the same phase breakdown as live apply (execution.py
            # tags its own), so recovery time decomposes like block time
            n_txs = len(block.data.txs)
            _seg = phases.Segment(sigs=n_txs, chunk=n_txs, device="app",
                                  plane="exec", height=h)
            _seg.begin()
            try:
                _seg.pack_done()
                exec_commit_block(consensus_conn, block, self.state_store,
                                  state.initial_height)
                _seg.dispatched()
            except BaseException:
                _seg.abandon()
                raise
            _seg.fetched()
            self.n_blocks += 1
        res = query_conn.info(abci.RequestInfo(version="0.1.0-tpu"))
        _assert_app_hash_eq(res.last_block_app_hash, state.app_hash)
        return state

    def _apply_final_block(self, state: State, consensus_conn: Client) -> State:
        """ApplyBlock for the stored-but-not-applied final block (replay.go:493)."""
        height = self.block_store.height()
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        from ..state.execution import BlockExecutor, EmptyEvidencePool, NoOpMempool

        block_exec = BlockExecutor(self.state_store, consensus_conn,
                                   NoOpMempool(), EmptyEvidencePool(),
                                   self.block_store, self.event_bus,
                                   exec_config=self.exec_config)
        state, _ = block_exec.apply_block(state, meta.block_id, block)
        self.n_blocks += 1
        return state


def _assert_app_hash_eq(app_hash: bytes, state_app_hash: bytes) -> None:
    """(replay.go:573 checkAppHash)"""
    if app_hash != state_app_hash:
        logger.warning("app hash (%s) does not match state app hash (%s)",
                       app_hash.hex(), state_app_hash.hex())
