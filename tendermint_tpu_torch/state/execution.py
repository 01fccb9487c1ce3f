"""BlockExecutor — the only entry for committing a block
(reference state/execution.go:131 ApplyBlock; SURVEY.md §3.3).

Pipeline: validate → BeginBlock → DeliverTx* → EndBlock → persist responses →
apply validator updates → mempool-locked Commit → save state → fire events.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from .. import crypto
from ..abci import types as abci
from ..abci.client import Client
from ..store import BlockStore
from ..types import ConsensusParams, ValidatorSet
from ..types.basic import BlockID, BlockIDFlag
from ..types.block import Block, Commit
from ..types.evidence import Evidence
from ..types.part_set import PartSet
from ..types.validator import Validator
from .state import State
from .store import ABCIResponses, StateStore
from .validation import validate_block

logger = logging.getLogger("tmtpu.state")


class Mempool:
    """The surface BlockExecutor needs (reference mempool/mempool.go:30).

    ``reap_max_bytes_max_gas`` — the proposal-creation call site below —
    must be DETERMINISTIC in the pool's contents: the CList port reaps
    insertion order, the sharded-lane pool (mempool/ingest.py) a merged
    (priority desc, arrival asc) order; either way two reaps over the
    same residents yield the same block. ``update`` runs under
    ``lock()``/``unlock()`` held across the whole commit (post-commit
    recheck included), so admissions racing a commit serialize behind
    it."""

    def lock(self) -> None: ...
    def unlock(self) -> None: ...
    def flush_app_conn(self) -> None: ...
    def update(self, height: int, txs: List[bytes],
               deliver_tx_responses: List[abci.ResponseDeliverTx],
               pre_check=None, post_check=None) -> None: ...
    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return []
    def size(self) -> int:
        return 0


class EvidencePool:
    """(reference state/services.go EvidencePool)"""

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        return [], 0

    def add_evidence(self, ev: Evidence) -> None: ...
    def check_evidence(self, evidence: List[Evidence]) -> None: ...
    def update(self, state: State, evidence: List[Evidence]) -> None: ...
    def report_conflicting_votes(self, vote_a, vote_b) -> None: ...


class EmptyEvidencePool(EvidencePool):
    pass


class NoOpMempool(Mempool):
    pass


class BlockExecutor:
    metrics = None  # StateMetrics, wired by the node

    def __init__(self, state_store: StateStore, proxy_app_consensus: Client,
                 mempool: Mempool, evidence_pool: EvidencePool,
                 block_store: Optional[BlockStore] = None, event_bus=None,
                 exec_config=None):
        self.state_store = state_store
        self.proxy_app = proxy_app_consensus
        self.mempool = mempool
        self.evpool = evidence_pool
        self.block_store = block_store
        self.event_bus = event_bus
        # execution.version: "v1" = optimistic parallel (state/parallel.py)
        # with automatic serial fallback; "v0"/None = the serial spec path
        self.exec_config = exec_config
        self._parallel = None
        if exec_config is not None and exec_config.version == "v1":
            from .parallel import ParallelExecutor

            self._parallel = ParallelExecutor(
                workers=exec_config.workers,
                min_parallel_txs=exec_config.min_parallel_txs)

    def _exec_block(self, block: Block, state: State) -> ABCIResponses:
        """The execute stage: parallel when configured AND eligible,
        else the serial spec — outputs byte-identical either way."""
        if self._parallel is not None:
            if self.metrics is not None:
                self._parallel.metrics = self.metrics
            resp = self._parallel.try_exec_block(
                self.proxy_app, block, self.state_store,
                state.initial_height)
            if resp is not None:
                return resp
        return exec_block_on_proxy_app(
            self.proxy_app, block, self.state_store, state.initial_height)

    # -- proposal creation (execution.go:94 CreateProposalBlock) -----------

    def create_proposal_block(self, height: int, state: State, commit: Optional[Commit],
                              proposer_addr: bytes) -> Tuple[Block, PartSet]:
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = self.evpool.pending_evidence(
            state.consensus_params.evidence.max_bytes)
        max_data_bytes = max_data_bytes_for(max_bytes, ev_size, state.validators.size())
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        return state.make_block(height, txs, commit, evidence, proposer_addr)

    # -- validation --------------------------------------------------------

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block)
        self.evpool.check_evidence(block.evidence)

    # -- the commit pipeline (execution.go:131 ApplyBlock) -----------------

    def apply_block(self, state: State, block_id: BlockID, block: Block) -> Tuple[State, int]:
        """Returns (new_state, retain_height)."""
        from ..libs.trace import tracer as _tracer

        # exception-safe span: a rejected block must still leave its event
        with _tracer.span("apply_block", height=block.header.height,
                          n_txs=len(block.data.txs)):
            return self._apply_block_inner(state, block_id, block)

    def _apply_block_inner(self, state: State, block_id: BlockID,
                           block: Block) -> Tuple[State, int]:
        import time as _time

        from ..crypto import phases
        from ..libs.fail import fail_point

        _t0 = _time.perf_counter()
        # exec-plane phase record (plane="exec", device="app"): validate
        # maps to pack, execute to dispatch, commit+persist to fetch — so
        # phase_breakdown() can split exposed-execute from exposed-verify
        # wall share under the blocksync pipeline.
        _seg = phases.Segment(sigs=len(block.data.txs),
                              chunk=len(block.data.txs), device="app",
                              plane="exec", height=block.header.height)
        _seg.begin()
        try:
            new_state, retain = self._apply_block_phases(
                state, block_id, block, _seg, fail_point)
        except BaseException:
            _seg.abandon()
            raise
        if self.metrics is not None:
            self.metrics.block_processing_time.observe(
                _time.perf_counter() - _t0)
        return new_state, retain

    def _apply_block_phases(self, state: State, block_id: BlockID,
                            block: Block, _seg, fail_point) -> Tuple[State, int]:
        self.validate_block(state, block)
        fail_point("execution.before_exec_block")  # (execution.go:149)
        _seg.pack_done()

        abci_responses = self._exec_block(block, state)
        _seg.dispatched()

        self.state_store.save_abci_responses(block.header.height, abci_responses)

        raw_updates = (abci_responses.end_block.validator_updates
                       if abci_responses.end_block else [])
        validate_validator_updates(raw_updates, state.consensus_params)
        validator_updates = [validator_update_to_validator(vu)
                             for vu in raw_updates]

        new_state = update_state(state, block_id, block, abci_responses, validator_updates)

        # Lock mempool, commit app state, update mempool (execution.go:211).
        app_hash, retain_height = self._commit(new_state, block,
                                               abci_responses.deliver_txs)

        self.evpool.update(new_state, block.evidence)

        new_state.app_hash = app_hash
        self.state_store.save(new_state)
        _seg.fetched()

        fail_point("execution.after_state_save")  # (execution.go:196)
        if self.event_bus is not None:
            # event publication order is the ABCIResponses ordering
            # contract: per-tx events index deliver_txs by block position
            fire_events(self.event_bus, block, block_id, abci_responses, validator_updates)

        return new_state, retain_height

    def _commit(self, state: State, block: Block,
                deliver_tx_responses: List[abci.ResponseDeliverTx]) -> Tuple[bytes, int]:
        self.mempool.lock()
        try:
            self.mempool.flush_app_conn()
            res = self.proxy_app.commit()
            logger.info("committed state: height=%d txs=%d app_hash=%s",
                        block.header.height, len(block.data.txs), res.data.hex())
            self.mempool.update(block.header.height, block.data.txs,
                                deliver_tx_responses)
            return res.data, res.retain_height
        finally:
            self.mempool.unlock()


# -- free functions mirroring execution.go ----------------------------------

def exec_block_on_proxy_app(proxy_app: Client, block: Block, state_store: StateStore,
                            initial_height: int) -> ABCIResponses:
    """(execution.go:259) BeginBlock → DeliverTx* → EndBlock."""
    commit_info = get_begin_block_validator_info(block, state_store, initial_height)
    byz_vals = [ev_to_abci(ev) for ev in block.evidence]

    begin = proxy_app.begin_block(abci.RequestBeginBlock(
        hash=block.hash() or b"", header=block.header,
        last_commit_info=commit_info, byzantine_validators=byz_vals))
    deliver_txs = [proxy_app.deliver_tx(abci.RequestDeliverTx(tx=tx))
                   for tx in block.data.txs]
    invalid = sum(1 for r in deliver_txs if not r.is_ok())
    if invalid:
        logger.debug("executed block height=%d valid_txs=%d invalid_txs=%d",
                     block.header.height, len(deliver_txs) - invalid, invalid)
    end = proxy_app.end_block(abci.RequestEndBlock(height=block.header.height))
    return ABCIResponses(deliver_txs=deliver_txs, end_block=end, begin_block=begin)


def get_begin_block_validator_info(block: Block, state_store: StateStore,
                                   initial_height: int) -> abci.LastCommitInfo:
    """(execution.go getBeginBlockValidatorInfo)"""
    votes: List[abci.VoteInfo] = []
    if block.header.height > initial_height:
        last_val_set = state_store.load_validators(block.header.height - 1)
        if last_val_set is None:
            raise ValueError(f"no validator set at height {block.header.height - 1}")
        commit_size = block.last_commit.size()
        vals_size = last_val_set.size()
        if commit_size != vals_size:
            raise ValueError(
                f"commit size ({commit_size}) doesn't match valset length ({vals_size}) "
                f"at height {block.header.height}")
        aggregated = hasattr(block.last_commit, "agg_sig")
        for i, val in enumerate(last_val_set.validators):
            if aggregated:
                signed = block.last_commit.signers.get_index(i)
            else:
                signed = not block.last_commit.signatures[i].absent()
            votes.append(abci.VoteInfo(
                validator=abci.ABCIValidator(val.address, val.voting_power),
                signed_last_block=signed))
    round_ = block.last_commit.round if block.last_commit else 0
    return abci.LastCommitInfo(round=round_, votes=votes)


def ev_to_abci(ev: Evidence) -> abci.ABCIEvidence:
    from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence

    if isinstance(ev, DuplicateVoteEvidence):
        return abci.ABCIEvidence(
            type="DUPLICATE_VOTE",
            validator=abci.ABCIValidator(ev.vote_a.validator_address, ev.validator_power),
            height=ev.height(), time_ns=ev.time_ns(),
            total_voting_power=ev.total_voting_power)
    if isinstance(ev, LightClientAttackEvidence):
        return abci.ABCIEvidence(
            type="LIGHT_CLIENT_ATTACK", height=ev.height(), time_ns=ev.time_ns(),
            total_voting_power=ev.total_voting_power)
    raise ValueError(f"unknown evidence type {type(ev)}")


def validator_update_to_validator(vu: abci.ValidatorUpdate) -> Validator:
    pub = crypto.pubkey_from_type_and_bytes(vu.pub_key_type, vu.pub_key_bytes)
    return Validator(pub.address(), pub, vu.power)


def validate_validator_updates(updates: List[abci.ValidatorUpdate],
                               params: ConsensusParams) -> None:
    """(state/validation.go validateValidatorUpdates) — takes the RAW ABCI
    updates so bls12381 admissions can be held to their proof of possession:
    an aggregated chain with a dynamic validator set is exactly where a
    rogue key (pk* - sum of honest pks) would let an attacker forge
    fast-aggregate commits, so the PoP gate that genesis enforces must also
    cover every key entering via EndBlock/InitChain."""
    from ..crypto import BLS12381_TYPE
    from ..crypto import bls12381 as _bls

    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu}")
        if vu.power == 0:
            continue  # deletion
        if vu.pub_key_type not in params.validator.pub_key_types:
            raise ValueError(
                f"validator update with pubkey {vu.pub_key_bytes.hex()} is using "
                f"pubkey type {vu.pub_key_type}, which is unsupported for consensus")
        if vu.pub_key_type == BLS12381_TYPE:
            # Every bls12381 admission (including a power change for a
            # sitting validator) must carry a valid PoP.  Deliberately NOT
            # short-circuited through is_registered: that set is in-process
            # state, and a freshly restarted node (empty set) must reach the
            # same verdict as a long-running one.
            if not vu.pop:
                raise ValueError(
                    f"bls12381 validator update {vu.pub_key_bytes.hex()} has no "
                    f"proof of possession (rogue-key gate)")
            if not _bls.pop_verify(vu.pub_key_bytes, vu.pop):
                raise ValueError(
                    f"invalid bls12381 proof of possession for validator "
                    f"update {vu.pub_key_bytes.hex()}")
            # vetted above — joins the aggregation-eligible set
            _bls.register_key(vu.pub_key_bytes, vu.pop)


def update_state(state: State, block_id: BlockID, block: Block,
                 abci_responses: ABCIResponses,
                 validator_updates: List[Validator]) -> State:
    """(execution.go:403 updateState)"""
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        last_height_vals_changed = block.header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    version = state.version
    cpu = abci_responses.end_block.consensus_param_updates if abci_responses.end_block else None
    if cpu is not None:
        next_params = state.consensus_params.update(cpu)
        next_params.validate_basic()
        from ..types.block import Consensus

        version = Consensus(state.version.block, next_params.version.app_version)
        last_height_params_changed = block.header.height + 1

    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        version=version,
        last_block_height=block.header.height,
        last_block_id=block_id,
        last_block_time_ns=block.header.time_ns,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=abci_responses.results_hash(),
        app_hash=b"",  # filled after Commit
    )


def fire_events(event_bus, block: Block, block_id: BlockID,
                abci_responses: ABCIResponses, validator_updates) -> None:
    """(execution.go:471 fireEvents)"""
    event_bus.publish_event_new_block(block, block_id,
                                      abci_responses.begin_block, abci_responses.end_block)
    event_bus.publish_event_new_block_header(block.header,
                                             abci_responses.begin_block, abci_responses.end_block)
    for ev in block.evidence:
        event_bus.publish_event_new_evidence(ev, block.header.height)
    for i, tx in enumerate(block.data.txs):
        event_bus.publish_event_tx(block.header.height, i, tx, abci_responses.deliver_txs[i])
    if validator_updates:
        event_bus.publish_event_validator_set_updates(validator_updates)


def max_data_bytes_for(max_bytes: int, evidence_bytes: int, val_count: int) -> int:
    """(types/block.go MaxDataBytes)"""
    from ..types.block import MAX_HEADER_BYTES

    max_commit_bytes = 94 + (109 + 2) * val_count
    # block proto envelope overhead
    max_data = max_bytes - 11 - MAX_HEADER_BYTES - max_commit_bytes - evidence_bytes
    if max_data < 0:
        raise ValueError("negative MaxDataBytes")
    return max_data


def exec_commit_block(proxy_app: Client, block: Block, state_store: StateStore,
                      initial_height: int) -> bytes:
    """Replay helper (execution.go:530 ExecCommitBlock): exec + commit, return app hash."""
    exec_block_on_proxy_app(proxy_app, block, state_store, initial_height)
    res = proxy_app.commit()
    return res.data
