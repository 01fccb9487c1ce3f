"""state.State — the deterministic chain-tip value struct
(reference state/state.go:48) + MakeBlock and MedianTime.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from ..types import ConsensusParams, GenesisDoc, ValidatorSet
from ..types.basic import BlockID
from ..types.block import BLOCK_PROTOCOL, Block, Commit, Consensus, Header
from ..types.part_set import PartSet
from ..types.validator import Validator

# Version.Software analogue (reference version/version.go TMVersionDefault).
SOFTWARE_VERSION = "0.1.0-tpu"


@dataclass
class State:
    chain_id: str = ""
    initial_height: int = 1
    version: Consensus = field(default_factory=lambda: Consensus(BLOCK_PROTOCOL, 0))
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0
    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            version=self.version,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time_ns=self.last_block_time_ns,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def make_block(self, height: int, txs: List[bytes], commit: Optional[Commit],
                   evidence: List, proposer_address: bytes) -> Tuple[Block, PartSet]:
        """(state/state.go:234)"""
        from ..types.block import Data

        if height == self.initial_height:
            timestamp = self.last_block_time_ns  # genesis time
        else:
            timestamp = median_time(commit, self.last_validators)
        header = Header(
            version=self.version,
            chain_id=self.chain_id,
            height=height,
            time_ns=timestamp,
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            proposer_address=proposer_address,
        )
        block = Block(header, Data(txs=list(txs)), list(evidence), commit)
        return block, block.make_part_set()


def median_time(commit: Commit, validators: ValidatorSet) -> int:
    """Voting-power-weighted median of commit vote timestamps
    (reference state/state.go:268 MedianTime)."""
    if hasattr(commit, "agg_sig"):
        # Aggregated commits carry the weighted median precomputed at
        # assembly time — the per-vote timestamps are not on the wire, and
        # the aggregate signature does NOT cover timestamp_ns (every
        # precommit signs zero-timestamp bytes, schemes.AGG_ZERO_TS_NS).
        # BFT time therefore weakens to proposer-assembled time bounded by
        # (a) deterministic monotonicity vs the previous block
        # (validation.validate_block) and (b) the subjective prevote-time
        # window each validator enforces against its own recorded precommit
        # times and local clock (consensus/aggregated.py
        # check_aggregated_commit_time, agg_commit_time_drift_s knob).
        return commit.timestamp_ns
    weighted = []
    total_power = 0
    for cs in commit.signatures:
        if cs.absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is None:
            continue
        total_power += val.voting_power
        weighted.append((cs.timestamp_ns, val.voting_power))
    weighted.sort()
    median = total_power // 2
    for ts, power in weighted:
        if median <= power:  # types/time/time.go:50 WeightedMedian
            return ts
        median -= power
    return 0


def state_from_genesis(genesis: GenesisDoc) -> State:
    """(reference state/state.go MakeGenesisState)"""
    genesis.validate_and_complete()
    from ..crypto import schemes

    schemes.register_chain(
        genesis.chain_id,
        (genesis.consensus_params or ConsensusParams()).signature)
    if genesis.validators:
        vals = [Validator(v.address, v.pub_key, v.power) for v in genesis.validators]
        val_set = ValidatorSet(vals)
        next_vals = val_set.copy_increment_proposer_priority(1)
    else:
        val_set = ValidatorSet()  # empty until InitChain supplies validators
        next_vals = ValidatorSet()
    return State(
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        version=Consensus(BLOCK_PROTOCOL, (genesis.consensus_params or ConsensusParams()).version.app_version),
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=genesis.genesis_time_ns,
        next_validators=next_vals,
        validators=val_set,
        last_validators=ValidatorSet(),
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params or ConsensusParams(),
        last_height_consensus_params_changed=genesis.initial_height,
        last_results_hash=b"",
        app_hash=genesis.app_hash,
    )
