"""Stateful block validation (reference state/validation.go:15 validateBlock).

LastCommit verification routes through the batched ValidatorSet.verify_commit
— HOT LOOP #2 in SURVEY.md §3.3 — one device call per block instead of N
scalar verifies.
"""

from __future__ import annotations

from ..types.block import Block


def validate_block(state, block: Block) -> None:
    block.validate_basic()

    if (block.header.version.app != state.version.app
            or block.header.version.block != state.version.block):
        raise ValueError(
            f"wrong Block.Header.Version. Expected {state.version}, got {block.header.version}")
    if block.header.chain_id != state.chain_id:
        raise ValueError(
            f"wrong Block.Header.ChainID. Expected {state.chain_id}, got {block.header.chain_id}")
    if state.last_block_height == 0 and block.header.height != state.initial_height:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.initial_height} for initial block, "
            f"got {block.header.height}")
    if state.last_block_height > 0 and block.header.height != state.last_block_height + 1:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.last_block_height + 1}, "
            f"got {block.header.height}")
    if block.header.last_block_id != state.last_block_id:
        raise ValueError(
            f"wrong Block.Header.LastBlockID. Expected {state.last_block_id}, "
            f"got {block.header.last_block_id}")

    if block.header.app_hash != state.app_hash:
        raise ValueError(
            f"wrong Block.Header.AppHash. Expected {state.app_hash.hex().upper()}, "
            f"got {block.header.app_hash.hex()}")
    hash_cp = state.consensus_params.hash()
    if block.header.consensus_hash != hash_cp:
        raise ValueError("wrong Block.Header.ConsensusHash")
    if block.header.last_results_hash != state.last_results_hash:
        raise ValueError("wrong Block.Header.LastResultsHash")
    if block.header.validators_hash != state.validators.hash():
        raise ValueError("wrong Block.Header.ValidatorsHash")
    if block.header.next_validators_hash != state.next_validators.hash():
        raise ValueError("wrong Block.Header.NextValidatorsHash")

    # LastCommit — the batched hot path.
    if block.header.height == state.initial_height:
        # size() covers both forms: CommitSig rows or signer bitmap
        if block.last_commit is not None and block.last_commit.size() != 0:
            raise ValueError("initial block can't have LastCommit signatures")
    else:
        state.last_validators.verify_commit(
            state.chain_id, state.last_block_id, block.header.height - 1, block.last_commit)

    # Proposer must be in the current validator set.
    if not state.validators.has_address(block.header.proposer_address):
        raise ValueError(
            f"block.Header.ProposerAddress {block.header.proposer_address.hex().upper()} "
            f"is not a validator")

    # Validate block time (state/validation.go:114-140).
    from .state import median_time

    if block.header.height > state.initial_height:
        if block.header.time_ns <= state.last_block_time_ns:
            raise ValueError(
                f"block time {block.header.time_ns} not greater than last block time "
                f"{state.last_block_time_ns}")
        expected = median_time(block.last_commit, state.last_validators)
        if block.header.time_ns != expected:
            raise ValueError(
                f"invalid block time. Expected {expected}, got {block.header.time_ns}")
    elif block.header.height == state.initial_height:
        if block.header.time_ns != state.last_block_time_ns:
            raise ValueError(
                f"block time {block.header.time_ns} is not equal to genesis time "
                f"{state.last_block_time_ns}")
    else:
        raise ValueError(
            f"block height {block.header.height} lower than initial height {state.initial_height}")
