"""Evidence verification (reference evidence/verify.go).

Duplicate-vote: both signatures checked in ONE batched device call instead of
two scalar verifies (verify.go:214,217 — a batch-offload site from SURVEY.md).
"""

from __future__ import annotations

from ..crypto.batch import BatchVerifier
from ..types import DuplicateVoteEvidence, Evidence, LightClientAttackEvidence
from ..types.validator_set import ValidatorSet

DEFAULT_TRUST_LEVEL = (1, 3)  # light.DefaultTrustLevel


class ErrNoEvidenceData(Exception):
    """We lack the header/valset to judge this evidence (benign: we may be
    behind or pruned) — callers must NOT punish the sender for it."""


def verify_duplicate_vote(e: DuplicateVoteEvidence, chain_id: str,
                          val_set: ValidatorSet) -> None:
    """(verify.go:162)"""
    _, val = val_set.get_by_address(e.vote_a.validator_address)
    if val is None:
        raise ValueError(
            f"address {e.vote_a.validator_address.hex().upper()} was not a validator "
            f"at height {e.height()}")
    pub_key = val.pub_key

    if (e.vote_a.height != e.vote_b.height or e.vote_a.round != e.vote_b.round
            or e.vote_a.type != e.vote_b.type):
        raise ValueError(
            f"h/r/s does not match: {e.vote_a.height}/{e.vote_a.round}/{e.vote_a.type} "
            f"vs {e.vote_b.height}/{e.vote_b.round}/{e.vote_b.type}")
    if e.vote_a.validator_address != e.vote_b.validator_address:
        raise ValueError(
            f"validator addresses do not match: {e.vote_a.validator_address.hex()} "
            f"vs {e.vote_b.validator_address.hex()}")
    if e.vote_a.block_id == e.vote_b.block_id:
        raise ValueError(
            f"block IDs are the same ({e.vote_a.block_id}) - not a real duplicate vote")
    if pub_key.address() != e.vote_a.validator_address:
        raise ValueError("address doesn't match pubkey")
    if val.voting_power != e.validator_power:
        raise ValueError(
            f"validator power from evidence and our validator set does not match "
            f"({e.validator_power} != {val.voting_power})")
    if val_set.total_voting_power() != e.total_voting_power:
        raise ValueError(
            f"total voting power from the evidence and our validator set does not "
            f"match ({e.total_voting_power} != {val_set.total_voting_power()})")

    # Both signatures in one batch (verify.go:214,217). Two signatures sit
    # below the break-even threshold (crypto/batch.py device_threshold), so
    # the "auto" backend verifies them on the host: that is the routing
    # rule for small batches, not a fallback after a device fault. A pinned
    # "cuda" backend puts them on the card, and a fault there reaches the
    # caller.
    bv = BatchVerifier(plane="evidence")
    bv.add(pub_key, e.vote_a.sign_bytes(chain_id), e.vote_a.signature)
    bv.add(pub_key, e.vote_b.sign_bytes(chain_id), e.vote_b.signature)
    _, per_item = bv.verify()
    if not per_item[0]:
        raise ValueError("verifying VoteA: invalid signature")
    if not per_item[1]:
        raise ValueError("verifying VoteB: invalid signature")


def verify_light_client_attack(e: LightClientAttackEvidence, chain_id: str,
                               common_header, trusted_header,
                               common_vals: ValidatorSet) -> None:
    """(verify.go:113) — simplified: byzantine-validator recomputation checks
    happen in the pool once the light client lands (SURVEY.md stage 9)."""
    cb = e.conflicting_block
    if common_header.height != cb.height:
        # commit_vals: aggregated commits pair against the conflicting
        # block's own set (the bitmap indexes it); plain commits ignore it
        common_vals.verify_commit_light_trusting(
            chain_id, cb.signed_header.commit, DEFAULT_TRUST_LEVEL,
            commit_vals=cb.validator_set)
    elif cb.signed_header.header.hash() != cb.signed_header.commit.block_id.hash:
        raise ValueError(
            "common height is the same as conflicting block height so expected the "
            "conflicting block to be correctly derived yet it wasn't")
    cb.validator_set.verify_commit_light(
        chain_id, cb.signed_header.commit.block_id, cb.height,
        cb.signed_header.commit)
    if e.total_voting_power != common_vals.total_voting_power():
        raise ValueError(
            f"total voting power from the evidence and our validator set does not "
            f"match ({e.total_voting_power} != {common_vals.total_voting_power()})")
    if (cb.height > trusted_header.height
            and cb.signed_header.header.time_ns > trusted_header.time_ns):
        raise ValueError("conflicting block doesn't violate monotonically increasing time")
    if (cb.height <= trusted_header.height
            and trusted_header.hash() == cb.signed_header.header.hash()):
        raise ValueError("trusted header hash matches the evidence's conflicting header hash")


def verify_evidence(ev: Evidence, state, state_store, block_store) -> None:
    """Entry check against node state (verify.go:37 verify)."""
    height = state.last_block_height
    ev_height = ev.height()
    age_num_blocks = height - ev_height
    params = state.consensus_params.evidence

    block_meta = block_store.load_block_meta(ev_height)
    if block_meta is None:
        raise ErrNoEvidenceData(f"don't have header at height #{ev_height}")
    ev_time = block_meta.header.time_ns
    age_duration = state.last_block_time_ns - ev_time
    if age_duration > params.max_age_duration_ns and age_num_blocks > params.max_age_num_blocks:
        raise ValueError(
            f"evidence from height {ev_height} is too old; min height is "
            f"{height - params.max_age_num_blocks}")

    if isinstance(ev, DuplicateVoteEvidence):
        val_set = state_store.load_validators(ev_height)
        if val_set is None:
            raise ErrNoEvidenceData(f"no validator set at height {ev_height}")
        verify_duplicate_vote(ev, state.chain_id, val_set)
        if ev.timestamp_ns != ev_time:
            raise ValueError(
                f"evidence has a different time to the block it is associated with "
                f"({ev.timestamp_ns} != {ev_time})")
    elif isinstance(ev, LightClientAttackEvidence):
        common_vals = state_store.load_validators(ev.common_height)
        if common_vals is None:
            raise ErrNoEvidenceData(f"no validator set at height {ev.common_height}")
        common_meta = block_store.load_block_meta(ev.common_height)
        if common_meta is None:
            raise ErrNoEvidenceData(f"don't have header at height #{ev.common_height}")
        trusted_meta = block_store.load_block_meta(ev.conflicting_block.height)
        if trusted_meta is None:
            trusted_meta = block_store.load_block_meta(block_store.height())
        if trusted_meta is None:
            raise ErrNoEvidenceData("no trusted header available")
        verify_light_client_attack(ev, state.chain_id, common_meta.header,
                                   trusted_meta.header, common_vals)
    else:
        raise ValueError(f"unrecognized evidence type: {type(ev)}")
