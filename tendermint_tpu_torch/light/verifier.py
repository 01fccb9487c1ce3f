"""Pure light-client verification (reference light/verifier.go:32,93).

Semantics mirror the reference exactly:

* verify_adjacent: trusting-period check, header/vals sanity, hash-chain
  (untrusted.ValidatorsHash == trusted.NextValidatorsHash), then
  VerifyCommitLight over the new set — which batches every present
  signature into one device call (types/validator_set.py);
* verify_non_adjacent: trusting-period check, header/vals sanity,
  VerifyCommitLightTrusting(trust_level, default 1/3) over the TRUSTED set,
  then VerifyCommitLight over the new set (ordered last deliberately — the
  untrusted set is attacker-supplied, reference verifier.go:70);
* verify_backwards: hash-linkage for walking the chain backwards.

Times are int nanoseconds; durations float seconds.
"""

from __future__ import annotations

from ..device import is_device_fault
from ..types.light_block import SignedHeader
from ..types.validator_set import Fraction, ValidatorSet

DEFAULT_TRUST_LEVEL = (1, 3)  # Fraction tuple


class LightError(Exception):
    pass


class ErrOldHeaderExpired(LightError):
    pass


class ErrInvalidHeader(LightError):
    pass


class ErrNewValSetCantBeTrusted(LightError):
    """< trust_level of the trusted set signed the new header — cannot skip;
    the caller bisects (light/client.go verifySkipping)."""


def validate_trust_level(lvl: Fraction) -> None:
    num, den = lvl
    if num * 3 < den or num > den or den == 0:
        raise LightError(f"trustLevel must be within [1/3, 1], given {lvl}")


def header_expired(h: SignedHeader, trusting_period_s: float, now_ns: int) -> bool:
    expiration_ns = h.header.time_ns + int(trusting_period_s * 1e9)
    return expiration_ns <= now_ns


def _verify_new_header_and_vals(untrusted: SignedHeader, untrusted_vals: ValidatorSet,
                                trusted: SignedHeader, now_ns: int,
                                max_clock_drift_s: float) -> None:
    untrusted.validate_basic(trusted.header.chain_id)
    if untrusted.header.height <= trusted.header.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted.header.height} to be greater "
            f"than one of old header {trusted.header.height}")
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise ErrInvalidHeader(
            "expected new header time to be after old header time")
    if untrusted.header.time_ns >= now_ns + int(max_clock_drift_s * 1e9):
        raise ErrInvalidHeader("new header has a time from the future")
    if untrusted.header.validators_hash != untrusted_vals.hash():
        raise ErrInvalidHeader(
            f"expected new header validators "
            f"({untrusted.header.validators_hash.hex()}) to match those "
            f"supplied ({untrusted_vals.hash().hex()})")


def verify_adjacent(trusted: SignedHeader, untrusted: SignedHeader,
                    untrusted_vals: ValidatorSet, trusting_period_s: float,
                    now_ns: int, max_clock_drift_s: float) -> None:
    """(light/verifier.go:93)"""
    if untrusted.header.height != trusted.header.height + 1:
        raise LightError("headers must be adjacent in height")
    if header_expired(trusted, trusting_period_s, now_ns):
        raise ErrOldHeaderExpired("old header has expired")
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now_ns,
                                max_clock_drift_s)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            f"expected old header next validators "
            f"({trusted.header.next_validators_hash.hex()}) to match those from "
            f"new header ({untrusted.header.validators_hash.hex()})")
    try:
        untrusted_vals.verify_commit_light(
            trusted.header.chain_id, untrusted.commit.block_id,
            untrusted.header.height, untrusted.commit)
    except Exception as e:
        if is_device_fault(e):
            raise  # a fault of the card says nothing of the header
        raise ErrInvalidHeader(str(e)) from e


def verify_non_adjacent(trusted: SignedHeader, trusted_vals: ValidatorSet,
                        untrusted: SignedHeader, untrusted_vals: ValidatorSet,
                        trusting_period_s: float, now_ns: int,
                        max_clock_drift_s: float,
                        trust_level: Fraction = DEFAULT_TRUST_LEVEL) -> None:
    """(light/verifier.go:32)"""
    if untrusted.header.height == trusted.header.height + 1:
        raise LightError("headers must be non adjacent in height")
    if header_expired(trusted, trusting_period_s, now_ns):
        raise ErrOldHeaderExpired("old header has expired")
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now_ns,
                                max_clock_drift_s)
    from ..types.errors import ErrNotEnoughVotingPowerSigned

    try:
        # commit_vals: aggregated commits pair against the commit-height set
        # (the bitmap indexes into untrusted_vals); plain commits ignore it
        trusted_vals.verify_commit_light_trusting(
            trusted.header.chain_id, untrusted.commit, trust_level,
            commit_vals=untrusted_vals)
    except ErrNotEnoughVotingPowerSigned as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    # last deliberately: untrusted set is attacker-sized (verifier.go:70)
    try:
        untrusted_vals.verify_commit_light(
            trusted.header.chain_id, untrusted.commit.block_id,
            untrusted.header.height, untrusted.commit)
    except Exception as e:
        if is_device_fault(e):
            raise  # a fault of the card says nothing of the header
        raise ErrInvalidHeader(str(e)) from e


def verify(trusted: SignedHeader, trusted_vals: ValidatorSet,
           untrusted: SignedHeader, untrusted_vals: ValidatorSet,
           trusting_period_s: float, now_ns: int, max_clock_drift_s: float,
           trust_level: Fraction = DEFAULT_TRUST_LEVEL) -> None:
    """(light/verifier.go Verify) adjacent or skipping, by height gap."""
    if untrusted.header.height != trusted.header.height + 1:
        verify_non_adjacent(trusted, trusted_vals, untrusted, untrusted_vals,
                            trusting_period_s, now_ns, max_clock_drift_s,
                            trust_level)
    else:
        verify_adjacent(trusted, untrusted, untrusted_vals, trusting_period_s,
                        now_ns, max_clock_drift_s)


def verify_chain_batched(trusted_lb, chain, trusting_period_s: float,
                         now_ns: int, max_clock_drift_s: float,
                         trust_level: Fraction = DEFAULT_TRUST_LEVEL) -> None:
    """Chain verification in one device batch: step trust through
    ``chain`` (a list of LightBlocks, ascending heights) with the SAME
    accept/reject semantics as calling :func:`verify` per step — but every
    signature check across every header rides ONE ``BatchVerifier`` call
    (on the card, one pass of the K5/K7 verify kernels).

    Each ``verify_commit_light*`` call of the replay then finds its whole
    batch in :data:`crypto.batch.precomputed_verdicts` and launches nothing
    (``batch.stats["precomputed_batches"]`` counts those hits: one per
    adjacent step, two per non-adjacent step). The sequential light path
    (the client's verifySequential, header-range proxies) batches the
    whole range. Raises the first failing step's error; header-rule checks
    stay strictly sequential.
    """
    from ..crypto.batch import BatchVerifier

    # one verification per (step, commit idx); both the trusting and light
    # checks of a step share commit signatures
    chain_id = trusted_lb.signed_header.header.chain_id
    bv = BatchVerifier(plane="light")
    keys = []  # (pubkey bytes, sign-bytes, signature), in batch order
    for target in chain:
        commit = target.signed_header.commit
        # all for-block signatures; the trusting check's address-lookup keys
        # to the same pubkey bytes (address = hash(pubkey)), so both checks
        # hit this one verification
        vals = target.validator_set.validators
        sb = None  # the commit's memoized sign-bytes, which the replay's
        # _batch_verify reads too (equal to vote_sign_bytes per index)
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block() or idx >= len(vals):
                # malformed shapes are NOT pre-verified: the replay phase's
                # structural checks raise the same typed error as the
                # sequential path (a miss there makes a batch call of its own)
                continue
            if sb is None:
                sb = commit.vote_sign_bytes_all(chain_id)
            keys.append((vals[idx].pub_key.bytes(), sb[idx], cs.signature))
            bv.add(vals[idx].pub_key, sb[idx], cs.signature)
    _, verdicts = bv.verify()

    # replay the exact sequential semantics; every signature check hits the
    # precomputed verdicts (crypto/batch.py contextvar) — zero extra dispatch
    pre = {k: bool(v) for k, v in zip(keys, verdicts)}

    from ..crypto.batch import precomputed_verdicts

    token = precomputed_verdicts.set(pre)
    try:
        trusted = trusted_lb
        for target in chain:
            verify(trusted.signed_header, trusted.validator_set,
                   target.signed_header, target.validator_set,
                   trusting_period_s, now_ns, max_clock_drift_s, trust_level)
            trusted = target
    finally:
        precomputed_verdicts.reset(token)


def verify_backwards(untrusted, trusted) -> None:
    """(light/verifier.go:221) headers, untrusted.height == trusted.height-1."""
    untrusted.validate_basic()
    if untrusted.chain_id != trusted.chain_id:
        raise ErrInvalidHeader("header belongs to another chain")
    if untrusted.time_ns >= trusted.time_ns:
        raise ErrInvalidHeader(
            "expected older header time to be before new header time")
    if untrusted.hash() != trusted.last_block_id.hash:
        raise ErrInvalidHeader(
            f"older header hash {untrusted.hash().hex()} does not match "
            f"trusted header's last block {trusted.last_block_id.hash.hex()}")
