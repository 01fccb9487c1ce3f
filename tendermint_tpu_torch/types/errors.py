"""Typed errors for commit/vote verification (reference types/errors.go, types/vote.go)."""

from __future__ import annotations


class TypesError(Exception):
    pass


class ErrInvalidCommitHeight(TypesError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"invalid commit -- wrong height: {expected} vs {actual}")
        self.expected = expected
        self.actual = actual


class ErrInvalidCommitSignatures(TypesError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"invalid commit -- wrong set size: {expected} vs {actual}")
        self.expected = expected
        self.actual = actual


class ErrNotEnoughVotingPowerSigned(TypesError):
    def __init__(self, got: int, needed: int):
        super().__init__(f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}")
        self.got = got
        self.needed = needed


class ErrWrongSignature(TypesError):
    def __init__(self, idx: int, sig: bytes):
        super().__init__(f"wrong signature (#{idx}): {sig.hex().upper()}")
        self.idx = idx


class ErrVoteInvalidSignature(TypesError):
    def __init__(self):
        super().__init__("invalid signature")


class ErrVoteInvalidValidatorAddress(TypesError):
    def __init__(self):
        super().__init__("invalid validator address")


class ErrVoteNonDeterministicSignature(TypesError):
    pass


class ErrVoteConflictingVotes(TypesError):
    def __init__(self, vote_a, vote_b):
        super().__init__("conflicting votes from validator")
        self.vote_a = vote_a
        self.vote_b = vote_b
