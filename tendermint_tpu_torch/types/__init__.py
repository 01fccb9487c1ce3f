"""Domain types (the reference's types/ tier, SURVEY.md §2.2).

This slice of the port carries what commit verification needs: BlockID,
Validator/ValidatorSet, Vote, Header, Commit/CommitSig and the canonical
sign-bytes. The rest of types/ (vote_set, evidence, genesis, part_set,
params, ...) comes with the next slice.
"""

from .basic import (  # noqa: F401
    BlockID,
    BlockIDFlag,
    PartSetHeader,
    SignedMsgType,
    ZERO_TIME_NS,
)
from .validator import Validator, new_validator  # noqa: F401
from .validator_set import ValidatorSet  # noqa: F401
from .vote import Vote  # noqa: F401
from .block import Commit, CommitSig, Header  # noqa: F401
