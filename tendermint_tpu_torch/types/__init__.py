"""Domain types (the reference's types/ tier, SURVEY.md §2.2).

Byte-identical wire artifacts: canonical sign-bytes, header/commit/validator-set
merkle hashes all match Tendermint v0.34.24 (reference types/canonical.go,
types/block.go:440, types/validator.go:117). Time is integer unix-nanoseconds
throughout (Go time.Time parity incl. the year-1 zero value).
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
from .block import Block, Commit, CommitSig, Data, Header  # noqa: F401
from .proposal import Proposal  # noqa: F401
from .part_set import Part, PartSet  # noqa: F401
from .vote_set import VoteSet  # noqa: F401
from .params import ConsensusParams, default_consensus_params  # noqa: F401
from .evidence import (  # noqa: F401
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
)
from .genesis import GenesisDoc, GenesisValidator  # noqa: F401
from .priv_validator import MockPV, PrivValidator  # noqa: F401
from .errors import (  # noqa: F401
    ErrInvalidCommitHeight,
    ErrInvalidCommitSignatures,
    ErrNotEnoughVotingPowerSigned,
    ErrVoteInvalidSignature,
)
