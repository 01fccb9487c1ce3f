"""Consensus engine (reference consensus/, SURVEY.md §2.1).

Single-writer async state machine driving the one-height/many-round Tendermint
BFT protocol: NewRound → Propose → Prevote → PrevoteWait → Precommit →
PrecommitWait → Commit, with WAL-before-act crash recovery (``wal``,
``replay``) and the consensus reactor (``reactor``) that gossips over the
port's switch. A fault of the card never becomes a verdict about a block or
a vote here: ``state`` re-raises it where the reference would prevote nil,
and ``reactor`` drops the vote delivery it came with.
"""

from .config import ConsensusConfig  # noqa: F401
from .round_state import HeightVoteSet, RoundState, RoundStep  # noqa: F401
from .state import ConsensusState  # noqa: F401
from .wal import WAL, FsyncError, NilWAL  # noqa: F401
