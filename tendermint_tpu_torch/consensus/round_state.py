"""Round bookkeeping: RoundStep, RoundState, HeightVoteSet
(reference consensus/types/round_state.go:67, height_vote_set.go:41).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Set, Tuple

from ..types import ValidatorSet, VoteSet
from ..types.basic import BlockID, SignedMsgType
from ..types.block import Block, Commit
from ..types.errors import ErrVoteConflictingVotes
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.vote import Vote


class RoundStep(IntEnum):
    """(round_state.go:20-32)"""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8

    def short_name(self) -> str:
        return {
            1: "NewHeight", 2: "NewRound", 3: "Propose", 4: "Prevote",
            5: "PrevoteWait", 6: "Precommit", 7: "PrecommitWait", 8: "Commit",
        }[int(self)]


@dataclass
class RoundState:
    """The consensus core's mutable view of one height (round_state.go:67)."""

    height: int = 0
    round: int = 0
    step: RoundStep = RoundStep.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional["HeightVoteSet"] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False


class HeightVoteSet:
    """One prevote + precommit VoteSet per round; tracks peer maj23 claims
    (consensus/types/height_vote_set.go:41). Keeps round 0..round+1 live to
    allow round skipping.
    """

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 verifier=None):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.verifier = verifier
        self.round = 0
        self._round_vote_sets: Dict[int, Tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: Dict[str, List[int]] = {}
        self._add_round(0)
        self._add_round(1)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        prevotes = VoteSet(self.chain_id, self.height, round_,
                           SignedMsgType.PREVOTE, self.val_set,
                           verifier=self.verifier)
        precommits = VoteSet(self.chain_id, self.height, round_,
                             SignedMsgType.PRECOMMIT, self.val_set,
                             verifier=self.verifier)
        self._round_vote_sets[round_] = (prevotes, precommits)

    def set_round(self, round_: int) -> None:
        """Track round 0..round (height_vote_set.go:104 SetRound)."""
        new_round = self.round - 1 if self.round > 0 else 0
        for r in range(new_round, round_ + 1):
            self._add_round(r)
        self.round = round_

    def add_vote(self, vote: Vote, peer_id: str) -> bool:
        """(height_vote_set.go:117) — peer catchup rounds are rate-limited to 2."""
        if not self._is_vote_type_valid(vote.type):
            return False
        vote_set = self._get_vote_set(vote.round, vote.type)
        if vote_set is None:
            rndz = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rndz) < 2:
                self._add_round(vote.round)
                vote_set = self._get_vote_set(vote.round, vote.type)
                rndz.append(vote.round)
            else:
                raise GotVoteFromUnwantedRound(
                    f"peer has sent a vote that does not match our round for more "
                    f"than one round; peer={peer_id} height={vote.height} round={vote.round}")
        return vote_set.add_vote(vote)

    @staticmethod
    def _is_vote_type_valid(t: SignedMsgType) -> bool:
        return t in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, SignedMsgType.PREVOTE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, SignedMsgType.PRECOMMIT)

    def _get_vote_set(self, round_: int, t: SignedMsgType) -> Optional[VoteSet]:
        pair = self._round_vote_sets.get(round_)
        if pair is None:
            return None
        return pair[0] if t == SignedMsgType.PREVOTE else pair[1]

    def pol_info(self) -> Tuple[int, Optional[BlockID]]:
        """Last round with a prevote polka, searched descending
        (height_vote_set.go:185 POLInfo)."""
        for r in range(self.round, -1, -1):
            rvs = self.prevotes(r)
            if rvs is not None:
                block_id, ok = rvs.two_thirds_majority()
                if ok:
                    return r, block_id
        return -1, None

    def set_peer_maj23(self, round_: int, vote_type: SignedMsgType,
                       peer_id: str, block_id: BlockID) -> None:
        if not self._is_vote_type_valid(vote_type):
            return
        self._add_round(round_)
        vote_set = self._get_vote_set(round_, vote_type)
        vote_set.set_peer_maj23(peer_id, block_id)


class GotVoteFromUnwantedRound(Exception):
    pass


def commit_to_vote_set(chain_id: str, commit: Commit,
                       val_set: ValidatorSet) -> "VoteSet | AggregatedLastCommit":
    """Reconstruct the precommit VoteSet backing a Commit
    (reference types/vote_set.go CommitToVoteSet in vote_set.go / block.go).
    An AggregatedCommit cannot be exploded back into votes (the per-validator
    signatures are gone) — it is wrapped in the read-only adapter instead."""
    if hasattr(commit, "agg_sig"):
        val_set.verify_commit_light(chain_id, commit.block_id, commit.height,
                                    commit)
        return AggregatedLastCommit(chain_id, commit, val_set)
    vote_set = VoteSet(chain_id, commit.height, commit.round,
                       SignedMsgType.PRECOMMIT, val_set)
    for idx, cs in enumerate(commit.signatures):
        if cs.absent():
            continue
        added = vote_set.add_vote(commit.get_vote(idx))
        if not added:
            raise ValueError(f"failed to reconstruct LastCommit: vote {idx} not added")
    return vote_set


class AggregatedLastCommit:
    """Read-only stand-in for rs.last_commit after a restart on an
    aggregated chain.  The stored AggregatedCommit has no per-validator
    votes to re-add or gossip, so this adapter answers the VoteSet surface
    the consensus core and reactor actually touch: the majority is already
    proven (verified in commit_to_vote_set), make_commit returns the commit
    verbatim for the next proposal, late precommits are dropped, and the
    vote-gossip bit array is empty so nothing tries to fetch votes that no
    longer exist (peers one height back catch up via block sync)."""

    def __init__(self, chain_id: str, commit, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = commit.height
        self.round = commit.round
        self.signed_msg_type = SignedMsgType.PRECOMMIT
        self.val_set = val_set
        self._commit = commit

    def size(self) -> int:
        return self._commit.size()

    def has_two_thirds_majority(self) -> bool:
        return True

    def two_thirds_majority(self):
        return self._commit.block_id, True

    def make_commit(self):
        return self._commit

    def add_vote(self, vote) -> bool:
        return False  # nothing to accumulate into

    def list_votes(self):
        # no per-validator votes survive aggregation — the subjective
        # commit-time window check then falls back to its clock bound
        return []

    def has_all(self) -> bool:
        return self._commit.signers.is_full()

    def bit_array(self):
        from ..libs.bits import BitArray

        return BitArray(self._commit.size())

    def get_by_index(self, idx: int):
        return None
