"""VoteSet: tally for one (height, round, type) (reference types/vote_set.go:61).

Semantics preserved exactly: dedup by validator index, conflicting-vote
detection (→ evidence), only-first-quorum maj23 selection, peer-claimed maj23
tracking. The signature check inside add_vote stays scalar (votes arrive one
at a time over gossip); commit-at-once paths use the batched verifier in
ValidatorSet.verify_commit*.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..libs.bits import BitArray
from .basic import BlockID, BlockIDFlag, SignedMsgType
from .block import Commit, CommitSig
from .errors import ErrVoteConflictingVotes
from .validator_set import ValidatorSet
from .vote import Vote


class VoteSetError(Exception):
    pass


class ErrVoteNonDeterministicSignatureSet(VoteSetError):
    pass


@dataclass
class _BlockVotes:
    """Votes for one particular block (vote_set.go blockVotes)."""

    peer_maj23: bool
    bit_array: BitArray
    votes: List[Optional[Vote]]
    sum: int = 0

    @staticmethod
    def new(peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return _BlockVotes(peer_maj23, BitArray(num_validators), [None] * num_validators, 0)

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        if 0 <= idx < len(self.votes):
            return self.votes[idx]
        return None


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: SignedMsgType, val_set: ValidatorSet,
                 verifier=None):
        if height == 0:
            raise ValueError("Cannot make VoteSet for height == 0, doesn't make sense")
        # signature verifier seam (crypto/vote_batcher.py): None = plain
        # host scalar verify, BatchVoteVerifier = micro-batched device path
        # with one-shot verdict cache fed by the reactor's preverification
        self.verifier = verifier
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self._mtx = threading.Lock()
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: List[Optional[Vote]] = [None] * val_set.size()
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    # -- adding votes ------------------------------------------------------

    def add_vote(self, vote: Optional[Vote]) -> bool:
        """Returns True if added. Duplicate → False. Conflicting →
        ErrVoteConflictingVotes (vote_set.go:145)."""
        with self._mtx:
            return self._add_vote(vote)

    def _add_vote(self, vote: Optional[Vote]) -> bool:
        if vote is None:
            raise VoteSetError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise VoteSetError("index < 0: invalid validator index")
        if len(val_addr) == 0:
            raise VoteSetError("empty address: invalid validator address")
        if (vote.height != self.height or vote.round != self.round
                or vote.type != self.signed_msg_type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, but got "
                f"{vote.height}/{vote.round}/{vote.type}: unexpected step"
            )
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteSetError(
                f"cannot find validator {val_index} in valSet of size "
                f"{self.val_set.size()}: invalid validator index"
            )
        if val_addr != lookup_addr:
            raise VoteSetError(
                f"vote.ValidatorAddress ({val_addr.hex()}) does not match address "
                f"({lookup_addr.hex()}) for vote.ValidatorIndex ({val_index})"
            )

        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise ErrVoteNonDeterministicSignatureSet(
                f"existing vote: {existing}; new vote: {vote}"
            )

        if self.verifier is None:
            vote.verify(self.chain_id, val.pub_key)
        else:
            vote.verify_with(self.chain_id, val.pub_key, self.verifier)

        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote)
        if not added:
            raise VoteSetError("Expected to add non-conflicting vote")
        return added

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        existing = self.votes[val_index] if val_index < len(self.votes) else None
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        by_block = self.votes_by_block.get(block_key)
        if by_block is not None:
            return by_block.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes,
                           voting_power: int) -> Tuple[bool, Optional[Vote]]:
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise VoteSetError("addVerifiedVote does not expect duplicate votes")
            conflicting = existing
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        by_block = self.votes_by_block.get(block_key)
        if by_block is not None:
            if conflicting is not None and not by_block.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            by_block = _BlockVotes.new(False, self.val_set.size())
            self.votes_by_block[block_key] = by_block

        orig_sum = by_block.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        by_block.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= by_block.sum:
            if self.maj23 is None:
                self.maj23 = vote.block_id
                for i, v in enumerate(by_block.votes):
                    if v is not None:
                        self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """Record a peer's claim of 2/3 majority for a block (vote_set.go:313)."""
        with self._mtx:
            block_key = block_id.key()
            existing = self.peer_maj23s.get(peer_id)
            if existing is not None:
                if existing == block_id:
                    return
                raise VoteSetError(
                    f"setPeerMaj23: Received conflicting blockID from peer {peer_id}. "
                    f"Got {block_id}, expected {existing}"
                )
            self.peer_maj23s[peer_id] = block_id
            by_block = self.votes_by_block.get(block_key)
            if by_block is not None:
                if by_block.peer_maj23:
                    return
                by_block.peer_maj23 = True
            else:
                self.votes_by_block[block_key] = _BlockVotes.new(True, self.val_set.size())

    # -- queries -----------------------------------------------------------

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        with self._mtx:
            by_block = self.votes_by_block.get(block_id.key())
            if by_block is not None:
                return by_block.bit_array.copy()
            return None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        with self._mtx:
            if 0 <= val_index < len(self.votes):
                return self.votes[val_index]
            return None

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        with self._mtx:
            idx, _ = self.val_set.get_by_address(address)
            if idx >= 0:
                return self.votes[idx]
            return None

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self.maj23 is not None

    def two_thirds_majority(self) -> Tuple[BlockID, bool]:
        """(blockID, True) if 2/3 majority reached (vote_set.go:449)."""
        with self._mtx:
            if self.maj23 is not None:
                return self.maj23, True
            return BlockID(), False

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._mtx:
            return self.sum == self.val_set.total_voting_power()

    def size(self) -> int:
        return self.val_set.size()

    def list_votes(self) -> List[Vote]:
        with self._mtx:
            return [v for v in self.votes if v is not None]

    # -- commit building ---------------------------------------------------

    def make_commit(self) -> Commit:
        """Requires an unambiguous 2/3 majority (vote_set.go:612).  On
        aggregated chains the maj23 precommits fold into one
        AggregatedCommit instead of a CommitSig list."""
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise VoteSetError("Cannot MakeCommit() unless VoteSet.Type is PRECOMMIT")
        from ..crypto import schemes

        with self._mtx:
            if self.maj23 is None:
                raise VoteSetError("Cannot MakeCommit() unless a blockhash has +2/3")
            if schemes.aggregated(self.chain_id):
                return self._make_aggregated_commit()
            commit_sigs = []
            for v in self.votes:
                cs = vote_to_commit_sig(v)
                # Sig for a different block than maj23 → excluded (vote_set.go:629).
                if cs.for_block() and v.block_id != self.maj23:
                    cs = CommitSig.new_absent()
                commit_sigs.append(cs)
            return Commit(self.height, self.round, self.maj23, commit_sigs)

    def _make_aggregated_commit(self):
        """Called with the lock held, maj23 set.  Every maj23 precommit
        signed the SAME zero-timestamp payload (Vote.sign_bytes on
        aggregated chains), so the signatures fold into one 48-byte BLS
        aggregate; nil/other-block votes simply stay out of the bitmap.
        The commit timestamp is the voting-power-weighted median of the
        included votes' (wire-carried) timestamps — the same WeightedMedian
        state.median_time computes for CommitSig lists."""
        from ..crypto import bls12381 as bls
        from .block import AggregatedCommit

        signers = BitArray(self.val_set.size())
        sigs: List[bytes] = []
        weighted = []
        total_power = 0
        for i, v in enumerate(self.votes):
            if v is None or not v.block_id.is_complete() or v.block_id != self.maj23:
                continue
            signers.set_index(i, True)
            sigs.append(v.signature)
            power = self.val_set.validators[i].voting_power
            weighted.append((v.timestamp_ns, power))
            total_power += power
        agg_sig = bls.aggregate(sigs)
        weighted.sort()
        median = total_power // 2
        ts = 0
        for t, power in weighted:
            if median <= power:  # types/time/time.go:50 WeightedMedian
                ts = t
                break
            median -= power
        return AggregatedCommit(self.height, self.round, self.maj23, [],
                                signers=signers, agg_sig=agg_sig,
                                timestamp_ns=ts)


def vote_to_commit_sig(v: Optional[Vote]) -> CommitSig:
    """Vote → CommitSig (types/vote.go:62)."""
    if v is None:
        return CommitSig.new_absent()
    if v.block_id.is_complete():
        flag = BlockIDFlag.COMMIT
    elif v.block_id.is_zero():
        flag = BlockIDFlag.NIL
    else:
        raise ValueError(f"Invalid vote {v} - expected BlockID to be either empty or complete")
    return CommitSig(flag, v.validator_address, v.timestamp_ns, v.signature)
