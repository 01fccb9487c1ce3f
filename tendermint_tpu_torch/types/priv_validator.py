"""PrivValidator interface + MockPV (reference types/priv_validator.go:15).

The file-backed FilePV with double-sign protection (reference
privval/file.go) is not ported yet.
"""

from __future__ import annotations

from .. import crypto
from .proposal import Proposal
from .vote import Vote


class PrivValidator:
    def get_pub_key(self) -> crypto.PubKey:
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature in place (as the reference mutates the proto)."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        raise NotImplementedError


class MockPV(PrivValidator):
    """In-memory signer for tests (types/priv_validator.go MockPV)."""

    def __init__(self, priv_key: "crypto.PrivKey | None" = None,
                 break_proposal_sigs: bool = False, break_vote_sigs: bool = False):
        self.priv_key = priv_key or crypto.Ed25519PrivKey.generate()
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    def get_pub_key(self) -> crypto.PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_vote_sigs else chain_id
        vote.signature = self.priv_key.sign(vote.sign_bytes(use_chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_proposal_sigs else chain_id
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(use_chain_id))
