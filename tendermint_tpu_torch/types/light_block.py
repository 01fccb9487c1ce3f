"""SignedHeader + LightBlock (reference types/block.go SignedHeader,
types/light_block.go LightBlock; proto types.proto:137-146).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..libs import protowire as pw
from .block import Commit, Header
from .validator_set import ValidatorSet


@dataclass
class SignedHeader:
    header: Optional[Header] = None
    commit: Optional[Commit] = None

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(f"header belongs to another chain {self.header.chain_id!r}, "
                             f"not {chain_id!r}")
        if self.commit.height != self.header.height:
            raise ValueError(
                f"header and commit height mismatch: {self.header.height} vs {self.commit.height}")
        hhash, chash = self.header.hash(), self.commit.block_id.hash
        if hhash != chash:
            raise ValueError(
                f"commit signs block {chash.hex()}, header is block {hhash.hex()}")

    @property
    def height(self) -> int:
        return self.header.height if self.header else 0

    def encode(self) -> bytes:
        w = pw.Writer()
        if self.header is not None:
            w.message(1, self.header.encode())
        if self.commit is not None:
            w.message(2, self.commit.encode())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "SignedHeader":
        sh = SignedHeader()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                sh.header = Header.decode(v)
            elif fn == 2:
                sh.commit = Commit.decode(v)
        return sh


@dataclass
class LightBlock:
    signed_header: Optional[SignedHeader] = None
    validator_set: Optional[ValidatorSet] = None

    def validate_basic(self, chain_id: str) -> None:
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise ValueError(
                f"expected validators hash of header to match validator set hash "
                f"({self.signed_header.header.validators_hash.hex()}, "
                f"{self.validator_set.hash().hex()})")

    @property
    def height(self) -> int:
        return self.signed_header.height if self.signed_header else 0

    def encode(self) -> bytes:
        w = pw.Writer()
        if self.signed_header is not None:
            w.message(1, self.signed_header.encode())
        if self.validator_set is not None:
            w.message(2, self.validator_set.encode())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "LightBlock":
        lb = LightBlock()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                lb.signed_header = SignedHeader.decode(v)
            elif fn == 2:
                lb.validator_set = ValidatorSet.decode(v)
        return lb
