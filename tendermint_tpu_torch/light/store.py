"""Trusted light-block store on the DB abstraction
(reference light/store/db/db.go)."""

from __future__ import annotations

from typing import List, Optional

from ..libs.db import DB
from ..libs import protowire as pw
from ..types.light_block import LightBlock, SignedHeader
from ..types.validator_set import ValidatorSet

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    def __init__(self, db: DB):
        self.db = db

    def save(self, lb: LightBlock) -> None:
        w = pw.Writer()
        w.message(1, lb.signed_header.encode())
        w.message(2, lb.validator_set.encode())
        self.db.set(_key(lb.signed_header.header.height), w.finish())

    def get(self, height: int) -> Optional[LightBlock]:
        raw = self.db.get(_key(height))
        if raw is None:
            return None
        lb = LightBlock()
        for fn, _wt, v in pw.iter_fields(raw):
            if fn == 1:
                lb.signed_header = SignedHeader.decode(v)
            elif fn == 2:
                lb.validator_set = ValidatorSet.decode(v)
        return lb

    def latest_height(self) -> int:
        for k, _v in self.db.iterate(_PREFIX, _PREFIX + b"\xff", reverse=True):
            return int.from_bytes(k[len(_PREFIX):], "big")
        return 0

    def first_height(self) -> int:
        for k, _v in self.db.iterate(_PREFIX, _PREFIX + b"\xff"):
            return int.from_bytes(k[len(_PREFIX):], "big")
        return 0

    def latest(self) -> Optional[LightBlock]:
        h = self.latest_height()
        return self.get(h) if h else None

    def heights(self) -> List[int]:
        return [int.from_bytes(k[len(_PREFIX):], "big")
                for k, _ in self.db.iterate(_PREFIX, _PREFIX + b"\xff")]

    def prune(self, keep: int) -> None:
        hs = self.heights()
        for h in hs[:-keep] if keep else hs:
            self.db.delete(_key(h))
