"""BlockStore: block metas/parts/commits by height (reference store/store.go:33).

Key layout mirrors the reference (store/store.go:434-456): H:<h> meta,
P:<h>:<i> part, C:<h> last commit, SC:<h> seen commit, BH:<hash> → height,
plus the blockStore state record holding (base, height) for pruning.
"""

from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..libs.db import DB, BufferedDB
from ..types.basic import BlockID
from ..types.block import Block, BlockMeta, Commit
from ..types.part_set import Part, PartSet


def _meta_key(h: int) -> bytes:
    return f"H:{h}".encode()


def _part_key(h: int, i: int) -> bytes:
    return f"P:{h}:{i}".encode()


def _commit_key(h: int) -> bytes:
    return f"C:{h}".encode()


def _seen_commit_key(h: int) -> bytes:
    return f"SC:{h}".encode()


def _hash_key(hash_: bytes) -> bytes:
    return b"BH:" + hash_.hex().encode()


_STORE_KEY = b"blockStore"


@dataclass
class BlockStoreState:
    base: int = 0
    height: int = 0


class BlockStore:
    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()
        st = self._load_state()
        self._base = st.base
        self._height = st.height

    # -- state record ------------------------------------------------------

    def _load_state(self) -> BlockStoreState:
        raw = self._db.get(_STORE_KEY)
        if raw is None:
            return BlockStoreState()
        d = json.loads(raw.decode())
        return BlockStoreState(d.get("base", 0), d.get("height", 0))

    def _save_state(self) -> None:
        self._db.set(_STORE_KEY, json.dumps(
            {"base": self._base, "height": self._height}).encode())

    # -- accessors ---------------------------------------------------------

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return self._height - self._base + 1 if self._height > 0 else 0

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_meta_key(height))
        return BlockMeta.decode(raw) if raw is not None else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            raw = self._db.get(_part_key(height, i))
            if raw is None:
                return None
            parts.append(Part.decode(raw).bytes_)
        return Block.decode(b"".join(parts))

    def load_block_by_hash(self, hash_: bytes) -> Optional[Block]:
        raw = self._db.get(_hash_key(hash_))
        if raw is None:
            return None
        return self.load_block(int(raw.decode()))

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_part_key(height, index))
        return Part.decode(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The canonical commit for height, stored at height+1 save time."""
        raw = self._db.get(_commit_key(height))
        return Commit.decode(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(_seen_commit_key(height))
        return Commit.decode(raw) if raw is not None else None

    # -- writes ------------------------------------------------------------

    @contextmanager
    def window_batch(self):
        """Stage every write inside the scope and flush them as ONE DB
        write-batch at exit (fast-sync applies a 16-block window per
        iteration; per-block write_batch + state-record writes were a
        measurable share of apply wall-clock). Reads inside the scope see
        the staged writes. Flushes on error too — staged writes describe
        blocks whose ABCI commit already happened. Reentrant: a nested
        scope joins the outer batch."""
        with self._mtx:
            nested = isinstance(self._db, BufferedDB)
            if not nested:
                buf = BufferedDB(self._db)
                self._db = buf
        if nested:  # outside the mutex: the outer scope owns the flush
            yield self
            return
        try:
            yield self
        finally:
            with self._mtx:
                # flush BEFORE unhooking: on a flush fault (injected or
                # real EIO) the staged window stays reachable as self._db,
                # so reads remain consistent with the handled-but-not-yet-
                # durable state while the fatal handler runs
                buf.flush()
                self._db = buf.base

    def save_block(self, block: Block, block_parts: PartSet, seen_commit: Commit) -> None:
        """(store/store.go:332 SaveBlock)"""
        height = block.header.height
        with self._mtx:
            expected = self._height + 1
            if self._height > 0 and height != expected:
                raise ValueError(f"BlockStore can only save contiguous blocks. Wanted {expected}, got {height}")
            block_id = BlockID(block.hash(), block_parts.header())
            # parts ARE the encoding split, so their byte total is the block
            # size — re-encoding the whole block just to measure it doubled
            # the save path's proto work
            meta = BlockMeta(block_id, block_parts.byte_size, block.header,
                             len(block.data.txs))
            sets: List[Tuple[bytes, bytes]] = [
                (_meta_key(height), meta.encode()),
                (_hash_key(block.hash()), str(height).encode()),
            ]
            for i in range(block_parts.total):
                part = block_parts.get_part(i)
                sets.append((_part_key(height, i), part.encode()))
            if block.last_commit is not None:
                sets.append((_commit_key(height - 1), block.last_commit.encode()))
            sets.append((_seen_commit_key(height), seen_commit.encode()))
            self._db.write_batch(sets)
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_state()

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        self._db.set(_seen_commit_key(height), commit.encode())

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height; returns count pruned
        (store/store.go:248)."""
        with self._mtx:
            if retain_height <= 0 or retain_height > self._height:
                raise ValueError(f"cannot prune to height {retain_height}")
            if retain_height <= self._base:
                return 0
            pruned = 0
            deletes: List[bytes] = []
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_meta_key(h))
                deletes.append(_hash_key(meta.header.hash() or b""))
                for i in range(meta.block_id.part_set_header.total):
                    deletes.append(_part_key(h, i))
                deletes.append(_commit_key(h))
                deletes.append(_seen_commit_key(h))
                pruned += 1
            # durability boundary (crashmatrix): the prune set is chosen but
            # not applied — a kill here must leave either the pre-prune or
            # post-prune store, never a half-readable base
            from ..libs.fail import fail_point

            fail_point("prune.mid_blocks")
            self._db.write_batch([], deletes)
            self._base = retain_height
            self._save_state()
            return pruned

    def load_base_meta(self) -> Optional[BlockMeta]:
        with self._mtx:
            return self.load_block_meta(self._base) if self._base > 0 else None
