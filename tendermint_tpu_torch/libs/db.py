"""Ordered key-value store behind a tm-db-style interface.

The reference depends on the external tm-db module (goleveldb default —
SURVEY.md §2.11). Here: `MemDB` (sorted in-memory) with prefix iteration
and write batches, which is all the stores need, and `BufferedDB`, the
write buffer over it. The JAX package's on-disk `SQLiteDB` comes with the
node's slice of the port.
"""

from __future__ import annotations

import bisect
import errno
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from .faults import faults


def _injected_db_fault(site: str) -> OSError:
    return OSError(errno.EIO, f"injected fault at {site}")


def _torn_write_cut(n_sets: int) -> "int | None":
    """Evaluate the ``db.torn_write`` site against a batch of n_sets
    records: a fired site returns the seeded prefix length to apply before
    failing (the batch-level analog of a byte-level torn write)."""
    return faults.tear_index("db.torn_write", n_sets)


class DB:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterate(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        """Half-open [start, end), ordered by raw bytes."""
        raise NotImplementedError

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        return self.iterate(prefix, _prefix_end(prefix))

    def write_batch(self, sets: List[Tuple[bytes, bytes]],
                    deletes: Optional[List[bytes]] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _prefix_end(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every key with this prefix."""
    p = bytearray(prefix)
    while p:
        if p[-1] != 0xFF:
            p[-1] += 1
            return bytes(p)
        p.pop()
    return None


class BufferedDB(DB):
    """Read-through write buffer over a base DB.

    set/delete are staged in memory; get/iterate see the overlay merged over
    the base, so code running inside the buffered scope observes its own
    writes (e.g. load_validators following a pointer record written earlier
    in the same window). flush() applies everything as ONE base write_batch —
    the per-window store-write batching the fast-sync apply plane relies on.
    Not a transaction: flush is called on success AND on error (the staged
    writes describe work that already happened in the app)."""

    def __init__(self, base: DB) -> None:
        self.base = base
        self._sets: Dict[bytes, bytes] = {}
        self._dels: set = set()

    def get(self, key: bytes) -> Optional[bytes]:
        v = self._sets.get(key)
        if v is not None:
            return v
        if key in self._dels:
            return None
        return self.base.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self._dels.discard(key)
        self._sets[key] = value

    def delete(self, key: bytes) -> None:
        self._sets.pop(key, None)
        self._dels.add(key)

    def iterate(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        # materialized merge: buffered scopes are one verify-window long, so
        # the simple, obviously-correct view beats a streaming merge
        merged = {k: v for k, v in self.base.iterate(start, end)}
        for k in self._dels:
            merged.pop(k, None)
        for k, v in self._sets.items():
            if (start is None or k >= start) and (end is None or k < end):
                merged[k] = v
        for k in sorted(merged, reverse=reverse):
            yield k, merged[k]

    def write_batch(self, sets, deletes=None) -> None:
        for k, v in sets:
            self.set(k, v)
        for k in deletes or []:
            self.delete(k)

    def pending(self) -> int:
        return len(self._sets) + len(self._dels)

    def flush(self) -> None:
        """Apply the staged window as one base write_batch. fsyncgate
        semantics: a failed flush raises WITHOUT clearing the staged
        writes — the records were handled by the app but are NOT durable,
        and silently dropping them here is exactly the
        handled-but-not-durable hole the chaos suite hunts. Callers treat
        the error as fatal (blockchain reactor → on_fatal) or retry the
        flush; injectable at the base DB's ``db.write_batch`` site."""
        from .trace import tracer

        if self._sets or self._dels:
            with tracer.span("window_flush", n_sets=len(self._sets),
                             n_dels=len(self._dels)):
                self.base.write_batch(list(self._sets.items()),
                                      list(self._dels))
        self._sets.clear()
        self._dels.clear()


class MemDB(DB):
    def __init__(self) -> None:
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect.bisect_left(self._keys, key)
                self._keys.pop(i)

    def iterate(self, start: Optional[bytes] = None, end: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            lo = bisect.bisect_left(self._keys, start) if start is not None else 0
            hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
            keys = self._keys[lo:hi]
        if reverse:
            keys = list(reversed(keys))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, sets, deletes=None) -> None:
        # chaos site: a fired fault applies NOTHING (all-or-nothing)
        faults.inject("db.write_batch", _injected_db_fault)
        # torn-write site: MemDB has no transaction, so a torn batch leaves
        # a PARTIAL prefix applied — the retry (BufferedDB keeps the staged
        # window on error) must land the whole window via idempotent upserts
        cut = _torn_write_cut(len(sets))
        if cut is not None:
            with self._lock:
                for k, v in list(sets)[:cut]:
                    self.set(k, v)
            raise _injected_db_fault("db.torn_write")
        with self._lock:
            for k, v in sets:
                self.set(k, v)
            for k in deletes or []:
                self.delete(k)
