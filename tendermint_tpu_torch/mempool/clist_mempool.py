"""FIFO mempool with async-style CheckTx and post-block recheck
(reference mempool/v0/clist_mempool.go:26).

The clist structure in the reference exists so per-peer gossip goroutines can
block at the tail; here an ordered dict + per-peer cursor indexes give the
same semantics for asyncio gossip tasks (see mempool reactor).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..abci import types as abci
from ..abci.client import Client

MAX_TX_CACHE = 10000


class MempoolError(Exception):
    pass


class ErrTxInCache(MempoolError):
    def __init__(self):
        super().__init__("tx already exists in cache")


@dataclass
class MempoolTx:
    tx: bytes
    height: int  # height when validated
    gas_wanted: int
    senders: Set[str]  # peers that sent us this tx (mempool/v0 memTx.senders)
    key: bytes = b""  # sha256(tx), precomputed for gossip bookkeeping


class TxCache:
    """LRU of recently seen tx hashes (mempool/cache.go)."""

    def __init__(self, size: int = MAX_TX_CACHE):
        self._size = size
        self._map: "OrderedDict[bytes, None]" = OrderedDict()

    def push(self, tx: bytes) -> bool:
        """False if already present."""
        key = hashlib.sha256(tx).digest()
        if key in self._map:
            self._map.move_to_end(key)
            return False
        self._map[key] = None
        if len(self._map) > self._size:
            self._map.popitem(last=False)
        return True

    def has(self, key: bytes) -> bool:
        """Membership by precomputed sha256 key (no recency bump)."""
        return key in self._map

    def remove(self, tx: bytes) -> None:
        self._map.pop(hashlib.sha256(tx).digest(), None)

    def reset(self) -> None:
        self._map.clear()


class CListMempool:
    def __init__(self, proxy_app: Client, height: int = 0,
                 max_txs: int = 5000, max_txs_bytes: int = 1073741824,
                 max_tx_bytes: int = 1048576, cache_size: int = MAX_TX_CACHE,
                 keep_invalid_txs_in_cache: bool = False,
                 recheck: bool = True):
        self._proxy_app = proxy_app
        self.metrics = None  # MempoolMetrics, wired by the node
        self.txlife = None  # libs/txlife.py TxLifecycle, wired by the node
        self._wal = None  # optional tx log (mempool/v0 WAL, mempool.go InitWAL)
        self._height = height
        self._max_txs = max_txs
        self._max_txs_bytes = max_txs_bytes
        self._max_tx_bytes = max_tx_bytes
        self._keep_invalid = keep_invalid_txs_in_cache
        self._recheck_enabled = recheck
        self.cache = TxCache(cache_size)
        self._txs: "OrderedDict[bytes, MempoolTx]" = OrderedDict()  # key=sha256(tx)
        self._txs_bytes = 0
        self._mtx = threading.RLock()
        self._notified_txs_available = False
        self.tx_available_callbacks: List[Callable[[], None]] = []
        self.pre_check: Optional[Callable[[bytes], None]] = None
        self.post_check: Optional[Callable[[bytes, abci.ResponseCheckTx], None]] = None

    # -- Mempool interface (mempool/mempool.go:30) -------------------------

    def size(self) -> int:
        with self._mtx:
            return len(self._txs)

    def tx_bytes(self) -> int:
        with self._mtx:
            return self._txs_bytes

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def flush_app_conn(self) -> None:
        self._proxy_app.flush()

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """Validate via app and add if OK (clist_mempool.go:203 CheckTx).

        Synchronous analogue of the reference's async path: the response
        callback logic (resCbFirstTime) runs inline.
        """
        with self._mtx:
            key = hashlib.sha256(tx).digest()
            tl = self.txlife
            if len(tx) > self._max_tx_bytes:
                self._count_failed("too-large")
                self._mark_capacity_reject(tl, key)
                raise MempoolError(
                    f"tx too large. Max size is {self._max_tx_bytes}, but got {len(tx)}")
            if len(self._txs) >= self._max_txs or \
                    self._txs_bytes + len(tx) > self._max_txs_bytes:
                self._count_failed("full")
                self._mark_capacity_reject(tl, key)
                raise MempoolError(
                    f"mempool is full: number of txs {len(self._txs)} "
                    f"(max: {self._max_txs}), total bytes {self._txs_bytes}")
            if self.pre_check is not None:
                try:
                    self.pre_check(tx)
                except Exception:
                    if tl is not None:
                        tl.discard_phantom(key)
                    raise
            if not self.cache.push(tx):
                # record the new sender for an existing tx (clist_mempool.go:239)
                existing = self._txs.get(key)
                if existing is not None and sender:
                    existing.senders.add(sender)
                # a duplicate is not a lifecycle event for the original
                # (still-live) record — count it, don't mark it; but a
                # retry of an already-SEALED tx just opened a fresh
                # record at rpc_received that nothing will ever close
                self._count_failed("cache-dup")
                if tl is not None:
                    tl.discard_phantom(key)
                raise ErrTxInCache()

            t0 = time.perf_counter()
            try:
                res = self._proxy_app.check_tx(abci.RequestCheckTx(tx=tx))
                checktx_s = time.perf_counter() - t0
                if self.post_check is not None:
                    self.post_check(tx, res)
            except Exception:
                # a broken app connection (or raising post_check) under a
                # broadcast storm must not leak one never-closed
                # rpc_received record per attempt; the checktx_done mark
                # below hasn't happened yet, so the record is still a
                # pure phantom
                if tl is not None:
                    tl.discard_phantom(key)
                raise
            if self.metrics is not None:
                self.metrics.tx_size_bytes.observe(len(tx))
                self.metrics.checktx_latency_seconds.observe(checktx_s)
                if res.code != 0:
                    self.metrics.failed_txs.labels("app-reject").inc()
            if tl is not None:
                tl.mark(key, "checktx_done",
                        outcome="accepted" if res.is_ok() else "rejected")
            if res.is_ok():
                mem_tx = MempoolTx(tx, self._height, res.gas_wanted,
                                   {sender} if sender else set(), key)
                self._txs[key] = mem_tx
                self._txs_bytes += len(tx)
                if self._wal is not None:
                    self._wal.write(tx)
                if self.metrics is not None:
                    self.metrics.admitted_txs_total.inc()
                    self._set_depth_gauges()
                if tl is not None:
                    tl.mark(key, "mempool_admitted")
                self._notify_txs_available()
            else:
                if not self._keep_invalid:
                    self.cache.remove(tx)
            return res

    def _count_failed(self, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.failed_txs.labels(reason).inc()

    def _mark_capacity_reject(self, tl, key: bytes) -> None:
        """The capacity checks run BEFORE the cache check (reference
        ordering), so a retry of an already-known tx can hit "full" too:
        a cached key must not seal a bogus rejected record over the
        ORIGINAL tx's lifecycle — drop the retry's rpc_received phantom
        instead. Only genuinely-new txs record the rejection."""
        if tl is None:
            return
        if self.cache.has(key):
            tl.discard_phantom(key)
        else:
            tl.mark(key, "checktx_done", outcome="rejected")

    def _set_depth_gauges(self) -> None:
        """Caller holds the lock. EVERY mutation path lands here — check_tx
        admission, update/recheck removals, and flush (which historically
        left the size gauge stale at the pre-flush depth)."""
        self.metrics.size.set(len(self._txs))
        self.metrics.size_bytes.set(self._txs_bytes)

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """(clist_mempool.go:521)"""
        with self._mtx:
            total_bytes = 0
            total_gas = 0
            out: List[bytes] = []
            for mem_tx in self._txs.values():
                tx_size = len(mem_tx.tx) + _proto_overhead(len(mem_tx.tx))
                if max_bytes > -1 and total_bytes + tx_size > max_bytes:
                    break
                new_gas = total_gas + mem_tx.gas_wanted
                if max_gas > -1 and new_gas > max_gas:
                    break
                total_bytes += tx_size
                total_gas = new_gas
                out.append(mem_tx.tx)
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._mtx:
            txs = [m.tx for m in self._txs.values()]
            return txs if n < 0 else txs[:n]

    def update(self, height: int, txs: List[bytes],
               deliver_tx_responses: List[abci.ResponseCheckTx],
               pre_check=None, post_check=None) -> None:
        """Remove committed txs, recheck the rest (clist_mempool.go:594).
        Caller must hold the lock (BlockExecutor.commit does)."""
        self._height = height
        self._notified_txs_available = False
        if pre_check is not None:
            self.pre_check = pre_check
        if post_check is not None:
            self.post_check = post_check
        tl = self.txlife
        for tx, res in zip(txs, deliver_tx_responses):
            key = hashlib.sha256(tx).digest()
            if res.is_ok():
                self.cache.push(tx)  # committed: keep in cache to block resubmission
                if tl is not None:
                    # on the consensus path _finalize_commit already
                    # stamped committed (before apply_block reached us),
                    # making THIS mark the no-op; it is load-bearing on
                    # the non-consensus apply paths (fast sync)
                    tl.mark(key, "committed", height=height)
            elif not self._keep_invalid:
                self.cache.remove(tx)
            mem_tx = self._txs.pop(key, None)
            if mem_tx is not None:
                self._txs_bytes -= len(mem_tx.tx)
        if self._txs and self._recheck_enabled:
            self._recheck_txs()
        if self._txs:
            self._notify_txs_available()
        if self.metrics is not None:
            self._set_depth_gauges()

    def _recheck_txs(self) -> None:
        """Re-run CheckTx on remaining txs post-block (clist_mempool.go:641)."""
        tl = self.txlife
        for key in list(self._txs.keys()):
            mem_tx = self._txs[key]
            if self.metrics is not None:
                self.metrics.recheck_times.inc()
            t0 = time.perf_counter()
            res = self._proxy_app.check_tx(abci.RequestCheckTx(
                tx=mem_tx.tx, type=abci.CHECK_TX_TYPE_RECHECK))
            if self.metrics is not None:
                self.metrics.recheck_latency_seconds.observe(
                    time.perf_counter() - t0)
            if tl is not None:
                tl.mark(key, "rechecked",
                        outcome="accepted" if res.is_ok() else "rejected")
            if self.post_check is not None:
                self.post_check(mem_tx.tx, res)
            if not res.is_ok():
                del self._txs[key]
                self._txs_bytes -= len(mem_tx.tx)
                if self.metrics is not None:
                    self.metrics.evicted_txs_total.labels(
                        "recheck-failed").inc()
                if not self._keep_invalid:
                    self.cache.remove(mem_tx.tx)

    def flush(self) -> None:
        with self._mtx:
            if self.metrics is not None and self._txs:
                self.metrics.evicted_txs_total.labels("flush").inc(
                    len(self._txs))
            self._txs.clear()
            self._txs_bytes = 0
            self.cache.reset()
            if self.metrics is not None:
                self._set_depth_gauges()

    # -- gossip support ----------------------------------------------------

    def entries_after(self, cursor: int) -> Tuple[List[MempoolTx], int]:
        """Txs in insertion order after position `cursor`; returns new cursor.
        A stable iteration surface for reactor gossip tasks."""
        with self._mtx:
            items = list(self._txs.values())
        return items[cursor:], len(items)

    def has_tx(self, tx: bytes) -> bool:
        with self._mtx:
            return hashlib.sha256(tx).digest() in self._txs

    # -- txs-available notification (clist_mempool.go TxsAvailable) --------

    def _notify_txs_available(self) -> None:
        if not self._notified_txs_available and self._txs:
            self._notified_txs_available = True
            for cb in self.tx_available_callbacks:
                cb()


def _proto_overhead(n: int) -> int:
    from ..types.tx import compute_proto_size_overhead

    return compute_proto_size_overhead(n)


class MempoolWAL:
    """Append-only tx log (reference mempool WAL, clist_mempool.go InitWAL):
    newline-delimited hex, flushed per write — a recovery/debugging trail of
    every tx that entered the mempool."""

    def __init__(self, wal_dir: str):
        import os

        os.makedirs(wal_dir, exist_ok=True)
        path = os.path.join(wal_dir, "wal")
        self._repair_tail(path)
        self._f = open(path, "ab")

    @staticmethod
    def _repair_tail(path: str) -> None:
        """Repair-on-open: truncate a partial (newline-less) tail line a
        crash left behind. Appending after it would MERGE the torn hex
        with the next tx's hex — often still valid hex, so replay would
        admit a bogus tx and silently lose the first post-restart one."""
        import os

        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        with open(path, "rb") as f:
            f.seek(max(0, size - 1))
            if f.read(1) == b"\n":
                return
            # only the tail line matters; a line is at most one tx's hex
            # (2*max_tx_bytes+1), so a bounded tail read covers it
            tail_len = min(size, 4 * 1024 * 1024)
            f.seek(size - tail_len)
            raw = f.read()
        cut = raw.rfind(b"\n")
        if cut < 0 and tail_len < size:
            # torn line longer than the window (pathological): scan whole
            with open(path, "rb") as f:
                raw = f.read()
            tail_len, cut = size, raw.rfind(b"\n")
        good = 0 if cut < 0 else size - tail_len + cut + 1
        os.truncate(path, good)

    def write(self, tx: bytes) -> None:
        from ..libs.faults import faults

        # torn-write seam at the byte-emit point: a fired site persists a
        # partial line (what a crash mid-append leaves); replay skips the
        # undecodable line and stays idempotent
        self._f.write(faults.tear("mempool.wal_torn",
                                  tx.hex().encode() + b"\n"))
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except ValueError:
            pass


def init_mempool_wal(mempool, wal_dir: str) -> None:
    """(mempool.go InitWAL)"""
    mempool._wal = MempoolWAL(wal_dir)
