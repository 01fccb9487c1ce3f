"""Production ingestion fast path: batched tx pre-verification, sharded
per-sender mempool lanes, and async admission control.

The measurement surface (libs/txlife.py lifecycle tracing, mempool
telemetry in libs/metrics.py) judges this fast path: the "mempool + RPC
built for millions of users" plane. Three stages, front to back:

**Async admission control** (:class:`IngestPipeline` +
:class:`AdmissionController`). ``broadcast_tx_*`` hands raw txs to a
bounded intake queue instead of running CheckTx inline on the event
loop. Overload is shed at the front door with a reason the client sees
(``queue-full``, ``sender-rate``, ``fee-floor``) as an explicit
non-zero CheckTx code — never a stall — and every shed lands on
``mempool_shed_txs_total{reason}``.

**Batched signature pre-verification.** Queued txs accumulate into
micro-batches (deadline- and size-triggered, the crypto/vote_batcher
discipline) and txs carrying the signed envelope (below) get their
ed25519 checks routed through ONE BatchVerifier call — riding
``batch_verify_stream`` (the dense kernel for a batch within one chunk;
above it the sparse one, where the messages compress) and the
multi-device pool where there is one, with verdicts byte-identical to the scalar path by
the crypto plane's differential guarantees. A
:func:`crypto.signcols.sign_columns_from_rows` hint makes tx packing
zero-copy for homogeneous batches, exactly like the vote-side
``SignColumns``. Verdicts land in a shared cache so the mempool's
scalar path — and post-commit recheck — never re-verify a signature
the batch already settled. A batch whose device call fails is not
settled on the host: the fault (a running kernel's error, the armed
``device.batch_verify`` site, ``KernelUnavailable``) reaches the
broadcast of every tx of that flush, ``stats["device_errors"]`` counts
it, no verdict is stored and no tx of the flush is admitted — the dedup
cache never saw them, so each may be resubmitted.

**Sharded per-sender mempool lanes** (:class:`ShardedMempool`).
Replaces the single CList mutex with N lanes keyed by the tx's sender
(the envelope pubkey; unsigned txs hash-shard), each lane its own
ordered dict + lock. Admission work (signature checks, the app CheckTx
call) runs outside the global mutex; only index/capacity bookkeeping
serializes. Eviction absorbs the v1 priority mempool's ordering logic
(that module is gone): when full, the lowest-(priority, newest) resident
across all lanes is evicted iff the incoming tx's priority is strictly
higher; reaping is a deterministic merge across lanes in
(priority desc, arrival asc) order; TTLs purge on update. Recheck after
commit is lane-local and reuses the cached pre-verification verdicts —
a commit triggers app rechecks only, never a signature re-verification
storm.

Signed-tx envelope (the ingest plane's native wire format)::

    b"stx1" || pubkey(32) || fee(8,BE) || nonce(8,BE) || payload || sig(64)

``sig`` is ed25519 over everything before it (the sign-bytes). Txs
without the magic are "unsigned": they pass pre-verification trivially
and carry fee 0 — the plane stays byte-compatible with every existing
app tx format. A tx WITH the magic but malformed (short, bad lengths)
is rejected before any device work, identically on both paths.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import itertools
import logging
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..abci import types as abci
from ..abci.client import Client
from .clist_mempool import (
    MAX_TX_CACHE,
    ErrTxInCache,
    MempoolError,
    TxCache,
    _proto_overhead,
)

logger = logging.getLogger("tmtpu.mempool.ingest")

# -- signed-tx envelope -------------------------------------------------------

STX_MAGIC = b"stx1"
_STX_HEADER = len(STX_MAGIC) + 32 + 8 + 8  # magic | pubkey | fee | nonce
_STX_MIN = _STX_HEADER + 64  # + trailing sig

#: classification outcomes of :func:`parse_signed_tx`
UNSIGNED, SIGNED, MALFORMED = "unsigned", "signed", "malformed"


@dataclass(frozen=True)
class SignedTx:
    pubkey: bytes
    fee: int
    nonce: int
    payload: bytes
    sig: bytes
    sign_bytes: bytes


def signed_tx_head(pubkey: bytes, payload: bytes, nonce: int = 0,
                   fee: int = 0) -> bytes:
    """The envelope before its signature: the bytes the sender signs."""
    return STX_MAGIC + pubkey + struct.pack(">QQ", fee, nonce) + payload


def make_signed_tx(priv_key, payload: bytes, nonce: int = 0,
                   fee: int = 0) -> bytes:
    """Encode + sign the envelope with a crypto.Ed25519PrivKey."""
    head = signed_tx_head(priv_key.pub_key().bytes(), payload, nonce, fee)
    return head + priv_key.sign(head)


def parse_signed_tx(tx: bytes) -> Tuple[str, Optional[SignedTx]]:
    """(status, envelope): ``unsigned`` for foreign formats, ``malformed``
    for magic-bearing txs that don't decode (identical verdict on the
    scalar and batched paths — malformed never reaches a verifier)."""
    if not tx.startswith(STX_MAGIC):
        return UNSIGNED, None
    if len(tx) < _STX_MIN:
        return MALFORMED, None
    fee, nonce = struct.unpack(">QQ", tx[36:52])
    return SIGNED, SignedTx(pubkey=tx[4:36], fee=fee, nonce=nonce,
                            payload=tx[_STX_HEADER:-64], sig=tx[-64:],
                            sign_bytes=tx[:-64])


def tx_fee(tx: bytes) -> int:
    status, stx = parse_signed_tx(tx)
    return stx.fee if status == SIGNED else 0


def tx_sender(tx: bytes) -> str:
    """Lane/rate-limit key: the envelope pubkey for signed txs; unsigned
    txs hash-shard (each is its own "sender", so per-sender controls
    never throttle foreign-format traffic as one client)."""
    status, stx = parse_signed_tx(tx)
    if status == SIGNED:
        return stx.pubkey.hex()
    return "h:" + hashlib.sha256(tx).hexdigest()[:16]


def conflict_hint(tx: bytes) -> Tuple[str, str]:
    """Conflict-group HINT for optimistic parallel execution
    (state/parallel.py): txs with different hints are *presumed*
    independent and speculated concurrently. This is only a scheduling
    hint — correctness never depends on it, because the executor
    validates actual read/write overlaps after speculation and
    re-executes anything the hint got wrong.

    ``("sender", pubkey_hex)`` for signed ``stx1`` envelopes (the ingest
    plane's per-sender lanes double as execution lanes);
    ``("key", k)`` for unsigned txs that strictly decode to the kvstore
    ``key=value`` format; ``("barrier", "")`` for validator-update
    ``val:`` txs and anything unparseable — those serialize in one
    block-ordered group."""
    status, stx = parse_signed_tx(tx)
    if status == SIGNED:
        return "sender", stx.pubkey.hex()
    if status == MALFORMED:
        return "barrier", ""
    try:
        raw = tx.decode("utf-8")
    except UnicodeDecodeError:
        return "barrier", ""
    if raw.startswith("val:"):
        return "barrier", ""
    return "key", raw.split("=", 1)[0] if "=" in raw else raw


def verify_signed_tx_scalar(tx: bytes) -> Tuple[bool, str]:
    """The SCALAR pre-verification spec the batched path must match
    byte-identically (differentially tested): (accept, reason)."""
    status, stx = parse_signed_tx(tx)
    if status == UNSIGNED:
        return True, UNSIGNED
    if status == MALFORMED:
        return False, MALFORMED
    from ..crypto import Ed25519PubKey

    ok = Ed25519PubKey(stx.pubkey).verify_signature(stx.sign_bytes, stx.sig)
    return bool(ok), "sig"


# -- sharded per-sender lanes -------------------------------------------------

DEFAULT_LANES = 8
VERDICT_CACHE_CAP = 16384


@dataclass
class LaneTx:
    """One resident tx (the mempool/v0 memTx + the v1 ordering fields)."""

    tx: bytes
    height: int
    gas_wanted: int
    senders: Set[str]
    key: bytes
    priority: int  # envelope fee, else app-assigned ResponseCheckTx.priority
    seq: int       # global admission order (reap/eviction tiebreak)
    time_s: float  # monotonic admission time (ttl_duration)
    lane: int


class _Lane:
    __slots__ = ("idx", "lock", "txs")

    def __init__(self, idx: int):
        self.idx = idx
        self.lock = threading.RLock()
        self.txs: "collections.OrderedDict[bytes, LaneTx]" = \
            collections.OrderedDict()


class ShardedMempool:
    """Drop-in for CListMempool (same surface the reactors, RPC layer,
    BlockExecutor, and WAL helpers consume) with per-sender lanes,
    fee/priority eviction, deterministic merged reap, and a shared
    pre-verification verdict cache.

    Locking: ``_admit_mtx`` guards the cross-lane index, dedup cache,
    and capacity counters; each lane's lock guards its dict. Acquisition
    order is always admit → lane. ``lock()``/``unlock()`` (held by
    BlockExecutor across commit+update) take everything.
    """

    def __init__(self, proxy_app: Client, height: int = 0,
                 max_txs: int = 5000, max_txs_bytes: int = 1073741824,
                 max_tx_bytes: int = 1048576, cache_size: int = MAX_TX_CACHE,
                 keep_invalid_txs_in_cache: bool = False,
                 recheck: bool = True, lanes: int = DEFAULT_LANES,
                 ttl_num_blocks: int = 0, ttl_duration: float = 0.0):
        self._proxy_app = proxy_app
        self.metrics = None  # MempoolMetrics, wired by the node
        self.txlife = None   # libs/txlife.py TxLifecycle, wired by the node
        self._wal = None     # MempoolWAL (clist_mempool.init_mempool_wal)
        self._height = height
        self._max_txs = max_txs
        self._max_txs_bytes = max_txs_bytes
        self._max_tx_bytes = max_tx_bytes
        self._keep_invalid = keep_invalid_txs_in_cache
        self._recheck_enabled = recheck
        self._ttl_num_blocks = ttl_num_blocks
        self._ttl_duration = ttl_duration
        self.cache = TxCache(cache_size)
        self.n_lanes = max(1, int(lanes))
        self._lanes = [_Lane(i) for i in range(self.n_lanes)]
        #: cross-lane index in ADMISSION order (seq order by construction:
        #: insertions happen under the admit mutex) — the gossip surface
        #: reads it straight off, no per-iteration sort
        self._index: "collections.OrderedDict[bytes, LaneTx]" = \
            collections.OrderedDict()
        self._txs_bytes = 0
        self._seq = itertools.count()
        self._admit_mtx = threading.RLock()
        #: pre-verification verdicts keyed by tx sha256: written by the
        #: batched pipeline AND the scalar path, consumed by both and by
        #: recheck — one signature check per tx lifetime
        self.sig_verdicts: "collections.OrderedDict[bytes, bool]" = \
            collections.OrderedDict()
        self._notified_txs_available = False
        self.tx_available_callbacks: List[Callable[[], None]] = []
        self.pre_check: Optional[Callable[[bytes], None]] = None
        self.post_check: Optional[Callable[[bytes, abci.ResponseCheckTx], None]] = None

    # -- Mempool interface (mempool/mempool.go:30) -------------------------

    def size(self) -> int:
        with self._admit_mtx:
            return len(self._index)

    def tx_bytes(self) -> int:
        with self._admit_mtx:
            return self._txs_bytes

    def lock(self) -> None:
        self._admit_mtx.acquire()
        for lane in self._lanes:
            lane.lock.acquire()

    def unlock(self) -> None:
        for lane in reversed(self._lanes):
            lane.lock.release()
        self._admit_mtx.release()

    def flush_app_conn(self) -> None:
        self._proxy_app.flush()

    def lane_for(self, tx: bytes) -> int:
        """Deterministic sender→lane shard (every node agrees)."""
        sender = tx_sender(tx)
        return int.from_bytes(
            hashlib.sha256(sender.encode()).digest()[:4], "big") % self.n_lanes

    # -- pre-verification (the scalar half of the differential contract) ----

    def _sig_verdict(self, key: bytes, tx: bytes) -> Tuple[bool, str]:
        """Cached batched verdict when the pipeline already settled this
        tx; the scalar spec otherwise. Writes its result back so recheck
        (and duplicate scalar submissions) stay signature-free."""
        status, _ = parse_signed_tx(tx)
        if status == UNSIGNED:
            return True, UNSIGNED
        if status == MALFORMED:
            return False, MALFORMED
        with self._admit_mtx:
            hit = self.sig_verdicts.get(key)
        m = self.metrics
        if hit is not None:
            if m is not None:
                m.preverify_cache_hits_total.labels("checktx").inc()
            return hit, "sig"
        ok, reason = verify_signed_tx_scalar(tx)
        self.store_sig_verdict(key, ok)
        if m is not None:
            m.preverified_txs_total.labels("scalar").inc()
        return ok, reason

    def store_sig_verdict(self, key: bytes, ok: bool) -> None:
        with self._admit_mtx:
            self.sig_verdicts[key] = ok
            self.sig_verdicts.move_to_end(key)
            while len(self.sig_verdicts) > VERDICT_CACHE_CAP:
                self.sig_verdicts.popitem(last=False)

    # -- admission ----------------------------------------------------------

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """Admission: dedup → signature pre-verification (cache or
        scalar) → app CheckTx → capacity/eviction → lane insertion.
        Raises like CListMempool (ErrTxInCache, MempoolError) so the
        gossip reactor and legacy RPC paths work unchanged; ``sender``
        remains the gossiping PEER id (lane keying uses the tx itself).
        """
        key = hashlib.sha256(tx).digest()
        tl = self.txlife
        with self._admit_mtx:
            if len(tx) > self._max_tx_bytes:
                self._count_failed("too-large")
                self._mark_reject_or_phantom(tl, key)
                raise MempoolError(
                    f"tx too large. Max size is {self._max_tx_bytes}, "
                    f"but got {len(tx)}")
            if self.pre_check is not None:
                try:
                    self.pre_check(tx)
                except Exception:
                    if tl is not None:
                        tl.discard_phantom(key)
                    raise
            if not self.cache.push(tx):
                resident = self._index.get(key)
                if resident is not None and sender:
                    resident.senders.add(sender)
                # a duplicate is not a lifecycle event for the original —
                # but the retry's fresh rpc_received phantom must die
                self._count_failed("cache-dup")
                if tl is not None:
                    tl.discard_phantom(key)
                raise ErrTxInCache()

        # signature work OUTSIDE the admission mutex: this is the cost the
        # lanes exist to keep off the global serial path
        sig_ok, sig_reason = self._sig_verdict(key, tx)
        if tl is not None:
            tl.mark(key, "preverified",
                    outcome="accepted" if sig_ok else "rejected")
        if not sig_ok:
            reason = ("malformed-stx" if sig_reason == MALFORMED
                      else "invalid-sig")
            self._count_failed(reason)
            if not self._keep_invalid:
                with self._admit_mtx:
                    self.cache.remove(tx)
            return abci.ResponseCheckTx(
                code=1, log=f"signature pre-verification failed: {reason}",
                codespace="ingest")

        t0 = time.perf_counter()
        try:
            res = self._proxy_app.check_tx(abci.RequestCheckTx(tx=tx))
            checktx_s = time.perf_counter() - t0
            if self.post_check is not None:
                self.post_check(tx, res)
        except Exception:
            # broken app conn / raising post_check must not leak one
            # never-closed rpc_received record per attempt
            if tl is not None:
                tl.discard_phantom(key)
            raise
        m = self.metrics
        if m is not None:
            m.tx_size_bytes.observe(len(tx))
            m.checktx_latency_seconds.observe(checktx_s)
            if res.code != 0:
                m.failed_txs.labels("app-reject").inc()
        if not res.is_ok():
            if tl is not None:
                tl.mark(key, "checktx_done", outcome="rejected")
            if not self._keep_invalid:
                with self._admit_mtx:
                    self.cache.remove(tx)
            return res
        # the accepted checktx_done stamp waits for the capacity verdict:
        # stamping before it would leave a full-pool rejection with an
        # "accepted" stage it can never seal over (first stamp wins)

        status, stx = parse_signed_tx(tx)
        priority = stx.fee if status == SIGNED else getattr(res, "priority", 0)
        lane_idx = self.lane_for(tx)
        lane = self._lanes[lane_idx]
        with self._admit_mtx:
            if not self._make_room(priority, len(tx)):
                self._count_failed("full")
                self.cache.remove(tx)
                self._mark_reject_or_phantom(tl, key)
                raise MempoolError(
                    f"mempool is full: number of txs {len(self._index)} "
                    f"(max: {self._max_txs}), total bytes {self._txs_bytes}")
            if tl is not None:
                tl.mark(key, "checktx_done", outcome="accepted")
            mem_tx = LaneTx(tx=tx, height=self._height,
                            gas_wanted=res.gas_wanted,
                            senders={sender} if sender else set(), key=key,
                            priority=priority, seq=next(self._seq),
                            time_s=time.monotonic(), lane=lane_idx)
            with lane.lock:
                lane.txs[key] = mem_tx
            self._index[key] = mem_tx
            self._txs_bytes += len(tx)
            if self._wal is not None:
                self._wal.write(tx)
            if m is not None:
                m.admitted_txs_total.inc()
                self._set_depth_gauges()
            if tl is not None:
                tl.mark(key, "mempool_admitted")
            self._notify_txs_available()
        return res

    def _make_room(self, priority: int, nbytes: int) -> bool:
        """Caller holds the admit mutex. Evict strictly-lower-priority
        residents (lowest priority, newest first — the absorbed v1
        canAddTx/evictTx policy) until the incoming tx fits; False when
        it can't."""
        while (len(self._index) >= self._max_txs
               or self._txs_bytes + nbytes > self._max_txs_bytes):
            victim = min(self._index.values(), default=None,
                         key=lambda m: (m.priority, -m.seq))
            if victim is None or victim.priority >= priority:
                return False
            self._remove_resident(victim.key, reason="priority-evicted")
        return True

    def _remove_resident(self, key: bytes, reason: Optional[str] = None,
                         drop_cache: bool = True) -> Optional[LaneTx]:
        """Caller holds the admit mutex."""
        mem_tx = self._index.pop(key, None)
        if mem_tx is None:
            return None
        lane = self._lanes[mem_tx.lane]
        with lane.lock:
            lane.txs.pop(key, None)
        self._txs_bytes -= len(mem_tx.tx)
        if reason is not None:
            if self.metrics is not None:
                self.metrics.evicted_txs_total.labels(reason).inc()
            if drop_cache:
                self.cache.remove(mem_tx.tx)
        return mem_tx

    def _count_failed(self, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.failed_txs.labels(reason).inc()

    def _mark_reject_or_phantom(self, tl, key: bytes) -> None:
        """Capacity rejections: a retry of an already-known tx must not
        seal a bogus record over the original's live lifecycle (the
        CListMempool rule, same rationale)."""
        if tl is None:
            return
        if self.cache.has(key):
            tl.discard_phantom(key)
        else:
            tl.mark(key, "checktx_done", outcome="rejected")

    def _set_depth_gauges(self) -> None:
        """Caller holds the admit mutex; every mutation path ends here."""
        self.metrics.size.set(len(self._index))
        self.metrics.size_bytes.set(self._txs_bytes)

    # -- reaping (deterministic merge across lanes) -------------------------

    def _ordered_snapshot(self) -> List[LaneTx]:
        """All residents in (priority desc, arrival asc) order — the
        merged deterministic reap order every proposer derives
        identically from the same lane contents."""
        with self._admit_mtx:
            out = list(self._index.values())
        out.sort(key=lambda m: (-m.priority, m.seq))
        return out

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """(v1/mempool.go ReapMaxBytesMaxGas semantics: walk the priority
        order, skip what doesn't fit — a large high-fee tx can't starve
        the block.)"""
        out: List[bytes] = []
        total_bytes = 0
        total_gas = 0
        for mem_tx in self._ordered_snapshot():
            tx_size = len(mem_tx.tx) + _proto_overhead(len(mem_tx.tx))
            if max_bytes > -1 and total_bytes + tx_size > max_bytes:
                continue
            if max_gas > -1 and total_gas + mem_tx.gas_wanted > max_gas:
                continue
            total_bytes += tx_size
            total_gas += mem_tx.gas_wanted
            out.append(mem_tx.tx)
        return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        txs = [m.tx for m in self._ordered_snapshot()]
        return txs if n < 0 else txs[:n]

    # -- post-commit update + lane-local recheck ----------------------------

    def update(self, height: int, txs: List[bytes],
               deliver_tx_responses: List[abci.ResponseCheckTx],
               pre_check=None, post_check=None) -> None:
        """Caller must hold the lock (BlockExecutor.commit does)."""
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
                self.cache.push(tx)  # block resubmission of committed txs
                if tl is not None:
                    tl.mark(key, "committed", height=height)
            elif not self._keep_invalid:
                self.cache.remove(tx)
            self._remove_resident(key, reason=None)
        self._purge_expired()
        if self._index and self._recheck_enabled:
            self._recheck_lanes()
        if self._index:
            self._notify_txs_available()
        if self.metrics is not None:
            self._set_depth_gauges()

    def _purge_expired(self) -> None:
        """(v1/mempool.go purgeExpiredTxs) — block- and wall-clock TTLs."""
        if not (self._ttl_num_blocks or self._ttl_duration):
            return
        now = time.monotonic()
        for lane in self._lanes:
            with lane.lock:
                expired = [m.key for m in lane.txs.values() if
                           (self._ttl_num_blocks and
                            self._height - m.height > self._ttl_num_blocks)
                           or (self._ttl_duration and
                               now - m.time_s > self._ttl_duration)]
            for key in expired:
                self._remove_resident(key, reason="ttl-expired")

    def _recheck_lanes(self) -> None:
        """Lane-local post-block recheck: app CheckTx ONLY — the cached
        pre-verification verdict stands (signatures don't change when the
        app state does), so a commit never triggers a signature
        re-verification storm."""
        tl = self.txlife
        m = self.metrics
        for lane in self._lanes:
            with lane.lock:
                residents = list(lane.txs.values())
            for mem_tx in residents:
                if m is not None:
                    m.recheck_times.inc()
                    if mem_tx.key in self.sig_verdicts:
                        m.preverify_cache_hits_total.labels("recheck").inc()
                t0 = time.perf_counter()
                res = self._proxy_app.check_tx(abci.RequestCheckTx(
                    tx=mem_tx.tx, type=abci.CHECK_TX_TYPE_RECHECK))
                if m is not None:
                    m.recheck_latency_seconds.observe(
                        time.perf_counter() - t0)
                if tl is not None:
                    tl.mark(mem_tx.key, "rechecked",
                            outcome="accepted" if res.is_ok() else "rejected")
                if self.post_check is not None:
                    self.post_check(mem_tx.tx, res)
                if not res.is_ok():
                    self._remove_resident(
                        mem_tx.key, reason="recheck-failed",
                        drop_cache=not self._keep_invalid)

    def flush(self) -> None:
        with self._admit_mtx:
            n = len(self._index)
            if self.metrics is not None and n:
                self.metrics.evicted_txs_total.labels("flush").inc(n)
            for lane in self._lanes:
                with lane.lock:
                    lane.txs.clear()
            self._index.clear()
            self._txs_bytes = 0
            self.cache.reset()
            self.sig_verdicts.clear()
            if self.metrics is not None:
                self._set_depth_gauges()

    # -- gossip support (mempool/reactor.py) --------------------------------

    def entries_after(self, cursor: int) -> Tuple[List[LaneTx], int]:
        """Residents in global admission order (stable across lanes) after
        position ``cursor``; the reactor's per-peer iteration surface.
        The admission-ordered index makes this one O(n) copy, like the
        CList walk — no sort per gossip iteration."""
        with self._admit_mtx:
            items = list(self._index.values())
        return items[cursor:], len(items)

    def has_tx(self, tx: bytes) -> bool:
        with self._admit_mtx:
            return hashlib.sha256(tx).digest() in self._index

    def lane_depths(self) -> List[int]:
        return [len(lane.txs) for lane in self._lanes]

    # -- txs-available notification ----------------------------------------

    def _notify_txs_available(self) -> None:
        if not self._notified_txs_available and self._index:
            self._notified_txs_available = True
            for cb in self.tx_available_callbacks:
                cb()


# -- async admission control --------------------------------------------------

#: shed taxonomy (mempool_shed_txs_total{reason})
SHED_QUEUE_FULL = "queue-full"
SHED_SENDER_RATE = "sender-rate"
SHED_FEE_FLOOR = "fee-floor"

_BUCKET_CAP = 4096


class AdmissionController:
    """Reason-labeled shedding at the intake front door: bounded queue
    depth, a per-sender token-bucket rate, and a fee floor — all judged
    from the raw tx bytes BEFORE any verification or app work."""

    def __init__(self, queue_limit: int = 2048,
                 per_sender_rate: float = 0.0, fee_floor: int = 0):
        self.queue_limit = max(1, int(queue_limit))
        self.per_sender_rate = float(per_sender_rate)
        self.fee_floor = int(fee_floor)
        # sender -> [tokens, last_refill_monotonic]; LRU-bounded so a
        # sender-spoofing firehose can't grow memory
        self._buckets: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()

    def shed_reason(self, queue_depth: int, tx: bytes) -> Optional[str]:
        if queue_depth >= self.queue_limit:
            return SHED_QUEUE_FULL
        if self.fee_floor > 0 and tx_fee(tx) < self.fee_floor:
            return SHED_FEE_FLOOR
        if self.per_sender_rate > 0:
            sender = tx_sender(tx)
            now = time.monotonic()
            bucket = self._buckets.get(sender)
            if bucket is None:
                # burst allowance = 1s of the sustained rate (min 1)
                bucket = [max(1.0, self.per_sender_rate), now]
                self._buckets[sender] = bucket
                while len(self._buckets) > _BUCKET_CAP:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(sender)
                bucket[0] = min(max(1.0, self.per_sender_rate),
                                bucket[0] + (now - bucket[1])
                                * self.per_sender_rate)
                bucket[1] = now
            if bucket[0] < 1.0:
                return SHED_SENDER_RATE
            bucket[0] -= 1.0
        return None


DEFAULT_BATCH_MAX = 256
DEFAULT_BATCH_DEADLINE_S = 0.005


class _Item:
    __slots__ = ("tx", "key", "fut")

    def __init__(self, tx: bytes, key: bytes,
                 fut: Optional[asyncio.Future]):
        self.tx = tx
        self.key = key
        self.fut = fut


def _shed_response(reason: str) -> abci.ResponseCheckTx:
    return abci.ResponseCheckTx(code=1, log=f"shed: {reason}",
                                codespace="ingest")


class IngestPipeline:
    """The async front end ``broadcast_tx_*`` rides: admission control →
    micro-batched signature pre-verification → mempool admission.
    Event-loop-affine like the vote batcher: ``submit`` runs on the
    node's loop; signature batches verify off-loop (executor → device).
    """

    def __init__(self, mempool: ShardedMempool,
                 batch_max: int = DEFAULT_BATCH_MAX,
                 batch_deadline_s: float = DEFAULT_BATCH_DEADLINE_S,
                 queue_limit: int = 2048, per_sender_rate: float = 0.0,
                 fee_floor: int = 0, verifier_factory=None):
        self.mempool = mempool
        self.batch_max = max(1, int(batch_max))
        self.batch_deadline_s = batch_deadline_s
        self.admission = AdmissionController(queue_limit, per_sender_rate,
                                             fee_floor)
        self.metrics = None  # MempoolMetrics, wired by the node
        # BatchVerifier factory seam (tests pin backends / arm faults)
        if verifier_factory is None:
            from ..crypto.batch import BatchVerifier

            verifier_factory = lambda: BatchVerifier(plane="ingest")  # noqa: E731
        self._verifier_factory = verifier_factory
        self._pending: List[_Item] = []
        self._inflight = 0  # handed to a flush, not yet settled
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._flush_tasks: set = set()
        self.stats = collections.Counter()

    # -- intake --------------------------------------------------------------

    def _admit_or_shed(self, raw: bytes) -> Optional[str]:
        # the bound covers ALL unsettled work — queued AND mid-flush —
        # so a slow verify/admission stage produces backpressure instead
        # of an unbounded wave of in-flight batches
        reason = self.admission.shed_reason(
            len(self._pending) + self._inflight, raw)
        if reason is None:
            return None
        self.stats["shed"] += 1
        self.stats[f"shed_{reason}"] += 1
        if self.metrics is not None:
            self.metrics.shed_txs_total.labels(reason).inc()
        tl = self.mempool.txlife
        if tl is not None:
            # the front door refused before any verification: the
            # rpc_received phantom must not linger as a "lost" record
            tl.discard_phantom(hashlib.sha256(raw).digest())
        return reason

    def _enqueue(self, raw: bytes,
                 fut: Optional[asyncio.Future]) -> None:
        key = hashlib.sha256(raw).digest()
        self._pending.append(_Item(raw, key, fut))
        self.stats["enqueued"] += 1
        if len(self._pending) >= self.batch_max:
            self._do_flush()
        elif self._flush_handle is None:
            self._flush_handle = asyncio.get_running_loop().call_later(
                self.batch_deadline_s, self._do_flush)

    async def submit(self, raw: bytes,
                     sender: str = "") -> abci.ResponseCheckTx:
        """Admission verdict for one tx: a shed/rejection response (never
        an exception, never a stall) or the app's CheckTx response."""
        reason = self._admit_or_shed(raw)
        if reason is not None:
            return _shed_response(reason)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._enqueue(raw, fut)
        return await fut

    def submit_nowait(self, raw: bytes) -> bool:
        """Fire-and-forget intake (broadcast_tx_async): False when shed."""
        if self._admit_or_shed(raw) is not None:
            return False
        self._enqueue(raw, None)
        return True

    # -- micro-batch flush ---------------------------------------------------

    def _do_flush(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        batch = self._pending
        self._pending = []
        if not batch:
            return
        self._inflight += len(batch)
        t = asyncio.ensure_future(self._run_flush(batch))
        self._flush_tasks.add(t)
        t.add_done_callback(self._flush_tasks.discard)

    async def _run_flush(self, batch: List[_Item]) -> None:
        try:
            await self._run_flush_inner(batch)
        except Exception as e:  # pragma: no cover - defensive
            # last-resort settle: whatever escaped the inner handlers must
            # not strand a single future — every waiter gets an explicit
            # rejection instead of an infinite await. A device fault never
            # gets here: _run_flush_inner hands it to the futures itself
            logger.exception("ingest flush failed: %s", e)
            for item in batch:
                if item.fut is not None and not item.fut.done():
                    item.fut.set_result(abci.ResponseCheckTx(
                        code=1, log=f"ingest flush error: {e}",
                        codespace="ingest"))
        finally:
            self._inflight -= len(batch)

    async def _run_flush_inner(self, batch: List[_Item]) -> None:
        m = self.metrics
        if m is not None:
            # the bounded quantity: queued + ALL in-flight batches (this
            # one included — _do_flush counted it before scheduling us)
            m.intake_queue_depth.set(self.queue_depth())
        tl = self.mempool.txlife
        loop = asyncio.get_running_loop()
        # classify: one pass, malformed settled inline, signed rows
        # (not already settled by the verdict cache) collected for ONE
        # batched verification call
        rows: List[Tuple[_Item, SignedTx]] = []
        verdicts: Dict[bytes, Tuple[bool, str]] = {}
        for item in batch:
            status, stx = parse_signed_tx(item.tx)
            if status == UNSIGNED:
                verdicts[item.key] = (True, UNSIGNED)
            elif status == MALFORMED:
                verdicts[item.key] = (False, MALFORMED)
            else:
                cached = self.mempool.sig_verdicts.get(item.key)
                if cached is not None:
                    verdicts[item.key] = (cached, "sig")
                    self.stats["verdict_cache_hits"] += 1
                    if m is not None:
                        m.preverify_cache_hits_total.labels("batch").inc()
                else:
                    rows.append((item, stx))
        if rows:
            bv = self._verifier_factory()
            from ..crypto import Ed25519PubKey
            from ..crypto.signcols import sign_columns_from_rows

            msgs = []
            for item, stx in rows:
                bv.add(Ed25519PubKey(stx.pubkey), stx.sign_bytes, stx.sig)
                msgs.append(stx.sign_bytes)
            cols = sign_columns_from_rows(msgs)
            if cols is not None and hasattr(bv, "set_columns"):
                bv.set_columns(cols)
                self.stats["column_batches"] += 1
            # off the event loop: BatchVerifier routes host/device itself
            # (the break-even threshold)
            t0 = time.perf_counter()
            try:
                _all_ok, per_item = await loop.run_in_executor(
                    None, bv.verify)
            except Exception as e:
                # a device fault is no verdict: it reaches every broadcast
                # of this flush, nothing is stored or admitted, and no
                # signature is settled on the host
                logger.warning("batched pre-verification failed (n=%d): %s",
                               len(rows), e)
                self._fail_flush(batch, e)
                return
            if m is not None:
                m.preverify_latency_seconds.observe(
                    time.perf_counter() - t0)
            self.stats["batches"] += 1
            self.stats["batched_sigs"] += len(rows)
            for (item, _stx), ok in zip(rows, per_item):
                ok = bool(ok)
                verdicts[item.key] = (ok, "sig")
                self.mempool.store_sig_verdict(item.key, ok)
                if m is not None:
                    m.preverified_txs_total.labels(
                        "accepted" if ok else "rejected").inc()
        # settle, in arrival order (admission happens on the loop — the
        # in-proc app CheckTx is microseconds; the expensive signature
        # work is already behind us)
        for item in batch:
            ok, reason = verdicts[item.key]
            if tl is not None:
                tl.mark(item.key, "preverified",
                        outcome="accepted" if ok else "rejected")
            if not ok:
                label = ("malformed-stx" if reason == MALFORMED
                         else "invalid-sig")
                if m is not None:
                    m.failed_txs.labels(label).inc()
                res = abci.ResponseCheckTx(
                    code=1,
                    log=f"signature pre-verification failed: {label}",
                    codespace="ingest")
            else:
                try:
                    # NOTE: the app CheckTx runs on the loop, exactly like
                    # the legacy inline broadcast_tx_sync path did — fine
                    # for abci=local (microseconds); a remote socket/grpc
                    # app pays its RTT here either way (the availability
                    # callbacks are loop-affine, so this cannot move to a
                    # worker thread without reworking them)
                    res = self.mempool.check_tx(item.tx)
                except ErrTxInCache:
                    res = abci.ResponseCheckTx(code=1,
                                               log="tx already exists in cache",
                                               codespace="ingest")
                except MempoolError as e:
                    # backpressure/capacity: an explicit rejection the
                    # client can act on, not an RPC 500
                    res = abci.ResponseCheckTx(code=1, log=str(e),
                                               codespace="ingest")
                except Exception as e:
                    # a broken app connection (or raising pre_check) must
                    # reject THIS tx and keep settling the rest of the
                    # batch — an escaped exception here would strand every
                    # remaining future and stall their broadcast calls
                    logger.warning("admission failed for queued tx: %s", e)
                    res = abci.ResponseCheckTx(
                        code=1, log=f"admission error: {e}",
                        codespace="ingest")
            if item.fut is not None and not item.fut.done():
                item.fut.set_result(res)

    def _fail_flush(self, batch: List[_Item], exc: BaseException) -> None:
        """A flush whose batched call raised: each of its txs' futures
        gets the exception and each lifecycle record is sealed (outcome
        error) rather than left to be evicted as lost."""
        from ..crypto.breaker import count_device_error

        self.stats["device_errors"] += 1
        count_device_error(exc, "ingest")
        tl = self.mempool.txlife
        for item in batch:
            if tl is not None:
                tl.mark(item.key, "preverified", outcome="error")
            if item.fut is not None and not item.fut.done():
                item.fut.set_exception(exc)

    async def flush_now(self) -> None:
        """Force a flush and let it settle (tests / shutdown)."""
        self._do_flush()
        while self._flush_tasks:
            await asyncio.gather(*list(self._flush_tasks),
                                 return_exceptions=True)

    async def stop(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        await self.flush_now()

    def queue_depth(self) -> int:
        """Unsettled intake: queued + mid-flush (the bounded quantity)."""
        return len(self._pending) + self._inflight


# -- WAL replay ---------------------------------------------------------------

def replay_mempool_wal(mempool, wal_dir: str) -> Tuple[int, int]:
    """Re-admit every tx the MempoolWAL recorded (crash recovery: the
    lanes repopulate through the normal admission path, so dedup, sig
    verdicts and lane placement all re-derive). Returns
    (replayed, skipped) — cache-dup/invalid/full replays are skipped,
    never raised, so a replay is idempotent (no dup admits).

    An EXPLICIT operator/recovery tool, deliberately NOT run at node
    startup: the log is append-only and never pruned on commit, so a
    boot-time replay would re-admit already-committed txs — double
    execution for any app without its own replay protection. Prune or
    rotate the WAL before replaying after a long uptime."""
    import os

    path = os.path.join(wal_dir, "wal")
    if not os.path.exists(path):
        return 0, 0
    replayed = skipped = 0
    # replayed admits must not re-append to the very log being read
    wal, mempool._wal = mempool._wal, None
    try:
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    tx = bytes.fromhex(line.decode())
                except ValueError:
                    continue  # torn tail
                try:
                    res = mempool.check_tx(tx)
                    if res.is_ok():
                        replayed += 1
                    else:
                        skipped += 1
                except (ErrTxInCache, MempoolError):
                    skipped += 1
    finally:
        mempool._wal = wal
    return replayed, skipped
