"""Micro-batched verification for the streaming vote path (HOT LOOP #1).

The reference's hottest call site is one scalar ed25519 verify per gossiped
vote (types/vote_set.go:205 → vote.go:147). Votes arrive concurrently from
many peer tasks but are *consumed* by the single-writer consensus loop —
verifying inside that loop serializes everything, so batching must happen
in front of it:

* per-peer reactor tasks call :meth:`preverify` BEFORE enqueueing the vote
  to the state machine. Pre-verifications accumulate across peers; a flush
  fires when ``max_batch`` is reached or ``deadline_s`` after the first
  pending item;
* a flush below ``min_device_batch`` verifies on the host scalar path (a
  device call would cost more than it saves at low rate: the routing rule,
  as ``BatchVerifier``'s break-even threshold); at or above it, ONE
  batched call of the CUDA kernels (``ed25519_cuda.batch_verify_stream``)
  covers every pending vote;
* verdicts land in a one-shot cache keyed by (pubkey, msg, sig). When the
  single-writer loop later reaches ``VoteSet.add_vote`` →
  :meth:`verify`, the lookup hits and no signature work happens on the
  hot loop at all. A miss (catchup votes, adversarial replays, no reactor)
  runs the host scalar verify — correctness never depends on
  pre-verification, and accept/reject stays byte-identical to the spec.

A device flush that fails is not re-verified on the host. Its fault — a
running kernel's error, the armed ``device.vote_flush`` site,
``KernelUnavailable``, or a flush that outlives ``device_timeout_s``
(:class:`DeviceFlushTimeout`) — reaches every ``preverify`` future of that
flush, counts one ``stats["device_errors"]``, and leaves nothing in the
cache, so the same vote is verified afresh when it comes back. A caller
must not turn that raise into a host re-verify through :meth:`verify`'s
miss path: the miss path is for votes that were never preverified. No
flush reads or strikes ``crypto/breaker.py``'s ``device_breaker``.

``stats`` counts device/host/cache traffic so tests can assert the device
path is provably taken.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import List, Optional, Tuple

from ..libs.faults import faults
from ..libs.trace import tracer
from . import batch as _batch  # module ref: reads the live metrics hook
from . import phases as _phases
from .breaker import count_device_error

logger = logging.getLogger("tmtpu.votebatch")

# at/above this many pending sigs a flush goes to the device; below, host
DEFAULT_MIN_DEVICE_BATCH = 16
DEFAULT_MAX_BATCH = 1024
DEFAULT_DEADLINE_S = 0.003
# consensus liveness bound: a device flush that has not produced verdicts
# in this long fails its preverify futures with DeviceFlushTimeout instead
# of holding consensus at one height. The kernels are built and loaded
# (first-use nvcc) before this clock starts, once per batcher.
DEFAULT_DEVICE_TIMEOUT_S = 3.0
_CACHE_CAP = 16384


class DeviceFlushTimeout(TimeoutError):
    """A device flush outlived ``device_timeout_s``. Its votes were not
    verified on the host; the call runs on, and its verdicts enter the
    cache when they land."""


class BatchVoteVerifier:
    """Shared by the consensus reactor (preverify) and VoteSet (verify)."""

    def __init__(self, min_device_batch: int = DEFAULT_MIN_DEVICE_BATCH,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 deadline_s: float = DEFAULT_DEADLINE_S,
                 device_timeout_s: float = DEFAULT_DEVICE_TIMEOUT_S):
        self.min_device_batch = min_device_batch
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self.device_timeout_s = device_timeout_s
        # the verify kernels are built and loaded (kernel_device) before
        # the first device flush's timed wait, once per batcher
        self._kernels_loaded = False
        self._pending: List[Tuple[bytes, bytes, bytes, bytes, asyncio.Future]] = []
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        # strong refs to in-flight flush tasks (event loop keeps only weak
        # refs; a GC'd flush would strand every pending preverify future)
        self._flush_tasks: set = set()
        self._cache: "collections.OrderedDict[bytes, bool]" = collections.OrderedDict()
        self.stats = collections.Counter()

    # -- sync side (VoteSet.add_vote, single-writer loop) --------------------

    def verify(self, pub, msg: bytes, sig: bytes) -> bool:
        """Byte-identical to pub.verify_signature; consumes a cached verdict
        when the reactor already pre-verified this exact (pk, msg, sig)."""
        key = self._key(pub.bytes(), msg, sig)
        hit = self._cache.pop(key, None)
        if hit is not None:
            self.stats["cache_hits"] += 1
            return hit
        self.stats["sync_host_sigs"] += 1
        return pub.verify_signature(msg, sig)

    # -- async side (reactor per-peer tasks) ---------------------------------

    async def preverify(self, pub, msg: bytes, sig: bytes) -> bool:
        """Micro-batched verification; resolves when this item's batch does,
        or raises that batch's device fault."""
        from . import Ed25519PubKey

        if not isinstance(pub, Ed25519PubKey):
            # rare key types never ride the ed25519 kernel (and must not
            # poison the cache with a wrong-scheme verdict); off the loop so
            # a flood of odd keys can't stall peer dispatch and timers
            self.stats["non_ed25519"] += 1
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, pub.verify_signature, msg, sig)
        pk = pub.bytes()
        key = self._key(pk, msg, sig)
        cached = self._cache.get(key)
        if cached is not None:
            self.stats["cache_hits_pre"] += 1
            return cached
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((key, pk, msg, sig, fut))
        if len(self._pending) >= self.max_batch:
            self._do_flush()
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(self.deadline_s, self._do_flush)
        return await fut

    def _do_flush(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        batch = self._pending
        self._pending = []
        if not batch:
            return
        t = asyncio.ensure_future(self._run_flush(batch))
        self._flush_tasks.add(t)
        t.add_done_callback(self._flush_tasks.discard)

    def _remember(self, keys, results) -> None:
        for key, ok in zip(keys, results):
            self._cache[key] = ok
            self._cache.move_to_end(key)
        while len(self._cache) > _CACHE_CAP:
            self._cache.popitem(last=False)

    def _fail(self, batch, exc: BaseException) -> None:
        self.stats["device_errors"] += 1
        count_device_error(exc, "votes")
        for _, _, _, _, fut in batch:
            if not fut.done():
                fut.set_exception(exc)

    def _late(self, keys, n: int):
        """Done-callback of a device call whose flush timed out: the card's
        own verdicts enter the cache when they land; a late failure is
        consumed (an unretrieved exception would dump a traceback at GC on
        a consensus-critical node) and logged."""
        def done(f):
            if f.cancelled():
                return
            exc = f.exception()
            if exc is not None:
                logger.info("device vote flush failed after its timeout "
                            "(n=%d): %s", n, exc)
                return
            self.stats["late_device_sigs"] += n
            self._remember(keys, [bool(v) for v in f.result()])
        return done

    async def _run_flush(self, batch) -> None:
        from . import Ed25519PubKey

        n = len(batch)
        loop = asyncio.get_running_loop()
        cm = _batch.metrics
        if cm is not None:
            # depth AT flush time = the flush size plus whatever already
            # queued behind it while this coroutine was scheduled
            cm.vote_queue_depth.set(n + len(self._pending))
        t_flush0 = time.perf_counter()
        t_v0 = t_flush0  # start of the verify work actually charged
        keys = [b[0] for b in batch]

        def _host_verify():
            # a sub-threshold live-plane batch verified on host: zero
            # device phases, still counted (crypto/phases.py host ledger)
            _phases.count_host("live", n)
            return [Ed25519PubKey(pk).verify_signature(m, s)
                    for _key, pk, m, s, _fut in batch]

        if n >= self.min_device_batch:
            route = "device"
            pks = [b[1] for b in batch]
            msgs = [b[2] for b in batch]
            sigs = [b[3] for b in batch]

            def _device_verify():
                # chaos seam: an armed `device.vote_flush` site raises on
                # the executor thread, exactly where a running kernel's
                # fault would surface
                faults.inject("device.vote_flush")
                from .ed25519_cuda import batch_verify_stream

                # plane=live set INSIDE the thunk: contextvars do not
                # follow run_in_executor onto the worker thread, and the
                # flush's pack/dispatch/fetch must land in the phase
                # histograms next to the sync plane's segments
                with _phases.telemetry(plane="live"):
                    return batch_verify_stream(pks, msgs, sigs)

            try:
                if not self._kernels_loaded:
                    from .ed25519_cuda.verify import kernel_device

                    # a first use builds the kernels (nvcc): outside the
                    # timed wait, so a build is never read as a stall
                    await loop.run_in_executor(None, kernel_device)
                    self._kernels_loaded = True
                    t_v0 = time.perf_counter()
                dev = loop.run_in_executor(None, _device_verify)
                try:
                    out = await asyncio.wait_for(
                        asyncio.shield(dev), self.device_timeout_s)
                except asyncio.TimeoutError:
                    self.stats["device_timeouts"] += 1
                    dev.add_done_callback(self._late(keys, n))
                    raise DeviceFlushTimeout(
                        f"device vote flush of {n} signatures produced no "
                        f"verdicts within {self.device_timeout_s} s")
            except Exception as e:
                # a running kernel's fault, the armed fault site,
                # KernelUnavailable or the timeout: every preverify future
                # of this flush gets it, nothing is cached, and nothing is
                # re-verified on the host
                logger.warning("device vote flush failed (n=%d): %s", n, e)
                self._fail(batch, e)
                return
            self.stats["device_batches"] += 1
            self.stats["device_sigs"] += n
            results = [bool(v) for v in out]
        else:
            route = "scalar"
            self.stats["host_batches"] += 1
            self.stats["host_sigs"] += n
            try:
                # off the event loop: even a sub-threshold flush shouldn't
                # stall peers/timers for ~ms of host work
                results = await loop.run_in_executor(None, _host_verify)
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("vote batch flush failed: %s", e)
                for _, _, _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return
        if cm is not None:
            now = time.perf_counter()
            cm.vote_flush_latency_seconds.labels(route).observe(now - t_flush0)
            cm.batch_size.labels(route, "votes").observe(n)
            cm.routing_decisions_total.labels(route, "votes").inc()
            # verify-only time (the same semantics batch.py gives this
            # series): a first flush's kernel build is not charged
            cm.verify_latency_seconds.labels(route, "votes").observe(
                now - t_v0)
        if tracer.enabled:
            tracer.instant("vote_flush", n=n, route=route)
        self._remember(keys, results)
        for (_key, _pk, _m, _s, fut), ok in zip(batch, results):
            if not fut.done():
                fut.set_result(ok)

    async def flush_now(self) -> None:
        """Force a flush (tests / shutdown)."""
        self._do_flush()
        await asyncio.sleep(0)

    @staticmethod
    def _key(pk: bytes, msg: bytes, sig: bytes) -> bytes:
        return b"%d|" % len(pk) + pk + b"|%d|" % len(msg) + msg + sig
