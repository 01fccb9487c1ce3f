"""Light-client serving plane: coalesced verification for thousands of
concurrent clients (the serving side of arXiv 2410.03347).

The node-side verifier is fast (one BatchVerifier stream call per commit),
but a population of light clients each asking "verify height H against my
trusted H0" would still cost one dispatch per client. This module turns
serving into the same micro-batching discipline the vote batcher and the
ingest plane use:

* ``VerifyCoalescer`` — admission-queues concurrent trusting-verify
  requests and flushes them on a deadline/size trigger as ONE batched
  device call (``crypto.batch.precompute`` over the union of candidate
  signatures, then a scalar-spec replay per request under the
  ``precomputed_verdicts`` contextvar — the verify_chain_batched pattern,
  so accept/reject is byte-identical to ``light/verifier.verify`` BY
  CONSTRUCTION, BLS aggregated commits included). Identical requests in a
  flush share one verification; a bounded verdict cache absorbs the
  steady-state where thousands of clients ask about the same heights.
* ``HeaderCache`` — bounded height-keyed LRU with *pinned* entries: a
  client bisecting trust from H0 to H will ask for the span's midpoints,
  so serving H with a declared trusted height prefetches and pins the
  ``bisection_skeleton`` heights; the second client through the same span
  hits memory.
* ``ClientLimiter`` — per-client token buckets with abuse scoring on the
  peerscore ledger; every shed is an explicit reason-labeled
  ``ShedError`` (surfaced as an RPC error), never a stall.
* ``ServeProvider`` + the ``lightserve.lying_server`` fault site — the
  chaos seam: an armed serving node swaps responses for an
  operator-supplied forged fork that only witness cross-check can catch.

The planning math at the top (flush schedule, bisection skeleton, fan-out
queue bounds) is pure stdlib with no package imports; everything touching
crypto/types imports lazily inside methods.

A flush's batched call runs in a worker thread of the event loop's default
executor, so on the card the verify kernels launch from that thread, on
the device ``device.default_device()`` names and that thread's current
stream. When the batched call raises (a fault of a running kernel, the
armed ``device.batch_verify`` site, ``KernelUnavailable``), every request
of the flush gets that exception and ``stats["device_errors"]`` counts
one: nothing is re-verified on the host.
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: chaos seam consulted by every serving surface (ServeProvider and the
#: node's /light_header route): when armed and it fires, the served header
#: is swapped for a tampered/forged one. Registered in libs/faults.
TAMPER_SITE = "lightserve.lying_server"

_MISS = object()


# -- pure planning math ------------------------------------------------------
# (stdlib only)

def bisection_skeleton(trusted_height: int, target_height: int,
                       cap: int = 64) -> List[int]:
    """Heights a bisecting client (light/client.py _verify_skipping) can ask
    for between trusted H0 and target H: breadth-first midpoints of the
    span, shallowest pivots first — the order bisection depth explores
    them. Bounded by ``cap``; deterministic pure math so serving planes and
    tools plan prefetch identically."""
    out: List[int] = []
    if target_height - trusted_height < 2:
        return out
    frontier = collections.deque([(trusted_height, target_height)])
    seen = set()
    while frontier and len(out) < cap:
        lo, hi = frontier.popleft()
        mid = (lo + hi) // 2
        if mid <= lo or mid >= hi or mid in seen:
            continue
        seen.add(mid)
        out.append(mid)
        frontier.append((lo, mid))
        frontier.append((mid, hi))
    return out


def plan_flushes(arrivals: List[float], deadline_s: float,
                 max_batch: int) -> List[Tuple[float, int]]:
    """Flush schedule for a sorted arrival series: a batch opens at its
    first request and closes when ``max_batch`` requests accumulate or
    ``deadline_s`` elapses, whichever first. Returns
    ``[(flush_time, batch_size)]`` — the pure spec ``VerifyCoalescer``
    implements and the bench self-test checks."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    if deadline_s < 0:
        raise ValueError("deadline_s must be >= 0")
    out: List[Tuple[float, int]] = []
    i, n = 0, len(arrivals)
    while i < n:
        t0 = arrivals[i]
        j = i + 1
        while j < n and j - i < max_batch and arrivals[j] <= t0 + deadline_s:
            j += 1
        t_flush = arrivals[j - 1] if j - i >= max_batch else t0 + deadline_s
        out.append((t_flush, j - i))
        i = j
    return out


def fanout_queue_plan(n_events: int, drained: int,
                      maxsize: int) -> Tuple[int, bool]:
    """Per-socket bounded send-queue math: ``n_events`` enqueued while the
    consumer drained ``drained`` of them -> (high-water mark, evicted?).
    A bounded queue EVICTS the socket on overflow (closes it with an
    explicit code) instead of stalling the event bus — the policy
    rpc/server._WsFanout implements."""
    if maxsize < 1:
        raise ValueError("maxsize must be >= 1")
    backlog = max(0, n_events - max(0, drained))
    return min(backlog, maxsize), backlog > maxsize


class TokenBucket:
    """Classic token bucket with an injectable clock (determinism seam)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def allow(self, cost: float = 1.0) -> bool:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False


class ShedError(Exception):
    """An admission shed: always an explicit, reason-labeled rejection
    (never a stall). ``reason`` lands in the RPC error payload and the
    sheds metric label."""

    def __init__(self, reason: str):
        super().__init__(f"request shed ({reason})")
        self.reason = reason


class HeaderCache:
    """Bounded height-keyed cache with pinned bisection-skeleton entries.

    Plain entries evict LRU-first; pinned entries (prefetched bisection
    midpoints) are only sacrificed when every resident entry is pinned —
    capacity is a hard bound either way."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        self._pinned: set = set()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def pinned_count(self) -> int:
        return len(self._pinned)

    def get(self, height: int):
        if height not in self._entries:
            self.stats["misses"] += 1
            return None
        self._entries.move_to_end(height)
        self.stats["hits"] += 1
        return self._entries[height]

    def peek(self, height: int):
        """get() without touching recency or hit/miss accounting (the
        prefetcher asking "is it already resident?")."""
        return self._entries.get(height)

    def put(self, height: int, value, pinned: bool = False) -> None:
        if height in self._entries:
            self._entries.move_to_end(height)
        self._entries[height] = value
        if pinned:
            self._pinned.add(height)
        while len(self._entries) > self.capacity:
            victim = next((h for h in self._entries
                           if h not in self._pinned), None)
            if victim is None:  # everything pinned: oldest pin goes
                victim = next(iter(self._entries))
            self._pinned.discard(victim)
            del self._entries[victim]
            self.stats["evictions"] += 1


class ClientLimiter:
    """Per-client token buckets + abuse scoring on the peerscore ledger.

    ``rate <= 0`` disables limiting entirely. A client that keeps hammering
    an empty bucket accumulates consecutive ``reason="rate"`` strikes on
    the scoreboard and gets banned (reason-labeled shed from then on);
    admitted requests record successes so honest bursts never accumulate.
    The scoreboard is duck-typed (record_failure/record_success/banned) so
    the pure self-tests can inject a stub."""

    def __init__(self, rate: float, burst: float, scoreboard=None,
                 max_clients: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.scoreboard = scoreboard
        self.max_clients = max_clients
        self._clock = clock
        self._buckets: "collections.OrderedDict[str, TokenBucket]" = \
            collections.OrderedDict()
        self.stats = {"admitted": 0, "rate_sheds": 0, "ban_sheds": 0}

    def admit(self, client_id: str) -> None:
        if self.rate <= 0:
            self.stats["admitted"] += 1
            return
        sb = self.scoreboard
        if sb is not None and sb.banned(client_id):
            self.stats["ban_sheds"] += 1
            raise ShedError("banned")
        bucket = self._buckets.get(client_id)
        if bucket is None:
            while len(self._buckets) >= self.max_clients:
                self._buckets.popitem(last=False)
            bucket = TokenBucket(self.rate, self.burst, self._clock)
            self._buckets[client_id] = bucket
        self._buckets.move_to_end(client_id)
        if not bucket.allow():
            self.stats["rate_sheds"] += 1
            if sb is not None:
                sb.record_failure(client_id, reason="rate")
            raise ShedError("client-rate")
        if sb is not None:
            sb.record_success(client_id)
        self.stats["admitted"] += 1


# -- the verification coalescer ----------------------------------------------

class VerifyRequest:
    """One light-client trusting-verify ask, exactly the arguments of
    ``light/verifier.verify``. ``cache_key`` (optional) marks the request
    dedupable: identical keys in a flush share one verification, and the
    verdict is remembered across flushes (callers only set it when the
    underlying content is immutable — canonical heights below the tip)."""

    __slots__ = ("trusted_sh", "trusted_vals", "untrusted_sh",
                 "untrusted_vals", "trusting_period_s", "now_ns",
                 "max_clock_drift_s", "trust_level", "cache_key")

    def __init__(self, trusted_sh, trusted_vals, untrusted_sh, untrusted_vals,
                 trusting_period_s: float, now_ns: int,
                 max_clock_drift_s: float,
                 trust_level: Tuple[int, int] = (1, 3), cache_key=None):
        self.trusted_sh = trusted_sh
        self.trusted_vals = trusted_vals
        self.untrusted_sh = untrusted_sh
        self.untrusted_vals = untrusted_vals
        self.trusting_period_s = trusting_period_s
        self.now_ns = now_ns
        self.max_clock_drift_s = max_clock_drift_s
        self.trust_level = trust_level
        self.cache_key = cache_key


class VerifyCoalescer:
    """Admission-queue concurrent verify requests; flush on deadline/size as
    ONE batched device call; resolve per-request futures from the shared
    verdict map.

    ``submit`` returns ``None`` (accepted) or the exact exception instance
    the scalar ``light/verifier.verify`` spec raises — the flush collects
    every candidate signature across the batch into one
    ``crypto.batch.precompute`` call and then replays the scalar spec per
    request under ``precomputed_verdicts``, so verdicts are byte-identical
    by construction (aggregated BLS commits skip collection and pair
    inline: a flush becomes a handful of pairings). A batched call that
    raises reaches every request of its flush as that exception, counted
    in ``stats["device_errors"]``."""

    def __init__(self, flush_deadline_s: float = 0.002, flush_max: int = 64,
                 queue_limit: int = 4096, verdict_cache_size: int = 4096,
                 backend: Optional[str] = None, metrics=None):
        if flush_max < 1:
            raise ValueError("flush_max must be >= 1")
        self.flush_deadline_s = flush_deadline_s
        self.flush_max = flush_max
        self.queue_limit = queue_limit
        self.verdict_cache_size = verdict_cache_size
        self.backend = backend
        self.metrics = metrics
        self._pending: List[Tuple[VerifyRequest, asyncio.Future]] = []
        self._inflight: Dict[Any, asyncio.Future] = {}
        self._timer: Optional[asyncio.Task] = None
        self._verdicts: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        self.stats = {"requests": 0, "flushes": 0, "largest_flush": 0,
                      "coalesced_dupes": 0, "verdict_cache_hits": 0,
                      "sheds": 0, "batched_sigs": 0, "verified_requests": 0,
                      "device_errors": 0}

    async def submit(self, req: VerifyRequest):
        self.stats["requests"] += 1
        key = req.cache_key
        if key is not None:
            hit = self._verdicts.get(key, _MISS)
            if hit is not _MISS:
                self._verdicts.move_to_end(key)
                self.stats["verdict_cache_hits"] += 1
                if self.metrics is not None:
                    self.metrics.verdict_cache_hits_total.inc()
                return hit
            inflight = self._inflight.get(key)
            if inflight is not None:
                self.stats["coalesced_dupes"] += 1
                return await asyncio.shield(inflight)
        if len(self._pending) >= self.queue_limit:
            self.stats["sheds"] += 1
            if self.metrics is not None:
                self.metrics.sheds_total.labels("queue-full").inc()
            raise ShedError("queue-full")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((req, fut))
        if key is not None:
            self._inflight[key] = fut
        if len(self._pending) >= self.flush_max:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            loop.create_task(self._flush())
        elif self._timer is None:
            self._timer = loop.create_task(self._deadline_flush())
        # shield: a cancelled client must not poison a future shared with
        # in-flight duplicates (or confuse the flush's set_result)
        return await asyncio.shield(fut)

    async def _deadline_flush(self) -> None:
        try:
            await asyncio.sleep(self.flush_deadline_s)
        except asyncio.CancelledError:
            return
        self._timer = None
        await self._flush()

    async def _flush(self) -> None:
        batch, self._pending = self._pending, []
        if not batch:
            return
        self.stats["flushes"] += 1
        self.stats["largest_flush"] = max(self.stats["largest_flush"],
                                          len(batch))
        if self.metrics is not None:
            self.metrics.flushes_total.inc()
            self.metrics.flush_occupancy.observe(len(batch))
        # within-flush dedup: identical cache keys share one verification
        groups: List[Tuple[VerifyRequest, List[asyncio.Future]]] = []
        by_key: Dict[Any, Tuple[VerifyRequest, List[asyncio.Future]]] = {}
        for req, fut in batch:
            g = by_key.get(req.cache_key) if req.cache_key is not None else None
            if g is not None:
                g[1].append(fut)
                self.stats["coalesced_dupes"] += 1
                continue
            g = (req, [fut])
            groups.append(g)
            if req.cache_key is not None:
                by_key[req.cache_key] = g
        reqs = [g[0] for g in groups]
        loop = asyncio.get_running_loop()
        faulted = False
        try:
            results, nsigs = await loop.run_in_executor(
                None, self._verify_many, reqs)
        except Exception as e:
            # the flush's batched call raised (_verify_many catches each
            # request's own verdict): every request gets that exception,
            # and nothing is re-verified on the host
            from ..crypto.breaker import count_device_error

            results, nsigs = [e] * len(reqs), 0
            faulted = True
            self.stats["device_errors"] += 1
            count_device_error(e, "light")
        self.stats["batched_sigs"] += nsigs
        self.stats["verified_requests"] += len(reqs)
        for (req, futs), res in zip(groups, results):
            if req.cache_key is not None:
                self._inflight.pop(req.cache_key, None)
                # a device fault is not a verdict: only the spec's are kept
                if not faulted:
                    self._remember(req.cache_key, res)
            for fut in futs:
                if not fut.done():
                    fut.set_result(res)

    def _remember(self, key, res) -> None:
        self._verdicts[key] = res
        self._verdicts.move_to_end(key)
        while len(self._verdicts) > self.verdict_cache_size:
            self._verdicts.popitem(last=False)

    def _verify_many(self, reqs: List[VerifyRequest]):
        """Runs in a worker thread: one batched device call over the union
        of candidate signatures, then the scalar spec replayed per request.
        Returns ([None-or-exception per request], batched signature count).
        Raises only what the batched call raises."""
        from ..crypto.batch import precompute, precomputed_verdicts
        from ..types.validator_set import _is_aggregated
        from .verifier import verify

        items = []
        seen = set()
        for r in reqs:
            commit = r.untrusted_sh.commit
            if _is_aggregated(commit):
                continue  # BLS aggregates pair inline in the scalar replay
            chain_id = r.trusted_sh.header.chain_id
            nvals = len(r.untrusted_vals.validators)
            sb = None  # the commit's memoized sign-bytes (the replay's too)
            for idx, cs in enumerate(commit.signatures):
                # malformed shapes are NOT pre-verified: the replay's
                # structural checks raise the same typed error as the
                # scalar path (a miss there makes a batch call of its own)
                if not cs.for_block() or idx >= nvals:
                    continue
                if sb is None:
                    sb = commit.vote_sign_bytes_all(chain_id)
                pub = r.untrusted_vals.validators[idx].pub_key
                msg = sb[idx]
                k = (pub.bytes(), msg, cs.signature)
                if k in seen:
                    continue
                seen.add(k)
                items.append((pub, msg, cs.signature))
        pre = precompute(items, plane="light",
                         backend=self.backend) if items else {}
        token = precomputed_verdicts.set(pre)
        try:
            out = []
            for r in reqs:
                try:
                    verify(r.trusted_sh, r.trusted_vals, r.untrusted_sh,
                           r.untrusted_vals, r.trusting_period_s, r.now_ns,
                           r.max_clock_drift_s, r.trust_level)
                    out.append(None)
                except Exception as e:
                    out.append(e)
        finally:
            precomputed_verdicts.reset(token)
        return out, len(items)

    def stop(self) -> None:
        """Cancel the deadline timer and fail anything still queued with an
        explicit shed (never a stall, even on shutdown)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        batch, self._pending = self._pending, []
        for req, fut in batch:
            if req.cache_key is not None:
                self._inflight.pop(req.cache_key, None)
            if not fut.done():
                fut.set_exception(ShedError("shutdown"))
                # nobody may await a shut-down future; don't warn about it
                fut.exception()


# -- serving surfaces --------------------------------------------------------

class ServeProvider:
    """Light-block provider over a served chain — the adapter a LightClient
    fleet sees when it hits a serving node. Duck-types light/provider's
    Provider (light_block / report_evidence / id) without importing it so
    the module stays loadable standalone.

    Carries the ``lightserve.lying_server`` chaos seam: when the site is
    armed, ``forged`` is non-empty, and the site fires for a requested
    height, the response is swapped for the operator-supplied forged block
    (a re-signed fork that *verifies* — only witness cross-check catches
    it). HeaderCache-backed so the cell also exercises cache recency."""

    def __init__(self, chain_id: str, blocks: Dict[int, Any],
                 forged: Optional[Dict[int, Any]] = None,
                 name: str = "serve", cache_capacity: int = 256):
        self.chain_id = chain_id
        self.blocks = dict(blocks)
        self.forged = dict(forged or {})
        self.cache = HeaderCache(capacity=cache_capacity)
        self.evidence: List[Any] = []
        self._name = name

    async def light_block(self, height: int):
        if height == 0 and self.blocks:
            height = max(self.blocks)
        lb = self.cache.get(height)
        if lb is None:
            lb = self.blocks.get(height)
            if lb is None:
                from .provider import ErrLightBlockNotFound

                raise ErrLightBlockNotFound(
                    f"no light block at height {height}")
            self.cache.put(height, lb)
        if height in self.forged:
            from ..libs.faults import faults

            if faults.armed(TAMPER_SITE) and faults.fire(TAMPER_SITE):
                return self.forged[height]
        return lb

    async def report_evidence(self, ev) -> None:
        self.evidence.append(ev)

    def id(self) -> str:
        return self._name


class LightServePlane:
    """The node's serving plane: header/commit cache with bisection-aware
    prefetch, the verification coalescer, and per-client admission —
    behind the /light_header, /light_verify, /lightserve_status routes."""

    def __init__(self, *, block_store, state_store, chain_id: str,
                 config, metrics=None):
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        self.cfg = config
        self.metrics = metrics
        self.cache = HeaderCache(capacity=config.cache_capacity)
        self.coalescer = VerifyCoalescer(
            flush_deadline_s=config.flush_deadline_ms / 1000.0,
            flush_max=config.flush_max,
            queue_limit=config.queue_limit,
            verdict_cache_size=config.verdict_cache_size,
            metrics=metrics)
        scoreboard = None
        if config.per_client_rate > 0:
            from ..libs.peerscore import PeerScoreboard

            scoreboard = PeerScoreboard(
                name="lightserve",
                ban_threshold=config.abuse_ban_threshold,
                bans_counter=(metrics.client_bans_total
                              if metrics is not None else None))
        self.scoreboard = scoreboard
        self.limiter = ClientLimiter(config.per_client_rate,
                                     config.per_client_burst,
                                     scoreboard=scoreboard)
        self.stats = {"headers_served": 0, "verifies_served": 0,
                      "prefetched": 0}

    # -- admission ----------------------------------------------------------

    def _admit(self, client_id: str, route: str) -> None:
        if self.metrics is not None:
            self.metrics.requests_total.labels(route).inc()
        try:
            self.limiter.admit(client_id or "anonymous")
        except ShedError as e:
            if self.metrics is not None:
                self.metrics.sheds_total.labels(e.reason).inc()
            raise

    # -- header serving -----------------------------------------------------

    def serve_header(self, height: int, trusted_height: int = 0,
                     client_id: str = "") -> Dict[str, Any]:
        """The /light_header answer: commit-route-shaped signed header doc.
        A declared ``trusted_height`` triggers bisection-skeleton prefetch
        for the span (pinned cache entries), so a fleet bisecting the same
        span hits memory. Raises ShedError on admission, KeyError when the
        height has no header."""
        self._admit(client_id, "light_header")
        tip = self.block_store.height()
        h = height or tip
        canonical = h != tip
        doc = None
        if canonical:
            doc = self.cache.get(h)
            if self.metrics is not None:
                if doc is not None:
                    self.metrics.cache_hits_total.inc()
                else:
                    self.metrics.cache_misses_total.inc()
        if doc is None:
            doc = self._build_doc(h, tip)
            if canonical:
                self.cache.put(h, doc)
        if trusted_height and 0 < trusted_height < h:
            self._prefetch_span(trusted_height, h)
        self.stats["headers_served"] += 1
        return self._maybe_tamper(doc)

    def _build_doc(self, h: int, tip: int) -> Dict[str, Any]:
        from ..rpc.json_enc import enc_commit, enc_header

        meta = self.block_store.load_block_meta(h)
        if meta is None:
            raise KeyError(f"no header at height {h}")
        if h == tip:
            commit = self.block_store.load_seen_commit(h)
            canonical = False
        else:
            commit = self.block_store.load_block_commit(h)
            canonical = True
        return {"signed_header": {"header": enc_header(meta.header),
                                  "commit": enc_commit(commit)},
                "canonical": canonical}

    def _prefetch_span(self, trusted_height: int, target_height: int) -> None:
        tip = self.block_store.height()
        for mid in bisection_skeleton(trusted_height, target_height,
                                      cap=self.cfg.prefetch_limit):
            if mid >= tip or self.cache.peek(mid) is not None:
                continue
            try:
                doc = self._build_doc(mid, tip)
            except KeyError:
                continue  # pruned height: nothing to pin
            self.cache.put(mid, doc, pinned=True)
            self.stats["prefetched"] += 1
            if self.metrics is not None:
                self.metrics.cache_prefetches_total.inc()

    def _maybe_tamper(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        from ..libs.faults import faults

        if not faults.armed(TAMPER_SITE) or not faults.fire(TAMPER_SITE):
            return doc
        import copy

        bad = copy.deepcopy(doc)
        hdr = bad["signed_header"]["header"]
        ah = hdr.get("app_hash") or "00" * 32
        hdr["app_hash"] = ("ff" if ah[:2] != "ff" else "00") + ah[2:]
        return bad

    # -- coalesced verification ---------------------------------------------

    async def serve_verify(self, height: int, trusted_height: int,
                           trust_level: Tuple[int, int] = (1, 3),
                           client_id: str = "") -> Optional[Exception]:
        """The /light_verify answer: trusting-verify ``height`` against
        ``trusted_height`` with the node's own stores as the header/valset
        source, through the coalescer. Returns None (accepted) or the exact
        scalar-spec exception."""
        self._admit(client_id, "light_verify")
        tip = self.block_store.height()
        if not (0 < trusted_height < height <= tip):
            raise KeyError(
                f"need 0 < trusted_height < height <= {tip}, "
                f"got trusted_height={trusted_height} height={height}")
        req = self._build_request(trusted_height, height, trust_level, tip)
        res = await self.coalescer.submit(req)
        self.stats["verifies_served"] += 1
        return res

    def _build_request(self, trusted_height: int, height: int,
                       trust_level: Tuple[int, int],
                       tip: int) -> VerifyRequest:
        from ..types.light_block import SignedHeader

        def signed_header(h: int) -> SignedHeader:
            meta = self.block_store.load_block_meta(h)
            if meta is None:
                raise KeyError(f"no header at height {h}")
            commit = (self.block_store.load_seen_commit(h) if h == tip
                      else self.block_store.load_block_commit(h))
            if commit is None:
                raise KeyError(f"no commit at height {h}")
            return SignedHeader(meta.header, commit)

        def vals(h: int):
            v = self.state_store.load_validators(h)
            if v is None:
                raise KeyError(f"no validator set at height {h}")
            return v

        now_ns = time.time_ns()
        # verdicts are only reusable while the content is immutable
        # (canonical heights below the tip) and within a trusting-period
        # bucket (expiry only moves one way; the minute bucket bounds how
        # stale a cached not-yet-expired verdict can be)
        cache_key = None
        if height < tip:
            cache_key = (trusted_height, height, trust_level,
                         now_ns // 60_000_000_000)
        return VerifyRequest(
            signed_header(trusted_height), vals(trusted_height),
            signed_header(height), vals(height),
            self.cfg.trusting_period_s, now_ns, self.cfg.max_clock_drift_s,
            trust_level, cache_key=cache_key)

    # -- observability / lifecycle ------------------------------------------

    def status(self) -> Dict[str, Any]:
        return {
            "served": dict(self.stats),
            "coalescer": dict(self.coalescer.stats),
            "cache": dict(self.cache.stats,
                          resident=len(self.cache),
                          pinned=self.cache.pinned_count()),
            "limiter": dict(self.limiter.stats),
        }

    def stop(self) -> None:
        self.coalescer.stop()
