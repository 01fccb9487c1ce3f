"""Prometheus-style metrics, dependency-free
(reference per-module metrics.go + prometheus/client_golang).

Counter / Gauge / Histogram with labels, collected in a Registry that
renders the text exposition format served on the node's
``instrumentation.prometheus_listen_addr`` /metrics endpoint
(reference node/node.go:962).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str) -> "_Bound":
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} "
                             f"labels, got {len(values)}")
        return _Bound(self, tuple(str(v) for v in values))

    def _fmt_labels(self, lv: Tuple[str, ...]) -> str:
        if not lv:
            return ""
        # sorted by label name — the SAME ordering Histogram bucket lines
        # use, so one metric's series never mix two orderings and raw-text
        # diffs/greps are deterministic (client_golang sorts identically)
        inner = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in sorted(zip(self.label_names, lv)))
        return "{" + inner + "}"

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._values.items())
        for lv, val in items:
            out.append(f"{self.name}{self._fmt_labels(lv)} {_fmt(val)}")
        return out

    def _check_arity(self, labels: Tuple) -> Tuple[str, ...]:
        if len(labels) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} "
                             f"labels, got {len(labels)}")
        return tuple(str(v) for v in labels)

    def value(self, *labels: str) -> float:
        """Current value for a counter/gauge label set (0.0 if never
        touched) — the seam bench/debug tooling reads instead of parsing
        the exposition text."""
        lv = self._check_arity(labels)
        with self._lock:
            return self._values.get(lv, 0.0)


class _Bound:
    __slots__ = ("metric", "lv")

    def __init__(self, metric: "_Metric", lv: Tuple[str, ...]):
        self.metric = metric
        self.lv = lv

    def inc(self, amount: float = 1.0) -> None:
        self.metric._inc(self.lv, amount)

    def set(self, value: float) -> None:
        self.metric._set(self.lv, value)

    def observe(self, value: float) -> None:
        self.metric._observe(self.lv, value)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the series line is unparseable
    (exposition format spec, "Line format")."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def _inc(self, lv: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + amount

    def _set(self, lv, value):  # misuse guard
        raise TypeError("counters only go up")

    def _observe(self, lv, value):  # misuse guard
        raise TypeError(f"{self.name}: observe() is only valid on histograms")


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def _set(self, lv: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[lv] = float(value)

    def _inc(self, lv: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + amount

    def _observe(self, lv, value):  # misuse guard
        raise TypeError(f"{self.name}: observe() is only valid on histograms")


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0)

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, lv: Tuple[str, ...], value: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(lv, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[lv] = self._sums.get(lv, 0.0) + value
            self._totals[lv] = self._totals.get(lv, 0) + 1

    def _set(self, lv, value):  # misuse guard
        raise TypeError(f"{self.name}: set() is not valid on histograms")

    def _inc(self, lv, amount):  # misuse guard
        raise TypeError(f"{self.name}: inc() is not valid on histograms")

    def value(self, *labels):  # misuse guard: _values is never populated
        raise TypeError(f"{self.name}: histograms have no single value — "
                        "use sum_value()/count_value()")

    def sum_value(self, *labels: str) -> float:
        lv = self._check_arity(labels)
        with self._lock:
            return self._sums.get(lv, 0.0)

    def count_value(self, *labels: str) -> int:
        lv = self._check_arity(labels)
        with self._lock:
            return self._totals.get(lv, 0)

    def _bucket_labels(self, lv: Tuple[str, ...], le: str) -> str:
        # deterministic: label names sorted, `le` always last (Prometheus
        # only requires consistency, but scrapers and tests diff raw text)
        pairs = sorted(zip(self.label_names, lv))
        pairs.append(("le", le))
        return ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self._counts.items())
            for lv, counts in items:
                for b, c in zip(self.buckets, counts):
                    inner = self._bucket_labels(lv, _fmt(b))
                    out.append(f"{self.name}_bucket{{{inner}}} {c}")
                inner = self._bucket_labels(lv, "+Inf")
                out.append(f"{self.name}_bucket{{{inner}}} {self._totals[lv]}")
                out.append(f"{self.name}_sum{self._fmt_labels(lv)} "
                           f"{_fmt(self._sums[lv])}")
                out.append(f"{self.name}_count{self._fmt_labels(lv)} "
                           f"{self._totals[lv]}")
        return out


class Registry:
    def __init__(self, namespace: str = "tendermint"):
        self.namespace = namespace
        self._metrics: List[_Metric] = []
        self._names: set = set()
        self._lock = threading.Lock()

    def counter(self, subsystem: str, name: str, help_: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._add(Counter(self._fq(subsystem, name), help_, labels))

    def gauge(self, subsystem: str, name: str, help_: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._add(Gauge(self._fq(subsystem, name), help_, labels))

    def histogram(self, subsystem: str, name: str, help_: str,
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._add(Histogram(self._fq(subsystem, name), help_, labels,
                                   buckets))

    def _fq(self, subsystem: str, name: str) -> str:
        parts = [p for p in (self.namespace, subsystem, name) if p]
        return "_".join(parts)

    def _add(self, m):
        with self._lock:
            if m.name in self._names:
                # a silent duplicate double-renders the series and Prometheus
                # rejects the whole scrape — fail at registration instead
                raise ValueError(f"metric {m.name!r} already registered")
            self._names.add(m.name)
            self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# --- per-module metric sets (reference mempool/metrics.go etc.) -------------
# Only the sets that the port's modules feed: the mempool, the
# verification plane, block execution (state/execution.py and
# state/parallel.py) and fast sync (blockchain/reactor.py). The consensus,
# p2p, RPC, device, fault, recovery, state-sync and node sets come with
# the node that wires them.

class MempoolMetrics:
    """(mempool/metrics.go — grown the ingestion-plane series a
    high-traffic mempool needs: depth in txs AND bytes on every mutation
    path, admission/rejection/eviction taxonomies, CheckTx/recheck
    latency distributions, and the per-tx lifecycle histograms fed by
    libs/txlife.py)."""

    #: CheckTx is an in-proc app call (~us) but socket/grpc apps reach ms
    CHECKTX_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                       0.01, 0.025, 0.05, 0.1, 0.25)
    #: broadcast→commit spans one to several block intervals
    COMMIT_LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                              30.0, 60.0)

    def __init__(self, reg: Registry):
        g, c, h = reg.gauge, reg.counter, reg.histogram
        self.size = g("mempool", "size", "Number of uncommitted txs.")
        self.size_bytes = g("mempool", "size_bytes",
                            "Total bytes of uncommitted txs (depth-bytes).")
        self.tx_size_bytes = h(
            "mempool", "tx_size_bytes", "Tx sizes in bytes.",
            buckets=(32, 128, 512, 2048, 8192, 32768, 131072))
        self.failed_txs = c(
            "mempool", "failed_txs",
            "Txs rejected before admission, by reason "
            "(cache-dup, app-reject, full, too-large, invalid-sig, "
            "malformed-stx).", ["reason"])
        self.admitted_txs_total = c(
            "mempool", "admitted_txs_total",
            "Txs that passed CheckTx and entered the mempool.")
        self.evicted_txs_total = c(
            "mempool", "evicted_txs_total",
            "Admitted txs removed without committing, by reason "
            "(recheck-failed, flush, priority-evicted, ttl-expired).",
            ["reason"])
        # -- ingestion fast path (mempool/ingest.py) ---------------------
        self.shed_txs_total = c(
            "mempool", "shed_txs_total",
            "Txs refused by admission control before any verification "
            "or app work, by reason (queue-full, sender-rate, "
            "fee-floor).", ["reason"])
        self.intake_queue_depth = g(
            "mempool", "intake_queue_depth",
            "Ingest pipeline intake depth sampled at each micro-batch "
            "flush (bounded by mempool.ingest_queue_size).")
        self.preverified_txs_total = c(
            "mempool", "preverified_txs_total",
            "Signature pre-verification verdicts, by path/outcome "
            "(accepted/rejected via the batched pipeline, scalar for "
            "inline admissions).", ["outcome"])
        self.preverify_cache_hits_total = c(
            "mempool", "preverify_cache_hits_total",
            "Signature checks skipped because a cached pre-verification "
            "verdict stood, by consumer (batch, checktx, recheck — "
            "recheck hits are what keep commits from re-verification "
            "storms).", ["path"])
        self.preverify_latency_seconds = h(
            "mempool", "preverify_latency_seconds",
            "Wall seconds one micro-batch spent in signature "
            "pre-verification (host or device, routed by "
            "crypto.BatchVerifier).",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
        self.recheck_times = c("mempool", "recheck_times",
                               "Times txs were rechecked.")
        self.checktx_latency_seconds = h(
            "mempool", "checktx_latency_seconds",
            "App CheckTx latency for first-time admission checks.",
            buckets=self.CHECKTX_BUCKETS)
        self.recheck_latency_seconds = h(
            "mempool", "recheck_latency_seconds",
            "App CheckTx latency for post-block rechecks.",
            buckets=self.CHECKTX_BUCKETS)
        # -- per-tx lifecycle (libs/txlife.py) ---------------------------
        self.tx_stage_seconds = h(
            "mempool", "tx_stage_seconds",
            "Seconds from the previous lifecycle stage stamp to this one "
            "(rpc_received, preverified, checktx_done, mempool_admitted, "
            "first_gossip, proposal_included, committed, rechecked).",
            ["stage"],
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0))
        self.tx_commit_latency_seconds = h(
            "mempool", "tx_commit_latency_seconds",
            "End-to-end seconds from a sampled tx's first lifecycle stamp "
            "(rpc_received on the ingesting node) to its block commit.",
            buckets=self.COMMIT_LATENCY_BUCKETS)


class CryptoMetrics:
    """The verification plane (no reference analog — the batched verifier
    is this build's defining feature, so its routing must be observable:
    batch-size and verify-latency distributions are the decisive tuning
    inputs for committee-based consensus [arXiv:2302.00418], and
    offload-vs-host routing counters the same for an offload engine
    [arXiv:2112.02229])."""

    #: batch sizes span 1 (evidence pairs) to 128k (10k-val windows)
    BATCH_BUCKETS = (1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 131072)
    LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

    def __init__(self, reg: Registry):
        g, c, h = reg.gauge, reg.counter, reg.histogram
        self.batch_size = h(
            "crypto", "batch_size",
            "Signatures per verification batch.", ["route", "plane"],
            buckets=self.BATCH_BUCKETS)
        self.verify_latency_seconds = h(
            "crypto", "verify_latency_seconds",
            "End-to-end batch verification latency.", ["route", "plane"],
            buckets=self.LATENCY_BUCKETS)
        self.routing_decisions_total = c(
            "crypto", "routing_decisions_total",
            "Batches routed per backend.", ["route", "plane"])
        # the port re-verifies nothing on the host after a device fault
        # (crypto/breaker.py count_device_error): each fault that reaches
        # a caller counts here once, by its kind and the caller's plane
        self.device_errors_total = c(
            "crypto", "device_errors_total",
            "Device faults raised to the caller.", ["reason", "plane"])
        self.precomputed_hits_total = c(
            "crypto", "precomputed_hits_total",
            "Batches served entirely from precomputed verdicts.", ["plane"])
        self.pad_waste_ratio = g(
            "crypto", "pad_waste_ratio",
            "Padded-slot fraction of the last device batch.", ["plane"])
        self.vote_queue_depth = g(
            "crypto", "vote_queue_depth",
            "Votes pending in the micro-batcher at last flush.")
        self.vote_flush_latency_seconds = h(
            "crypto", "vote_flush_latency_seconds",
            "Vote micro-batch flush latency.", ["route"],
            buckets=self.LATENCY_BUCKETS)
        # -- device circuit breaker (crypto/breaker.py) ------------------
        self.breaker_state = g(
            "crypto", "breaker_state",
            "Circuit breaker state: 0 closed, 1 open, 2 half-open.",
            ["breaker"])
        self.breaker_transitions_total = c(
            "crypto", "breaker_transitions_total",
            "Circuit breaker state transitions.",
            ["breaker", "from", "to"])


class StateMetrics:
    """(state/metrics.go)"""

    def __init__(self, reg: Registry):
        self.block_processing_time = reg.histogram(
            "state", "block_processing_time",
            "Seconds in ApplyBlock.", buckets=(0.001, 0.005, 0.01, 0.025,
                                               0.05, 0.1, 0.25, 0.5, 1.0))
        # optimistic parallel execution plane (state/parallel.py)
        self.parallel_exec_blocks = reg.counter(
            "state", "parallel_exec_blocks_total",
            "Blocks executed via the optimistic parallel path.")
        self.parallel_exec_conflict_txs = reg.counter(
            "state", "parallel_exec_conflict_txs_total",
            "Txs serially re-executed after conflict validation.")
        self.parallel_exec_fallbacks = reg.counter(
            "state", "parallel_exec_fallbacks_total",
            "Blocks that fell back to the serial spec path.",
            labels=("reason",))


class BlocksyncMetrics:
    """The fast-sync apply plane (blockchain/reactor.py 2-deep pipeline)."""

    STAGE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5)

    def __init__(self, reg: Registry):
        g, c, h = reg.gauge, reg.counter, reg.histogram
        self.stage_seconds = h(
            "blocksync", "stage_seconds",
            "Seconds per pipeline stage observation "
            "(hash/verify per window, exec/store per block).", ["stage"],
            buckets=self.STAGE_BUCKETS)
        self.window_blocks = h(
            "blocksync", "window_blocks",
            "Blocks applied per verify window.",
            buckets=(1, 2, 4, 8, 16, 32))
        self.pipelined_windows_total = c(
            "blocksync", "pipelined_windows_total",
            "Windows whose stage A overlapped the previous apply.")
        self.inline_windows_total = c(
            "blocksync", "inline_windows_total",
            "Windows verified inline (pipeline starved or first window).")
        self.lookahead_stalls_total = c(
            "blocksync", "lookahead_stalls_total",
            "Iterations where the next window's blocks were not yet "
            "downloaded when the lookahead wanted to start.")
        self.stale_window_discards_total = c(
            "blocksync", "stale_window_discards_total",
            "Prepared windows discarded because the pool or validator set "
            "moved underneath them.")
        # -- adversarial resilience (libs/peerscore.py scoreboard) --------
        self.peer_bans_total = c(
            "blocksync", "peer_bans_total",
            "Block-sync peers banned after repeated bad blocks/commits.",
            ["reason"])
        self.sync_retries_total = c(
            "blocksync", "sync_retries_total",
            "Block windows redone after a bad block from a peer.")
