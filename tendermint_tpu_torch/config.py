"""Node configuration. Only two sections are ported so far:
``ExecutionConfig`` (read by ``state/execution.py`` ``BlockExecutor``) and
``LightServeConfig`` (read by ``light/serve.py`` ``LightServePlane``); the
node's other sections come with the node."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ExecutionConfig:
    """Execution plane (state/execution.py + state/parallel.py). No
    reference analog — tendermint executes DeliverTx serially; this build
    grows an optimistic parallel path over it."""

    # v1 = optimistic parallel block execution: conflict-grouped
    # speculation + validation + serial re-execution of conflicts, with
    # byte-identical outputs and automatic per-block fallback to serial
    # (state/parallel.py); v0 = the serial spec path only
    version: str = "v1"
    workers: int = 4            # speculation thread pool width
    min_parallel_txs: int = 2   # below this, serial is always cheaper


@dataclass
class LightServeConfig:
    """Light-client serving plane (light/serve.py). No reference analog —
    tendermint serves light clients one scalar RPC at a time; this build
    coalesces a population of them into shared device batches."""

    enable: bool = True
    # coalescer: flush after this many ms from the first queued request,
    # or as soon as flush_max requests accumulate, whichever first
    flush_deadline_ms: float = 2.0
    flush_max: int = 64
    queue_limit: int = 4096            # pending verifies; beyond: queue-full
    cache_capacity: int = 1024         # header/commit docs resident
    verdict_cache_size: int = 4096     # remembered verify verdicts
    prefetch_limit: int = 16           # bisection-skeleton heights pinned
    per_client_rate: float = 0.0       # requests/s per client id; 0 disables
    per_client_burst: int = 16
    abuse_ban_threshold: int = 8       # consecutive rate strikes before ban
    trusting_period_s: float = 14 * 24 * 3600.0
    max_clock_drift_s: float = 10.0
