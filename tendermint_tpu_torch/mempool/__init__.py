"""Mempool (reference mempool/, SURVEY.md §2.5).

Two implementations behind one surface: the v0 CList port
(``clist_mempool.CListMempool``) and the production ingestion fast path
(``ingest.ShardedMempool`` — per-sender lanes, fee/priority eviction,
batched signature pre-verification; the v1 priority mempool's ordering
logic lives inside its lane eviction policy now).
"""

from .clist_mempool import CListMempool, MempoolError, TxCache  # noqa: F401
from .ingest import IngestPipeline, ShardedMempool  # noqa: F401
