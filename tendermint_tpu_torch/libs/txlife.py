"""Per-tx lifecycle tracker: the ingestion-plane observability spine.

The ROADMAP's ingestion plane ("mempool + RPC built for millions of users")
cannot be built — or judged — without per-tx end-to-end measurement: runtimes
chasing sub-second finality treat broadcast→commit latency percentiles as the
first-class product metric (ACE Runtime, arXiv 2603.10242), and
committee-consensus evaluations are throughput/latency trade curves
(arXiv 2302.00418). This module records that trade curve's raw material
live, per sampled tx, as monotonic stage stamps:

    rpc_received        the tx arrived at a broadcast_tx_* RPC handler
    preverified         the ingestion plane's batched (or scalar)
                        signature pre-verification verdict landed
                        (outcome accepted|rejected; rejected is
                        terminal — an invalid signature never reaches
                        the app), or its batch's device call failed
                        (outcome error, terminal: the fault reached the
                        broadcast, and the tx may be resubmitted)
    checktx_done        the app's CheckTx verdict landed (outcome
                        accepted|rejected; rejected is terminal)
    mempool_admitted    the tx entered the mempool
    first_gossip        we first forwarded the tx to any peer
    proposal_included   the tx landed in a proposal block (proposer stamps
                        at creation; followers at complete-proposal decode)
    committed           the tx's block committed (terminal)
    rechecked           post-block CheckTx re-run while still pending
                        (repeatable; outcome rejected is terminal)

Design mirrors ``crypto/phases.py`` / ``consensus/timeline.py``:

* **hash-sampled**: a tx participates iff the leading 8 bytes of its
  sha256 key fall under the sample rate (``TMTPU_TXLIFE_SAMPLE``, default
  1.0) — deterministic per tx, so every node in a fleet samples the SAME
  txs and ``tools/trace_merge.py`` can correlate one tx across nodes;
* **bounded**: sealed records land on a ring (default 512) and the
  in-flight map is capped (default 4096, oldest evicted as ``lost``) so a
  million-user firehose cannot grow process memory;
* **cheap when idle**: one attribute load + dict lookup per mark for
  unsampled txs; trackers are per-node instances (the in-proc test nets
  run 4 nodes in one process), wired once onto ``CListMempool.txlife``
  and reached by the RPC layer / consensus hooks through the mempool.

On seal the tracker:

* observes ``tendermint_mempool_tx_stage_seconds{stage}`` (interval from
  the previous stamped stage) and, for committed txs,
  ``tendermint_mempool_tx_commit_latency_seconds`` (first stamp →
  committed: on the RPC node that is the honest broadcast→commit number,
  on gossip-fed peers it runs from ``checktx_done``);
* emits height-tagged ``tx_<stage>`` tracer spans on a synthetic
  per-record track, so a merged Perfetto view shows tx latency riding
  next to the consensus stage timeline;
* appends a JSON-safe record served at ``GET /tx_timeline?limit=N`` and
  bundled by debugdump as ``txlife.json``.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

from .trace import tracer

#: canonical stage order (README "Ingestion observability"); durations are
#: deltas between consecutive STAMPED stages in this order
STAGES = ("rpc_received", "preverified", "checktx_done", "mempool_admitted",
          "first_gossip", "proposal_included", "committed", "rechecked")

#: stages allowed to OPEN a record — everything else on an unknown key is
#: a stale mark (e.g. a block commit for a tx sampled before a restart).
#: Gossip-fed txs skip the RPC door AND the ingest pipeline, so both
#: preverified and checktx_done can open a record.
ENTRY_STAGES = ("rpc_received", "preverified", "checktx_done")

DEFAULT_RING_CAPACITY = 512
DEFAULT_ACTIVE_CAPACITY = 4096

#: marks kept per record: ``rechecked`` repeats every block a tx stays
#: pending, and an unbounded marks list would grow the active map's
#: records without bound — the recheck COUNT keeps counting past the cap
MAX_MARKS_PER_RECORD = 64

#: synthetic tracer track base for per-tx spans (same trick as
#: crypto/phases.py segment tracks): concurrent tx lifecycles overlap in
#: wall time and would render mis-nested on one shared track
_TX_TRACK_BASE = 0x71F0000
_TRACK_SEQ = itertools.count()


def _env_sample_rate() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("TMTPU_TXLIFE_SAMPLE", "1.0"))))
    except ValueError:
        return 1.0


class TxLifecycle:
    """One node's tx-lifecycle recorder. All methods are thread-safe: RPC
    handlers run on the event loop thread, ``CheckTx`` under the mempool
    lock, commits on the consensus loop."""

    def __init__(self, sample_rate: Optional[float] = None,
                 ring_capacity: int = DEFAULT_RING_CAPACITY,
                 active_capacity: int = DEFAULT_ACTIVE_CAPACITY):
        self.sample_rate = (_env_sample_rate() if sample_rate is None
                            else min(1.0, max(0.0, float(sample_rate))))
        self.ring_capacity = ring_capacity
        self.active_capacity = active_capacity
        self.enabled = True
        self.metrics = None  # MempoolMetrics, wired by the node
        self._lock = threading.Lock()
        self._active: "collections.OrderedDict[bytes, dict]" = \
            collections.OrderedDict()
        self._ring: "collections.deque" = collections.deque(
            maxlen=ring_capacity)
        self.sealed_total = 0
        self.evicted_total = 0  # active-map overflow (records closed "lost")

    # -- sampling ----------------------------------------------------------

    def sampled(self, key: bytes) -> bool:
        """Deterministic by tx hash: the leading 64 bits of the sha256 key
        as a fraction of 2^64. Every node samples the same txs."""
        if not self.enabled or self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        return int.from_bytes(key[:8], "big") < self.sample_rate * 2.0 ** 64

    # -- recording ---------------------------------------------------------

    def mark(self, key: bytes, stage: str, height: Optional[int] = None,
             outcome: Optional[str] = None) -> None:
        """Stamp ``stage`` for the tx with sha256 digest ``key``. First
        stamp per stage wins (``rechecked`` repeats and counts);
        ``committed`` — and any stage with ``outcome="rejected"``, or
        ``preverified`` with ``outcome="error"`` — seals the record.
        Unknown keys only open a record at an entry stage."""
        if not self.sampled(key):
            # the cheap-when-idle contract: an unsampled tx (deterministic
            # per key, so it can never be in the active map) pays no clock
            # read and never touches the tracker lock — the RPC loop, the
            # mempool mutex holder, and the consensus loop must not
            # contend here at low sample rates
            return
        t_wall, t_perf = time.time(), time.perf_counter()
        with self._lock:
            rec = self._active.get(key)
            if rec is None:
                if stage not in ENTRY_STAGES:
                    return
                rec = {
                    "key": key.hex(),
                    "t0_wall": t_wall,
                    "t0_perf": t_perf,
                    "height": None,
                    "marks": [],        # (stage, t_wall, t_perf) in order
                    "_by_stage": {},    # stage -> t_perf, first wins
                    "rechecks": 0,
                    "terminal": None,
                }
                self._active[key] = rec
                if len(self._active) > self.active_capacity:
                    _, lost = self._active.popitem(last=False)
                    lost["terminal"] = "lost"
                    self._ring.append(self._seal_view(lost))
                    self.evicted_total += 1
            if stage == "rechecked":
                rec["rechecks"] += 1
            elif stage in rec["_by_stage"]:
                return  # first stamp wins; a duplicate is not a new event
            # every non-repeating stage appends at most once; only the
            # repeating rechecked marks are capped (the count keeps going)
            if stage != "rechecked" or rec["rechecks"] <= MAX_MARKS_PER_RECORD:
                rec["marks"].append((stage, t_wall, t_perf))
            rec["_by_stage"].setdefault(stage, t_perf)
            if height is not None:
                rec["height"] = int(height)
            terminal = (stage == "committed"
                        or (outcome == "rejected"
                            and stage in ("preverified", "checktx_done",
                                          "rechecked"))
                        or (outcome == "error" and stage == "preverified"))
            if not terminal:
                return
            rec["terminal"] = ("committed" if stage == "committed"
                               else outcome)
            self._active.pop(key, None)
            view = self._seal_view(rec)
            self._ring.append(view)
            self.sealed_total += 1
        # metrics + tracer OUTSIDE the lock: observing takes metric locks
        # and the tracer ring lock — neither belongs under ours
        self._observe(rec, view)

    def discard_phantom(self, key: bytes) -> None:
        """Drop an active record that never got past the front door
        (``rpc_received``/``preverified``): a client retrying an
        already-committed (cache-blocked) tx opens a record — and with
        the ingest pipeline in front, collects a preverified stamp —
        that no later stage will ever close. Under a retry storm those
        phantoms would evict genuine in-flight records and flood the
        sealed ring with ``lost`` entries. A record with any admission
        stamp (checktx_done onward) is left alone (the live original of
        a duplicate broadcast)."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._active.get(key)
            if rec is not None and \
                    set(rec["_by_stage"]) <= {"rpc_received", "preverified"}:
                self._active.pop(key, None)

    def tracking(self) -> bool:
        """False when nothing can ever be recorded (disabled or rate 0) —
        the guard per-block hook loops check before hashing anything."""
        return self.enabled and self.sample_rate > 0.0

    def mark_tx(self, tx: bytes, stage: str, height: Optional[int] = None,
                outcome: Optional[str] = None) -> None:
        """``mark`` for call sites that hold the raw tx, not its digest
        (proposal/commit hooks walking ``block.data.txs``). A rate-0
        tracker pays no sha256: sampling is key-independent then."""
        if not self.tracking():
            return
        self.mark(hashlib.sha256(tx).digest(), stage, height=height,
                  outcome=outcome)

    # -- seal side effects -------------------------------------------------

    def _seal_view(self, rec: dict) -> dict:
        durations: Dict[str, float] = {}
        prev = rec["t0_perf"]
        for stage in STAGES:
            got = rec["_by_stage"].get(stage)
            if got is None:
                continue
            durations[stage] = max(0.0, got - prev)
            prev = max(prev, got)
        view = {
            "key": rec["key"],
            "t0_wall": rec["t0_wall"],
            "height": rec["height"],
            "terminal": rec["terminal"],
            "rechecks": rec["rechecks"],
            "marks": [[stage, t_wall] for stage, t_wall, _ in rec["marks"]],
            "durations": {s: round(d, 6) for s, d in durations.items()},
            "total_s": round(max(0.0, prev - rec["t0_perf"]), 6),
        }
        rec["_durations"] = durations
        return view

    def _observe(self, rec: dict, view: dict) -> None:
        m = self.metrics
        if m is not None:
            try:
                for stage, d in rec["_durations"].items():
                    m.tx_stage_seconds.labels(stage).observe(d)
                if rec["terminal"] == "committed":
                    m.tx_commit_latency_seconds.observe(
                        max(0.0, rec["_by_stage"]["committed"]
                            - rec["t0_perf"]))
            except Exception:
                pass
        if tracer.enabled:
            tid = _TX_TRACK_BASE + (next(_TRACK_SEQ) & 0xFFF)
            args = {"tx": rec["key"][:16], "terminal": rec["terminal"]}
            if rec["height"] is not None:
                args["height"] = rec["height"]
            prev = rec["t0_perf"]
            for stage in STAGES:
                got = rec["_by_stage"].get(stage)
                if got is None:
                    continue
                start = min(prev, got)
                tracer.complete(f"tx_{stage}", start * 1e6,
                                max(0.0, got - start) * 1e6, tid=tid, **args)
                prev = max(prev, got)

    # -- read side (RPC /tx_timeline, debugdump txlife.json) ---------------

    def tail(self, n: int) -> List[dict]:
        with self._lock:
            records = list(self._ring)
        return records[-n:] if n < len(records) else records

    def snapshot(self, limit: int = 20) -> dict:
        with self._lock:
            active = len(self._active)
        return {
            "enabled": self.enabled,
            "sample_rate": self.sample_rate,
            "ring_capacity": self.ring_capacity,
            "active_capacity": self.active_capacity,
            "active": active,
            "sealed_total": self.sealed_total,
            "evicted_total": self.evicted_total,
            "records": self.tail(max(1, int(limit))),
        }

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._ring.clear()
            self.sealed_total = 0
            self.evicted_total = 0
