"""Per-height consensus stage timeline (cluster observability plane).

The reference explains a slow height by reading four nodes' logs; the papers
this build tracks (arXiv 2302.00418, 2410.03347) attribute every win via a
per-phase latency decomposition of the consensus round. This module records
that decomposition live, per height: wall-clock marks at

    proposal_received   the proposal message was accepted by the state machine
    prevote_sent        our own prevote was signed and enqueued
    prevote_quorum      2/3+ prevotes seen for the round
    precommit_sent      our own precommit was signed and enqueued
    precommit_quorum    2/3+ precommits seen for the round
    commit_finalized    the block passed final validation and is committing

plus an auxiliary ``proposal_wire`` mark stamped by the reactor at wire
receipt (the gap to ``proposal_received`` is the state-machine queue delay).

When a height seals at ``commit_finalized`` the timeline:

* observes the interval between consecutive marks into
  ``ConsensusMetrics.stage_seconds`` (series
  ``tendermint_consensus_stage_seconds{stage=...}``),
* emits one height-tagged complete span per stage interval
  (``stage_<name>``) into the process tracer, so bench per-height
  breakdowns and the cross-node merged timeline (tools/trace_merge.py)
  show WHERE each height's wall-clock went,
* appends a JSON-safe record to a bounded ring queryable over RPC
  (``/consensus_stage_timeline``) and included in debugdump bundles.

All marks happen inside the single-writer consensus loop, so recording is
lock-free; readers (RPC handlers on the same loop, the debugdump signal
handler, the watchdog thread) only ever see fully-built records because a
record is appended to the ring in one bytecode after construction.

Marks store BOTH clocks: ``time.time()`` for cross-node skew (nodes on one
box share a wall clock; across boxes NTP bounds it) and
``time.perf_counter()`` for durations (wall clock can step backwards).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from ..libs.trace import tracer

#: canonical stage order within a height — durations are deltas between
#: consecutive PRESENT stages in this order (a non-validator never marks
#: the *_sent stages; its deltas bridge straight across)
STAGES = ("proposal_received", "prevote_sent", "prevote_quorum",
          "precommit_sent", "precommit_quorum", "commit_finalized")

DEFAULT_CAPACITY = 256


class StageTimeline:
    """Bounded per-height stage-mark recorder for one ConsensusState."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: "collections.deque" = collections.deque(maxlen=capacity)
        self.metrics = None  # ConsensusMetrics, wired by the node
        #: seal observer: called with the sealed height's durations dict
        #: from inside the single-writer loop — the adaptive-timeout
        #: controller's observation stream (consensus/config.py)
        self.on_seal = None
        self._cur: Optional[dict] = None
        self.heights_sealed = 0
        #: replay guard: WAL catchup re-feeds old messages through the
        #: state machine microseconds apart — those marks are replay time,
        #: not consensus time, and would seal one garbage record (and
        #: garbage stage_seconds samples) per restart.
        #: consensus/replay.py disables recording around catchup; the
        #: first live height then opens a fresh record at its first mark.
        self.enabled = True

    # -- recording (single-writer consensus loop) -------------------------

    def begin_height(self, height: int) -> None:
        """Open a record for ``height``; called from update_to_state. An
        unsealed predecessor (height overtaken by fast sync, or abandoned
        mid-round at a restart) is pushed as-is so the ring shows the gap."""
        if not self.enabled:
            return
        cur = self._cur
        if cur is not None and cur["height"] == height:
            return
        if cur is not None:
            self._ring.append(self._view(cur))
        self._cur = {
            "height": height,
            "round": 0,
            "t0_wall": time.time(),
            "t0_perf": time.perf_counter(),
            "marks": [],           # (stage, round, t_wall, t_perf) in order
            "_by_stage": {},       # stage -> (round, t_wall, t_perf), last wins
            "sealed": False,
        }

    def mark(self, height: int, round_: int, stage: str) -> None:
        if not self.enabled:
            return
        cur = self._cur
        if cur is None or height > cur["height"]:
            # marks can precede update_to_state only at process start
            self.begin_height(height)
            cur = self._cur
        elif height < cur["height"]:
            return  # stale (e.g. a WAL-replayed message for an old height)
        t_wall, t_perf = time.time(), time.perf_counter()
        if round_ > cur["round"]:
            cur["round"] = round_
        cur["marks"].append((stage, round_, t_wall, t_perf))
        cur["_by_stage"][stage] = (round_, t_wall, t_perf)
        if stage == "commit_finalized":
            self._seal(cur)

    def marked(self, height: int, stage: str) -> bool:
        """Cheap dedup guard for per-vote quorum checks."""
        cur = self._cur
        return (cur is not None and cur["height"] == height
                and stage in cur["_by_stage"])

    def note_wire_proposal(self, height: int) -> None:
        """Reactor hook: earliest wire receipt of this height's proposal —
        not one of the six stages (no histogram), but the record shows the
        queue delay to ``proposal_received``."""
        if not self.enabled:
            return
        cur = self._cur
        if (cur is None or cur["height"] != height
                or "proposal_wire" in cur["_by_stage"]):
            return
        t_wall, t_perf = time.time(), time.perf_counter()
        cur["marks"].append(("proposal_wire", -1, t_wall, t_perf))
        cur["_by_stage"]["proposal_wire"] = (-1, t_wall, t_perf)

    def _seal(self, cur: dict) -> None:
        by = cur["_by_stage"]
        durations: Dict[str, float] = {}
        prev = cur["t0_perf"]
        for stage in STAGES:
            got = by.get(stage)
            if got is None:
                continue
            t_perf = got[2]
            durations[stage] = max(0.0, t_perf - prev)
            prev = max(prev, t_perf)
        cur["durations"] = durations
        cur["total_s"] = max(0.0, by["commit_finalized"][2] - cur["t0_perf"])
        cur["sealed"] = True
        self.heights_sealed += 1
        m = self.metrics
        if m is not None:
            for stage, d in durations.items():
                m.stage_seconds.labels(stage).observe(d)
        cb = self.on_seal
        if cb is not None:
            cb(dict(durations))
        if tracer.enabled:
            prev = cur["t0_perf"]
            for stage in STAGES:
                got = by.get(stage)
                if got is None:
                    continue
                r, _, t_perf = got
                start = min(prev, t_perf)
                tracer.complete(f"stage_{stage}", start * 1e6,
                                max(0.0, t_perf - start) * 1e6,
                                height=cur["height"], round=r)
                prev = max(prev, t_perf)
        self._ring.append(self._view(cur))
        self._cur = None

    # -- queries (RPC / debugdump / bench) ---------------------------------

    @staticmethod
    def _view(cur: dict) -> dict:
        rec = {
            "height": cur["height"],
            "round": cur["round"],
            "t0_wall": cur["t0_wall"],
            "sealed": cur["sealed"],
            "marks": [[stage, r, t_wall]
                      for stage, r, t_wall, _ in cur["marks"]],
        }
        if cur["sealed"]:
            rec["durations"] = {s: round(d, 6)
                                for s, d in cur["durations"].items()}
            rec["total_s"] = round(cur["total_s"], 6)
        return rec

    def tail(self, n: int) -> List[dict]:
        records = list(self._ring)
        return records[-n:] if n < len(records) else records

    def snapshot(self, limit: int = 20) -> dict:
        cur = self._cur
        return {
            "capacity": self.capacity,
            "heights_sealed": self.heights_sealed,
            "current": self._view(cur) if cur is not None else None,
            "heights": self.tail(max(1, int(limit))),
        }
