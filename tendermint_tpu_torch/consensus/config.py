"""Consensus timing/behaviour config (reference config/config.go:917 ConsensusConfig).

Two timeout modes:

* ``spec`` (default) — the reference's fixed linear-in-round schedule:
  ``timeout_X + timeout_X_delta * round``. Byte-identical to the config
  that existed before adaptive mode; nothing consults the controller.
* ``adaptive`` (opt-in) — :class:`AdaptiveTimeouts` keeps one EWMA per
  timeout class over the stage timeline's sealed per-height durations
  (proposal arrival, proposal→prevote-quorum, prevote→precommit-quorum)
  and sets each round-0 baseline to ``clamp(headroom * ewma, spec,
  spec * adaptive_max_scale)``; the per-round delta escalation is
  unchanged. The controller is a pure fold over the observation stream —
  same sealed durations in the same order → same timeouts — so seeded
  degraded-network runs stay replayable. Under a WAN profile the floor
  clamp means adaptive can only *raise* timeouts toward observed reality
  (fewer spurious round escalations), never starve below spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class ConsensusConfig:
    # all times in seconds (float); defaults from config/config.go:996-1010
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    double_sign_check_height: int = 0
    wal_file: str = ""
    # gossip sleeps (reactor). With event wakeups on, the sleep is only the
    # FALLBACK cap on how stale a gossip iteration can go without a signal —
    # state transitions, new parts, and new votes wake the routines directly.
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    peer_gossip_event_wakeups: bool = True
    # WAL group commit: the receive loop drains up to max_batch queued
    # messages, logs them all, and fsyncs ONCE when any is our own —
    # records and ordering identical to per-record sync, fewer disk syncs.
    wal_group_commit: bool = True
    wal_group_commit_max_batch: int = 128
    # fsync deadline for grouped batches with only peer records (which the
    # reference never syncs at all; this bounds the async tail's lag)
    wal_sync_deadline: float = 0.05
    # self-healing gossip: a peer silent for this long AND behind our
    # height gets its delivery bitmaps cleared so catchup re-sends
    # (PeerState.refresh_if_stalled; the behind-gate is in the reactor).
    # Gossip marks votes/parts delivered ON SEND — sound over reliable
    # TCP, but a lossy/blackholed link silently eats sends and the
    # bookkeeping then wedges the link forever. Quiet for healthy nets:
    # a peer at our height triggers nothing. 0 disables.
    gossip_stall_refresh_s: float = 10.0
    # stall watchdog: no committed-height advance for this many seconds →
    # consensus_stalled_total + a debugdump bundle (consensus/watchdog.py).
    # 0 disables (default: a net configured to idle between txs would
    # false-positive); e2e/chaos nets enable it.
    stall_watchdog_s: float = 0.0
    # Aggregated commits: the commit timestamp is covered by NO signature
    # (precommits sign zero-timestamp bytes), so before prevoting a proposal
    # each validator subjectively bounds the proposed last-commit timestamp
    # within this drift of its own recorded precommit times / local clock
    # (ConsensusState._check_aggregated_commit_time). 0 disables the check.
    agg_commit_time_drift_s: float = 10.0
    # round-timeout mode: "spec" keeps the fixed linear-in-round schedule
    # above; "adaptive" folds the stage timeline's observed latencies into
    # per-class EWMAs (see AdaptiveTimeouts) clamped to
    # [spec, spec * adaptive_max_scale]
    timeout_mode: str = "spec"
    # EWMA gain per sealed height (weight of the newest observation)
    adaptive_gain: float = 0.25
    # baseline = headroom * ewma before clamping: the slack multiple over
    # the observed latency a round must fit in before escalating
    adaptive_headroom: float = 2.0
    # clamp ceiling as a multiple of the spec timeout (spec_max)
    adaptive_max_scale: float = 5.0

    def propose(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit_time_ns(self, t_ns: int) -> int:
        return t_ns + int(self.timeout_commit * 1e9)

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks or self.create_empty_blocks_interval > 0

    def validate_timeout_mode(self) -> None:
        if self.timeout_mode not in ("spec", "adaptive"):
            raise ValueError(
                f"unknown timeout_mode {self.timeout_mode!r}; "
                f'known: ("spec", "adaptive")')


class AdaptiveTimeouts:
    """Deterministic EWMA controller for adaptive round timeouts.

    One EWMA per timeout class, fed from the stage timeline's sealed
    per-height duration dicts (``StageTimeline._seal``):

    * ``propose``   ← time to ``proposal_received`` (height open → proposal
      accepted by the state machine — what timeout_propose waits on)
    * ``prevote``   ← ``prevote_sent`` + ``prevote_quorum`` deltas
      (proposal → 2/3+ prevotes — what timeout_prevote waits on)
    * ``precommit`` ← ``precommit_sent`` + ``precommit_quorum`` deltas
      (polka → 2/3+ precommits — what timeout_precommit waits on)

    ``timeout(kind, round)`` returns ``clamp(headroom * ewma, spec,
    spec * max_scale) + spec_delta * round`` — the round escalation delta
    is untouched, only the round-0 baseline adapts. Pure fold: state is
    three floats, updated only in :meth:`observe`, so two nodes (or two
    runs) fed the same observation stream compute bit-identical timeouts.
    Before the first observation every class sits at its spec floor —
    adaptive mode starts exactly where spec mode is.
    """

    _CLASSES = ("propose", "prevote", "precommit")

    def __init__(self, config: ConsensusConfig):
        self.config = config
        self.ewma: Dict[str, Optional[float]] = {k: None for k in self._CLASSES}
        self.heights_observed = 0

    def observe(self, durations: Dict[str, float]) -> None:
        """Fold one sealed height's stage durations into the EWMAs.
        Missing stages (non-validator seals, fast-sync gaps) leave the
        affected class untouched rather than feeding it a zero."""
        g = self.config.adaptive_gain
        obs = {
            "propose": durations.get("proposal_received"),
            "prevote": self._span(durations, "prevote_sent", "prevote_quorum"),
            "precommit": self._span(durations, "precommit_sent",
                                    "precommit_quorum"),
        }
        for kind, x in obs.items():
            if x is None:
                continue
            prev = self.ewma[kind]
            self.ewma[kind] = x if prev is None else prev + g * (x - prev)
        self.heights_observed += 1

    @staticmethod
    def _span(durations: Dict[str, float], *stages: str) -> Optional[float]:
        got = [durations[s] for s in stages if s in durations]
        return sum(got) if got else None

    def timeout(self, kind: str, round_: int) -> float:
        cfg = self.config
        spec = getattr(cfg, f"timeout_{kind}")
        delta = getattr(cfg, f"timeout_{kind}_delta")
        ewma = self.ewma[kind]
        base = spec
        if ewma is not None:
            base = min(max(cfg.adaptive_headroom * ewma, spec),
                       spec * cfg.adaptive_max_scale)
        return base + delta * round_

    def snapshot(self) -> Dict[str, float]:
        """JSON-safe controller state (debugdump / RPC / tests)."""
        out = {"heights_observed": self.heights_observed}
        for kind in self._CLASSES:
            e = self.ewma[kind]
            out[f"ewma_{kind}"] = round(e, 6) if e is not None else None
            out[f"timeout_{kind}_r0"] = round(self.timeout(kind, 0), 6)
        return out


def test_consensus_config() -> ConsensusConfig:
    """Fast timeouts for in-proc tests (reference config TestConsensusConfig)."""
    return ConsensusConfig(  # noqa
        timeout_propose=0.08,
        timeout_propose_delta=0.05,
        timeout_prevote=0.01,
        timeout_prevote_delta=0.01,
        timeout_precommit=0.01,
        timeout_precommit_delta=0.01,
        timeout_commit=0.01,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration=0.005,
        peer_query_maj23_sleep_duration=0.25,
    )


test_consensus_config.__test__ = False  # not a pytest test despite the name
