"""The subjective time check of an aggregated commit.

An AggregatedCommit's ``timestamp_ns`` (the voting-power-weighted median
of its precommits' times) is covered by no signature: every precommit
signed the zero-timestamp payload. So each validator bounds it against
what it saw itself before it prevotes.
"""

from __future__ import annotations


def check_aggregated_commit_time(commit, seen_ts_ns, now_ns_, drift_ns) -> None:
    """Window check behind ConsensusState._check_aggregated_commit_time
    (consensus/state.py), which a validator runs on an aggregated
    LastCommit before it prevotes.

    `seen_ts_ns` are the precommit timestamps THIS node recorded for the
    commit's height from validators inside the signer bitmap; possibly a
    subset of what the proposer aggregated over, so the window keeps
    drift-sized slack on both sides.  Raises ValueError on a timestamp
    outside [min(seen)-drift, max(seen)+drift] or more than drift ahead of
    the local clock."""
    ts = commit.timestamp_ns
    if ts > now_ns_ + drift_ns:
        raise ValueError(
            f"aggregated commit timestamp {ts} is more than "
            f"{drift_ns / 1e9:g}s ahead of local time {now_ns_}")
    if seen_ts_ns:
        lo, hi = min(seen_ts_ns) - drift_ns, max(seen_ts_ns) + drift_ns
        if not lo <= ts <= hi:
            raise ValueError(
                f"aggregated commit timestamp {ts} outside the window "
                f"[{lo}, {hi}] of locally recorded precommit times")
