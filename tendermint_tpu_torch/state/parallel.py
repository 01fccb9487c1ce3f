"""Optimistic parallel block execution (the ROADMAP's "parallel execution
plane"; no direct reference analog — tendermint executes DeliverTx serially,
state/execution.go:259).

The serial path (:func:`.execution.exec_block_on_proxy_app`) is the SPEC:
this module must produce a byte-identical ``ABCIResponses`` list, app hash,
and event order for every block, or it doesn't run at all. The shape is
classic optimistic concurrency control, keyed off the ingest plane's
per-sender lanes:

1. **Partition** the block's txs into conflict groups by
   :func:`mempool.ingest.conflict_hint` — signed ``stx1`` envelopes group
   by sender pubkey, unsigned txs by parsed kvstore key, validator-update
   and unparseable txs into one serial barrier group. The hint is ONLY a
   scheduling guess; nothing below trusts it.
2. **Speculate** each group concurrently against a :class:`SpecView` — a
   copy-on-write overlay over committed app state that records every
   logical key a tx reads or writes plus a replayable op log. Speculation
   never mutates the app, so a failed run is discarded for free.
3. **Validate** after the join: compute the conflict closure — the least
   fixpoint of (keys touched by ≥ 2 groups) ∪ (keys touched by any
   conflicted tx). Txs outside the closure touched only keys their own
   group owns, so their speculative reads — and therefore their responses
   — are exactly what serial execution would have produced.
4. **Apply + re-execute** under the app mutex: replay non-conflicted op
   logs in block order, then re-run only the conflicted txs through the
   real ``deliver_tx`` in block order. Closure keys are touched *only* by
   conflicted txs, so the re-run sees precisely the serial state.

Apps opt in by setting ``parallel_exec_supported`` and implementing
``spec_read`` / ``deliver_tx_on_view`` / ``apply_spec_ops``
(abci/application.py documents the contract; abci/example/kvstore.py is
the model). Anything else — remote apps, tiny blocks, a speculation
error — falls back to the serial spec, counted per reason on
``state_parallel_exec_fallbacks_total``.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

from ..abci import types as abci
from ..abci.client import Client, LocalClient
from ..libs.faults import faults
from ..mempool.ingest import conflict_hint
from ..types.block import Block
from .store import ABCIResponses, StateStore

logger = logging.getLogger("tmtpu.state.parallel")

#: logical key spaces a view tracks; (space, key) tuples are the unit of
#: conflict detection. "vup" is the ordered validator-update stream: every
#: emitter touches the SAME ("vup", "") key, so validator updates from
#: different groups can never silently interleave — the closure pulls all
#: of them into the serial re-execution together (all-or-nothing).
Key = Tuple[str, str]


class TxLog:
    """Read/write record of one speculated tx."""

    __slots__ = ("idx", "keys", "ops", "response")

    def __init__(self, idx: int):
        self.idx = idx
        self.keys: Set[Key] = set()
        self.ops: List[tuple] = []
        self.response: Optional[abci.ResponseDeliverTx] = None


class SpecView:
    """Copy-on-write overlay for one conflict group's speculation.

    Reads hit the overlay first (earlier txs of the SAME group, in block
    order) and fall back to the app's committed state via ``spec_read``.
    Ops are app-defined tuples replayed verbatim by ``apply_spec_ops`` —
    the view only guarantees they are logged per tx, in execution order.
    """

    __slots__ = ("_app", "_overlay", "logs", "_log")

    def __init__(self, app):
        self._app = app
        self._overlay: Dict[Key, object] = {}
        self.logs: List[TxLog] = []
        self._log: Optional[TxLog] = None

    def begin_tx(self, idx: int) -> None:
        self._log = TxLog(idx)
        self.logs.append(self._log)

    def read(self, space: str, key: str):
        k = (space, key)
        self._log.keys.add(k)
        if k in self._overlay:
            return self._overlay[k]
        return self._app.spec_read(space, key)

    def write(self, space: str, key: str, value, extra=None) -> None:
        k = (space, key)
        self._log.keys.add(k)
        self._overlay[k] = value
        self._log.ops.append(("set", space, key, value, extra))

    def emit(self, space: str, value) -> None:
        """Ordered append to a shared per-space stream: touches the
        stream's single shared key, so cross-group emitters always
        conflict (and thus re-execute in block order)."""
        self._log.keys.add((space, ""))
        self._log.ops.append(("emit", space, value))

    def add(self, counter: str, n: int = 1) -> None:
        """Commutative counter bump — keyless, never conflicts."""
        self._log.ops.append(("add", counter, n))


def conflict_groups(txs: List[bytes]) -> List[List[int]]:
    """Partition tx indices by conflict hint, preserving block order both
    across groups (first appearance) and within each group. The
    ``exec.conflict`` chaos site seeded-perturbs assignments into
    deliberately wrong lanes — correctness must then come from
    validation + re-execution, which is exactly what the site tests."""
    groups: Dict[Tuple[str, str], List[int]] = {}
    chaos = faults.armed("exec.conflict")
    for i, tx in enumerate(txs):
        hint = conflict_hint(tx)
        if chaos and faults.fire("exec.conflict"):
            hint = ("chaos", str(i % 2))
        groups.setdefault(hint, []).append(i)
    return list(groups.values())


def conflict_closure(logs: List[TxLog], group_of: Dict[int, int]
                     ) -> Tuple[Set[int], Set[Key]]:
    """Least fixpoint of conflicted txs/keys.

    Seed: keys touched by two or more groups. Grow: every tx touching a
    conflicted key is conflicted, and every key a conflicted tx touches
    becomes conflicted. At the fixpoint, non-conflicted txs touch only
    keys owned exclusively by their group's non-conflicted txs — the
    property that makes their speculative responses serial-identical."""
    key_groups: Dict[Key, Set[int]] = {}
    for log in logs:
        gi = group_of[log.idx]
        for k in log.keys:
            key_groups.setdefault(k, set()).add(gi)
    ck: Set[Key] = {k for k, gs in key_groups.items() if len(gs) > 1}
    ct: Set[int] = set()
    changed = True
    while changed:
        changed = False
        for log in logs:
            if log.idx in ct or not log.keys:
                continue
            if log.keys & ck:
                ct.add(log.idx)
                if not log.keys <= ck:
                    ck |= log.keys
                changed = True
    return ct, ck


class ParallelExecutor:
    """Optimistic executor bound to one BlockExecutor's proxy connection.

    ``try_exec_block`` returns None when the parallel path can't run
    (remote app, app without the view protocol, tiny block) or aborts
    (speculation raised) — the caller then takes the serial spec path.
    """

    def __init__(self, workers: int = 4, min_parallel_txs: int = 2,
                 metrics=None):
        import os

        # more spec threads than cores only adds contention: on a 1-core
        # host speculation degrades to in-line (still batched apply)
        self.workers = max(1, min(int(workers), os.cpu_count() or 1))
        self.min_parallel_txs = max(0, int(min_parallel_txs))
        self.metrics = metrics
        # last-block stats, for tests and the bench payload
        self.last_groups = 0
        self.last_conflicted = 0

    def _fallback(self, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.parallel_exec_fallbacks.labels(reason).inc()

    def try_exec_block(self, proxy_app: Client, block: Block,
                       state_store: StateStore,
                       initial_height: int) -> Optional[ABCIResponses]:
        from .execution import ev_to_abci, get_begin_block_validator_info

        if not isinstance(proxy_app, LocalClient):
            self._fallback("remote-app")
            return None
        app, mtx = proxy_app._app, proxy_app._mtx
        if not getattr(app, "parallel_exec_supported", False):
            self._fallback("app-unsupported")
            return None
        txs = block.data.txs
        if len(txs) < self.min_parallel_txs:
            self._fallback("small-block")
            return None

        commit_info = get_begin_block_validator_info(
            block, state_store, initial_height)
        byz_vals = [ev_to_abci(ev) for ev in block.evidence]
        begin = proxy_app.begin_block(abci.RequestBeginBlock(
            hash=block.hash() or b"", header=block.header,
            last_commit_info=commit_info, byzantine_validators=byz_vals))

        groups = conflict_groups(txs)
        views = [SpecView(app) for _ in groups]

        def speculate(gi: int) -> None:
            view = views[gi]
            for idx in groups[gi]:
                view.begin_tx(idx)
                resp = app.deliver_tx_on_view(txs[idx], view)
                view.logs[-1].response = resp

        # Speculation runs WITHOUT the app mutex: views never mutate the
        # app, and the only concurrent callers (mempool CheckTx, RPC
        # Query on their own connection locks) are read-only by the ABCI
        # contract. A raise here aborts cleanly to the serial path.
        try:
            if len(groups) > 1 and self.workers > 1:
                with ThreadPoolExecutor(
                        max_workers=min(self.workers, len(groups)),
                        thread_name_prefix="spec-exec") as pool:
                    for _ in pool.map(speculate, range(len(groups))):
                        pass
            else:
                for gi in range(len(groups)):
                    speculate(gi)
        except Exception:
            logger.exception("speculative execution aborted; "
                             "falling back to serial")
            self._fallback("spec-error")
            return None

        group_of = {idx: gi for gi, idxs in enumerate(groups)
                    for idx in idxs}
        logs = sorted((log for v in views for log in v.logs),
                      key=lambda l: l.idx)
        ct, _ck = conflict_closure(logs, group_of)

        responses: List[Optional[abci.ResponseDeliverTx]] = [None] * len(txs)
        # Apply under the app mutex: non-conflicted op logs replay in
        # block order (their key sets are disjoint from everything that
        # re-executes, so the interleaving is immaterial), then the
        # conflicted txs re-run through the REAL deliver_tx in block
        # order against exactly the serial state for their keys.
        with mtx:
            for log in logs:
                if log.idx not in ct:
                    app.apply_spec_ops(log.ops)
                    responses[log.idx] = log.response
            for idx in sorted(ct):
                responses[idx] = app.deliver_tx(
                    abci.RequestDeliverTx(tx=txs[idx]))

        invalid = sum(1 for r in responses if not r.is_ok())
        if invalid:
            logger.debug("executed block height=%d valid_txs=%d invalid_txs=%d",
                         block.header.height, len(responses) - invalid, invalid)
        end = proxy_app.end_block(
            abci.RequestEndBlock(height=block.header.height))

        self.last_groups = len(groups)
        self.last_conflicted = len(ct)
        if self.metrics is not None:
            self.metrics.parallel_exec_blocks.inc()
            if ct:
                self.metrics.parallel_exec_conflict_txs.inc(len(ct))
        # ORDERING CONTRACT (see ABCIResponses): deliver_txs[i] is the
        # response to block.data.txs[i]; event publication indexes into
        # this list by block position. The index-addressed assembly above
        # preserves it by construction; this assert locks it down.
        assert all(r is not None for r in responses), \
            "parallel execution left a response hole"
        return ABCIResponses(deliver_txs=responses, end_block=end,
                             begin_block=begin)
