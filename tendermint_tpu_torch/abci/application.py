"""Application interface — 13 methods (reference abci/types/application.go:11).

BaseApplication provides OK-everything defaults, like the reference's
abci/types/application.go BaseApplication.
"""

from __future__ import annotations

from . import types as abci


class Application:
    #: Optimistic parallel execution opt-in (state/parallel.py). An app
    #: that sets this True must implement the speculation protocol:
    #:
    #: ``spec_read(space, key)`` — read committed state for one logical
    #: key, with NO side effects (called concurrently, lock-free).
    #: ``deliver_tx_on_view(tx, view)`` — the pure-speculation twin of
    #: ``deliver_tx``: identical decision logic and response bytes, but
    #: every state access goes through the view (``read`` / ``write`` /
    #: ``emit`` / ``add``) instead of mutating the app.
    #: ``apply_spec_ops(ops)`` — replay one tx's recorded op log against
    #: real state (called under the app mutex, in block order).
    #:
    #: Invariant: for any tx and any state, ``deliver_tx_on_view`` +
    #: ``apply_spec_ops`` must leave the app byte-identical (state, app
    #: hash, response, events) to a plain ``deliver_tx`` — the parallel
    #: executor differential-tests this but cannot prove it for you.
    parallel_exec_supported = False

    # -- info/query connection --
    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo()

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        return abci.ResponseQuery()

    # -- mempool connection --
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return abci.ResponseCheckTx()

    # -- consensus connection --
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        return abci.ResponseInitChain()

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        return abci.ResponseDeliverTx()

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return abci.ResponseEndBlock()

    def commit(self) -> abci.ResponseCommit:
        return abci.ResponseCommit()

    # -- snapshot connection --
    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        return abci.ResponseListSnapshots()

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        return abci.ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        return abci.ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        return abci.ResponseApplySnapshotChunk()

    def set_option(self, key: str, value: str) -> None:  # legacy SetOption
        pass
