"""Application interface — 13 methods (reference abci/types/application.go:11).

BaseApplication provides OK-everything defaults, like the reference's
abci/types/application.go BaseApplication.
"""

from __future__ import annotations

from . import types as abci


class Application:
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
