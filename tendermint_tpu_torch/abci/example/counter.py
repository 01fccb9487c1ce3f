"""counter example app (reference abci/example/counter/counter.go).

In serial mode, txs must be the big-endian encoding of the current tx count
— CheckTx rejects txs <= the committed count, DeliverTx requires exactly
count+1. Used pervasively by the reference's consensus tests to detect
reordering/replay.
"""

from __future__ import annotations

from .. import types as abci
from ..application import Application


class CounterApplication(Application):
    def __init__(self, serial: bool = True):
        self.serial = serial
        self.tx_count = 0
        self.height = 0

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=f"{{\"hashes\":{self.height},\"txs\":{self.tx_count}}}",
            last_block_height=self.height,
            last_block_app_hash=self._hash(),
        )

    def _hash(self) -> bytes:
        if self.tx_count == 0:
            return b""
        return self.tx_count.to_bytes(8, "big")

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if self.serial:
            if len(req.tx) > 8:
                return abci.ResponseCheckTx(
                    code=1, log=f"max tx size is 8 bytes, got {len(req.tx)}")
            value = int.from_bytes(req.tx, "big")
            if value < self.tx_count:
                return abci.ResponseCheckTx(
                    code=2, log=f"invalid nonce: got {value}, expected >= "
                                f"{self.tx_count}")
        return abci.ResponseCheckTx(code=0)

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if self.serial:
            if len(req.tx) > 8:
                return abci.ResponseDeliverTx(
                    code=1, log=f"max tx size is 8 bytes, got {len(req.tx)}")
            value = int.from_bytes(req.tx, "big")
            if value != self.tx_count:
                return abci.ResponseDeliverTx(
                    code=2, log=f"invalid nonce: got {value}, expected "
                                f"{self.tx_count}")
        self.tx_count += 1
        return abci.ResponseDeliverTx(code=0)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "hash":
            return abci.ResponseQuery(code=0, value=str(self.height).encode())
        if req.path == "tx":
            return abci.ResponseQuery(code=0, value=str(self.tx_count).encode())
        return abci.ResponseQuery(code=1, log=f"invalid query path {req.path}")

    def commit(self) -> abci.ResponseCommit:
        self.height += 1
        return abci.ResponseCommit(data=self._hash())
