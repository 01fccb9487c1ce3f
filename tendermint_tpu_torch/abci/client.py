"""ABCI clients (reference abci/client/).

`LocalClient` wraps an in-process Application behind one mutex — the
reference's local_client.go:15 semantics (all connections share the lock).
The socket and gRPC clients of the JAX package (out-of-process apps) are
not ported yet; the JSON helpers below persist ABCI responses
(state/store.py).
"""

from __future__ import annotations

import threading
from dataclasses import is_dataclass
from typing import Any, Optional

from . import types as abci
from .application import Application


class Client:
    """Synchronous call interface; async pipelining is layered above
    (state execution collects futures via callbacks)."""

    def echo(self, msg: str) -> str:
        raise NotImplementedError

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class LocalClient(Client):
    """In-proc app behind a shared mutex (abci/client/local_client.go:15)."""

    def __init__(self, app: Application, mtx: Optional[threading.RLock] = None):
        self._app = app
        self._mtx = mtx or threading.RLock()

    def echo(self, msg: str) -> str:
        return msg

    def info(self, req):
        with self._mtx:
            return self._app.info(req)

    def init_chain(self, req):
        with self._mtx:
            return self._app.init_chain(req)

    def query(self, req):
        with self._mtx:
            return self._app.query(req)

    def check_tx(self, req):
        with self._mtx:
            return self._app.check_tx(req)

    def begin_block(self, req):
        with self._mtx:
            return self._app.begin_block(req)

    def deliver_tx(self, req):
        with self._mtx:
            return self._app.deliver_tx(req)

    def end_block(self, req):
        with self._mtx:
            return self._app.end_block(req)

    def commit(self):
        with self._mtx:
            return self._app.commit()

    def list_snapshots(self, req):
        with self._mtx:
            return self._app.list_snapshots(req)

    def offer_snapshot(self, req):
        with self._mtx:
            return self._app.offer_snapshot(req)

    def load_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.load_snapshot_chunk(req)

    def apply_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.apply_snapshot_chunk(req)


# --- JSON helpers (ABCIResponses persistence) ------------------------------

def _to_jsonable(obj: Any) -> Any:
    from ..types.block import Header

    if isinstance(obj, Header):
        # RequestBeginBlock.header crosses the socket as its proto encoding so
        # out-of-process apps see a real Header, same as in-process ones
        return {"__hdr": obj.encode().hex()}
    if is_dataclass(obj) and not isinstance(obj, type):
        # field-by-field (not asdict) so nested special types like Header
        # reach this function intact instead of pre-flattened to dicts
        return {name: _to_jsonable(getattr(obj, name))
                for name in obj.__dataclass_fields__}
    if isinstance(obj, bytes):
        return {"__b": obj.hex()}
    if isinstance(obj, list):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__b"}:
            return bytes.fromhex(obj["__b"])
        if set(obj.keys()) == {"__hdr"}:
            from ..types.block import Header

            return Header.decode(bytes.fromhex(obj["__hdr"]))
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


def _rebuild(cls, data):
    """Shallow dataclass reconstruction — nested dataclasses rebuilt where typed."""
    if cls is None or data is None:
        return data
    import dataclasses
    import typing

    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        t = hints.get(f.name)
        origin = typing.get_origin(t)
        if origin is list and v is not None:
            (item_t,) = typing.get_args(t)
            if dataclasses.is_dataclass(item_t):
                v = [_rebuild(item_t, x) for x in v]
        elif dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = _rebuild(t, v)
        elif origin is typing.Union and v is not None and isinstance(v, dict):
            args = [a for a in typing.get_args(t) if dataclasses.is_dataclass(a)]
            if args:
                v = _rebuild(args[0], v)
        kwargs[f.name] = v
    return cls(**kwargs)
