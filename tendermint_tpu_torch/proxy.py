"""proxy.AppConns: the 4 logical ABCI connections (reference proxy/):
consensus, mempool, query, snapshot. Local (in-process) apps only in this
port: the socket and gRPC client creators wait for their ABCI clients.

Lock split (vs. the reference's single shared mutex,
proxy/client.go NewLocalClientCreator): the WRITER connections —
consensus and mempool — still share one RLock, because DeliverTx/Commit
and CheckTx both mutate app state and their interleaving is part of the
mempool-locked commit protocol (state/execution.py _commit). The READER
connections — query and snapshot — each get their own lock, so a slow
``/abci_query`` or a snapshot chunk read can no longer stall block
execution (and vice versa). Apps must therefore keep their query/snapshot
handlers read-only and tolerant of mid-block state (the kvstore family
snapshots the store dict atomically before iterating).

Lock order: a caller holds AT MOST ONE connection lock at a time — no
code path may acquire a second one while holding the first (the parallel
executor's apply phase enters the writer lock it already shares with the
consensus connection via RLock reentrancy, never a reader lock). This
makes lock-ordering deadlocks structurally impossible across the proxy.
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable, Optional

from .abci.application import Application
from .abci.client import Client, LocalClient

#: creators may accept the connection role ("consensus" | "mempool" |
#: "query" | "snapshot") to pick per-role locking/transport; zero-arg
#: creators are still honored (every connection then shares whatever the
#: creator closes over)
ClientCreator = Callable[..., Client]

#: roles that mutate app state and therefore share the writer lock
WRITER_ROLES = ("consensus", "mempool")


def local_client_creator(app: Application) -> ClientCreator:
    writer_mtx = threading.RLock()
    reader_locks = {"query": threading.RLock(),
                    "snapshot": threading.RLock()}

    def make(role: str = "consensus") -> Client:
        return LocalClient(app, reader_locks.get(role, writer_mtx))

    return make


class AppConns:
    """(proxy/multi_app_conn.go)"""

    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self._role_aware = _accepts_role(creator)
        self.consensus: Optional[Client] = None
        self.mempool: Optional[Client] = None
        self.query: Optional[Client] = None
        self.snapshot: Optional[Client] = None

    def _make(self, role: str) -> Client:
        if self._role_aware:
            return self._creator(role)
        return self._creator()

    def start(self) -> None:
        self.query = self._make("query")
        self.snapshot = self._make("snapshot")
        self.mempool = self._make("mempool")
        self.consensus = self._make("consensus")

    def stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            if c is not None:
                c.close()


def _accepts_role(creator: ClientCreator) -> bool:
    try:
        sig = inspect.signature(creator)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                      p.VAR_POSITIONAL):
            return True
    return False
