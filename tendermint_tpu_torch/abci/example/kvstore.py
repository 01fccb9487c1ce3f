"""kvstore example app (reference abci/example/kvstore/).

Txs are "key=value" (or raw bytes stored under themselves). The persistent
variant accepts validator-update txs: "val:<pubkey_hex>!<power>" — mirroring
the reference's persistent_kvstore (abci/example/kvstore/persistent_kvstore.go).
State hash = big-endian tx count (kvstore.go State.Hash semantics: size-based
deterministic app hash).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

from .. import types as abci
from ..application import Application

VALIDATOR_TX_PREFIX = "val:"


class KVStoreApplication(Application):
    #: speculation protocol below (spec_read / deliver_tx_on_view /
    #: apply_spec_ops) — see abci/application.py for the contract
    parallel_exec_supported = True

    def __init__(self):
        self.state: Dict[str, str] = {}
        self.tx_count = 0  # deterministic state size counter
        self.height = 0
        self.app_hash = b""
        self.val_updates: List[abci.ValidatorUpdate] = []
        self.validators: Dict[str, int] = {}  # pubkey hex -> power

    # -- info --
    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": self.tx_count}),
            version="0.1.0",
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "/store" or req.path == "":
            key = req.data.decode("utf-8", errors="replace")
            val = self.state.get(key)
            if val is None:
                return abci.ResponseQuery(code=0, key=req.data, log="does not exist",
                                          height=self.height)
            return abci.ResponseQuery(code=0, key=req.data, value=val.encode(),
                                      log="exists", height=self.height)
        if req.path == "/val":
            power = self.validators.get(req.data.decode(), 0)
            return abci.ResponseQuery(code=0, key=req.data,
                                      value=str(power).encode(), height=self.height)
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")

    # -- mempool --
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if tx_is_validator_update(req.tx) and parse_validator_tx(req.tx) is None:
            return abci.ResponseCheckTx(code=1, log="malformed validator tx")
        return abci.ResponseCheckTx(code=0, gas_wanted=1)

    # -- consensus --
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for vu in req.validators:
            self.validators[vu.pub_key_bytes.hex()] = vu.power
        return abci.ResponseInitChain()

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        self.val_updates = []
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if tx_is_validator_update(req.tx):
            parsed = parse_validator_tx(req.tx)
            if parsed is None:
                return abci.ResponseDeliverTx(code=1, log="malformed validator tx")
            pubkey_hex, power = parsed
            self.validators[pubkey_hex] = power
            self.val_updates.append(abci.ValidatorUpdate(
                pub_key_type="ed25519", pub_key_bytes=bytes.fromhex(pubkey_hex), power=power))
        else:
            raw = req.tx.decode("utf-8", errors="replace")
            if "=" in raw:
                k, v = raw.split("=", 1)
            else:
                k = v = raw
            self._set_kv(k, v)
        self.tx_count += 1
        return abci.ResponseDeliverTx(code=0, events=_tx_events(req.tx),
                                      gas_wanted=1, gas_used=1)

    def _set_kv(self, k: str, v: str, vhash: Optional[bytes] = None) -> None:
        """Single store-write seam: MerkleKVStoreApplication hooks it for
        value-hash caching + dirty-leaf tracking. ``vhash`` is sha256(v)
        when the caller already computed it (the speculative path hashes
        in parallel worker threads), else recomputed where needed."""
        self.state[k] = v

    # -- optimistic parallel execution (state/parallel.py) -----------------

    def spec_read(self, space: str, key: str):
        if space == "kv":
            return self.state.get(key)
        if space == "val":
            return self.validators.get(key)
        return None

    def deliver_tx_on_view(self, tx: bytes, view) -> abci.ResponseDeliverTx:
        """deliver_tx's speculation twin: same decision logic and response
        bytes, state effects recorded on the view instead of applied.
        Value hashing happens HERE — in the speculating worker thread,
        where hashlib releases the GIL for large values — so the serial
        apply/commit path never recomputes it."""
        if tx_is_validator_update(tx):
            parsed = parse_validator_tx(tx)
            if parsed is None:
                return abci.ResponseDeliverTx(code=1,
                                              log="malformed validator tx")
            pubkey_hex, power = parsed
            view.write("val", pubkey_hex, power)
            # shared ordered stream: cross-group validator updates always
            # conflict, so mixed-order val_updates are impossible
            view.emit("vup", (pubkey_hex, power))
        else:
            raw = tx.decode("utf-8", errors="replace")
            if "=" in raw:
                k, v = raw.split("=", 1)
            else:
                k = v = raw
            view.write("kv", k, v, extra=hashlib.sha256(v.encode()).digest())
        view.add("tx_count", 1)
        return abci.ResponseDeliverTx(code=0, events=_tx_events(tx),
                                      gas_wanted=1, gas_used=1)

    def apply_spec_ops(self, ops) -> None:
        for op in ops:
            kind = op[0]
            if kind == "set":
                _, space, key, value, extra = op
                if space == "kv":
                    self._set_kv(key, value, extra)
                else:  # "val"
                    self.validators[key] = value
            elif kind == "emit":  # ("emit", "vup", (pubkey_hex, power))
                pubkey_hex, power = op[2]
                self.val_updates.append(abci.ValidatorUpdate(
                    pub_key_type="ed25519",
                    pub_key_bytes=bytes.fromhex(pubkey_hex), power=power))
            else:  # ("add", "tx_count", n)
                self.tx_count += op[2]

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        return abci.ResponseEndBlock(validator_updates=list(self.val_updates))

    def commit(self) -> abci.ResponseCommit:
        self.height += 1
        self.app_hash = self.tx_count.to_bytes(8, "big")
        return abci.ResponseCommit(data=self.app_hash)


class SnapshotKVStoreApplication(KVStoreApplication):
    """kvstore + state-sync snapshots (the reference's e2e app shape,
    test/e2e/app/snapshots.go): every ``interval`` heights the full app state
    is serialized to JSON and split into fixed-size chunks."""

    CHUNK_SIZE = 1024

    def __init__(self, interval: int = 4):
        super().__init__()
        self.snapshot_interval = interval
        self._snapshots: Dict[int, List[bytes]] = {}  # height -> chunks
        self._restore: Optional[Dict] = None

    def commit(self) -> abci.ResponseCommit:
        resp = super().commit()
        if self.snapshot_interval and self.height % self.snapshot_interval == 0:
            blob = json.dumps({
                "state": self.state, "tx_count": self.tx_count,
                "height": self.height, "validators": self.validators,
            }, sort_keys=True).encode()
            chunks = [blob[i:i + self.CHUNK_SIZE]
                      for i in range(0, max(len(blob), 1), self.CHUNK_SIZE)]
            self._snapshots[self.height] = chunks
        return resp

    def list_snapshots(self, req: abci.RequestListSnapshots
                       ) -> abci.ResponseListSnapshots:
        out = []
        for h, chunks in sorted(self._snapshots.items()):
            # metadata carries per-chunk hashes (the reference e2e app's
            # trick): restore can then verify EACH chunk as it arrives and
            # blame the specific sender of a corrupted one, instead of
            # discovering a whole-blob mismatch at the end with no culprit
            meta = json.dumps({"chunk_hashes": [
                hashlib.sha256(c).hexdigest() for c in chunks]}).encode()
            out.append(abci.Snapshot(
                height=h, format=1, chunks=len(chunks),
                hash=hashlib.sha256(b"".join(chunks)).digest(),
                metadata=meta))
        return abci.ResponseListSnapshots(snapshots=out)

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk
                            ) -> abci.ResponseLoadSnapshotChunk:
        chunks = self._snapshots.get(req.height)
        if req.format != 1 or chunks is None or not 0 <= req.chunk < len(chunks):
            return abci.ResponseLoadSnapshotChunk(chunk=b"")
        return abci.ResponseLoadSnapshotChunk(chunk=chunks[req.chunk])

    def offer_snapshot(self, req: abci.RequestOfferSnapshot
                       ) -> abci.ResponseOfferSnapshot:
        if req.snapshot is None or req.snapshot.format != 1:
            return abci.ResponseOfferSnapshot(
                result=abci.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restore = {"snapshot": req.snapshot, "app_hash": req.app_hash,
                         "chunks": [],
                         # parsed once here: apply_snapshot_chunk runs per
                         # chunk and must not re-decode an O(chunks) list
                         "chunk_hashes": _parse_chunk_hashes(req.snapshot)}
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk
                             ) -> abci.ResponseApplySnapshotChunk:
        if self._restore is None:
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT)
        expected = self._restore["chunk_hashes"]
        if (expected is not None
                and hashlib.sha256(req.chunk).hexdigest()
                != expected[req.index]):
            # corrupted chunk from an untrusted peer: don't apply it — ask
            # for a refetch and name the sender so the syncer can ban it
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_SNAPSHOT_CHUNK_RETRY,
                refetch_chunks=[req.index],
                reject_senders=[req.sender] if req.sender else [])
        self._restore["chunks"].append(req.chunk)
        snap = self._restore["snapshot"]
        if len(self._restore["chunks"]) == snap.chunks:
            blob = b"".join(self._restore["chunks"])
            if hashlib.sha256(blob).digest() != snap.hash:
                self._restore = None
                return abci.ResponseApplySnapshotChunk(
                    result=abci.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT)
            doc = json.loads(blob)
            self.state = dict(doc["state"])
            self.tx_count = doc["tx_count"]
            self.height = doc["height"]
            self.validators = dict(doc["validators"])
            self.app_hash = self.tx_count.to_bytes(8, "big")
            self._restore = None
        return abci.ResponseApplySnapshotChunk(
            result=abci.APPLY_SNAPSHOT_CHUNK_ACCEPT)


def _parse_chunk_hashes(snap: abci.Snapshot) -> Optional[List[str]]:
    """Per-chunk sha256 hexdigests from a snapshot's metadata; None when
    absent/garbled (older snapshots, or a lying advertiser — the final
    whole-blob check still guards those)."""
    try:
        hashes = json.loads(snap.metadata.decode())["chunk_hashes"]
    except Exception:
        return None
    if (not isinstance(hashes, list) or len(hashes) != snap.chunks
            or not all(isinstance(x, str) for x in hashes)):
        return None
    return hashes


def _tx_events(tx: bytes) -> List[abci.Event]:
    return [abci.Event(type="app", attributes=[
        abci.EventAttribute(b"creator", b"tendermint_tpu", True),
        abci.EventAttribute(b"key", tx.split(b"=", 1)[0], True),
    ])]


def tx_is_validator_update(tx: bytes) -> bool:
    return tx.decode("utf-8", errors="replace").startswith(VALIDATOR_TX_PREFIX)


def parse_validator_tx(tx: bytes) -> "Optional[tuple[str, int]]":
    try:
        body = tx.decode("utf-8")[len(VALIDATOR_TX_PREFIX):]
        pubkey_hex, power_s = body.split("!", 1)
        bytes.fromhex(pubkey_hex)
        power = int(power_s)
        if power < 0 or len(bytes.fromhex(pubkey_hex)) != 32:
            return None
        return pubkey_hex, power
    except (ValueError, UnicodeDecodeError):
        return None


class MerkleKVStoreApplication(SnapshotKVStoreApplication):
    """kvstore whose app hash is an RFC-6962 merkle root over the sorted
    key/value state, serving merkle ``ProofOps`` on ``Query(prove=True)`` —
    the proof path the reference's light proxy verifies queries with
    (light/rpc/client.go ABCIQueryWithOptions → merkle.ProofRuntime;
    leaf encoding per crypto/merkle/proof_value.go ValueOp).

    The proof at query height H verifies against the app hash carried in
    HEADER H+1 (AppHash(H+1) = Commit(H) result), exactly the reference's
    height convention.

    Commit cost: the root is maintained by crypto.merkle.IncrementalMerkle
    — only leaves whose value changed since the last commit re-hash
    (``_dirty``), the level reduce vectorizes through the crypto plane's
    batched SHA-256 when the tree is large, and ``TMTPU_MERKLE_FAST=0``
    forces the recursive spec recompute (byte-identical by construction
    and by differential test).
    """

    def __init__(self, interval: int = 4):
        super().__init__(interval)
        self._vhash: Dict[str, bytes] = {}  # key -> sha256(value)
        self._dirty: set = set()            # keys written since last commit
        from ...crypto.merkle import IncrementalMerkle

        self._imt = IncrementalMerkle()

    def _set_kv(self, k: str, v: str, vhash: Optional[bytes] = None) -> None:
        self.state[k] = v
        self._vhash[k] = vhash if vhash is not None \
            else hashlib.sha256(v.encode()).digest()
        self._dirty.add(k)

    def _leaf_item(self, k: str) -> bytes:
        from ...crypto.merkle import _encode_byte_slice

        vh = self._vhash.get(k)
        if vh is None:  # state poked behind _set_kv (tests, tools)
            vh = hashlib.sha256(self.state[k].encode()).digest()
            self._vhash[k] = vh
        return (_encode_byte_slice(k.encode())
                + _encode_byte_slice(vh))

    @staticmethod
    def _leaf_items(state: Dict[str, str]) -> List[bytes]:
        """The SPEC leaf encoding (proof_value.go ValueOp), recomputed
        from scratch — the incremental path must match it byte-for-byte."""
        from ...crypto.merkle import _encode_byte_slice

        items = []
        for k in sorted(state):
            vhash = hashlib.sha256(state[k].encode()).digest()
            items.append(_encode_byte_slice(k.encode())
                         + _encode_byte_slice(vhash))
        return items

    def _reset_merkle_cache(self) -> None:
        """Rebuild value-hash cache + drop the level cache (snapshot
        restore and any other out-of-band state swap)."""
        self._vhash = {k: hashlib.sha256(v.encode()).digest()
                       for k, v in self.state.items()}
        self._dirty = set()
        self._imt.reset()

    def commit(self) -> abci.ResponseCommit:
        import os

        resp = super().commit()
        if os.environ.get("TMTPU_MERKLE_FAST", "1") == "0":
            from ...crypto.merkle import hash_from_byte_slices

            self.app_hash = hash_from_byte_slices(
                self._leaf_items(self.state))
        else:
            self.app_hash = self._imt.root(sorted(self.state),
                                           self._leaf_item, self._dirty)
        self._dirty = set()
        return abci.ResponseCommit(data=self.app_hash)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        resp = super().query(req)
        # proofs exist only for the KV store path; /val and missing keys
        # answer unproven (the light proxy then refuses to vouch for them)
        key = req.data.decode("utf-8", errors="replace")
        # queries run on their own connection lock (proxy.py) and may
        # interleave with a block mid-apply: take one atomic snapshot of
        # the store instead of iterating the live dict
        snap = dict(self.state)
        if (req.prove and resp.code == 0 and resp.value
                and req.path in ("", "/store") and key in snap):
            from ...crypto.merkle import (
                ProofOp,
                ValueOp,
                proofs_from_byte_slices,
            )

            idx = sorted(snap).index(key)
            proof = proofs_from_byte_slices(self._leaf_items(snap))[idx]
            op = ValueOp(req.data, proof).proof_op()
            resp.proof_ops = [ProofOp(op.type, op.key, op.data)]
        return resp

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk
                             ) -> abci.ResponseApplySnapshotChunk:
        from ...crypto.merkle import hash_from_byte_slices

        resp = super().apply_snapshot_chunk(req)
        if (self._restore is None
                and resp.result == abci.APPLY_SNAPSHOT_CHUNK_ACCEPT):
            # restore completed: the app hash is the merkle root, not the
            # parent's tx-count encoding; the incremental cache is stale
            self._reset_merkle_cache()
            self.app_hash = hash_from_byte_slices(self._leaf_items(self.state))
        return resp
