"""state.Store: persists State, ABCIResponses, per-height validator sets and
consensus params with change-height dedup (reference state/store.go:52).
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional

from ..abci import types as abci
from ..libs import protowire as pw
from ..libs.db import DB, BufferedDB
from ..types import ConsensusParams, ValidatorSet
from ..types.basic import BlockID, PartSetHeader
from ..types.block import Consensus
from .state import State

_STATE_KEY = b"stateKey"


def _validators_key(h: int) -> bytes:
    return b"validatorsKey:" + str(h).encode()


# resolution floor for validator change-pointers after pruning (heights
# below it are deleted) — distinct from the materialization marker below,
# which only says "a nearby full record exists", never "data is gone"
_VALS_CHECKPOINT_KEY = b"validatorsCheckpoint"
# latest interval-materialized full record (see _VALS_MATERIALIZE_INTERVAL)
_VALS_MATERIALIZED_KEY = b"validatorsMaterialized"

# materialize a full set at least this often even without changes: loads
# roll proposer priorities forward from the pointer target, so unbounded
# pointer runs make load_validators O(height since change) — the reference
# bounds the same walk with valSetCheckpointInterval (store.go:36; its
# 100k interval tolerates huge rolls because Go's increment is ~ns — in
# Python a short interval keeps the per-load roll under ~16 increments
# while a full write every 16 heights amortizes to noise)
_VALS_MATERIALIZE_INTERVAL = 16


def _params_key(h: int) -> bytes:
    return b"consensusParamsKey:" + str(h).encode()


def _abci_responses_key(h: int) -> bytes:
    return b"abciResponsesKey:" + str(h).encode()


@dataclass
class ABCIResponses:
    """Responses persisted per height (reference proto/tendermint/state ABCIResponses).

    ORDERING CONTRACT: ``deliver_txs[i]`` is the response to
    ``block.data.txs[i]`` — block position, not execution order. Everything
    downstream leans on the index: ``results_hash()`` merkle-hashes the
    list positionally (committed into the next header), event publication
    pairs ``txs[i]`` with ``deliver_txs[i]`` (execution.py fire_events),
    the tx indexer keys on (height, i), and mempool.update consumes the
    list zip-wise. Any executor — serial or parallel (state/parallel.py) —
    must assemble this list by block index; tests/test_parallel_exec.py
    pins the contract differentially."""

    deliver_txs: List[abci.ResponseDeliverTx] = field(default_factory=list)
    end_block: Optional[abci.ResponseEndBlock] = None
    begin_block: Optional[abci.ResponseBeginBlock] = None

    def results_hash(self) -> bytes:
        return abci.last_results_hash(self.deliver_txs)

    def to_json(self) -> bytes:
        from ..abci.client import _to_jsonable

        return json.dumps(_to_jsonable({
            "deliver_txs": self.deliver_txs,
            "end_block": self.end_block,
            "begin_block": self.begin_block,
        })).encode()

    @staticmethod
    def from_json(raw: bytes) -> "ABCIResponses":
        from ..abci.client import _from_jsonable, _rebuild

        d = _from_jsonable(json.loads(raw.decode()))
        return ABCIResponses(
            deliver_txs=[_rebuild(abci.ResponseDeliverTx, x) for x in d.get("deliver_txs") or []],
            end_block=_rebuild(abci.ResponseEndBlock, d.get("end_block")),
            begin_block=_rebuild(abci.ResponseBeginBlock, d.get("begin_block")),
        )


# -- State <-> JSON (storage format is ours; byte parity not required here) --

def _state_to_json(s: State) -> bytes:
    return json.dumps({
        "chain_id": s.chain_id,
        "initial_height": s.initial_height,
        "version_block": s.version.block,
        "version_app": s.version.app,
        "last_block_height": s.last_block_height,
        "last_block_id": {
            "hash": s.last_block_id.hash.hex(),
            "total": s.last_block_id.part_set_header.total,
            "psh_hash": s.last_block_id.part_set_header.hash.hex(),
        },
        "last_block_time_ns": s.last_block_time_ns,
        "next_validators": s.next_validators.encode().hex() if s.next_validators else None,
        "validators": s.validators.encode().hex() if s.validators else None,
        "last_validators": s.last_validators.encode().hex() if s.last_validators else None,
        "last_height_validators_changed": s.last_height_validators_changed,
        "consensus_params": s.consensus_params.encode().hex(),
        "last_height_consensus_params_changed": s.last_height_consensus_params_changed,
        "last_results_hash": s.last_results_hash.hex(),
        "app_hash": s.app_hash.hex(),
    }).encode()


def _state_from_json(raw: bytes) -> State:
    d = json.loads(raw.decode())

    def vs(key):
        return ValidatorSet.decode(bytes.fromhex(d[key])) if d.get(key) else None

    return State(
        chain_id=d["chain_id"],
        initial_height=d["initial_height"],
        version=Consensus(d["version_block"], d["version_app"]),
        last_block_height=d["last_block_height"],
        last_block_id=BlockID(
            bytes.fromhex(d["last_block_id"]["hash"]),
            PartSetHeader(d["last_block_id"]["total"],
                          bytes.fromhex(d["last_block_id"]["psh_hash"])),
        ),
        last_block_time_ns=d["last_block_time_ns"],
        next_validators=vs("next_validators"),
        validators=vs("validators"),
        last_validators=vs("last_validators"),
        last_height_validators_changed=d["last_height_validators_changed"],
        consensus_params=ConsensusParams.decode(bytes.fromhex(d["consensus_params"])),
        last_height_consensus_params_changed=d["last_height_consensus_params_changed"],
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
    )


class StateStore:
    def __init__(self, db: DB):
        self._db = db
        # one-slot decode cache for the latest full validator record:
        # (height, pristine ValidatorSet). Per-block ABCI BeginBlock loads
        # the prior height's set — hex+proto decoding 1000 validators every
        # block was a top apply-plane cost. All record writes go through
        # this class, so the slot is refreshed at every materialization.
        self._full_record_cache: "Optional[tuple]" = None

    @contextmanager
    def window_batch(self):
        """Stage every write in the scope into ONE DB write-batch, flushed
        at exit (success or error — staged writes describe blocks whose
        ABCI commit already happened). Reads inside the scope observe the
        staged writes (load_validators follows pointer records written
        earlier in the same fast-sync window). Reentrant: nested scopes
        join the outer batch."""
        if isinstance(self._db, BufferedDB):
            yield self
            return
        buf = BufferedDB(self._db)
        self._db = buf
        try:
            yield self
        finally:
            # flush BEFORE unhooking: a failed flush keeps the staged
            # window reachable as self._db (no silent drop of records the
            # app already handled)
            buf.flush()
            self._db = buf.base

    # -- state --

    def load(self) -> Optional[State]:
        raw = self._db.get(_STATE_KEY)
        return _state_from_json(raw) if raw is not None else None

    def save(self, state: State) -> None:
        """Persist state + next validators + params at their change heights
        (state/store.go:175)."""
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:  # genesis bootstrap
            next_height = state.initial_height
            self._save_validators(next_height, state.validators)
        self._save_validators(next_height + 1, state.next_validators,
                              last_changed=state.last_height_validators_changed)
        self._save_params(next_height, state.consensus_params,
                          state.last_height_consensus_params_changed)
        self._db.set(_STATE_KEY, _state_to_json(state))

    def bootstrap(self, state: State) -> None:
        """Seed stores from an out-of-band trusted state — state sync
        (state/store.go Bootstrap)."""
        # reference store.go Bootstrap: height := LastBlockHeight+1 (or
        # InitialHeight at genesis); LastValidators validate block height-1,
        # Validators block height, NextValidators block height+1; params for
        # block height
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height
        if height > 1 and state.last_validators is not None \
                and state.last_validators.size() > 0:
            self._save_validators(height - 1, state.last_validators)
        self._save_validators(height, state.validators)
        self._save_validators(height + 1, state.next_validators)
        self._save_params(height, state.consensus_params,
                          state.last_height_consensus_params_changed)
        self._db.set(_STATE_KEY, _state_to_json(state))

    # -- validators (with change-height dedup, state/store.go:289) --

    def _save_validators(self, height: int, vals: ValidatorSet,
                         last_changed: Optional[int] = None) -> None:
        """Full set only at its change height; unchanged heights store just
        the pointer (saveValidatorsInfo, store.go:289) — re-encoding a
        1000-validator set every block was ~1/3 of the store's per-block
        cost, for bytes that never change. A pointer is only written when
        its target record actually holds a full set: rollback can rewrite
        change heights such that the natural target is itself a pointer,
        and a pointer chain would make the height unloadable."""
        if last_changed is None or last_changed >= height:
            last_changed = height
        target_h = (self._resolve_target(last_changed, height)
                    if height > last_changed else height)
        if (height > target_h
                and height - target_h < _VALS_MATERIALIZE_INTERVAL):
            target = self._db.get(_validators_key(target_h))
            if target is not None and b'"set"' in target:
                self._db.set(_validators_key(height), json.dumps(
                    {"last_changed": target_h}).encode())
                return
            # unresolvable target: materialize (self-healing, no chains)
        self._db.set(_validators_key(height), json.dumps({
            "last_changed": height, "set": vals.encode().hex(),
        }).encode())
        # copy: the caller keeps mutating its live set (priority rotation)
        self._full_record_cache = (height, vals.copy())
        if height > last_changed:
            # interval materialization: record this nearby full set so
            # subsequent pointers (and loads) target it instead of rolling
            # priorities all the way from the original change height
            self._db.set(_VALS_MATERIALIZED_KEY, str(height).encode())

    def _resolve_target(self, last_changed: int, height: int) -> int:
        """The best full-record height for a pointer valid at ``height``:
        the highest of the declared change height, the prune floor, and the
        latest materialized record that does not exceed ``height`` (a
        prune floor above ``height`` means the data is simply gone; a
        materialization above it must be ignored, records below it still
        exist)."""
        best = last_changed
        raw = self._db.get(_VALS_CHECKPOINT_KEY)
        if raw is not None and best < int(raw) <= height:
            best = int(raw)
        raw = self._db.get(_VALS_MATERIALIZED_KEY)
        if raw is not None and best < int(raw) <= height:
            best = int(raw)
        return best

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        """(loadValidators, store.go:249) follow the change pointer, then
        roll proposer priorities forward to the requested height."""
        raw = self._db.get(_validators_key(height))
        if raw is None:
            return None
        d = json.loads(raw.decode())
        if "set" in d:
            return ValidatorSet.decode(bytes.fromhex(d["set"]))
        declared = int(d["last_changed"])
        last_changed = self._resolve_target(declared, height)
        vals = self._load_full_record(last_changed)
        if vals is None and last_changed != declared:
            # the resolved target (checkpoint/materialization marker) does
            # not hold a full record — stale marker, interrupted prune:
            # fall back to the pointer's own declared change height rather
            # than reporting a retained height as unloadable
            last_changed = declared
            vals = self._load_full_record(declared)
        if vals is None:
            return None
        vals.increment_proposer_priority(height - last_changed)
        return vals

    def _load_full_record(self, height: int) -> Optional[ValidatorSet]:
        """Decode the full validator record at ``height`` (None when the
        record is missing or a pointer); serves the hot per-block load from
        the one-slot cache when possible."""
        cached = self._full_record_cache
        if cached is not None and cached[0] == height:
            return cached[1].copy()
        raw = self._db.get(_validators_key(height))
        if raw is None:
            return None
        d = json.loads(raw.decode())
        if "set" not in d:
            return None
        vals = ValidatorSet.decode(bytes.fromhex(d["set"]))
        self._full_record_cache = (height, vals.copy())
        return vals

    # -- consensus params --

    def _save_params(self, height: int, params: ConsensusParams, last_changed: int) -> None:
        self._db.set(_params_key(height), json.dumps({
            "last_changed": last_changed, "params": params.encode().hex(),
        }).encode())

    def load_consensus_params(self, height: int) -> Optional[ConsensusParams]:
        raw = self._db.get(_params_key(height))
        if raw is None:
            return None
        d = json.loads(raw.decode())
        return ConsensusParams.decode(bytes.fromhex(d["params"]))

    # -- abci responses --

    def save_abci_responses(self, height: int, responses: ABCIResponses) -> None:
        self._db.set(_abci_responses_key(height), responses.to_json())

    def load_abci_responses(self, height: int) -> Optional[ABCIResponses]:
        raw = self._db.get(_abci_responses_key(height))
        return ABCIResponses.from_json(raw) if raw is not None else None

    def prune_states(self, retain_height: int) -> None:
        """Drop per-height records below retain_height (state/store.go PruneStates)."""
        # checkpoint first: validator records at/above the retain height may
        # be change-pointers into the range being pruned — materialize a
        # full set at retain_height and record it as the resolution floor
        # (the reference's loadValidators clamps pointer targets to its
        # checkpoint the same way, store.go lastStoredHeightFor). Skip the
        # decode/re-encode when the record is already full: prune runs per
        # commit on retention-configured nodes, and re-materializing every
        # block would re-add the cost the pointer scheme removed.
        raw = self._db.get(_validators_key(retain_height))
        record_is_full = raw is not None and b'"set"' in raw
        if raw is not None and not record_is_full:
            keep = self.load_validators(retain_height)
            if keep is not None:
                self._db.set(_validators_key(retain_height), json.dumps({
                    "last_changed": retain_height,
                    "set": keep.encode().hex(),
                }).encode())
                self._full_record_cache = (retain_height, keep)
                record_is_full = True
        # the checkpoint is a resolution floor: writing it while the
        # retain-height record is still a pointer (materialization failed)
        # would clamp every later pointer onto a non-full record and make
        # retained heights unloadable — only advance it once the full
        # record is confirmed on disk
        if record_is_full:
            self._db.set(_VALS_CHECKPOINT_KEY, str(retain_height).encode())
        if (self._full_record_cache is not None
                and self._full_record_cache[0] < retain_height):
            self._full_record_cache = None  # record about to be deleted
        deletes: List[bytes] = []
        for key_fn in (_validators_key, _params_key, _abci_responses_key):
            prefix = key_fn(0).rsplit(b":", 1)[0] + b":"
            for k, _ in self._db.iterate_prefix(prefix):
                try:
                    h = int(k.rsplit(b":", 1)[1])
                except ValueError:
                    continue
                if h < retain_height:
                    deletes.append(k)
        if deletes:
            self._db.write_batch([], deletes)
