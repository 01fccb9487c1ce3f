"""ABCI request/response types (reference abci/types/types.pb.go).

Dataclasses with JSON (storage) and — where consensus requires byte parity —
protobuf encoding: deterministic ResponseDeliverTx feeds LastResultsHash
(reference types/results.go), so its proto encoding matches gogo exactly.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from ..libs import protowire as pw

CODE_TYPE_OK = 0


# --- events ----------------------------------------------------------------

@dataclass
class EventAttribute:
    key: bytes = b""
    value: bytes = b""
    index: bool = False


@dataclass
class Event:
    type: str = ""
    attributes: List[EventAttribute] = field(default_factory=list)


# --- validators ------------------------------------------------------------

@dataclass
class ValidatorUpdate:
    pub_key_type: str = "ed25519"
    pub_key_bytes: bytes = b""
    power: int = 0
    # bls12381 keys must arrive with a proof of possession — the rogue-key
    # gate validate_validator_updates enforces before admission; unused for
    # every other scheme
    pop: bytes = b""


@dataclass
class ABCIValidator:
    """abci.Validator: address + power (in LastCommitInfo / evidence)."""

    address: bytes = b""
    power: int = 0


@dataclass
class VoteInfo:
    validator: ABCIValidator = field(default_factory=ABCIValidator)
    signed_last_block: bool = False


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: List[VoteInfo] = field(default_factory=list)


@dataclass
class ABCIEvidence:
    type: str = ""  # DUPLICATE_VOTE | LIGHT_CLIENT_ATTACK
    validator: ABCIValidator = field(default_factory=ABCIValidator)
    height: int = 0
    time_ns: int = 0
    total_voting_power: int = 0


# --- param updates ---------------------------------------------------------

@dataclass
class ABCIBlockParams:
    max_bytes: int = 0
    max_gas: int = 0


@dataclass
class ABCIEvidenceParams:
    max_age_num_blocks: int = 0
    max_age_duration_ns: int = 0
    max_bytes: int = 0


@dataclass
class ABCIValidatorParams:
    pub_key_types: List[str] = field(default_factory=list)


@dataclass
class ABCIVersionParams:
    app_version: int = 0


@dataclass
class ABCIConsensusParams:
    block: Optional[ABCIBlockParams] = None
    evidence: Optional[ABCIEvidenceParams] = None
    validator: Optional[ABCIValidatorParams] = None
    version: Optional[ABCIVersionParams] = None


# --- requests --------------------------------------------------------------

@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[ABCIConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 0


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: object = None  # types.Header
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: List[ABCIEvidence] = field(default_factory=list)


CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_NEW


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


# --- responses -------------------------------------------------------------

@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseInitChain:
    consensus_params: Optional[ABCIConsensusParams] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: Optional[object] = None
    height: int = 0
    codespace: str = ""


@dataclass
class ResponseBeginBlock:
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""
    sender: str = ""
    priority: int = 0
    mempool_error: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def deterministic_encode(self) -> bytes:
        """Proto encoding of the deterministic subset {code,data,gas_wanted,
        gas_used} — merkle leaf of LastResultsHash (types/results.go:45)."""
        w = pw.Writer()
        w.varint(1, self.code)
        w.bytes(2, self.data)
        w.varint(5, self.gas_wanted)
        w.varint(6, self.gas_used)
        return w.finish()


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[ABCIConsensusParams] = None
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = field(default_factory=list)


OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_REJECT


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


APPLY_SNAPSHOT_CHUNK_ACCEPT = 1
APPLY_SNAPSHOT_CHUNK_ABORT = 2
APPLY_SNAPSHOT_CHUNK_RETRY = 3
APPLY_SNAPSHOT_CHUNK_RETRY_SNAPSHOT = 4
APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT = 5


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT
    refetch_chunks: List[int] = field(default_factory=list)
    reject_senders: List[str] = field(default_factory=list)


def last_results_hash(deliver_txs: List[ResponseDeliverTx]) -> bytes:
    """Merkle root over deterministic DeliverTx encodings (types/results.go:22)."""
    from ..crypto import merkle

    return merkle.hash_from_byte_slices([r.deterministic_encode() for r in deliver_txs])
