"""JSON encoding of domain types for the RPC surface.

Follows the reference's conventions (rpc/core responses rendered through
tmjson): hashes/addresses as upper-hex strings, binary payloads (txs, app
data) as base64, heights/numbers as decimal strings, timestamps as RFC3339.
"""

from __future__ import annotations

import base64
import datetime
from typing import Any, Dict, Optional

from ..types.block import Block, Commit, Header
from ..types.basic import BlockID
from ..types.validator import Validator


def b64(b: bytes) -> str:
    return base64.b64encode(b or b"").decode()


def hexu(b: bytes) -> str:
    return (b or b"").hex().upper()


def rfc3339(ns: int) -> str:
    """Nanosecond-precision RFC3339 (Go time.RFC3339Nano shape): header times
    are ns-exact and MUST round-trip, or recomputed header hashes diverge."""
    secs, frac = divmod(ns, 1_000_000_000)
    dt = datetime.datetime.fromtimestamp(secs, tz=datetime.timezone.utc)
    # strftime leaves year 1 (Go zero time) unpadded — pad explicitly so
    # the string stays ISO-parseable on the way back in
    return (f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
            f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}.{frac:09d}Z")


def enc_block_id(bid: Optional[BlockID]) -> Dict[str, Any]:
    if bid is None:
        return {"hash": "", "parts": {"total": 0, "hash": ""}}
    return {
        "hash": hexu(bid.hash),
        "parts": {"total": bid.part_set_header.total,
                  "hash": hexu(bid.part_set_header.hash)},
    }


def enc_header(h: Header) -> Dict[str, Any]:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": rfc3339(h.time_ns),
        "last_block_id": enc_block_id(h.last_block_id),
        "last_commit_hash": hexu(h.last_commit_hash),
        "data_hash": hexu(h.data_hash),
        "validators_hash": hexu(h.validators_hash),
        "next_validators_hash": hexu(h.next_validators_hash),
        "consensus_hash": hexu(h.consensus_hash),
        "app_hash": hexu(h.app_hash),
        "last_results_hash": hexu(h.last_results_hash),
        "evidence_hash": hexu(h.evidence_hash),
        "proposer_address": hexu(h.proposer_address),
    }


def enc_commit(c: Optional[Commit]) -> Optional[Dict[str, Any]]:
    if c is None:
        return None
    if hasattr(c, "agg_sig"):
        return {
            "height": str(c.height),
            "round": c.round,
            "block_id": enc_block_id(c.block_id),
            "aggregated_signature": {
                "signers": "".join("1" if c.signers.get_index(i) else "0"
                                   for i in range(c.signers.size())),
                "signature": b64(c.agg_sig),
                "timestamp": rfc3339(c.timestamp_ns),
            },
        }
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": enc_block_id(c.block_id),
        "signatures": [
            {
                "block_id_flag": int(s.block_id_flag),
                "validator_address": hexu(s.validator_address),
                "timestamp": rfc3339(s.timestamp_ns),
                "signature": b64(s.signature),
            }
            for s in c.signatures
        ],
    }


def enc_vote(v) -> Dict[str, Any]:
    return {
        "type": int(v.type),
        "height": str(v.height),
        "round": int(v.round),
        "block_id": enc_block_id(v.block_id),
        "timestamp": rfc3339(v.timestamp_ns),
        "validator_address": hexu(v.validator_address),
        "validator_index": int(v.validator_index),
        "signature": b64(v.signature),
    }


def enc_evidence(ev) -> Dict[str, Any]:
    """(types/evidence.go json shapes; DuplicateVoteEvidence is the one the
    e2e byzantine invariant scans for)"""
    kind = type(ev).__name__
    if kind == "DuplicateVoteEvidence":
        return {
            "type": "tendermint/DuplicateVoteEvidence",
            "value": {
                "vote_a": enc_vote(ev.vote_a),
                "vote_b": enc_vote(ev.vote_b),
                "total_voting_power": str(getattr(ev, "total_voting_power", 0)),
                "validator_power": str(getattr(ev, "validator_power", 0)),
                "timestamp": rfc3339(ev.timestamp_ns),
            },
        }
    return {"type": f"tendermint/{kind}",
            "value": {"height": str(getattr(ev, "height", 0))}}


def enc_block(b: Block) -> Dict[str, Any]:
    return {
        "header": enc_header(b.header),
        "data": {"txs": [b64(tx) for tx in b.data.txs]},
        "evidence": {"evidence": [enc_evidence(e) for e in b.evidence]},
        "last_commit": enc_commit(b.last_commit),
    }


_PUBKEY_JSON_TYPES = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "sr25519": "tendermint/PubKeySr25519",
    "bls12381": "tendermint/PubKeyBls12381",
}


def enc_validator(v: Validator) -> Dict[str, Any]:
    return {
        "address": hexu(v.address),
        "pub_key": {"type": _PUBKEY_JSON_TYPES.get(v.pub_key.type_name,
                                                   "tendermint/PubKeyEd25519"),
                    "value": b64(v.pub_key.bytes())},
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def enc_tx_result(r) -> Dict[str, Any]:
    return {
        "code": getattr(r, "code", 0),
        "data": b64(getattr(r, "data", b"")),
        "log": getattr(r, "log", ""),
        "info": getattr(r, "info", ""),
        "gas_wanted": str(getattr(r, "gas_wanted", 0)),
        "gas_used": str(getattr(r, "gas_used", 0)),
        "events": [],
        "codespace": getattr(r, "codespace", ""),
    }
