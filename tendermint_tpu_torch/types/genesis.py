"""GenesisDoc (reference types/genesis.go): JSON load/validate/save."""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .. import crypto
from .params import ConsensusParams, default_consensus_params
from .validator import Validator

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key: crypto.PubKey
    power: int
    name: str = ""
    address: bytes = b""
    # BLS proof of possession; mandatory when the chain's signature scheme
    # is bls12381 (the rogue-key gate), absent otherwise
    pop: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: Optional[ConsensusParams] = None
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> None:
        """(types/genesis.go ValidateAndComplete)"""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = default_consensus_params()
        else:
            self.consensus_params.validate_basic()
        bls_chain = (self.consensus_params.signature.scheme == "bls12381")
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"the genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i} in the genesis file")
            if bls_chain:
                # key registration: a BLS validator key enters the set only
                # with a verified proof of possession (rogue-key defense)
                if v.pub_key.type_name != "bls12381":
                    raise ValueError(
                        f"validator {i}: bls12381 chain requires bls12381 "
                        f"keys, got {v.pub_key.type_name}")
                from ..crypto import bls12381 as _bls

                if not v.pop:
                    raise ValueError(
                        f"validator {i}: missing BLS proof of possession")
                _bls.register_key(v.pub_key.bytes(), v.pop)
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    def validator_hash(self) -> bytes:
        vals = [Validator(v.pub_key.address(), v.pub_key, v.power) for v in self.validators]
        from .validator_set import ValidatorSet

        return ValidatorSet(vals).hash()

    def to_json(self) -> str:
        def enc_params(p: ConsensusParams) -> dict:
            return {
                "block": {
                    "max_bytes": str(p.block.max_bytes),
                    "max_gas": str(p.block.max_gas),
                    "time_iota_ms": str(p.block.time_iota_ms),
                },
                "evidence": {
                    "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
                    "max_age_duration": str(p.evidence.max_age_duration_ns),
                    "max_bytes": str(p.evidence.max_bytes),
                },
                "validator": {"pub_key_types": p.validator.pub_key_types},
                "version": {"app_version": str(p.version.app_version)},
            }

        def enc_params_full(p: ConsensusParams) -> dict:
            out = enc_params(p)
            if not p.signature.is_default:
                # omitted for default chains: genesis JSON stays byte-for-
                # byte what it was before the scheme plane existed
                out["signature"] = {
                    "scheme": p.signature.scheme,
                    "aggregate_commits": p.signature.aggregate_commits,
                }
            return out

        doc = {
            "genesis_time": self.genesis_time_ns,
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": enc_params_full(self.consensus_params or default_consensus_params()),
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": v.pub_key.type_name, "value": v.pub_key.bytes().hex()},
                    "power": str(v.power),
                    "name": v.name,
                    **({"pop": v.pop.hex()} if v.pop else {}),
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
            "app_state": json.loads(self.app_state.decode("utf-8")) if self.app_state else {},
        }
        return json.dumps(doc, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "GenesisDoc":
        doc = json.loads(s)
        params = None
        if "consensus_params" in doc and doc["consensus_params"]:
            cp = doc["consensus_params"]
            from .params import (BlockParams, EvidenceParams, SignatureParams,
                                 ValidatorParams, VersionParams)

            sig = cp.get("signature") or {}
            params = ConsensusParams(
                BlockParams(int(cp["block"]["max_bytes"]), int(cp["block"]["max_gas"]),
                            int(cp["block"].get("time_iota_ms", 1000))),
                EvidenceParams(int(cp["evidence"]["max_age_num_blocks"]),
                               int(cp["evidence"]["max_age_duration"]),
                               int(cp["evidence"].get("max_bytes", 1048576))),
                ValidatorParams(list(cp["validator"]["pub_key_types"])),
                VersionParams(int(cp.get("version", {}).get("app_version", 0))),
                SignatureParams(sig.get("scheme", "ed25519"),
                                bool(sig.get("aggregate_commits", False))),
            )
        validators = []
        for v in doc.get("validators") or []:
            pub = crypto.pubkey_from_type_and_bytes(
                v["pub_key"]["type"], bytes.fromhex(v["pub_key"]["value"])
            )
            validators.append(GenesisValidator(
                pub_key=pub, power=int(v["power"]), name=v.get("name", ""),
                address=bytes.fromhex(v["address"]) if v.get("address") else b"",
                pop=bytes.fromhex(v["pop"]) if v.get("pop") else b"",
            ))
        gd = GenesisDoc(
            chain_id=doc["chain_id"],
            genesis_time_ns=int(doc.get("genesis_time", 0)),
            initial_height=int(doc.get("initial_height", 1)),
            consensus_params=params,
            validators=validators,
            app_hash=bytes.fromhex(doc.get("app_hash", "")),
            app_state=json.dumps(doc.get("app_state", {})).encode("utf-8"),
        )
        gd.validate_and_complete()
        return gd

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def from_file(path: str) -> "GenesisDoc":
        with open(path) as f:
            return GenesisDoc.from_json(f.read())

    def hash(self) -> bytes:
        return hashlib.sha256(self.to_json().encode("utf-8")).digest()
