"""ConsensusParams (reference types/params.go): validation + hash.

HashConsensusParams hashes a subset proto (BlockParams.MaxBytes/MaxGas +
Evidence + Validator params) — see types/params.go HashConsensusParams.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List

from ..libs import protowire as pw

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB (types/params.go MaxBlockSizeBytes)

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_SR25519 = "sr25519"
ABCI_PUBKEY_TYPE_BLS12381 = "bls12381"


@dataclass
class SignatureParams:
    """Which signature scheme the chain's validators run and whether commits
    are BLS-aggregated (this repo's scheme-agnostic crypto plane; no
    reference equivalent).  The ed25519/non-aggregated default is encoded as
    *absence* — no proto field, no genesis JSON section — so every default
    chain stays byte-identical to the pre-scheme-plane format."""

    scheme: str = ABCI_PUBKEY_TYPE_ED25519
    aggregate_commits: bool = False

    @property
    def is_default(self) -> bool:
        return (self.scheme == ABCI_PUBKEY_TYPE_ED25519
                and not self.aggregate_commits)

    def encode(self) -> bytes:
        w = pw.Writer()
        w.string(1, self.scheme)
        if self.aggregate_commits:
            w.varint(2, 1)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "SignatureParams":
        p = SignatureParams()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                p.scheme = v.decode("utf-8")
            elif fn == 2:
                p.aggregate_commits = bool(v)
        return p


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB
    max_gas: int = -1
    time_iota_ms: int = 1000  # unexposed in v0.34 but part of the proto/hash

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.max_bytes)
        w.varint(2, self.max_gas)
        w.varint(3, self.time_iota_ms)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "BlockParams":
        p = BlockParams(0, 0, 0)
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                p.max_bytes = pw.varint_to_int64(v)
            elif fn == 2:
                p.max_gas = pw.varint_to_int64(v)
            elif fn == 3:
                p.time_iota_ms = pw.varint_to_int64(v)
        return p


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000  # 48h
    max_bytes: int = 1048576

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.max_age_num_blocks)
        # google.protobuf.Duration { int64 seconds=1; int32 nanos=2 }
        seconds, nanos = divmod(self.max_age_duration_ns, 1_000_000_000)
        dw = pw.Writer()
        dw.varint(1, seconds)
        dw.varint(2, nanos)
        w.message(2, dw.finish())
        w.varint(3, self.max_bytes)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "EvidenceParams":
        p = EvidenceParams(0, 0, 0)
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                p.max_age_num_blocks = pw.varint_to_int64(v)
            elif fn == 2:
                p.max_age_duration_ns = pw.parse_timestamp(v)  # same layout
            elif fn == 3:
                p.max_bytes = pw.varint_to_int64(v)
        return p


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519])

    def encode(self) -> bytes:
        w = pw.Writer()
        for t in self.pub_key_types:
            w.string(1, t)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "ValidatorParams":
        types_ = [v.decode("utf-8") for fn, _wt, v in pw.iter_fields(data) if fn == 1]
        return ValidatorParams(types_)


@dataclass
class VersionParams:
    app_version: int = 0

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.app_version)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "VersionParams":
        p = VersionParams()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                p.app_version = v
        return p


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    signature: SignatureParams = field(default_factory=SignatureParams)

    def hash(self) -> bytes:
        """HashConsensusParams (types/params.go): sha256 of HashedParams proto
        {block_max_bytes=1, block_max_gas=2}."""
        w = pw.Writer()
        w.varint(1, self.block.max_bytes)
        w.varint(2, self.block.max_gas)
        return hashlib.sha256(w.finish()).digest()

    def validate_basic(self) -> None:
        if self.block.max_bytes <= 0:
            raise ValueError(f"block.MaxBytes must be greater than 0. Got {self.block.max_bytes}")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(
                f"block.MaxBytes is too big. {self.block.max_bytes} > {MAX_BLOCK_SIZE_BYTES}"
            )
        if self.block.max_gas < -1:
            raise ValueError(f"block.MaxGas must be greater or equal to -1. Got {self.block.max_gas}")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be greater than 0")
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be greater than 0")
        if self.evidence.max_bytes > self.block.max_bytes:
            raise ValueError("evidence.MaxBytesEvidence is greater than upper bound")
        if self.evidence.max_bytes < 0:
            raise ValueError("evidence.MaxBytes must be non negative")
        if len(self.validator.pub_key_types) == 0:
            raise ValueError("len(Validator.PubKeyTypes) must be greater than 0")
        for t in self.validator.pub_key_types:
            if t not in (ABCI_PUBKEY_TYPE_ED25519, ABCI_PUBKEY_TYPE_SECP256K1,
                         ABCI_PUBKEY_TYPE_SR25519, ABCI_PUBKEY_TYPE_BLS12381):
                raise ValueError(f"unknown pubkey type {t}")
        if self.signature.scheme not in (ABCI_PUBKEY_TYPE_ED25519,
                                         ABCI_PUBKEY_TYPE_BLS12381):
            raise ValueError(
                f"unknown signature scheme {self.signature.scheme}")
        if self.signature.aggregate_commits and \
                self.signature.scheme != ABCI_PUBKEY_TYPE_BLS12381:
            raise ValueError(
                "signature.aggregate_commits requires the bls12381 scheme")

    def update(self, updates) -> "ConsensusParams":
        """Apply ABCI EndBlock param updates (types/params.go UpdateConsensusParams)."""
        res = ConsensusParams(
            BlockParams(self.block.max_bytes, self.block.max_gas, self.block.time_iota_ms),
            EvidenceParams(self.evidence.max_age_num_blocks,
                           self.evidence.max_age_duration_ns, self.evidence.max_bytes),
            ValidatorParams(list(self.validator.pub_key_types)),
            VersionParams(self.version.app_version),
            SignatureParams(self.signature.scheme,
                            self.signature.aggregate_commits),
        )
        if updates is None:
            return res
        if updates.block is not None:
            res.block.max_bytes = updates.block.max_bytes
            res.block.max_gas = updates.block.max_gas
        if updates.evidence is not None:
            res.evidence = EvidenceParams(updates.evidence.max_age_num_blocks,
                                          updates.evidence.max_age_duration_ns,
                                          updates.evidence.max_bytes)
        if updates.validator is not None:
            res.validator = ValidatorParams(list(updates.validator.pub_key_types))
        if updates.version is not None:
            res.version = VersionParams(updates.version.app_version)
        return res

    def encode(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.block.encode())
        w.message(2, self.evidence.encode())
        w.message(3, self.validator.encode())
        w.message(4, self.version.encode())
        if not self.signature.is_default:
            # absent for default chains: pre-scheme-plane bytes unchanged
            w.message(5, self.signature.encode())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "ConsensusParams":
        p = ConsensusParams()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                p.block = BlockParams.decode(v)
            elif fn == 2:
                p.evidence = EvidenceParams.decode(v)
            elif fn == 3:
                p.validator = ValidatorParams.decode(v)
            elif fn == 4:
                p.version = VersionParams.decode(v)
            elif fn == 5:
                p.signature = SignatureParams.decode(v)
        return p


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
