"""Block, Header, Commit, CommitSig, Data, BlockMeta (reference
types/block.go).

Header.Hash merkle-izes the 14 proto-encoded fields (block.go:440-475);
Commit.Hash merkle-izes CommitSig proto encodings (block.go:894-912);
Commit.vote_sign_bytes rebuilds each validator's canonical vote sign-bytes
(block.go:784-810) — the per-index payload of the batched verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .. import crypto
from ..crypto import merkle, schemes
from ..libs import protowire as pw
from ..libs.bits import BitArray
from .basic import BlockID, BlockIDFlag, PartSetHeader, SignedMsgType, ZERO_TIME_NS
from .canonical import (
    vote_sign_bytes,
    vote_sign_bytes_batch,
    vote_sign_bytes_columns_batch,
)
from .tx import txs_hash
from .vote import MAX_SIGNATURE_SIZE, Vote

# Protocol versions (reference version/version.go:16-22).
BLOCK_PROTOCOL = 11
P2P_PROTOCOL = 8

MAX_HEADER_BYTES = 626  # types/block.go MaxHeaderBytes


def _cdc_bytes(b: bytes) -> bytes:
    """gogotypes.BytesValue wrapper, empty → empty bytes (types/encoding_helper.go:11)."""
    if not b:
        return b""
    w = pw.Writer()
    w.bytes(1, b)
    return w.finish()


def _cdc_string(s: str) -> bytes:
    if not s:
        return b""
    w = pw.Writer()
    w.string(1, s)
    return w.finish()


def _cdc_int64(v: int) -> bytes:
    if v == 0:
        return b""
    w = pw.Writer()
    w.varint(1, v)
    return w.finish()


@dataclass(frozen=True)
class Consensus:
    """Version info committed to the chain (proto/tendermint/version/types.proto)."""

    block: int = BLOCK_PROTOCOL
    app: int = 0

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.block)
        w.varint(2, self.app)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Consensus":
        block = app = 0
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                block = v
            elif fn == 2:
                app = v
        return Consensus(block, app)


@dataclass
class Header:
    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time_ns: int = ZERO_TIME_NS
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def __setattr__(self, name: str, value) -> None:
        # any field write invalidates the hash memo: headers ARE mutated
        # after construction (fill_header, decode, test tampering), and a
        # stale memo would be a consensus fault, not a perf bug
        d = self.__dict__
        if "_hash_memo" in d:
            del d["_hash_memo"]
        object.__setattr__(self, name, value)

    def hash(self) -> Optional[bytes]:
        """Merkle root of the proto-encoded fields (block.go:440), memoized
        until the next field write. The sync hot path hashes each header
        several times (BlockID assembly, store save, ABCI BeginBlock), and
        a 14-leaf merkle plus 14 proto encodes per call was measurable at
        pipeline scale."""
        if len(self.validators_hash) == 0:
            return None
        memo = self.__dict__.get("_hash_memo")
        if memo is not None:
            return memo
        h = merkle.hash_from_byte_slices([
            self.version.encode(),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            pw.timestamp(self.time_ns),
            self.last_block_id.encode(),
            _cdc_bytes(self.last_commit_hash),
            _cdc_bytes(self.data_hash),
            _cdc_bytes(self.validators_hash),
            _cdc_bytes(self.next_validators_hash),
            _cdc_bytes(self.consensus_hash),
            _cdc_bytes(self.app_hash),
            _cdc_bytes(self.last_results_hash),
            _cdc_bytes(self.evidence_hash),
            _cdc_bytes(self.proposer_address),
        ])
        self.__dict__["_hash_memo"] = h
        return h

    def validate_basic(self) -> None:
        if len(self.chain_id) > 50:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Header.Height")
        if self.height == 0:
            raise ValueError("zero Header.Height")
        self.last_block_id.validate_basic()
        for name, h in (("LastCommitHash", self.last_commit_hash),
                        ("DataHash", self.data_hash),
                        ("EvidenceHash", self.evidence_hash)):
            if len(h) not in (0, 32):
                raise ValueError(f"wrong {name}")
        if len(self.proposer_address) != crypto.ADDRESS_SIZE:
            raise ValueError("invalid ProposerAddress length")
        for name, h in (("ValidatorsHash", self.validators_hash),
                        ("NextValidatorsHash", self.next_validators_hash),
                        ("ConsensusHash", self.consensus_hash),
                        ("LastResultsHash", self.last_results_hash)):
            if len(h) not in (0, 32):
                raise ValueError(f"wrong {name}")

    # -- proto (types.proto Header) ---------------------------------------

    def encode(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.version.encode())
        w.string(2, self.chain_id)
        w.varint(3, self.height)
        w.message(4, pw.timestamp(self.time_ns))
        w.message(5, self.last_block_id.encode())
        w.bytes(6, self.last_commit_hash)
        w.bytes(7, self.data_hash)
        w.bytes(8, self.validators_hash)
        w.bytes(9, self.next_validators_hash)
        w.bytes(10, self.consensus_hash)
        w.bytes(11, self.app_hash)
        w.bytes(12, self.last_results_hash)
        w.bytes(13, self.evidence_hash)
        w.bytes(14, self.proposer_address)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Header":
        h = Header()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                h.version = Consensus.decode(v)
            elif fn == 2:
                h.chain_id = v.decode("utf-8")
            elif fn == 3:
                h.height = pw.varint_to_int64(v)
            elif fn == 4:
                h.time_ns = pw.parse_timestamp(v)
            elif fn == 5:
                h.last_block_id = BlockID.decode(v)
            elif fn == 6:
                h.last_commit_hash = v
            elif fn == 7:
                h.data_hash = v
            elif fn == 8:
                h.validators_hash = v
            elif fn == 9:
                h.next_validators_hash = v
            elif fn == 10:
                h.consensus_hash = v
            elif fn == 11:
                h.app_hash = v
            elif fn == 12:
                h.last_results_hash = v
            elif fn == 13:
                h.evidence_hash = v
            elif fn == 14:
                h.proposer_address = v
        return h


@dataclass
class CommitSig:
    block_id_flag: BlockIDFlag = BlockIDFlag.ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = ZERO_TIME_NS
    signature: bytes = b""

    @staticmethod
    def new_absent() -> "CommitSig":
        return CommitSig(BlockIDFlag.ABSENT, b"", ZERO_TIME_NS, b"")

    @staticmethod
    def new_for_block(signature: bytes, val_addr: bytes, ts_ns: int) -> "CommitSig":
        return CommitSig(BlockIDFlag.COMMIT, val_addr, ts_ns, signature)

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def absent(self) -> bool:
        return self.block_id_flag == BlockIDFlag.ABSENT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        if self.block_id_flag == BlockIDFlag.COMMIT:
            return commit_block_id
        if self.block_id_flag in (BlockIDFlag.ABSENT, BlockIDFlag.NIL):
            return BlockID()
        raise ValueError(f"Unknown BlockIDFlag: {self.block_id_flag}")

    def validate_basic(self) -> None:
        if self.block_id_flag not in (BlockIDFlag.ABSENT, BlockIDFlag.COMMIT, BlockIDFlag.NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BlockIDFlag.ABSENT:
            if len(self.validator_address) != 0:
                raise ValueError("validator address is present")
            if self.timestamp_ns != ZERO_TIME_NS:
                raise ValueError("time is present")
            if len(self.signature) != 0:
                raise ValueError("signature is present")
        else:
            if len(self.validator_address) != crypto.ADDRESS_SIZE:
                raise ValueError(
                    f"expected ValidatorAddress size to be {crypto.ADDRESS_SIZE} bytes, "
                    f"got {len(self.validator_address)} bytes"
                )
            if len(self.signature) == 0:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, int(self.block_id_flag))
        w.bytes(2, self.validator_address)
        w.message(3, pw.timestamp(self.timestamp_ns))
        w.bytes(4, self.signature)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "CommitSig":
        cs = CommitSig()
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                cs.block_id_flag = BlockIDFlag(v)
            elif fn == 2:
                cs.validator_address = v
            elif fn == 3:
                cs.timestamp_ns = pw.parse_timestamp(v)
            elif fn == 4:
                cs.signature = v
        return cs


#: memo sentinel: vote_sign_bytes_columns legitimately caches None
_NO_COLUMNS = object()


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: List[CommitSig] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def get_vote(self, val_idx: int) -> Vote:
        cs = self.signatures[val_idx]
        return Vote(
            type=SignedMsgType.PRECOMMIT,
            height=self.height,
            round=self.round,
            block_id=cs.block_id(self.block_id),
            timestamp_ns=cs.timestamp_ns,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Canonical sign-bytes for validator val_idx's precommit (block.go:807)."""
        cs = self.signatures[val_idx]
        ts = cs.timestamp_ns
        if schemes.for_chain(chain_id).zero_precommit_ts:
            ts = schemes.AGG_ZERO_TS_NS
        return vote_sign_bytes(
            chain_id,
            SignedMsgType.PRECOMMIT,
            self.height,
            self.round,
            cs.block_id(self.block_id),
            ts,
        )

    def vote_sign_bytes_all(self, chain_id: str) -> List[bytes]:
        """Every validator's canonical sign-bytes in one pass, memoized per
        (chain_id, zero-ts flag). Batched commit verification needs all rows
        anyway, and the shared-field assembly
        (canonical.vote_sign_bytes_batch) plus the memo cut the dominant
        host-side cost of the device verify path. Commits are immutable once
        built, so the memo only invalidates if the chain's scheme flips
        zero_precommit_ts under us — hence the flag in the key."""
        zero = schemes.for_chain(chain_id).zero_precommit_ts
        cache = self.__dict__.setdefault("_sb_cache", {})
        hit = cache.get((chain_id, zero))
        if hit is None:
            hit = vote_sign_bytes_batch(
                chain_id,
                SignedMsgType.PRECOMMIT,
                self.height,
                self.round,
                [cs.block_id(self.block_id) for cs in self.signatures],
                [schemes.AGG_ZERO_TS_NS if zero else cs.timestamp_ns
                 for cs in self.signatures],
            )
            cache[(chain_id, zero)] = hit
        return hit

    def vote_sign_bytes_columns(self, chain_id: str):
        """Columnar sign-bytes (crypto.signcols.SignColumns) for the whole
        commit, memoized per (chain_id, scheme) like vote_sign_bytes_all — or
        None when the rows are not structurally uniform (nil votes mixed in,
        ragged timestamp encodings) or when the chain's scheme is not
        ed25519: the columns feed the ed25519 device pack path exclusively,
        and a memo keyed on chain_id alone would keep serving stale ed25519
        columns after the chain registers a different scheme. Row i
        reconstructs byte-identically to vote_sign_bytes_all(chain_id)[i]."""
        sch = schemes.for_chain(chain_id)
        if sch.scheme != schemes.SCHEME_ED25519:
            return None
        cache = self.__dict__.setdefault("_sbc_cache", {})
        key = (chain_id, sch.scheme, sch.zero_precommit_ts)
        hit = cache.get(key, _NO_COLUMNS)
        if hit is _NO_COLUMNS:
            hit = vote_sign_bytes_columns_batch(
                chain_id,
                SignedMsgType.PRECOMMIT,
                self.height,
                self.round,
                [cs.block_id(self.block_id) for cs in self.signatures],
                [cs.timestamp_ns for cs in self.signatures],
            )
            cache[key] = hit
        return hit

    def size(self) -> int:
        return len(self.signatures)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([cs.encode() for cs in self.signatures])
        return self._hash

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if len(self.signatures) == 0:
                raise ValueError("no signatures in commit")
            for i, cs in enumerate(self.signatures):
                try:
                    cs.validate_basic()
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.height)
        w.varint(2, self.round)
        w.message(3, self.block_id.encode())
        for cs in self.signatures:
            w.message(4, cs.encode())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Commit":
        """Polymorphic: the presence of the aggregate fields (5/6/7) makes
        the wire form self-describing, so every existing decode call site —
        block store, WAL, blocksync, light client — handles aggregated
        commits without knowing the chain's scheme."""
        height = round_ = 0
        block_id = BlockID()
        sigs: List[CommitSig] = []
        signers = None
        agg_sig = b""
        agg_ts = 0
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                height = pw.varint_to_int64(v)
            elif fn == 2:
                round_ = pw.varint_to_int64(v)
            elif fn == 3:
                block_id = BlockID.decode(v)
            elif fn == 4:
                sigs.append(CommitSig.decode(v))
            elif fn == 5:
                signers = BitArray.decode(v)
            elif fn == 6:
                agg_sig = v
            elif fn == 7:
                agg_ts = pw.varint_to_int64(v)
        if signers is not None or agg_sig:
            return AggregatedCommit(height, round_, block_id, [],
                                    signers=signers or BitArray(0),
                                    agg_sig=agg_sig, timestamp_ns=agg_ts)
        return Commit(height, round_, block_id, sigs)


@dataclass
class AggregatedCommit(Commit):
    """BLS fast-aggregate commit (the aggregated-commit block path; no
    reference equivalent).  Replaces the per-validator CommitSig list with
    one 48-byte aggregate signature over the shared zero-timestamp precommit
    sign-bytes, a signer bitmap positioned by validator index, and the
    voting-power-weighted median of the aggregated precommit timestamps.

    Wire form reuses Commit fields 1-3 and adds signers=5, agg_sig=6,
    timestamp=7; field 4 is never emitted, so Commit.decode dispatches on
    5/6 presence.  Verification is one fast-aggregate-verify against the
    apk of the bitmap's keys (validator_set.verify_commit*)."""

    signers: BitArray = field(default_factory=lambda: BitArray(0))
    agg_sig: bytes = b""
    timestamp_ns: int = 0

    def size(self) -> int:
        return self.signers.size()

    def signed(self, val_idx: int) -> bool:
        return self.signers.get_index(val_idx)

    def sign_message(self, chain_id: str) -> bytes:
        """The single canonical payload every signer in the bitmap signed
        (zero-timestamp precommit sign-bytes — see schemes.AGG_ZERO_TS_NS)."""
        return vote_sign_bytes(
            chain_id,
            SignedMsgType.PRECOMMIT,
            self.height,
            self.round,
            self.block_id,
            schemes.AGG_ZERO_TS_NS,
        )

    def get_vote(self, val_idx: int):
        raise TypeError("aggregated commit has no per-validator votes")

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        raise TypeError("aggregated commit has no per-validator sign-bytes")

    def vote_sign_bytes_all(self, chain_id: str):
        raise TypeError("aggregated commit has no per-validator sign-bytes")

    def vote_sign_bytes_columns(self, chain_id: str):
        return None

    def hash(self) -> bytes:
        if self._hash is None:
            w = pw.Writer()
            w.message(1, self.signers.encode())
            w.bytes(2, self.agg_sig)
            w.varint(3, self.timestamp_ns)
            self._hash = merkle.hash_from_byte_slices([w.finish()])
        return self._hash

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.signatures:
            raise ValueError("aggregated commit carries per-validator signatures")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if self.signers.size() == 0 or self.signers.num_true() == 0:
                raise ValueError("no signers in aggregated commit")
            from ..crypto.bls12381 import SIG_SIZE

            if len(self.agg_sig) != SIG_SIZE:
                raise ValueError(
                    f"aggregate signature must be {SIG_SIZE} bytes, "
                    f"got {len(self.agg_sig)}")

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint(1, self.height)
        w.varint(2, self.round)
        w.message(3, self.block_id.encode())
        w.message(5, self.signers.encode())
        w.bytes(6, self.agg_sig)
        w.varint(7, self.timestamp_ns)
        return w.finish()


@dataclass
class Data:
    txs: List[bytes] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = txs_hash(self.txs)
        return self._hash

    def encode(self) -> bytes:
        w = pw.Writer()
        for tx in self.txs:
            w.bytes(1, tx) if tx else w.message(1, b"")
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Data":
        txs = [v for fn, _wt, v in pw.iter_fields(data) if fn == 1]
        return Data(txs=list(txs))


@dataclass
class Block:
    header: Header
    data: Data
    evidence: List = field(default_factory=list)  # List[Evidence]
    last_commit: Optional[Commit] = None

    def hash(self) -> Optional[bytes]:
        if self.last_commit is None and self.header.height > 1:
            return None
        self.fill_header()
        return self.header.hash()

    def fill_header(self) -> None:
        """Populate derived header hashes (block.go fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            from .evidence import evidence_list_hash

            self.header.evidence_hash = evidence_list_hash(self.evidence)

    def validate_basic(self) -> None:
        self.header.validate_basic()
        if self.last_commit is None:
            if self.header.height > 1:
                raise ValueError("nil LastCommit")
        else:
            self.last_commit.validate_basic()
            if self.header.last_commit_hash != self.last_commit.hash():
                raise ValueError(
                    f"wrong Header.LastCommitHash. Expected "
                    f"{self.last_commit.hash().hex().upper()}, got "
                    f"{self.header.last_commit_hash.hex().upper()}"
                )
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong Header.DataHash")
        from .evidence import evidence_list_hash

        if self.header.evidence_hash != evidence_list_hash(self.evidence):
            raise ValueError("wrong Header.EvidenceHash")

    def make_part_set(self, part_size: int = 65536):
        """Memoized: the sync/consensus paths build the part set of the same
        block several times (gossip entries, store save, proposal); encoding
        a 1000-signature block costs tens of ms, so rebuild only when asked
        for a different part size. Blocks are frozen once assembled (the
        memo key includes nothing mutable: fill_header() is idempotent)."""
        cached = self.__dict__.get("_part_set_cache")
        if cached is not None and cached[0] == part_size:
            return cached[1]
        from .part_set import PartSet

        self.fill_header()
        ps = PartSet.from_data(self.encode(), part_size)
        self.__dict__["_part_set_cache"] = (part_size, ps)
        return ps

    # -- proto (types/block.proto Block) ----------------------------------

    def encode(self) -> bytes:
        from .evidence import encode_evidence_list

        w = pw.Writer()
        w.message(1, self.header.encode())
        w.message(2, self.data.encode())
        w.message(3, encode_evidence_list(self.evidence))
        if self.last_commit is not None:
            w.message(4, self.last_commit.encode())
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Block":
        from .evidence import decode_evidence_list

        header = Header()
        blk_data = Data()
        evidence: List = []
        last_commit = None
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                header = Header.decode(v)
            elif fn == 2:
                blk_data = Data.decode(v)
            elif fn == 3:
                evidence = decode_evidence_list(v)
            elif fn == 4:
                last_commit = Commit.decode(v)
        return Block(header, blk_data, evidence, last_commit)


@dataclass
class BlockMeta:
    """Stored per height in the block store (types/block_meta.go)."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def encode(self) -> bytes:
        w = pw.Writer()
        w.message(1, self.block_id.encode())
        w.varint(2, self.block_size)
        w.message(3, self.header.encode())
        w.varint(4, self.num_txs)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "BlockMeta":
        block_id = BlockID()
        header = Header()
        block_size = num_txs = 0
        for fn, _wt, v in pw.iter_fields(data):
            if fn == 1:
                block_id = BlockID.decode(v)
            elif fn == 2:
                block_size = pw.varint_to_int64(v)
            elif fn == 3:
                header = Header.decode(v)
            elif fn == 4:
                num_txs = pw.varint_to_int64(v)
        return BlockMeta(block_id, block_size, header, num_txs)


def make_block(height: int, txs: List[bytes], last_commit: Optional[Commit],
               evidence: Optional[List] = None) -> Block:
    """Block skeleton; header chain fields are filled by state.MakeBlock."""
    return Block(
        header=Header(height=height),
        data=Data(txs=list(txs)),
        evidence=list(evidence or []),
        last_commit=last_commit,
    )
