"""RFC 6962 merkle trees + proofs (reference crypto/merkle/{tree,proof}.go).

Domain-separated hashing: leaf = SHA256(0x00 || item), inner = SHA256(0x01 || l || r).
Empty tree hashes to SHA256(""). Split point is the largest power of two < n
(reference crypto/merkle/tree.go:85 getSplitPoint).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"

# Bound on proof depth, as in the reference (crypto/merkle/proof.go:14
# MaxAunts=100): rejects adversarial proofs instead of recursing unboundedly.
MAX_AUNTS = 100

# Pre-seeded hash objects: copying a seeded sha256 state is cheaper than
# re-hashing the domain prefix for every node, and update(l); update(r)
# avoids materializing the prefix||l||r concatenation per inner node.
_LEAF_SEED = hashlib.sha256(LEAF_PREFIX)
_INNER_SEED = hashlib.sha256(INNER_PREFIX)


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_hash(item: bytes) -> bytes:
    h = _LEAF_SEED.copy()
    h.update(item)
    return h.digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    h = _INNER_SEED.copy()
    h.update(left)
    h.update(right)
    return h.digest()


def _split_point(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root (reference crypto/merkle/tree.go:9).

    Iterative bottom-up pass over a level buffer instead of the reference's
    recursion. The reference tree splits at the largest power of two < n;
    that tree is identical to pairing adjacent nodes level by level and
    promoting an unpaired last node unchanged (the odd node joins exactly at
    the level where everything to its left is a full power-of-two subtree),
    so the roots are byte-identical while per-node Python call overhead —
    dominant at 1000+ leaf valset/commit hashing scale — disappears.
    """
    n = len(items)
    if n == 0:
        return _sha256(b"")
    leaf_seed = _LEAF_SEED
    level: List[bytes] = []
    for item in items:
        h = leaf_seed.copy()
        h.update(item)
        level.append(h.digest())
    inner_seed = _INNER_SEED
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            h = inner_seed.copy()
            h.update(level[i])
            h.update(level[i + 1])
            nxt.append(h.digest())
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


# --- vectorized fast path + incremental roots (app-hash merkle) -------------
#
# MerkleKVStoreApplication recomputes its root every commit; at real state
# sizes that is the execution plane's commit bottleneck. Two escapes, both
# byte-identical to hash_from_byte_slices (differential-tested):
#
#  * batched hashing — one tree level's nodes are equal-length messages
#    (inner nodes always 65 bytes), so a wide level is one launch of the
#    hand-written SHA-256 kernel (K9) through crypto/merkle_fast.py.
#  * IncrementalMerkle — a cached level structure patched along the paths
#    of dirty leaves, so commit cost scales with writes, not state size.
#
# TMTPU_MERKLE_FAST=0 disables batching (hashlib everywhere);
# TMTPU_MERKLE_DEVICE_MIN sets the narrowest level sent to the device.
#
# The JAX package has a numpy tier between the two and falls back to it on
# any device exception. The port has neither: numpy was slower than
# hashlib at every level width on the H100's host (PERF.md), and a level
# the device route takes is hashed on the card or raises — KernelUnavailable
# (no card while the default device is cuda, a kernel that does not build
# or load) and every fault of a running kernel reach the caller.

import os as _os

from . import merkle_fast as _mf
from .breaker import count_device_error

#: messages hashed by each route
stats = {"hashlib": 0, "device": 0}


def _env_int(name: str, default: int) -> int:
    try:
        return int(_os.environ.get(name, default))
    except ValueError:
        return default


def _batch_sha256(msgs: List[bytes]) -> Optional[List[bytes]]:
    """Hash n equal-length messages on the device when the level is wide
    enough; None tells the caller to take the hashlib loop."""
    if (_os.environ.get("TMTPU_MERKLE_FAST", "1") == "0"
            or len(msgs) < _env_int("TMTPU_MERKLE_DEVICE_MIN", 16384)):
        stats["hashlib"] += len(msgs)
        return None
    try:
        out = _mf.sha256_many_device(msgs)
    except Exception as e:
        # a device fault reaches the caller, counted; nothing is hashed
        # on the host in its place
        count_device_error(e, "merkle")
        raise
    stats["device"] += len(msgs)
    return out


def _leaf_hashes(items: Sequence[bytes]) -> List[bytes]:
    """Leaf level, batched per item length (one kvstore level is mostly
    homogeneous; stragglers take the hashlib path)."""
    out: List[Optional[bytes]] = [None] * len(items)
    by_len: dict = {}
    for i, item in enumerate(items):
        by_len.setdefault(len(item), []).append(i)
    for idxs in by_len.values():
        hashed = _batch_sha256([LEAF_PREFIX + items[i] for i in idxs])
        if hashed is None:
            for i in idxs:
                out[i] = leaf_hash(items[i])
        else:
            for j, i in enumerate(idxs):
                out[i] = hashed[j]
    return out


def _inner_level(level: List[bytes]) -> List[bytes]:
    """One reduction step: pair-adjacent inner hashes, odd node promoted
    (same scheme as hash_from_byte_slices)."""
    pairs = [INNER_PREFIX + level[2 * i] + level[2 * i + 1]
             for i in range(len(level) // 2)]
    nxt = _batch_sha256(pairs)
    if nxt is None:
        nxt = [inner_hash(level[2 * i], level[2 * i + 1])
               for i in range(len(level) // 2)]
    if len(level) % 2:
        nxt.append(level[-1])
    return nxt


def _build_levels(items: Sequence[bytes]) -> List[List[bytes]]:
    """All tree levels bottom-up; levels[0] = leaf hashes, levels[-1] =
    [root]. Empty input is the caller's problem (no levels exist)."""
    levels = [_leaf_hashes(items)]
    while len(levels[-1]) > 1:
        levels.append(_inner_level(levels[-1]))
    return levels


def fast_hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """hash_from_byte_slices through the vectorized path — byte-identical
    root, batched level hashing when the tree is wide enough."""
    if len(items) == 0:
        return _sha256(b"")
    return _build_levels(list(items))[-1][0]


class IncrementalMerkle:
    """Merkle root cache with dirty-leaf patching.

    ``root(keys, leaf_item, dirty)`` returns the root over
    ``[leaf_item(k) for k in keys]``. While ``keys`` is unchanged from the
    previous call, only leaves named in ``dirty`` re-hash and only their
    root paths recompute — O(|dirty| · log n) instead of O(n). Any key-set
    change (insert/delete/reorder), ``dirty=None``, or a wide dirty set
    triggers a full (vectorized) rebuild. The result is always identical
    to ``hash_from_byte_slices`` over the same items; tests hold the two
    in lockstep over randomized op sequences.
    """

    def __init__(self):
        self._keys: List = []
        self._pos: dict = {}
        self._levels: Optional[List[List[bytes]]] = None
        self.rebuilds = 0  # observability for tests/bench
        self.patches = 0

    def reset(self) -> None:
        self._keys, self._pos, self._levels = [], {}, None

    def root(self, keys: Sequence, leaf_item, dirty=None) -> bytes:
        keys = list(keys)
        if not keys:
            self.reset()
            return _sha256(b"")
        stale = (self._levels is None or dirty is None
                 or keys != self._keys)
        # patching is hashlib-serial; past ~n/4 dirty leaves the batched
        # full rebuild is cheaper and touches every path anyway
        if not stale and len(dirty) >= max(32, len(keys) // 4):
            stale = True
        if stale:
            self._keys = keys
            self._pos = {k: i for i, k in enumerate(keys)}
            self._levels = _build_levels([leaf_item(k) for k in keys])
            self.rebuilds += 1
            return self._levels[-1][0]
        if dirty:
            self.patches += 1
            levels = self._levels
            cur = set()
            for k in dirty:
                # a key created-then-deleted inside one window sits in the
                # dirty set but is no longer a leaf; with the key set
                # otherwise unchanged it contributes nothing to the tree
                i = self._pos.get(k)
                if i is None:
                    continue
                levels[0][i] = leaf_hash(leaf_item(k))
                cur.add(i)
            for lvl in range(len(levels) - 1):
                level, nxt = levels[lvl], levels[lvl + 1]
                parents = {i // 2 for i in cur}
                for p in parents:
                    li = 2 * p
                    if li + 1 < len(level):
                        nxt[p] = inner_hash(level[li], level[li + 1])
                    else:
                        nxt[p] = level[li]  # promoted odd node
                cur = parents
        return self._levels[-1][0]


@dataclass
class Proof:
    """Inclusion proof (reference crypto/merkle/proof.go:35)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def compute_root(self) -> Optional[bytes]:
        return _root_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if len(self.aunts) > MAX_AUNTS or self.total > (1 << MAX_AUNTS):
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        return self.compute_root() == root

    def encode(self) -> bytes:
        """(proto tendermint.crypto.Proof: total=1 index=2 leaf_hash=3
        aunts=4)"""
        from ..libs import protowire as pw

        w = pw.Writer()
        w.varint(1, self.total)
        if self.index:
            w.varint(2, self.index)
        w.bytes(3, self.leaf_hash)
        for a in self.aunts:
            w.bytes(4, a)
        return w.finish()

    @staticmethod
    def decode(data: bytes) -> "Proof":
        from ..libs import protowire as pw

        f = pw.fields_dict(data)

        def as_int(v) -> int:
            if not isinstance(v, int):
                raise ValueError("expected varint field in Proof")
            return pw.varint_to_int64(v)

        return Proof(
            total=as_int(f.get(1, [0])[0] or 0),
            index=as_int(f.get(2, [0])[0] or 0),
            leaf_hash=pw.as_bytes(f.get(3, [b""])[0] or b""),
            aunts=[pw.as_bytes(a) for a in f.get(4, [])])


def _root_from_aunts(index: int, total: int, lh: bytes, aunts: List[bytes]) -> Optional[bytes]:
    if total == 0:
        return None
    if total == 1:
        if aunts:
            return None
        return lh
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _root_from_aunts(index, k, lh, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _root_from_aunts(index - k, total - k, lh, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]) -> List[Proof]:
    """Root + one proof per item (reference crypto/merkle/proof.go:91)."""
    trails, _ = _trails_from_byte_slices(list(items))
    total = len(items)
    proofs = []
    for i, trail in enumerate(trails):
        node, aunts = trail, []
        cur = trail
        while cur.parent is not None:
            sib = cur.sibling
            if sib is not None:
                aunts.append(sib.hash)
            cur = cur.parent
        proofs.append(Proof(total=total, index=i, leaf_hash=node.hash, aunts=aunts))
    return proofs


class _Node:
    __slots__ = ("hash", "parent", "sibling")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent: Optional[_Node] = None
        self.sibling: Optional[_Node] = None


def _trails_from_byte_slices(items: List[bytes]):
    """Leaf trail nodes + root, built bottom-up (same promoted-odd-node
    scheme as hash_from_byte_slices; a promoted node's parent/sibling stay
    unset until it is paired, which matches the recursive reference shape,
    so the aunt lists — and therefore the proofs — are byte-identical)."""
    if len(items) == 0:
        return [], _Node(_sha256(b""))
    leaves = [_Node(leaf_hash(item)) for item in items]
    level = leaves
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            left, right = level[i], level[i + 1]
            parent = _Node(inner_hash(left.hash, right.hash))
            left.parent = parent
            left.sibling = right
            right.parent = parent
            right.sibling = left
            nxt.append(parent)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return leaves, level[0]


# --- ProofOp chains (reference crypto/merkle/proof_op.go) -------------------
#
# Chained merkle proofs across trees (app store proofs through the light
# proxy): each operator maps leaf value(s) to its tree's root; the last root
# must equal the trusted one; keys are consumed right-to-left against the
# URL-encoded keypath (proof_key_path.go).

from urllib.parse import quote as _quote, unquote_to_bytes as _unquote


def _encode_byte_slice(b: bytes) -> bytes:
    """(libs/protoio encodeByteSlice) uvarint length prefix + bytes — the
    leaf encoding proof_value.go uses for both key and value hash."""
    from ..libs import protowire as pw

    return pw.encode_varint(len(b)) + b


@dataclass
class ProofOp:
    """(proto tendermint.crypto.ProofOp) the generic encoded operator."""

    type: str = ""
    key: bytes = b""
    data: bytes = b""


class ProofOperator:
    """(proof_op.go ProofOperator)"""

    def run(self, args: List[bytes]) -> List[bytes]:
        raise NotImplementedError

    def get_key(self) -> bytes:
        raise NotImplementedError

    def proof_op(self) -> ProofOp:
        raise NotImplementedError


class ValueOp(ProofOperator):
    """(proof_value.go) leaf = leafHash(encodeByteSlice(key) ||
    encodeByteSlice(sha256(value))) proven into a simple tree — the exact
    reference leaf encoding, so proofs interoperate with reference apps."""

    TYPE = "simple:v"

    def __init__(self, key: bytes, proof: Proof):
        self.key = key
        self.proof = proof

    def run(self, args: List[bytes]) -> List[bytes]:
        if len(args) != 1:
            raise ValueError(f"expected 1 arg, got {len(args)}")
        vhash = _sha256(args[0])
        leaf = leaf_hash(_encode_byte_slice(self.key)
                         + _encode_byte_slice(vhash))
        if leaf != self.proof.leaf_hash:
            raise ValueError("leaf mismatch in ValueOp")
        root = self.proof.compute_root()
        if root is None:
            raise ValueError("bad proof in ValueOp")
        return [root]

    def get_key(self) -> bytes:
        return self.key

    def proof_op(self) -> ProofOp:
        return ProofOp(self.TYPE, self.key, self.proof.encode())


def key_path(*keys: bytes) -> str:
    """(proof_key_path.go KeyPath) '/' + url-encoded key components."""
    return "".join("/" + _quote(k, safe="") for k in keys)


def keypath_to_keys(path: str) -> List[bytes]:
    if not path.startswith("/"):
        raise ValueError(f"keypath must start with '/': {path!r}")
    return [_unquote(p) for p in path[1:].split("/") if p]


class ProofRuntime:
    """(proof_op.go ProofRuntime) decoder registry + chained verification."""

    def __init__(self):
        self._decoders = {}  # type name -> ProofOp decoder

    def register_op_decoder(self, type_: str, dec) -> None:
        if type_ in self._decoders:
            raise ValueError(f"already registered for type {type_}")
        self._decoders[type_] = dec

    def decode(self, op: ProofOp) -> ProofOperator:
        dec = self._decoders.get(op.type)
        if dec is None:
            raise ValueError(f"unrecognized proof op type {op.type!r}")
        return dec(op)

    def verify_value(self, ops: List[ProofOp], root: bytes, keypath: str,
                     value: bytes) -> None:
        self.verify(ops, root, keypath, [value])

    def verify(self, ops: List[ProofOp], root: bytes, keypath: str,
               args: List[bytes]) -> None:
        """(proof_op.go ProofOperators.Verify) run the chain; keys consumed
        right-to-left; final root must match."""
        keys = keypath_to_keys(keypath)
        operators = [self.decode(op) for op in ops]
        for i, op in enumerate(operators):
            key = op.get_key()
            if key:
                if not keys:
                    raise ValueError(
                        f"key path has insufficient parts: got {key!r}")
                if keys[-1] != key:
                    raise ValueError(
                        f"key mismatch on operation #{i}: expected "
                        f"{keys[-1]!r} but got {key!r}")
                keys = keys[:-1]
            args = op.run(args)
        if root != args[0]:
            raise ValueError(
                f"calculated root hash is invalid: expected {root.hex()} "
                f"but got {args[0].hex()}")
        if keys:
            raise ValueError("keypath not consumed all")


def default_proof_runtime() -> ProofRuntime:
    """(proof_op.go DefaultProofRuntime) with the simple-value decoder."""
    prt = ProofRuntime()
    prt.register_op_decoder(
        ValueOp.TYPE,
        lambda op: ValueOp(op.key, Proof.decode(op.data)))
    return prt
