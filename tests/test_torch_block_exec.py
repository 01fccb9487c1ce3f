"""The port's block-execution slice as a whole, against the JAX package.

The same seeded genesis, the same txs, the same evidence and the same
signed LastCommits go through both packages' ``BlockExecutor.apply_block``
with the Merkle kvstore app behind a local ABCI client. Blocks, part sets,
app hashes, results hashes, the persisted ABCI responses and states, and
the block store must be identical. The JAX side verifies on its host
route (``TMTPU_BATCH_BACKEND=host``: no test compiles its verify kernel)
and keeps its merkle defaults; the port verifies LastCommits on its device
route (the kernels' plain versions on the CPU) and runs its merkle device
tier from a lowered threshold, so hashlib and the device tier each hash
part of the app hashes.

Also mirrors tests/test_store_state.py (db iteration, apply-and-store,
wrong app hash, prune, validator-update tx) and the part-set and evidence
round trips of tests/test_part_set_evidence.py on the port.
"""

import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

import tendermint_tpu.crypto as jcrypto
import tendermint_tpu_torch.crypto as tcrypto
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.libs import db as jdb
from tendermint_tpu import proxy as jproxy
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state import state as jstate
from tendermint_tpu.state import store as jstore
from tendermint_tpu.store import block_store as jbs
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.basic import SignedMsgType as JMsg
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.block import CommitSig as JCommitSig
from tendermint_tpu.types.canonical import vote_sign_bytes as jsign_bytes
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.example import kvstore as tkv
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto import schemes as tschemes
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.libs import db as tdb
from tendermint_tpu_torch.libs import fail as tfail
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch import proxy as tproxy
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.state import state as tstate
from tendermint_tpu_torch.state import store as tstore
from tendermint_tpu_torch.store import block_store as tbs
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types.basic import BlockID as TBlockID
from tendermint_tpu_torch.types.basic import BlockIDFlag, SignedMsgType
from tendermint_tpu_torch.types.block import Commit as TCommit
from tendermint_tpu_torch.types.block import CommitSig as TCommitSig
from tendermint_tpu_torch.types.canonical import vote_sign_bytes as \
    tsign_bytes
from tendermint_tpu_torch.types.part_set import Part as TPart
from tendermint_tpu_torch.types.part_set import PartSet as TPartSet
from tendermint_tpu_torch.types.params import (ConsensusParams,
                                               ValidatorParams)

CHAIN_ID = "torch-exec-chain"
GENESIS_NS = 1_700_000_000_000_000_000
HEIGHTS = 4

J = SimpleNamespace(crypto=jcrypto, kv=jkv, db=jdb, proxy=jproxy,
                    exe=jexec, st=jstate, store=jstore, bs=jbs, gen=jgen)
T = SimpleNamespace(crypto=tcrypto, kv=tkv, db=tdb, proxy=tproxy,
                    exe=texec, st=tstate, store=tstore, bs=tbs, gen=tgen)


def _reset_port():
    tfaults.reset()
    tfail.reset()
    tbreaker.reset()
    tphases.reset()
    tschemes.reset()
    TV.reset_launches()
    for k in tbatch.stats:
        tbatch.stats[k] = 0
    for k in tmerkle.stats:
        tmerkle.stats[k] = 0


class _Env:
    """Each package's environment, set around its calls: the variables are
    read at call time and both packages read the same names."""

    def __init__(self, monkeypatch):
        self._mp = monkeypatch

    @contextlib.contextmanager
    def jax(self):
        self._mp.setenv("TMTPU_BATCH_BACKEND", "host")
        self._mp.delenv("TMTPU_MERKLE_DEVICE_MIN", raising=False)
        yield

    @contextlib.contextmanager
    def port(self):
        self._mp.setenv("TMTPU_BATCH_BACKEND", "cuda")
        self._mp.setenv("TMTPU_MERKLE_DEVICE_MIN", "16")
        yield


@pytest.fixture(autouse=True)
def env(monkeypatch):
    device.set_default_device("cpu")
    monkeypatch.delenv("TMTPU_MERKLE_FAST", raising=False)
    monkeypatch.setenv("TMTPU_DEVICE_THRESHOLD", "1")
    _reset_port()
    yield _Env(monkeypatch)
    _reset_port()
    device.set_default_device(None)


def _seed(i):
    return bytes([i + 1]) * 32


class _Chain:
    """One package's chain: genesis state, Merkle kvstore app behind a
    local client, MemDB state and block stores, and the executor."""

    def __init__(self, ns, seeds, app=None, power=10):
        genesis = ns.gen.GenesisDoc(
            chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
            validators=[ns.gen.GenesisValidator(
                ns.crypto.Ed25519PrivKey.generate(s).pub_key(), power)
                for s in seeds])
        self.state = ns.st.state_from_genesis(genesis)
        self.app = app if app is not None else \
            ns.kv.MerkleKVStoreApplication(interval=4)
        conns = ns.proxy.AppConns(ns.proxy.local_client_creator(self.app))
        conns.start()
        self.state_store = ns.store.StateStore(ns.db.MemDB())
        self.block_store = ns.bs.BlockStore(ns.db.MemDB())
        self.executor = ns.exe.BlockExecutor(
            self.state_store, conns.consensus, ns.exe.NoOpMempool(),
            ns.exe.EmptyEvidencePool(), self.block_store)
        self.state_store.save(self.state)

    def propose(self, height, txs, last_commit, evidence=()):
        proposer = self.state.validators.get_proposer().address
        return self.state.make_block(height, txs, last_commit,
                                     list(evidence), proposer)

    def apply(self, block, parts, block_id_cls):
        bid = block_id_cls(block.hash(), parts.header())
        self.state, _ = self.executor.apply_block(self.state, bid, block)
        return bid


def _sign_commit(height, block, parts, valset, privs):
    """The JAX package's commit of ``block`` by every member of
    ``valset``, each with its own timestamp."""
    bid = JBlockID(block.hash(), parts.header())
    sigs = []
    for i, v in enumerate(valset.validators):
        ts = block.header.time_ns + 1_000_000 * (i + 1)
        sb = jsign_bytes(CHAIN_ID, JMsg.PRECOMMIT, height, 0, bid, ts)
        sigs.append(JCommitSig(JFlag.COMMIT, v.address, ts,
                               privs[v.address].sign(sb)))
    return JCommit(height, 0, bid, sigs)


def _duplicate_vote(valset, privs, height):
    val = valset.validators[0]

    def vote(seed):
        bid = JBlockID(seed * 32, JPSH(1, b"\x09" * 32))
        v = JVote(JMsg.PRECOMMIT, height, 0, bid, GENESIS_NS + 5, val.address,
                  0)
        v.signature = privs[val.address].sign(v.sign_bytes(CHAIN_ID))
        return v

    return jev.DuplicateVoteEvidence.new(vote(b"\x01"), vote(b"\x02"),
                                         GENESIS_NS + 7, valset)


def _txs(rng, height, keys):
    """24 new keys a height; from height 2 on, updates of 6 old ones."""
    new = [rng.bytes(8).hex() for _ in range(24)]
    old = [keys[int(i)] for i in rng.integers(0, len(keys), 6)] \
        if height > 1 else []
    keys.extend(new)
    return [f"{k}={rng.bytes(16).hex()}".encode() for k in new + old]


def test_apply_block_matches_jax(env):
    seeds = [_seed(i) for i in range(5)]
    jprivs = {p.pub_key().address(): p for p in
              (jcrypto.Ed25519PrivKey.generate(s) for s in seeds)}
    j, t = _Chain(J, seeds[:4]), _Chain(T, seeds[:4])
    newval = jcrypto.Ed25519PrivKey.generate(seeds[4]).pub_key().bytes()
    rng = np.random.default_rng(20261017)
    keys = []
    jlast = JCommit(0, 0, JBlockID(), [])
    tlast = TCommit(0, 0, TBlockID(), [])
    for h in range(1, HEIGHTS + 1):
        txs = _txs(rng, h, keys)
        if h == 2:  # a fifth validator, in the set from height 4
            txs.append(f"val:{newval.hex()}!7".encode())
        jevidence = [_duplicate_vote(j.state.validators, jprivs, h - 1)] \
            if h == 3 else []
        tevidence = tev.decode_evidence_list(
            jev.encode_evidence_list(jevidence))
        jblock, jparts = j.propose(h, txs, jlast, jevidence)
        tblock, tparts = t.propose(h, txs, tlast, tevidence)
        assert tblock.encode() == jblock.encode()
        assert tblock.hash() == jblock.hash()
        assert tparts.header().encode() == jparts.header().encode()
        jvals = j.state.validators
        with env.jax():
            j.apply(jblock, jparts, JBlockID)
        with env.port():
            t.apply(tblock, tparts, TBlockID)
        assert t.state.app_hash == j.state.app_hash
        assert t.state.last_results_hash == j.state.last_results_hash
        assert t.state_store.load_abci_responses(h).to_json() == \
            j.state_store.load_abci_responses(h).to_json()
        assert tstore._state_to_json(t.state) == \
            jstore._state_to_json(j.state)
        assert tstore._state_to_json(t.state_store.load()) == \
            jstore._state_to_json(j.state_store.load())
        jlast = _sign_commit(h, jblock, jparts, jvals, jprivs)
        tlast = convert.commit_from_reference(jlast.encode())
        j.block_store.save_block(jblock, jparts, jlast)
        t.block_store.save_block(tblock, tparts, tlast)
        assert t.block_store.load_block(h).encode() == jblock.encode()
        assert t.block_store.load_block_meta(h).encode() == \
            j.block_store.load_block_meta(h).encode()
        assert t.block_store.load_seen_commit(h).encode() == jlast.encode()
    assert t.state.app_hash == tmerkle.hash_from_byte_slices(
        tkv.MerkleKVStoreApplication._leaf_items(t.app.state))
    assert t.state.validators.size() == 5
    assert t.state_store.load_validators(HEIGHTS).hash() == \
        j.state_store.load_validators(HEIGHTS).hash()
    # the port verified each LastCommit on its device route, and both
    # merkle tiers hashed part of the app hashes
    assert tbatch.stats["device_sigs"] == 4 * (HEIGHTS - 1)
    assert tbatch.stats["device_errors"] == 0
    assert tmerkle.stats["device"] and tmerkle.stats["hashlib"]
    # one exec-plane segment per applied block
    execs = [r for r in tphases.recent_segments() if r["plane"] == "exec"]
    assert [r["height"] for r in execs] == list(range(1, HEIGHTS + 1))


def test_parallel_execution_and_bls_updates_are_not_ported(env):
    """Both are ported now. ``execution.version`` "v1" builds the parallel
    executor (tests/test_torch_parallel_exec.py holds it against the JAX
    package), "v0" does not. A bls12381 update without a proof of
    possession meets the rogue-key gate (tests/test_torch_bls.py holds the
    gate against the JAX package)."""
    v1 = texec.BlockExecutor(None, None, None, None,
                             exec_config=SimpleNamespace(
                                 version="v1", workers=2,
                                 min_parallel_txs=2))
    assert v1._parallel is not None and v1._parallel.min_parallel_txs == 2
    v0 = texec.BlockExecutor(None, None, None, None,
                             exec_config=SimpleNamespace(version="v0"))
    assert v0._parallel is None
    params = ConsensusParams(validator=ValidatorParams(["ed25519",
                                                        "bls12381"]))
    with pytest.raises(ValueError, match="proof of possession"):
        texec.validate_validator_updates(
            [tabci.ValidatorUpdate("bls12381", b"\x01" * 96, 5)], params)


# -- mirrors of tests/test_store_state.py ------------------------------------

def test_db_prefix_iteration():
    base = tdb.MemDB()
    buf = tdb.BufferedDB(base)
    for db in (tdb.MemDB(), buf):
        db.set(b"a:1", b"x")
        db.set(b"a:2", b"y")
        db.set(b"b:1", b"z")
        assert [k for k, _ in db.iterate_prefix(b"a:")] == [b"a:1", b"a:2"]
        assert [k for k, _ in db.iterate(reverse=True)][0] == b"b:1"
        db.write_batch([(b"c:1", b"w")], [b"a:1"])
        assert db.get(b"a:1") is None and db.get(b"c:1") == b"w"
    buf.set(b"a:3", b"q")
    assert base.get(b"a:3") is None and buf.pending() > 0
    buf.flush()
    assert [k for k, _ in base.iterate_prefix(b"a:")] == [b"a:2", b"a:3"]
    assert base.get(b"c:1") == b"w" and buf.pending() == 0
    assert tdb._prefix_end(b"a\xff") == b"b"
    assert tdb._prefix_end(b"\xff\xff") is None


@pytest.fixture
def chain(env, monkeypatch):
    """One validator, the plain kvstore app, the port's host verify route
    (its device route is held against the JAX package above)."""
    monkeypatch.setenv("TMTPU_BATCH_BACKEND", "host")
    return _Chain(T, [b"\x11" * 32], app=tkv.KVStoreApplication())


def _commit_for(c, block, parts):
    priv = tcrypto.Ed25519PrivKey.generate(b"\x11" * 32)
    bid = TBlockID(block.hash(), parts.header())
    ts = block.header.time_ns + 1
    val = c.state.validators.validators[0]
    sb = tsign_bytes(CHAIN_ID, SignedMsgType.PRECOMMIT, block.header.height,
                     0, bid, ts)
    return TCommit(block.header.height, 0, bid,
                   [TCommitSig(BlockIDFlag.COMMIT, val.address, ts,
                               priv.sign(sb))])


def test_apply_blocks_and_stores(chain):
    c = chain
    last = TCommit(0, 0, TBlockID(), [])
    for h in range(1, 4):
        block, parts = c.propose(h, [f"k{h}=v{h}".encode()], last)
        c.apply(block, parts, TBlockID)
        last = _commit_for(c, block, parts)
        c.block_store.save_block(block, parts, last)
    assert c.state.last_block_height == 3 and c.app.height == 3
    assert c.app.state == {"k1": "v1", "k2": "v2", "k3": "v3"}
    assert c.state.app_hash == (3).to_bytes(8, "big")
    bs = c.block_store
    assert bs.height() == 3 and bs.base() == 1
    blk2 = bs.load_block(2)
    assert blk2 is not None and blk2.data.txs == [b"k2=v2"]
    assert bs.load_block_by_hash(blk2.hash()).header.height == 2
    assert bs.load_seen_commit(3) is not None
    assert bs.load_block_commit(2).height == 2
    st2 = c.state_store.load()
    assert st2.last_block_height == 3
    assert st2.validators.hash() == c.state.validators.hash()
    assert c.state_store.load_validators(2) is not None
    resp = c.state_store.load_abci_responses(2)
    assert len(resp.deliver_txs) == 1 and resp.deliver_txs[0].is_ok()


def test_validate_block_rejects_wrong_app_hash(chain):
    c = chain
    block, _ = c.propose(1, [b"a=b"], TCommit(0, 0, TBlockID(), []))
    block.header.app_hash = b"\x01" * 8
    block.header.data_hash = b""
    block.fill_header()
    with pytest.raises(ValueError, match="AppHash"):
        c.executor.validate_block(c.state, block)


def test_block_store_prune(chain):
    c = chain
    last = TCommit(0, 0, TBlockID(), [])
    for h in range(1, 6):
        block, parts = c.propose(h, [], last)
        c.apply(block, parts, TBlockID)
        last = _commit_for(c, block, parts)
        c.block_store.save_block(block, parts, last)
    assert c.block_store.prune_blocks(4) == 3
    assert c.block_store.base() == 4
    assert c.block_store.load_block(2) is None
    assert c.block_store.load_block(5) is not None
    c.state_store.prune_states(4)
    assert c.state_store.load_abci_responses(3) is None
    assert c.state_store.load_validators(4) is not None


def test_kvstore_validator_update_tx(chain):
    c = chain
    pub = tcrypto.Ed25519PrivKey.generate(b"\x22" * 32).pub_key().bytes()
    block, parts = c.propose(1, [f"val:{pub.hex()}!7".encode()],
                             TCommit(0, 0, TBlockID(), []))
    c.apply(block, parts, TBlockID)
    assert c.state.next_validators.size() == 2
    assert c.state.validators.size() == 1


# -- mirrors of tests/test_part_set_evidence.py ------------------------------

def test_part_set_roundtrip_and_tamper():
    data = np.random.default_rng(5).bytes(250_000)  # 4 parts of 64 KiB
    ps = TPartSet.from_data(data)
    assert ps.total == 4 and ps.is_complete()
    ps2 = TPartSet.from_header(ps.header())
    for i in range(ps.total):
        assert ps2.add_part(ps.get_part(i))
    assert ps2.get_reader() == data
    assert ps2.add_part(ps.get_part(0)) is False
    p = ps.get_part(1)
    got = TPart.decode(p.encode())
    assert got.index == 1 and got.bytes_ == p.bytes_
    assert got.proof.compute_root() == ps.hash()
    ps3 = TPartSet.from_header(ps.header())
    bad = TPart(0, ps.get_part(0).bytes_[:-1] + b"\x00",
                ps.get_part(0).proof)
    with pytest.raises(ValueError, match="invalid proof"):
        ps3.add_part(bad)


def test_part_set_and_evidence_match_jax():
    from tendermint_tpu.types.part_set import PartSet as JPartSet
    from tendermint_tpu.types.validator import new_validator
    from tendermint_tpu.types.validator_set import ValidatorSet

    data = np.random.default_rng(6).bytes(140_000)
    jps, tps = JPartSet.from_data(data), TPartSet.from_data(data)
    assert tps.header().encode() == jps.header().encode()
    for i in range(jps.total):
        assert tps.get_part(i).encode() == jps.get_part(i).encode()
    privs = [jcrypto.Ed25519PrivKey.generate(_seed(i)) for i in range(3)]
    vs = ValidatorSet([new_validator(p.pub_key(), 10) for p in privs])
    ev = _duplicate_vote(vs, {p.pub_key().address(): p for p in privs}, 10)
    (got,) = tev.decode_evidence_list(jev.encode_evidence_list([ev]))
    got.validate_basic()
    assert got.hash() == ev.hash()
    assert tev.encode_evidence_list([got]) == jev.encode_evidence_list([ev])
    assert tev.evidence_list_hash([got]) == jev.evidence_list_hash([ev])
    assert got.vote_a.block_id.key() < got.vote_b.block_id.key()
    abci_ev = texec.ev_to_abci(got)
    assert (abci_ev.type, abci_ev.height, abci_ev.total_voting_power) == \
        ("DUPLICATE_VOTE", 10, 30)


def test_abci_responses_json_roundtrip():
    resp = tstore.ABCIResponses(
        deliver_txs=[tabci.ResponseDeliverTx(code=0, data=b"\x01",
                                             gas_used=1)],
        end_block=tabci.ResponseEndBlock(validator_updates=[
            tabci.ValidatorUpdate("ed25519", b"\x02" * 32, 7)]),
        begin_block=tabci.ResponseBeginBlock())
    back = tstore.ABCIResponses.from_json(resp.to_json())
    assert back == resp
    assert back.results_hash() == resp.results_hash()
    assert os.environ.get("TMTPU_MERKLE_FAST") is None
