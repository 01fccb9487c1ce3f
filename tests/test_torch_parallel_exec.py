"""The port's optimistic parallel block execution (state/parallel.py, the
kvstore's speculation protocol, ``execution.version`` "v1") against its
own serial spec and the JAX package.

Mirrors all 19 tests of tests/test_parallel_exec.py on the port. Every
parity check runs the SAME block through four rigs, v0 and v1 in each
package, and asserts the persisted ABCIResponses JSON, app hash,
last_results_hash and final app state are equal across all four. The
file ends with a differential replay of a seeded multi-height chain whose
blocks carry cross-group conflicts (binary values on keys that plain txs
also write): v1 speculates, re-executes, and lands on the JAX package's
app hashes. Nothing here launches a kernel: the one validator's LastCommit
verifies on the host route.
"""

import threading
import time

import pytest

from tendermint_tpu import crypto as jcrypto
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.config import ExecutionConfig as JExecutionConfig
from tendermint_tpu.libs.db import MemDB as JMemDB
from tendermint_tpu.proxy import AppConns as JAppConns
from tendermint_tpu.proxy import local_client_creator as jlocal_creator
from tendermint_tpu.state import BlockExecutor as JBlockExecutor
from tendermint_tpu.state import StateStore as JStateStore
from tendermint_tpu.state import state_from_genesis as jstate_from_genesis
from tendermint_tpu.state.execution import EmptyEvidencePool as JEmptyEvPool
from tendermint_tpu.state.execution import NoOpMempool as JNoOpMempool
from tendermint_tpu.store import BlockStore as JBlockStore
from tendermint_tpu import types as jtypes
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu_torch import crypto
from tendermint_tpu_torch import device
from tendermint_tpu_torch import types as ttypes
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.example.kvstore import (KVStoreApplication,
                                                       MerkleKVStoreApplication)
from tendermint_tpu_torch.config import ExecutionConfig
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.faults import faults
from tendermint_tpu_torch.mempool.ingest import conflict_hint, make_signed_tx
from tendermint_tpu_torch.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                        state_from_genesis)
from tendermint_tpu_torch.state.execution import (EmptyEvidencePool,
                                                  NoOpMempool)
from tendermint_tpu_torch.state.parallel import (SpecView, TxLog,
                                                 conflict_closure,
                                                 conflict_groups)
from tendermint_tpu_torch.store import BlockStore
from tendermint_tpu_torch.types import (BlockID, GenesisDoc, GenesisValidator,
                                        MockPV, SignedMsgType, Vote, VoteSet)
from tendermint_tpu_torch.types import events as tme
from tendermint_tpu_torch.types.block import Commit

CHAIN_ID = "parallel-test"

SENDERS = [crypto.Ed25519PrivKey.generate(bytes([i]) * 32) for i in range(1, 9)]
VAL_KEYS = [crypto.Ed25519PrivKey.generate(bytes([100 + i]) * 32)
            for i in range(6)]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    # one validator: its LastCommits verify on the host route in both
    # packages (they read the same variable)
    monkeypatch.setenv("TMTPU_BATCH_BACKEND", "host")
    faults.reset()
    fail.reset()
    yield
    faults.reset()
    fail.reset()
    device.set_default_device(None)


#: the JAX package's twins of the port names a rig needs
_JAX = dict(crypto=jcrypto, MockPV=jtypes.MockPV, GenesisDoc=jtypes.GenesisDoc,
            GenesisValidator=jtypes.GenesisValidator,
            state_from_genesis=jstate_from_genesis, AppConns=JAppConns,
            local_client_creator=jlocal_creator, StateStore=JStateStore,
            MemDB=JMemDB, BlockExecutor=JBlockExecutor,
            NoOpMempool=JNoOpMempool, EmptyEvidencePool=JEmptyEvPool,
            BlockStore=JBlockStore, ExecutionConfig=JExecutionConfig,
            Commit=JCommit, BlockID=jtypes.BlockID, types=jtypes,
            apps={MerkleKVStoreApplication: jkv.MerkleKVStoreApplication,
                  KVStoreApplication: jkv.KVStoreApplication})
_PORT = dict(crypto=crypto, MockPV=MockPV, GenesisDoc=GenesisDoc,
             GenesisValidator=GenesisValidator,
             state_from_genesis=state_from_genesis, AppConns=AppConns,
             local_client_creator=local_client_creator, StateStore=StateStore,
             MemDB=MemDB, BlockExecutor=BlockExecutor,
             NoOpMempool=NoOpMempool, EmptyEvidencePool=EmptyEvidencePool,
             BlockStore=BlockStore, ExecutionConfig=ExecutionConfig,
             Commit=Commit, BlockID=BlockID, types=ttypes, apps=None)


def _rig(version, app_cls=MerkleKVStoreApplication, workers=4,
         min_parallel_txs=2, ns=None):
    n = ns or _PORT
    pv = n["MockPV"](n["crypto"].Ed25519PrivKey.generate(b"\x11" * 32))
    genesis = n["GenesisDoc"](
        chain_id=CHAIN_ID, genesis_time_ns=1_700_000_000_000_000_000,
        validators=[n["GenesisValidator"](pv.get_pub_key(), 10)])
    state = n["state_from_genesis"](genesis)
    app = (n["apps"][app_cls] if n["apps"] else app_cls)()
    conns = n["AppConns"](n["local_client_creator"](app))
    conns.start()
    ss = n["StateStore"](n["MemDB"]())
    ss.save(state)
    ex = n["BlockExecutor"](ss, conns.consensus, n["NoOpMempool"](),
                            n["EmptyEvidencePool"](),
                            n["BlockStore"](n["MemDB"]()),
                            exec_config=n["ExecutionConfig"](
                                version=version, workers=workers,
                                min_parallel_txs=min_parallel_txs))
    return pv, state, ex, ss, app


def _apply_one(version, txs, app_cls=MerkleKVStoreApplication, ns=None):
    """Apply one block of `txs` at height 1; return the parity tuple."""
    n = ns or _PORT
    pv, state, ex, ss, app = _rig(version, app_cls, ns=ns)
    proposer = state.validators.get_proposer().address
    block, parts = state.make_block(1, txs, n["Commit"](0, 0, n["BlockID"](),
                                                         []), [], proposer)
    bid = n["BlockID"](block.hash(), parts.header())
    state, _ = ex.apply_block(state, bid, block)
    return (ss.load_abci_responses(1).to_json(), state.app_hash,
            state.last_results_hash, dict(app.state), app.tx_count,
            dict(app.validators)), ex


def assert_parity(txs, app_cls=MerkleKVStoreApplication):
    serial, _ = _apply_one("v0", txs, app_cls)
    parallel, ex = _apply_one("v1", txs, app_cls)
    assert serial == parallel
    # the txs are bytes: the JAX package takes the very same block body
    jparallel, jex = _apply_one("v1", txs, app_cls, ns=_JAX)
    assert jparallel == parallel
    assert (jex._parallel.last_groups, jex._parallel.last_conflicted) == \
        (ex._parallel.last_groups, ex._parallel.last_conflicted)
    return ex._parallel

# -- differential suite ------------------------------------------------------


def test_parity_disjoint_senders():
    txs = [make_signed_tx(SENDERS[i % 8], f"s{i}=v{i}".encode(), nonce=i)
           for i in range(32)]
    p = assert_parity(txs)
    assert p.last_groups == 8
    assert p.last_conflicted == 0


def test_parity_same_key_conflict_storm():
    # every tx writes the same key: one giant group, strictly serial order
    txs = [f"hot=v{i}".encode() for i in range(40)]
    p = assert_parity(txs)
    assert p.last_groups == 1


def test_parity_val_txs_crossing_groups():
    # validator updates interleaved with kv writes; each val pubkey distinct
    # (duplicate addresses in one block are rejected by update validation)
    txs = []
    for i, vk in enumerate(VAL_KEYS[:4]):
        txs.append(f"val:{vk.pub_key().bytes().hex()}!{i + 1}".encode())
        txs.append(f"k{i}=x".encode())
        txs.append(make_signed_tx(SENDERS[i], f"w{i}=y".encode(), nonce=i))
    assert_parity(txs)


def test_parity_unparseable_barrier_groups():
    txs = [b"a=1", bytes([0xff, 0xfe, 1]), b"b=2", b"val:zznothex!5",
           b"c=3", bytes(6), b"noequals", b"d=4"]
    assert_parity(txs)


def test_parity_mixed_seeded_workload():
    import random
    rng = random.Random(3)
    vals = iter(VAL_KEYS)
    txs = []
    for i in range(50):
        r = rng.random()
        if r < 0.4:
            sk = SENDERS[rng.randrange(8)]
            txs.append(make_signed_tx(sk, f"s{i}=v{rng.random()}".encode(),
                                      nonce=i))
        elif r < 0.7:
            txs.append(f"shared{rng.randrange(5)}=x{i}".encode())
        elif r < 0.76:
            try:
                pk = next(vals).pub_key()
                txs.append(f"val:{pk.bytes().hex()}!{rng.randrange(1, 20)}"
                           .encode())
            except StopIteration:
                txs.append(f"v{i}=z".encode())
        elif r < 0.9:
            txs.append(bytes([rng.randrange(256) for _ in range(12)]))
        else:
            txs.append(b"val:zznothex!5")
    rng.shuffle(txs)
    assert_parity(txs)


def test_parity_exec_conflict_fault_forces_reexec():
    """exec.conflict mis-assigns txs to chaos lanes; validation + serial
    re-exec must still land on the exact serial bytes."""
    txs = [f"val:{VAL_KEYS[0].pub_key().bytes().hex()}!7".encode(), b"q=1",
           make_signed_tx(SENDERS[0], b"w=2", nonce=0),
           b"val:zznothex!5", bytes([250, 251, 1]),
           f"val:{VAL_KEYS[1].pub_key().bytes().hex()}!9".encode(), b"q=2"]
    serial, _ = _apply_one("v0", txs)
    faults.configure("exec.conflict", seed=5)
    try:
        parallel, ex = _apply_one("v1", txs)
    finally:
        faults.reset()
    assert serial == parallel
    assert ex._parallel.last_conflicted > 0  # the fault actually bit
    # the JAX package's site, seeded alike, perturbs the same lanes
    from tendermint_tpu.libs.faults import faults as jfaults
    jfaults.configure("exec.conflict", seed=5)
    try:
        jparallel, jex = _apply_one("v1", txs, ns=_JAX)
    finally:
        jfaults.reset()
    assert jparallel == parallel
    assert jex._parallel.last_conflicted == ex._parallel.last_conflicted


def test_parity_plain_kvstore_app():
    # the non-merkle kvstore takes the same speculation protocol
    txs = [f"k{i % 5}=v{i}".encode() for i in range(20)]
    assert_parity(txs, app_cls=KVStoreApplication)


def test_parity_multi_height():
    """3 heights through both rigs; app hash chains forward identically."""
    outs = {}
    for version in ("v0", "v1"):
        pv, state, ex, ss, app = _rig(version)
        last_commit = Commit(0, 0, BlockID(), [])
        for h in range(1, 4):
            proposer = state.validators.get_proposer().address
            txs = ([f"h{h}k{i % 3}=v{i}".encode() for i in range(8)]
                   + [make_signed_tx(SENDERS[i], f"sh{h}={i}".encode(),
                                     nonce=h * 10 + i) for i in range(4)])
            block, parts = state.make_block(h, txs, last_commit, [], proposer)
            bid = BlockID(block.hash(), parts.header())
            state, _ = ex.apply_block(state, bid, block)
            vs = VoteSet(state.chain_id, h, 0, SignedMsgType.PRECOMMIT,
                         state.validators)
            v = Vote(SignedMsgType.PRECOMMIT, h, 0, bid,
                     block.header.time_ns + 1,
                     state.validators.validators[0].address, 0)
            pv.sign_vote(state.chain_id, v)
            vs.add_vote(v)
            last_commit = vs.make_commit()
        outs[version] = (state.app_hash, state.last_results_hash,
                         dict(app.state), app.tx_count,
                         [ss.load_abci_responses(h).to_json()
                          for h in range(1, 4)])
    assert outs["v0"] == outs["v1"]


# -- conflict machinery units ------------------------------------------------


def test_conflict_hint_classes():
    sk = SENDERS[0]
    assert conflict_hint(make_signed_tx(sk, b"a=1", nonce=0)) == \
        ("sender", sk.pub_key().bytes().hex())
    assert conflict_hint(b"a=1") == ("key", "a")
    assert conflict_hint(b"noequals") == ("key", "noequals")
    assert conflict_hint(bytes([0xff, 0xfe])) == ("barrier", "")
    assert conflict_hint(b"val:aa!1") == ("barrier", "")


def test_conflict_groups_preserve_block_order():
    txs = [b"a=1", b"b=1", b"a=2", b"c=1", b"b=2"]
    assert conflict_groups(txs) == [[0, 2], [1, 4], [3]]


def _log(idx, keys):
    log = TxLog(idx)
    log.keys = set(keys)
    return log


def test_conflict_closure_fixpoint():
    # key a is cross-group -> every a-toucher conflicts; their OTHER keys
    # (b via tx 2, c via tx 3) join the closure and drag tx 1 in too;
    # group 2's private key d stays clean
    logs = [_log(0, {("kv", "a")}),
            _log(1, {("kv", "b")}),
            _log(2, {("kv", "a"), ("kv", "b")}),
            _log(3, {("kv", "a"), ("kv", "c")}),
            _log(4, {("kv", "d")})]
    group_of = {0: 0, 1: 1, 2: 1, 3: 0, 4: 2}
    ct, ck = conflict_closure(logs, group_of)
    assert ct == {0, 1, 2, 3}
    assert {("kv", "a"), ("kv", "b"), ("kv", "c")} <= ck
    assert 4 not in ct and ("kv", "d") not in ck


def test_spec_view_read_through_and_overlay():
    class FakeApp:
        def spec_read(self, space, key):
            return "base" if (space, key) == ("kv", "a") else None

    view = SpecView(FakeApp())
    view.begin_tx(0)
    assert view.read("kv", "a") == "base"
    view.write("kv", "a", "new")
    assert view.read("kv", "a") == "new"
    assert ("kv", "a") in view.logs[0].keys
    assert ("set", "kv", "a", "new", None) in view.logs[0].ops


# -- fallback gating ---------------------------------------------------------


def test_small_block_falls_back_to_serial():
    pv, state, ex, ss, app = _rig("v1", min_parallel_txs=10)
    proposer = state.validators.get_proposer().address
    block, parts = state.make_block(1, [b"a=1", b"b=2"],
                                    Commit(0, 0, BlockID(), []), [], proposer)
    bid = BlockID(block.hash(), parts.header())
    state, _ = ex.apply_block(state, bid, block)
    assert app.state == {"a": "1", "b": "2"}
    assert ex._parallel.last_groups == 0  # never speculated


def test_unsupported_app_falls_back():
    class NoSpecApp(Application):
        """parallel_exec_supported stays False."""

        def __init__(self):
            self.seen = []

        def deliver_tx(self, req):
            self.seen.append(req.tx)
            return abci.ResponseDeliverTx(code=0)

    pv, state, ex, ss, app = _rig("v1", app_cls=NoSpecApp)
    proposer = state.validators.get_proposer().address
    txs = [f"t{i}".encode() for i in range(8)]
    block, parts = state.make_block(1, txs, Commit(0, 0, BlockID(), []),
                                    [], proposer)
    bid = BlockID(block.hash(), parts.header())
    state, _ = ex.apply_block(state, bid, block)
    assert app.seen == txs  # serial path ran, in order


def test_v0_never_builds_parallel_executor():
    _, _, ex, _, _ = _rig("v0")
    assert ex._parallel is None


# -- ordering contract (state/store.py ABCIResponses) ------------------------


def test_response_ordering_contract():
    """deliver_txs[i] answers block.data.txs[i], and EventDataTx fires in
    index order — under parallel execution with cross-group conflicts."""
    txs = [f"k{i % 3}=v{i}".encode() for i in range(12)]  # 3 colliding lanes
    pv, state, ex, ss, app = _rig("v1")
    from tendermint_tpu_torch.types.event_bus import EventBus, EventDataTx
    bus = EventBus()
    ex.event_bus = bus
    sub = bus.subscribe("order-test", tme.QUERY_TX)
    proposer = state.validators.get_proposer().address
    block, parts = state.make_block(1, txs, Commit(0, 0, BlockID(), []),
                                    [], proposer)
    bid = BlockID(block.hash(), parts.header())
    state, _ = ex.apply_block(state, bid, block)

    resp = ss.load_abci_responses(1)
    assert len(resp.deliver_txs) == len(txs)
    for i, r in enumerate(resp.deliver_txs):
        # kvstore tags each response with the tx's own key attribute
        attrs = {a.key: a.value for ev in r.events for a in ev.attributes}
        assert attrs[b"key"] == txs[i].split(b"=", 1)[0]

    seen = []
    while not sub.queue.empty():
        msg = sub.queue.get_nowait()
        if isinstance(msg.data, EventDataTx):
            seen.append((msg.data.index, msg.data.tx))
    assert seen == [(i, tx) for i, tx in enumerate(txs)]


# -- proxy lock split --------------------------------------------------------


def test_query_does_not_block_on_consensus_apply():
    """A query on the query connection completes while a slow deliver_tx
    holds the consensus (writer) lock."""
    gate = threading.Event()

    class SlowApp(KVStoreApplication):
        parallel_exec_supported = False  # force the serial locked path

        def deliver_tx(self, req):
            gate.wait(timeout=5.0)
            return super().deliver_tx(req)

    app = SlowApp()
    conns = AppConns(local_client_creator(app))
    conns.start()
    app.state["probe"] = "1"

    done = threading.Event()

    def writer():
        conns.consensus.deliver_tx(abci.RequestDeliverTx(tx=b"x=1"))
        done.set()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    time.sleep(0.05)  # writer is now parked inside deliver_tx
    t0 = time.monotonic()
    res = conns.query.query(abci.RequestQuery(data=b"probe", path="/store"))
    elapsed = time.monotonic() - t0
    gate.set()
    t.join(timeout=5.0)
    assert done.is_set()
    assert res.value == b"1"
    assert elapsed < 1.0  # returned while the writer still held its lock


def test_zero_arg_creator_still_works():
    app = KVStoreApplication()
    calls = []

    def creator():
        from tendermint_tpu_torch.abci.client import LocalClient
        calls.append(1)
        return LocalClient(app, threading.RLock())

    conns = AppConns(creator)
    conns.start()
    assert len(calls) == 4
    assert conns.query.echo("hi") == "hi"


# -- crash mid-parallel-apply ------------------------------------------------


def test_crash_at_before_exec_block_parallel_replays_identically():
    """Kill at execution.before_exec_block under v1, then recover: replaying
    the same block lands on the exact bytes the serial spec produces."""
    txs = [f"k{i % 4}=v{i}".encode() for i in range(16)]
    serial, _ = _apply_one("v0", txs)

    pv, state, ex, ss, app = _rig("v1")
    proposer = state.validators.get_proposer().address
    block, parts = state.make_block(1, txs, Commit(0, 0, BlockID(), []),
                                    [], proposer)
    bid = BlockID(block.hash(), parts.header())
    fail.arm_raise("execution.before_exec_block")
    with pytest.raises(fail.KilledAtFailPoint):
        ex.apply_block(state, bid, block)
    assert fail.killed_at() == "execution.before_exec_block"
    # nothing durable happened: no responses, app untouched
    assert ss.load_abci_responses(1) is None
    assert app.tx_count == 0

    # recovery: a fresh executor (same stores/app — the kill fired before
    # any app mutation) replays the block to the exact serial bytes
    state2, _ = ex.apply_block(state, bid, block)
    got = (ss.load_abci_responses(1).to_json(), state2.app_hash,
           state2.last_results_hash, dict(app.state), app.tx_count,
           dict(app.validators))
    assert got == serial


# -- differential replay ------------------------------------------------------


def _conflicting_txs(h):
    """A block whose groups collide: one tx in eight puts a value that is
    not UTF-8 (a barrier-group tx) on a key that a plain tx also writes."""
    import random

    rng = random.Random(h)
    txs = []
    for i in range(32):
        if i % 8 == 7:
            txs.append(b"h%d-k%02d=\xff%c" % (h, i - 7, 0x80 + i))
        elif i % 8 == 3:
            txs.append(make_signed_tx(SENDERS[i % 8], b"s%d=%d" % (h, i),
                                      nonce=h * 100 + i))
        else:
            txs.append(b"h%d-k%02d=%08x" % (h, i, rng.getrandbits(32)))
    return txs


def _chain_hashes(ns, version, heights=4):
    n = ns or _PORT
    pv, state, ex, ss, app = _rig(version, ns=ns)
    last_commit = n["Commit"](0, 0, n["BlockID"](), [])
    out, conflicted = [], []
    T = n["types"]
    for h in range(1, heights + 1):
        proposer = state.validators.get_proposer().address
        block, parts = state.make_block(h, _conflicting_txs(h), last_commit,
                                        [], proposer)
        bid = n["BlockID"](block.hash(), parts.header())
        prev = state.validators
        state, _ = ex.apply_block(state, bid, block)
        out.append((state.app_hash, state.last_results_hash,
                    ss.load_abci_responses(h).to_json()))
        if ex._parallel is not None:
            conflicted.append(ex._parallel.last_conflicted)
        vs = T.VoteSet(CHAIN_ID, h, 0, T.SignedMsgType.PRECOMMIT, prev)
        v = T.Vote(T.SignedMsgType.PRECOMMIT, h, 0, bid,
                   block.header.time_ns + 1, prev.validators[0].address, 0)
        pv.sign_vote(CHAIN_ID, v)
        vs.add_vote(v)
        last_commit = vs.make_commit()
    return out, conflicted


def test_v1_replay_matches_jax_app_hashes():
    """Four heights of conflicting blocks: the port's v1 re-executes the
    conflicts (every height) and every app hash, results hash and response
    list equals the JAX package's v1 and v0 and the port's v0."""
    port_v1, conflicted = _chain_hashes(None, "v1")
    assert all(c >= 8 for c in conflicted), conflicted
    assert port_v1 == _chain_hashes(None, "v0")[0]
    jax_v1, jconflicted = _chain_hashes(_JAX, "v1")
    assert jax_v1 == port_v1
    assert jconflicted == conflicted
    assert _chain_hashes(_JAX, "v0")[0] == port_v1
