"""The port's fast sync (tendermint_tpu_torch/blockchain/: pool, wire
messages, the windowed two-plane reactor) against the JAX package's.

* the cases of tests/test_block_sync.py that need no net (:91, :103,
  :124, :132, :148, :173, :295) on the port; the wire bytes of every
  message equal the JAX package's on a block carried across by
  ``convert.block_from_reference``;
* a differential replay: one seeded 4-validator chain, built and signed by
  the JAX package, replayed from a fresh node through both reactors (the
  JAX one on its host route, the port on its ``cuda`` route, which on the
  CPU runs the verify kernels' plain PyTorch versions) gives equal
  per-height app, results and validators hashes and an equal outcome list
  for each window; a tampered block gives the same redo height and the
  same struck peers;
* the port's device-fault rules (the reactor's module docstring), driven
  through its pool routine with ``device.batch_verify`` armed: a fault
  strikes nobody and redoes nothing, ``KernelUnavailable`` reaches
  ``on_fatal`` at once, and three consecutive window faults reach it too.
"""

import asyncio
import os
import random
from types import SimpleNamespace

import pytest
import torch

import tendermint_tpu.blockchain.reactor as JR
import tendermint_tpu.crypto as jcrypto
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.blockchain import msgs as jmsgs
from tendermint_tpu.libs import db as jdb
from tendermint_tpu import proxy as jproxy
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state import state as jstate
from tendermint_tpu.state import store as jstore
from tendermint_tpu.store import block_store as jbs
from tendermint_tpu.types import genesis as jgen
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvote_set
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import SignedMsgType as JMsg
from tendermint_tpu.types.block import Block as JBlock
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.priv_validator import MockPV as JMockPV
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.abci.example import kvstore as tkv
from tendermint_tpu_torch.blockchain import BlockPool
from tendermint_tpu_torch.blockchain import msgs as tmsgs
from tendermint_tpu_torch.blockchain import reactor as TR
from tendermint_tpu_torch.crypto import Ed25519PubKey as TEd25519PubKey
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs import db as tdb
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
from tendermint_tpu_torch.p2p import BLOCKCHAIN_CHANNEL
from tendermint_tpu_torch import proxy as tproxy
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.state import state as tstate
from tendermint_tpu_torch.state import store as tstore
from tendermint_tpu_torch.store import block_store as tbs
from tendermint_tpu_torch.types import genesis as tgen
from tendermint_tpu_torch.types.basic import BlockID as TBlockID
from tendermint_tpu_torch.types.errors import ErrWrongSignature
from tendermint_tpu_torch.types.validator_set import \
    verify_commit_light_batched as tbatched

from tests.test_torch_light import _KNOBS, reset_port, routed

CHAIN_ID = "torch-sync-chain"
GENESIS_NS = 1_700_000_000_000_000_000
N_VALS = 4
N_BLOCKS = 20          # served; the last carries the commit of the one before
TAMPER_AT = 6          # its LastCommit (the commit of 5) gets a flipped bit

J = SimpleNamespace(kv=jkv, db=jdb, proxy=jproxy, exe=jexec, st=jstate,
                    store=jstore, bs=jbs, gen=jgen, R=JR, BlockID=JBlockID)
T = SimpleNamespace(kv=tkv, db=tdb, proxy=tproxy, exe=texec, st=tstate,
                    store=tstore, bs=tbs, gen=tgen, R=TR, BlockID=TBlockID)


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    tbatch.set_crypto_metrics(None)
    device.set_default_device(None)


# -- the JAX-built source chain (built once) ---------------------------------

_PVS = [JMockPV(jcrypto.Ed25519PrivKey.generate(bytes([0x51 + i]) * 32))
        for i in range(N_VALS)]


def _genesis(ns):
    pubs = [pv.get_pub_key() for pv in _PVS]
    if ns is T:
        pubs = [TEd25519PubKey(p.bytes()) for p in pubs]
    return ns.gen.GenesisDoc(
        chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
        validators=[ns.gen.GenesisValidator(p, 10) for p in pubs])


def _txs(h):
    """16 kvstore txs; one in eight writes a key another tx of the block
    also writes, with a value that is not UTF-8."""
    rng = random.Random(h)
    out = [b"h%d-k%02d=%08x" % (h, i, rng.getrandbits(32)) for i in range(14)]
    out += [b"h%d-k00=\xff\xfe" % h, b"h%d-k01=\xfe" % h]
    return out


_SOURCE = {}


def source():
    """{"blocks": {h: JAX Block}, "hashes": {h: (app, results, vals)}}."""
    if _SOURCE:
        return _SOURCE
    old = os.environ.get("TMTPU_BATCH_BACKEND")
    os.environ["TMTPU_BATCH_BACKEND"] = "host"
    try:
        state, execu, _bs, conns = fresh_node(J)
        blocks, hashes = {}, {}
        last_commit = JCommit(0, 0, JBlockID(), [])
        for h in range(1, N_BLOCKS + 1):
            proposer = state.validators.get_proposer().address
            block, parts = state.make_block(h, _txs(h), last_commit, [],
                                            proposer)
            bid = JBlockID(block.hash(), parts.header())
            prev_vals = state.validators
            state, _ = execu.apply_block(state, bid, block)
            hashes[h] = _hashes(state)
            vs = jvote_set.VoteSet(CHAIN_ID, h, 0, JMsg.PRECOMMIT, prev_vals)
            for i, v in enumerate(prev_vals.validators):
                pv = next(p for p in _PVS
                          if p.get_pub_key().address() == v.address)
                vote = jvote.Vote(JMsg.PRECOMMIT, h, 0, bid,
                                  block.header.time_ns + 1 + i, v.address, i)
                pv.sign_vote(CHAIN_ID, vote)
                assert vs.add_vote(vote)
            last_commit = vs.make_commit()
            blocks[h] = block
        conns.stop()
    finally:
        if old is None:
            os.environ.pop("TMTPU_BATCH_BACKEND", None)
        else:
            os.environ["TMTPU_BATCH_BACKEND"] = old
    _SOURCE.update(blocks=blocks, hashes=hashes)
    return _SOURCE


def _hashes(state):
    return (state.app_hash, state.last_results_hash,
            state.validators.hash())


def port_blocks():
    """The source's blocks carried across (fresh objects every call: the
    replays memoize on block instances)."""
    return {h: convert.block_from_reference(b.encode())
            for h, b in source()["blocks"].items()}


def jax_blocks():
    return {h: JBlock.decode(b.encode())
            for h, b in source()["blocks"].items()}


def fresh_node(ns):
    app = ns.kv.KVStoreApplication()
    conns = ns.proxy.AppConns(ns.proxy.local_client_creator(app))
    conns.start()
    state = ns.st.state_from_genesis(_genesis(ns))
    state_store = ns.store.StateStore(ns.db.MemDB())
    state_store.save(state)
    block_store = ns.bs.BlockStore(ns.db.MemDB())
    execu = ns.exe.BlockExecutor(state_store, conns.consensus,
                                 ns.exe.NoOpMempool(),
                                 ns.exe.EmptyEvidencePool(), block_store)
    return state, execu, block_store, conns


class Replay:
    """A fresh node's reactor on ``ns`` with every applied height's hashes,
    every window's outcomes and every redo recorded."""

    def __init__(self, ns):
        state, execu, block_store, self.conns = fresh_node(ns)
        self.reactor = r = ns.R.BlockchainReactor(state, execu, block_store,
                                                  fast_sync=True)
        r.pool = ns.R.BlockPool(1)
        self.hashes, self.windows, self.redos = {}, [], []
        apply_block = execu.apply_block

        def recorded_apply(st, bid, block):
            out = apply_block(st, bid, block)
            self.hashes[block.header.height] = _hashes(out[0])
            return out

        execu.apply_block = recorded_apply
        apply_window = r._apply_window

        async def recorded_window(prep):
            self.windows.append((prep.start_height, [
                None if e is None else (type(e).__name__, str(e))
                for e in prep.results]))
            await apply_window(prep)

        r._apply_window = recorded_window
        redo = r.pool.redo

        def recorded_redo(height):
            bad = redo(height)
            self.redos.append((height, sorted(bad)))
            return bad

        r.pool.redo = recorded_redo

    def feed(self, served):
        """Answer the requests the pool schedules from ``served`` (peer id
        -> {height: block}) until it schedules no more."""
        while True:
            reqs = self.reactor.pool.schedule_requests()
            if not reqs:
                return
            for pid, h in reqs:
                self.reactor.pool.add_block(pid, served[pid][h])

    def run(self, served, until):
        """Drive the window loop as a node's pool routine would, with every
        block downloaded first, until ``until`` blocks are applied or a
        pass applies nothing."""
        async def drive():
            r = self.reactor
            while r.blocks_synced < until:
                self.feed(served)
                before = r.blocks_synced
                await r._process_window()
                if r.blocks_synced == before:
                    return

        asyncio.run(drive())
        return self

    def close(self):
        self.conns.stop()


def _struck(reactor):
    return sorted(pid for pid, s in reactor.scoreboard.snapshot().items()
                  if s["total_failures"])


# -- pool (test_block_sync.py :91, :103, :124) --------------------------------

def test_pool_schedule_and_consume():
    pool = BlockPool(start_height=1)
    pool.set_peer_range("p1", 1, 50)
    reqs = pool.schedule_requests()
    heights = sorted(h for _pid, h in reqs)
    assert heights[0] == 1 and len(heights) <= 50
    assert all(pid == "p1" for pid, _h in reqs[:5])
    assert len(reqs) <= 16  # the per-peer pending cap
    assert pool.schedule_requests() == []


def test_pool_redo_punishes_provider():
    pool = BlockPool(start_height=1)
    pool.set_peer_range("bad", 1, 10)

    class _B:
        def __init__(self, h):
            self.header = SimpleNamespace(height=h)

    for pid, h in pool.schedule_requests():
        pool.add_block(pid, _B(h))
    assert len(pool.peek_window(5)) == 5
    assert pool.redo(1) == {"bad"}
    assert pool.peek_window(5) == []
    assert pool.schedule_requests() == []
    assert not pool.is_caught_up()


def test_pool_caught_up():
    pool = BlockPool(start_height=11)
    pool.set_peer_range("p", 1, 10)
    assert pool.is_caught_up()


# -- wire codec (:132) --------------------------------------------------------

def test_blockchain_msg_bytes_equal_jax():
    jblk = source()["blocks"][2]
    tblk = convert.block_from_reference(jblk.encode())
    assert tblk.hash() == jblk.hash()
    for jm, tm in ((jmsgs.BlockRequest(7), tmsgs.BlockRequest(7)),
                   (jmsgs.NoBlockResponse(9), tmsgs.NoBlockResponse(9)),
                   (jmsgs.StatusRequest(), tmsgs.StatusRequest()),
                   (jmsgs.StatusResponse(12, 3), tmsgs.StatusResponse(12, 3)),
                   (jmsgs.BlockResponse(jblk), tmsgs.BlockResponse(tblk))):
        wire = tmsgs.encode_msg(tm)
        assert wire == jmsgs.encode_msg(jm)
        out = tmsgs.decode_msg(wire)
        if isinstance(tm, tmsgs.BlockResponse):
            assert out.block.hash() == jblk.hash()
        else:
            assert out == tm
    with pytest.raises(ValueError):
        tmsgs.decode_msg(b"")


# -- windowed batched verification (:148, :173) --------------------------------

def _light_entries(blocks, vals):
    out = []
    for h in range(1, 11):
        blk = blocks[h]
        bid = TBlockID(blk.hash(), blk.make_part_set().header())
        out.append((vals, CHAIN_ID, bid, h, blocks[h + 1].last_commit))
    return out


def _port_vals():
    return tstate.state_from_genesis(_genesis(T)).validators


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_verify_commit_light_batched_window(backend):
    blocks = port_blocks()
    entries = _light_entries(blocks, _port_vals())
    with routed(backend):
        assert tbatched(entries) == [None] * 10
        bad = blocks[6].last_commit
        sig = bytearray(bad.signatures[0].signature)
        sig[0] ^= 1
        bad.signatures[0].signature = bytes(sig)
        results = tbatched(entries)
    assert isinstance(results[4], ErrWrongSignature)
    assert str(results[4]).startswith("wrong signature (#0)")
    assert all(r is None for i, r in enumerate(results) if i != 4)


def test_verify_commit_light_batched_device_path():
    """18 entries of 4 signatures ride one device batch (the plain
    kernels on the CPU); decisions unchanged."""
    blocks = port_blocks()
    vals = _port_vals()
    entries = []
    for h in range(1, N_BLOCKS - 1):
        blk = blocks[h]
        bid = TBlockID(blk.hash(), blk.make_part_set().header())
        entries.append((vals, CHAIN_ID, bid, h, blocks[h + 1].last_commit))
    with routed("cuda"):
        assert tbatched(entries) == [None] * len(entries)
    assert tbatch.stats["device_batches"] == 1
    assert tbatch.stats["device_sigs"] == 4 * len(entries)


# -- the window precompute (:295) ---------------------------------------------

def test_window_precompute_covers_both_planes(monkeypatch):
    """Both planes in ONE device batch a window: the light call and
    apply_block's full verify_commit hit its verdicts."""
    monkeypatch.setattr(TR, "PRECOMPUTE_MIN_SIGS", 2)
    rep = Replay(T)
    rep.reactor.pool.set_peer_range("src", 1, N_BLOCKS)
    with routed("cuda"):
        rep.run({"src": port_blocks()}, 10)
    rep.close()
    assert rep.reactor.blocks_synced >= 10
    # both planes consumed precomputed verdicts: the light batched call
    # and apply_block's per-block full verify_commit
    # (the window's light call, then applies 2-16: block 1 has none)
    assert tbatch.stats["precomputed_batches"] >= 1 + 15, dict(tbatch.stats)
    assert tbatch.stats["precomputed_sigs"] > 0


# -- differential replay -------------------------------------------------------

def _replay_both(monkeypatch, served_jax, served_port, until, setup=None):
    monkeypatch.setattr(TR, "PRECOMPUTE_MIN_SIGS", 2)
    monkeypatch.setattr(JR, "PRECOMPUTE_MIN_SIGS", 2)
    out = []
    for ns, served, backend in ((J, served_jax, "host"),
                                (T, served_port, "cuda")):
        rep = Replay(ns)
        if setup is not None:
            setup(rep, served)
        else:
            rep.reactor.pool.set_peer_range("src", 1, N_BLOCKS)
        with routed(backend):
            rep.run(served, until)
        rep.close()
        out.append(rep)
    return out


def test_replay_equals_jax_and_the_source(monkeypatch):
    jrep, trep = _replay_both(monkeypatch, {"src": jax_blocks()},
                              {"src": port_blocks()}, N_BLOCKS - 1)
    want = {h: source()["hashes"][h] for h in range(1, N_BLOCKS)}
    assert jrep.hashes == want
    assert trep.hashes == want
    assert trep.windows == jrep.windows
    assert [s for s, _ in trep.windows] == [1, 17]
    assert trep.reactor.stage_breakdown()["pipelined_windows"] == \
        jrep.reactor.stage_breakdown()["pipelined_windows"] == 1
    assert tbatch.stats["device_batches"] == 2  # one a window, both planes
    assert tbatch.stats["host_batches"] == 0


def _tampered(blocks):
    blk = blocks[TAMPER_AT]
    cs = blk.last_commit.signatures[0]
    cs.signature = cs.signature[:3] + bytes([cs.signature[3] ^ 1]) + \
        cs.signature[4:]
    return blk


def test_tampered_block_same_redo_and_struck_peers(monkeypatch):
    """``evil`` serves height 6 with a flipped LastCommit signature: both
    reactors redo the same height and strike the same peers, then finish
    from another source with the source's hashes."""
    def served(blocks_fn):
        honest = blocks_fn()
        evil = blocks_fn()
        _tampered(evil)
        return {"src": honest, "src2": blocks_fn(), "evil": evil}

    def setup(rep, srv):
        pool = rep.reactor.pool
        pool.set_peer_range("evil", TAMPER_AT, TAMPER_AT)
        rep.feed(srv)  # height 6 goes to evil alone
        pool.set_peer_range("src", 1, N_BLOCKS)

    reps = _replay_both(monkeypatch, served(jax_blocks), served(port_blocks),
                        TAMPER_AT - 2, setup)
    for rep in reps:  # after the strike: another source finishes the sync
        rep.reactor.pool.set_peer_range("src2", 1, N_BLOCKS)
    jrep, trep = reps
    assert trep.redos == jrep.redos == [(TAMPER_AT - 1, ["evil", "src"])]
    assert _struck(trep.reactor) == _struck(jrep.reactor) == ["evil", "src"]
    assert trep.windows == jrep.windows
    assert trep.windows[0][1][TAMPER_AT - 2][0] == "ErrWrongSignature"
    for ns, rep, blocks_fn, backend in ((J, jrep, jax_blocks, "host"),
                                        (T, trep, port_blocks, "cuda")):
        with routed(backend):
            rep.run({"src2": blocks_fn()}, N_BLOCKS - 1)
    assert trep.hashes == jrep.hashes == {
        h: source()["hashes"][h] for h in range(1, N_BLOCKS)}


# -- device faults: the pool routine's rules -----------------------------------

class _Peer:
    def __init__(self, pid, reactor, blocks):
        self.id, self.reactor, self.blocks = pid, reactor, blocks

    def try_send(self, channel_id, msg):
        req = tmsgs.decode_msg(msg)
        if isinstance(req, tmsgs.BlockRequest):
            resp = tmsgs.BlockResponse(self.blocks[req.height])
            asyncio.get_running_loop().create_task(self.reactor.receive(
                channel_id, self, tmsgs.encode_msg(resp)))
        return True


class _Switch:
    """One serving peer: answers status and block requests on the loop."""

    def __init__(self, reactor, blocks):
        self.peers = {"src": _Peer("src", reactor, blocks)}
        self.reactor = reactor
        self.stopped = []

    def broadcast(self, channel_id, msg):
        assert channel_id == BLOCKCHAIN_CHANNEL
        peer = self.peers["src"]
        status = tmsgs.encode_msg(tmsgs.StatusResponse(N_BLOCKS, 1))
        asyncio.get_running_loop().create_task(
            self.reactor.receive(channel_id, peer, status))

    async def stop_peer_for_error(self, peer, reason):
        self.stopped.append(peer.id)


def _routine(monkeypatch, timeout=180.0):
    """Run the port reactor's pool routine against one serving peer until
    it syncs or reaches on_fatal; -> (reactor, replay, fatal exceptions)."""
    monkeypatch.setattr(TR, "PRECOMPUTE_MIN_SIGS", 2)
    monkeypatch.setattr(TR, "SWITCH_TO_CONSENSUS_INTERVAL", 0.05)
    rep = Replay(T)
    r = rep.reactor
    fatal = []
    r.on_fatal = fatal.append
    switch = _Switch(r, port_blocks())
    r.set_switch(switch)

    async def run():
        await r.start()
        done = asyncio.ensure_future(r.synced.wait())
        t0 = asyncio.get_running_loop().time()
        while not done.done() and not fatal:
            assert asyncio.get_running_loop().time() - t0 < timeout
            await asyncio.sleep(0.01)
        done.cancel()
        await r.stop()

    with routed("cuda"):
        asyncio.run(run())
    rep.close()
    return r, rep, fatal, switch


def test_armed_device_fault_strikes_nobody(monkeypatch):
    m = CryptoMetrics(Registry())
    tbatch.set_crypto_metrics(m)
    tfaults.configure("device.batch_verify*1")
    r, rep, fatal, switch = _routine(monkeypatch)
    assert fatal == []
    assert m.device_errors_total.value("injected", "light") == 1
    assert tbatch.stats["device_errors"] == 1
    assert rep.redos == [] and _struck(r) == [] and switch.stopped == []
    assert r.metrics.sync_retries_total.value() == 0
    assert r.window_device_faults == 0  # reset by the window that applied
    synced = r.state.last_block_height
    assert synced >= N_BLOCKS - 2
    assert rep.hashes == {h: source()["hashes"][h]
                          for h in range(1, synced + 1)}


def test_kernel_unavailable_reaches_on_fatal(monkeypatch):
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, rep, fatal, _ = _routine(monkeypatch)
    assert len(fatal) == 1 and isinstance(fatal[0], KernelUnavailable)
    assert r.window_device_faults == 1
    assert rep.redos == [] and _struck(r) == [] and r.blocks_synced == 0
    # the window's blocks stay in the pool
    assert r.pool.height == 1 and len(r.pool.peek_window(2)) == 2


def test_three_window_faults_reach_on_fatal(monkeypatch):
    tfaults.configure("device.batch_verify")
    r, rep, fatal, _ = _routine(monkeypatch)
    assert len(fatal) == 1 and isinstance(fatal[0], InjectedFault)
    assert r.window_device_faults == TR.MAX_WINDOW_DEVICE_FAULTS == 3
    assert tbatch.stats["device_errors"] == 3
    assert rep.redos == [] and _struck(r) == [] and r.blocks_synced == 0
    assert r.pool.height == 1 and len(r.pool.peek_window(2)) == 2


def test_precompute_falls_back_for_malformed_data_only(monkeypatch):
    """The window precompute's per-block fallback is for malformed peer
    data (here a block without a LastCommit); a device fault propagates."""
    monkeypatch.setattr(TR, "PRECOMPUTE_MIN_SIGS", 2)
    rep = Replay(T)
    blocks = port_blocks()
    vals = rep.reactor.state.validators
    pairs = [(blocks[h], "src", blocks[h + 1], "src") for h in range(2, 6)]
    with routed("cuda"):
        pre = rep.reactor._precompute_last_commit_verdicts(
            pairs, vals, vals, CHAIN_ID)
        # the LastCommits of blocks 2-6, each once: both planes share them
        assert len(pre) == 5 * N_VALS and all(pre.values())
        tfaults.configure("device.batch_verify*1")
        with pytest.raises(InjectedFault):
            rep.reactor._precompute_last_commit_verdicts(pairs, vals, vals,
                                                         CHAIN_ID)
        blocks[3].last_commit = None
        assert rep.reactor._precompute_last_commit_verdicts(
            pairs, vals, vals, CHAIN_ID) is None
    rep.close()
