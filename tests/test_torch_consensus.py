"""The port's consensus state machine, WAL, handshake replay, stage timeline
and wire messages (tendermint_tpu_torch/consensus/) against the JAX
package's.

* the cases of tests/test_consensus_single.py (all five; the restart keeps
  the same in-memory stores where the JAX case reopens SQLite files: the
  port has no ``SQLiteDB``), the WAL classes of
  tests/test_wal_privval_mempool.py (``TestWAL``, ``TestWALGroupCommit``;
  the FilePV cases wait for ``privval/``), the unit cases of
  tests/test_stage_timeline.py and tests/test_gossip_wakeup.py's encode
  cache (:53-:84), on the port; the metric sets those cases read
  (``ConsensusMetrics``) are not ported, so a registry of the port's
  primitives stands in with the same series names;
* differential cases, exact equality: every consensus message encodes to
  the same bytes in both packages and each decodes the other's; the same
  WAL records give byte-identical files that each package reads back, and
  a torn tail or a bad CRC stops both at the same record; the same votes
  into both ``HeightVoteSet``s give the same +2/3 and POL answers; a
  single-validator port chain of 6 heights decodes in the JAX package to
  the same block hashes, its blocks applied by the JAX ``BlockExecutor``
  give the same app, results and validators hashes, and the JAX
  ``verify_commit`` accepts every seen commit;
* the fault pins (ROADMAP §3): a fault of the card at the prevote's
  ``validate_block`` gives no nil prevote and counts once; at the
  finalize the height stays in COMMIT and is finalized on the COMMIT
  timeout; a fault inside ``apply_block`` is raised, not retried, so the
  app executes the block once; a malformed block still draws a nil
  prevote.
"""

import asyncio
import os
import random

import pytest
import torch

from tendermint_tpu import crypto as jcrypto
from tendermint_tpu.abci.example.kvstore import KVStoreApplication as JKV
from tendermint_tpu.consensus import msgs as jmsgs
from tendermint_tpu.consensus import round_state as jrs
from tendermint_tpu.consensus import wal as jwal
from tendermint_tpu.consensus.state import BlockPartMessage as JBlockPartMsg
from tendermint_tpu.consensus.state import ProposalMessage as JProposalMsg
from tendermint_tpu.consensus.state import VoteMessage as JVoteMsg
from tendermint_tpu.libs.bits import BitArray as JBitArray
from tendermint_tpu.libs.db import MemDB as JMemDB
from tendermint_tpu.proxy import AppConns as JAppConns
from tendermint_tpu.proxy import local_client_creator as jlocal
from tendermint_tpu.state import BlockExecutor as JBlockExecutor
from tendermint_tpu.state import StateStore as JStateStore
from tendermint_tpu.state import state_from_genesis as jstate_from_genesis
from tendermint_tpu.state.execution import EmptyEvidencePool as JEmptyPool
from tendermint_tpu.state.execution import NoOpMempool as JNoOpMempool
from tendermint_tpu.store import BlockStore as JBlockStore
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu.types import GenesisValidator as JGenesisValidator
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.basic import SignedMsgType as JSMT
from tendermint_tpu.types.block import Block as JBlock
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu.types.priv_validator import MockPV as JMockPV
from tendermint_tpu.types.proposal import Proposal as JProposal
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch import convert, crypto, device
from tendermint_tpu_torch.abci.example.kvstore import (
    KVStoreApplication, MerkleKVStoreApplication)
from tendermint_tpu_torch.consensus import WAL, ConsensusState
from tendermint_tpu_torch.consensus import msgs as tmsgs
from tendermint_tpu_torch.consensus import round_state as trs
from tendermint_tpu_torch.consensus import state as tstate_mod
from tendermint_tpu_torch.consensus import wal as twal
from tendermint_tpu_torch.consensus.config import test_consensus_config
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.round_state import RoundStep
from tendermint_tpu_torch.consensus.state import VoteMessage, _MsgInfo
from tendermint_tpu_torch.consensus.timeline import STAGES, StageTimeline
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
from tendermint_tpu_torch.libs.trace import tracer
from tendermint_tpu_torch.mempool import CListMempool
from tendermint_tpu_torch.proxy import AppConns, local_client_creator
from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                        state_from_genesis)
from tendermint_tpu_torch.state.execution import EmptyEvidencePool
from tendermint_tpu_torch.store import BlockStore
from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                        GenesisValidator, MockPV,
                                        PartSetHeader, SignedMsgType)
from tendermint_tpu_torch.types import events as tme
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.event_bus import EventBus
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from tests.test_torch_light import _KNOBS, ROUTE, reset_port, routed

CHAIN_ID = "single-chain"
GENESIS_NS = 1_700_000_000_000_000_000
BID = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    # the plain kernels run from executor threads beside the event loop:
    # with several test workers on the host, torch's intra-op threads
    # oversubscribe it and a flush takes tens of seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    reset_port()
    tbatch.set_crypto_metrics(None)
    tbatch._calibrated_threshold = None
    device.set_default_device(None)


# -- the single-validator node (tests/test_consensus_single.py) --------------

def build_node(app=None, pv=None, wal=None, stores=None, config=None):
    pv = pv or MockPV(crypto.Ed25519PrivKey.generate(b"\x33" * 32))
    genesis = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
                         validators=[GenesisValidator(pv.get_pub_key(), 10)])
    app = app or KVStoreApplication()
    conns = AppConns(local_client_creator(app))
    conns.start()
    state_store, block_store = stores or (StateStore(MemDB()),
                                          BlockStore(MemDB()))
    state = Handshaker(state_store, state_from_genesis(genesis), block_store,
                       genesis).handshake(conns.consensus, conns.query)
    state_store.save(state)
    mempool = CListMempool(conns.mempool)
    event_bus = EventBus()
    block_exec = BlockExecutor(state_store, conns.consensus, mempool,
                               EmptyEvidencePool(), block_store, event_bus)
    cs = ConsensusState(config or test_consensus_config(), state, block_exec,
                        block_store, wal=wal)
    cs.set_priv_validator(pv)
    cs.set_event_bus(event_bus)
    mempool.tx_available_callbacks.append(cs.notify_txs_available)
    return cs, mempool, app, event_bus, pv, (state_store, block_store,
                                             genesis, conns)


async def wait_for_height(event_bus, cs, height, timeout=10.0):
    sub = event_bus.subscribe(f"test-wait-{height}", tme.QUERY_NEW_BLOCK)
    try:
        while cs.state.last_block_height < height:
            msg = await asyncio.wait_for(sub.next(), timeout)
            if msg.data.block.header.height >= height:
                return
    finally:
        event_bus.unsubscribe_all(f"test-wait-{height}")


def test_single_validator_produces_blocks():
    async def run():
        cs, mempool, app, event_bus, pv, _ = build_node()
        await cs.start()
        try:
            mempool.check_tx(b"alpha=1")
            await wait_for_height(event_bus, cs, 3)
        finally:
            await cs.stop()
        assert cs.state.last_block_height >= 3
        assert app.state.get("alpha") == "1"
        assert mempool.size() == 0

    asyncio.run(run())


def test_single_validator_commits_txs_across_heights():
    async def run():
        cs, mempool, app, event_bus, pv, _ = build_node()
        await cs.start()
        try:
            mempool.check_tx(b"k1=a")
            await wait_for_height(event_bus, cs, 1)
            mempool.check_tx(b"k2=b")
            mempool.check_tx(b"k3=c")
            await wait_for_height(event_bus, cs,
                                  cs.state.last_block_height + 2)
        finally:
            await cs.stop()
        assert app.state == {"k1": "a", "k2": "b", "k3": "c"}

    asyncio.run(run())


def test_wal_written_and_replayable(tmp_path):
    async def run():
        wal = WAL(str(tmp_path / "cs.wal"))
        cs, mempool, app, event_bus, pv, _ = build_node(wal=wal)
        await cs.start()
        try:
            mempool.check_tx(b"x=y")
            await wait_for_height(event_bus, cs, 2)
        finally:
            await cs.stop()
        committed = cs.state.last_block_height
        wal2 = WAL(str(tmp_path / "cs.wal"))
        for h in range(1, committed + 1):
            assert wal2.search_for_end_height(h), f"missing ENDHEIGHT {h}"
        assert isinstance(wal2.messages_after_end_height(committed), list)

    asyncio.run(run())


def test_restart_recovers_via_handshake():
    async def run():
        pv = MockPV(crypto.Ed25519PrivKey.generate(b"\x44" * 32))
        cs, mempool, app, event_bus, _, extras = build_node(pv=pv)
        await cs.start()
        mempool.check_tx(b"persist=me")
        await wait_for_height(event_bus, cs, 2)
        await cs.stop()
        committed = cs.state.last_block_height
        state_store, block_store, genesis, conns = extras

        # "restart": a fresh app at height 0 over the same stores
        app2 = KVStoreApplication()
        conns2 = AppConns(local_client_creator(app2))
        conns2.start()
        handshaker = Handshaker(state_store, state_store.load(), block_store,
                                genesis)
        state2 = handshaker.handshake(conns2.consensus, conns2.query)
        assert handshaker.n_blocks == committed
        assert app2.height == committed
        assert app2.state.get("persist") == "me"
        assert state2.last_block_height == committed

    asyncio.run(run())


def test_timeout_ticker_ignores_earlier_hrs():
    async def run():
        cs, *_ = build_node()
        try:
            cs._schedule_timeout(30.0, 5, 1, RoundStep.PRECOMMIT_WAIT)
            pending = cs._pending_timeout
            assert (pending.height, pending.round, pending.step) == \
                (5, 1, int(RoundStep.PRECOMMIT_WAIT))
            task = cs._timeout_task
            cs._schedule_timeout(0.001, 4, 9, RoundStep.COMMIT)
            cs._schedule_timeout(0.001, 5, 0, RoundStep.COMMIT)
            cs._schedule_timeout(0.001, 5, 1, RoundStep.PROPOSE)
            cs._schedule_timeout(0.001, 5, 1, RoundStep.PRECOMMIT_WAIT)
            assert cs._pending_timeout is pending
            assert cs._timeout_task is task and not task.cancelled()
            cs._schedule_timeout(30.0, 5, 1, RoundStep.COMMIT)
            assert cs._pending_timeout.step == int(RoundStep.COMMIT)
            cs._schedule_timeout(30.0, 5, 2, RoundStep.NEW_ROUND)
            assert cs._pending_timeout.round == 2
            cs._schedule_timeout(30.0, 6, 0, RoundStep.NEW_HEIGHT)
            assert cs._pending_timeout.height == 6
            assert task.cancelled() or task.done() or \
                cs._timeout_task is not task
        finally:
            cs._timeout_task and cs._timeout_task.cancel()
            await asyncio.sleep(0)

    asyncio.run(run())


# -- the stage timeline (tests/test_stage_timeline.py, unit cases) ------------

def _stage_histogram():
    """``ConsensusMetrics.stage_seconds`` of the JAX package: the same
    series on a registry of the port's primitives."""
    return Registry().histogram("consensus", "stage_seconds",
                                "Seconds from the previous stage mark.",
                                labels=("stage",))


def _drive_height(tl, h, round_=0):
    tl.begin_height(h)
    tl.note_wire_proposal(h)
    for stage in STAGES:
        tl.mark(h, round_, stage)


def test_marks_monotonic_and_durations_sum():
    tl = StageTimeline()
    _drive_height(tl, 5)
    (rec,) = tl.tail(10)
    assert rec["height"] == 5 and rec["sealed"]
    times = [t for _, _, t in rec["marks"]]
    assert times == sorted(times)
    assert set(rec["durations"]) == set(STAGES)
    assert all(d >= 0 for d in rec["durations"].values())
    assert sum(rec["durations"].values()) <= \
        rec["total_s"] + 1e-6 * (len(rec["durations"]) + 1)
    assert ["proposal_wire"] == [m[0] for m in rec["marks"]
                                 if m[0] not in STAGES]


def test_multi_round_height_last_mark_wins():
    tl = StageTimeline()
    tl.begin_height(7)
    for r, stage in ((0, "proposal_received"), (0, "prevote_sent"),
                     (2, "proposal_received"), (2, "prevote_sent"),
                     (2, "prevote_quorum"), (2, "precommit_sent"),
                     (2, "precommit_quorum"), (2, "commit_finalized")):
        tl.mark(7, r, stage)
    (rec,) = tl.tail(1)
    assert rec["round"] == 2
    assert [m[1] for m in rec["marks"] if m[0] == "proposal_received"] \
        == [0, 2]
    times = [t for _, _, t in rec["marks"]]
    assert times == sorted(times)
    assert set(rec["durations"]) == set(STAGES)


def test_ring_bounded_and_unsealed_heights_pushed():
    tl = StageTimeline(capacity=8)
    for h in range(1, 20):
        _drive_height(tl, h)
    assert len(tl.tail(100)) == 8
    assert [r["height"] for r in tl.tail(3)] == [17, 18, 19]
    assert tl.heights_sealed == 19
    tl.begin_height(30)
    tl.mark(30, 0, "proposal_received")
    tl.begin_height(31)
    rec = tl.tail(1)[0]
    assert rec["height"] == 30 and not rec["sealed"]
    assert "durations" not in rec
    tl.mark(30, 0, "prevote_sent")
    assert tl.snapshot()["current"]["height"] == 31


def test_metrics_emission_on_seal():
    tl = StageTimeline()
    hist = _stage_histogram()
    tl.metrics = type("M", (), {"stage_seconds": hist})()
    _drive_height(tl, 2)
    _drive_height(tl, 3)
    for stage in STAGES:
        assert hist.count_value(stage) == 2, stage
        assert hist.sum_value(stage) >= 0.0
    text = "\n".join(hist.render())
    assert "tendermint_consensus_stage_seconds_bucket" in text
    assert 'stage="commit_finalized"' in text


def test_trace_spans_emitted_on_seal():
    tl = StageTimeline()
    tracer.clear()
    tracer.enable()
    try:
        _drive_height(tl, 9)
    finally:
        tracer.disable()
    stage_events = [e for e in tracer.events()
                    if e["name"].startswith("stage_")]
    tracer.clear()
    assert [e["name"] for e in stage_events] == \
        [f"stage_{s}" for s in STAGES]
    for e in stage_events:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert e["args"]["height"] == 9
    for a, b in zip(stage_events, stage_events[1:]):
        assert abs((a["ts"] + a["dur"]) - b["ts"]) < 1.0


def test_snapshot_shape_and_limit():
    import json

    tl = StageTimeline()
    for h in range(1, 6):
        _drive_height(tl, h)
    tl.begin_height(6)
    tl.mark(6, 0, "proposal_received")
    snap = tl.snapshot(limit=2)
    assert snap["heights_sealed"] == 5
    assert [r["height"] for r in snap["heights"]] == [4, 5]
    assert snap["current"]["height"] == 6 and not snap["current"]["sealed"]
    json.dumps(snap)


def test_disabled_timeline_records_nothing():
    tl = StageTimeline()
    hist = _stage_histogram()
    tl.metrics = type("M", (), {"stage_seconds": hist})()
    tl.enabled = False
    _drive_height(tl, 3)
    assert tl.tail(10) == [] and tl.heights_sealed == 0
    assert hist.count_value("commit_finalized") == 0
    tl.enabled = True
    tl.mark(3, 1, "precommit_quorum")
    tl.mark(3, 1, "commit_finalized")
    (rec,) = tl.tail(10)
    assert rec["sealed"] and rec["height"] == 3
    assert set(rec["durations"]) == {"precommit_quorum", "commit_finalized"}


def test_single_validator_chain_populates_timeline():
    async def run():
        cs, mempool, app, event_bus, pv, _ = build_node()
        hist = _stage_histogram()
        cs.timeline.metrics = type("M", (), {"stage_seconds": hist})()
        await cs.start()
        try:
            mempool.check_tx(b"tl=1")
            await wait_for_height(event_bus, cs, 3)
        finally:
            await cs.stop()
        recs = [r for r in cs.timeline.tail(100) if r["sealed"]]
        assert len(recs) >= 2
        for rec in recs:
            assert set(STAGES) <= {mk[0] for mk in rec["marks"]}
            times = [t for _, _, t in rec["marks"]]
            assert times == sorted(times)
        assert hist.count_value("commit_finalized") == len(recs)

    asyncio.run(run())


# -- the WAL (tests/test_wal_privval_mempool.py TestWAL, TestWALGroupCommit) --

class _WalMetrics:
    """The WAL series of the JAX ``ConsensusMetrics`` on a port registry."""

    def __init__(self):
        r = Registry()
        self.wal_fsyncs_total = r.counter("consensus", "wal_fsyncs_total", "")
        self.wal_fsync_errors_total = r.counter(
            "consensus", "wal_fsync_errors_total", "")
        self.wal_records_per_fsync = r.histogram(
            "consensus", "wal_records_per_fsync", "")
        self.wal_fsync_seconds = r.histogram("consensus",
                                             "wal_fsync_seconds", "")


class TestWAL:
    def test_roundtrip(self, tmp_path):
        wal = WAL(str(tmp_path / "w.wal"))
        wal.write("round_step", {"height": 1, "round": 0, "step": 1}, 123)
        wal.write_timeout(twal.TimeoutInfo(1.5, 1, 0, 3), 124)
        wal.write_end_height(1, 125)
        wal.close()
        msgs = list(WAL(str(tmp_path / "w.wal")).iter_messages())
        assert [m.type for m in msgs] == ["end_height", "round_step",
                                          "timeout", "end_height"]
        assert msgs[0].data["height"] == 0
        assert msgs[2].data["duration_s"] == 1.5

    def test_torn_tail_tolerated(self, tmp_path):
        path = str(tmp_path / "w.wal")
        wal = WAL(path)
        wal.write("round_step", {"height": 1}, 1)
        wal.write("round_step", {"height": 2}, 2)
        wal.close()
        with open(path, "ab") as f:
            f.write(b"\x00\x01\x02")
        assert len(list(WAL(path).iter_messages())) == 3

    def test_corrupt_crc_stops_replay(self, tmp_path):
        path = str(tmp_path / "w.wal")
        wal = WAL(path)
        wal.write("round_step", {"height": 1}, 1)
        wal.write("round_step", {"height": 2}, 2)
        wal.close()
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        assert len(list(WAL(path).iter_messages())) == 2

    def test_search_for_end_height(self, tmp_path):
        wal = WAL(str(tmp_path / "w.wal"))
        wal.write_end_height(5, 1)
        wal.write("vote", {"vote": "00", "peer": "p"}, 2)
        assert wal.search_for_end_height(5)
        assert not wal.search_for_end_height(6)
        after = wal.messages_after_end_height(5)
        assert len(after) == 1 and after[0].type == "vote"

    def test_rotation(self, tmp_path):
        path = str(tmp_path / "w.wal")
        wal = WAL(path, head_size_limit=512)
        for i in range(100):
            wal.write("round_step", {"height": i, "pad": "x" * 50}, i)
        wal.close()
        assert os.path.exists(path + ".0")
        msgs = [m for m in WAL(path).iter_messages()
                if m.type == "round_step"]
        assert [m.data["height"] for m in msgs] == list(range(100))


class TestWALGroupCommit:
    RECORDS = [
        ("proposal", {"proposal": "aa", "peer": ""}, 10, True),
        ("block_part", {"height": 1, "round": 0, "part": "bb", "peer": ""},
         11, True),
        ("block_part", {"height": 1, "round": 0, "part": "cc", "peer": ""},
         12, True),
        ("vote", {"vote": "dd", "peer": "p1"}, 13, False),
        ("timeout", {"duration_s": 0.5, "height": 1, "round": 0, "step": 3},
         14, False),
        ("vote", {"vote": "ee", "peer": ""}, 15, True),
    ]

    def _write(self, wal):
        for type_, data, ts, sync in self.RECORDS:
            (wal.write_sync if sync else wal.write)(type_, data, ts)

    def test_group_commit_replay_byte_identical(self, tmp_path):
        per = WAL(str(tmp_path / "per.wal"))
        self._write(per)
        per.close()
        grp = WAL(str(tmp_path / "grp.wal"))
        with grp.group():
            self._write(grp)
        grp.close()
        per_bytes = open(str(tmp_path / "per.wal"), "rb").read()
        grp_bytes = open(str(tmp_path / "grp.wal"), "rb").read()
        assert per_bytes == grp_bytes and len(per_bytes) > 0
        per_msgs = [(m.type, m.data, m.time_ns) for m in
                    WAL(str(tmp_path / "per.wal")).iter_messages()]
        grp_msgs = [(m.type, m.data, m.time_ns) for m in
                    WAL(str(tmp_path / "grp.wal")).iter_messages()]
        assert per_msgs == grp_msgs
        assert len(per_msgs) == len(self.RECORDS) + 1

    def test_group_commit_single_fsync(self, tmp_path, monkeypatch):
        wal = WAL(str(tmp_path / "w.wal"))
        wal.metrics = _WalMetrics()
        calls = []
        monkeypatch.setattr(twal.os, "fsync", lambda fd: calls.append(fd))
        with wal.group():
            self._write(wal)
        assert len(calls) == 1, "group commit must coalesce to ONE fsync"
        m = wal.metrics
        assert m.wal_fsyncs_total.value() == 1
        assert m.wal_records_per_fsync.count_value() == 1
        assert m.wal_records_per_fsync.sum_value() == len(self.RECORDS)
        calls.clear()
        wal2 = WAL(str(tmp_path / "w2.wal"))
        self._write(wal2)
        n_sync = sum(1 for r in self.RECORDS if r[3])
        assert len(calls) == n_sync + 1

    def test_group_commit_external_only_respects_deadline(self, tmp_path,
                                                          monkeypatch):
        wal = WAL(str(tmp_path / "w.wal"))
        calls = []
        monkeypatch.setattr(twal.os, "fsync", lambda fd: calls.append(fd))
        wal.sync_deadline_s = 3600.0
        with wal.group():
            wal.write("vote", {"vote": "aa", "peer": "p1"}, 1)
            wal.write("vote", {"vote": "bb", "peer": "p2"}, 2)
        assert calls == []
        wal.sync_deadline_s = 0.0
        with wal.group():
            wal.write("vote", {"vote": "cc", "peer": "p1"}, 3)
        assert len(calls) == 1

    def test_batch_crossing_commit_relogs_remainder(self, tmp_path):
        def _vote(h, idx_sig):
            return Vote(SignedMsgType.PREVOTE, h, 0, BID, GENESIS_NS,
                        b"\xaa" * 20, 0, bytes([idx_sig]) * 64)

        async def run():
            wal = WAL(str(tmp_path / "t.wal"))
            cs, *_ = build_node(wal=wal)
            assert cs.config.wal_group_commit
            commit_trigger = _MsgInfo(VoteMessage(_vote(1, 1)), "p1")
            straggler = _MsgInfo(VoteMessage(_vote(2, 2)), "p2")

            def fake_handle(mi):
                if mi is commit_trigger:
                    cs.wal.write_end_height(1, 999)
                    cs.state.last_block_height = 1

            cs._handle_msg = fake_handle
            cs._queue.put_nowait(commit_trigger)
            cs._queue.put_nowait(straggler)
            task = asyncio.get_running_loop().create_task(
                cs.receive_routine())
            while not cs._queue.empty():
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            task.cancel()
            wal.close()

        asyncio.run(run())
        replayed = WAL(str(tmp_path / "t.wal")).messages_after_end_height(1)
        votes = [m for m in replayed if m.type == "vote"]
        assert len(votes) == 1
        assert votes[0].data["vote"] == _vote(2, 2).encode().hex()
        all_votes = [m for m in WAL(str(tmp_path / "t.wal")).iter_messages()
                     if m.type == "vote"]
        assert len(all_votes) == 3

    def test_own_messages_durable_before_handled(self, tmp_path):
        events = []

        class TracingWAL(WAL):
            def write_msg_info(self, msg, peer_id, time_ns, internal):
                events.append(("record", internal))
                super().write_msg_info(msg, peer_id, time_ns, internal)

            def _fsync(self):
                events.append(("fsync",))
                super()._fsync()

        async def run():
            wal = TracingWAL(str(tmp_path / "t.wal"))
            cs, mempool, app, bus, pv, _ = build_node(wal=wal)
            orig_handle = cs._handle_msg

            def traced(mi):
                events.append(("handle", mi.peer_id == ""))
                orig_handle(mi)

            cs._handle_msg = traced
            await cs.start()
            try:
                await wait_for_height(bus, cs, 2)
            finally:
                await cs.stop()

        asyncio.run(run())
        pending_internal, batch_sizes, since_sync = 0, [], 0
        for ev in events:
            if ev[0] == "record":
                since_sync += 1
                pending_internal += ev[1]
            elif ev[0] == "fsync":
                pending_internal = 0
                if since_sync:
                    batch_sizes.append(since_sync)
                since_sync = 0
            elif ev == ("handle", True):
                assert pending_internal == 0, \
                    "own message handled before its WAL record was fsynced"
        assert batch_sizes and max(batch_sizes) >= 2, batch_sizes


# -- the encode cache (tests/test_gossip_wakeup.py :53-:84) ------------------

def _mk_vote(h=1, r=0, idx=0, sig=b"\x01" * 64):
    return Vote(SignedMsgType.PREVOTE, h, r,
                BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32)),
                GENESIS_NS, b"\xaa" * 20, idx, sig)


class TestWireEncodeCache:
    def test_identical_bytes_and_hit_accounting(self):
        cache = tmsgs.WireEncodeCache()
        vote = _mk_vote(sig=b"\x11" * 64)
        direct = tmsgs.encode_msg(tmsgs.VoteMessageWire(vote))
        assert cache.vote(vote) == direct
        assert cache.vote(vote) == direct
        assert cache.stats == {"hits": 1, "misses": 1}
        decoded = tmsgs.decode_msg(cache.vote(vote))
        assert isinstance(decoded, tmsgs.VoteMessageWire)
        assert decoded.vote.signature == vote.signature
        parts = PartSet.from_data(b"block-bytes " * 100, part_size=256)
        part, psh = parts.get_part(0), parts.header()
        direct = tmsgs.encode_msg(tmsgs.BlockPartMessageWire(1, 0, part))
        assert cache.block_part(1, 0, psh.hash, part) == direct
        assert cache.block_part(1, 0, psh.hash, part) == direct
        prop = Proposal(1, 0, -1, BlockID(b"\x03" * 32, psh), GENESIS_NS,
                        b"\x22" * 64)
        assert cache.proposal(prop) == tmsgs.encode_msg(
            tmsgs.ProposalMessageWire(prop))

    def test_signature_keys_distinguish_equivocations(self):
        cache = tmsgs.WireEncodeCache()
        a, b = _mk_vote(sig=b"\xaa" * 64), _mk_vote(sig=b"\xbb" * 64)
        assert cache.vote(a) != cache.vote(b)
        assert cache.stats["misses"] == 2 and cache.stats["hits"] == 0

    def test_lru_bound_and_height_prune(self):
        cache = tmsgs.WireEncodeCache(max_entries=4)
        for i in range(8):
            cache.vote(_mk_vote(h=i + 1, sig=bytes([i]) * 64))
        assert len(cache) == 4
        assert cache.prune_below(8) == 3
        assert len(cache) == 1


# -- differential: wire messages, the WAL, HeightVoteSet ----------------------

def _seeded_messages(rng):
    """Each consensus message, built with the same seeded content in both
    packages: [(JAX message, port message)]."""
    def b(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    bid = (b(32), 3, b(32))
    jbid, tbid = JBlockID(bid[0], JPSH(bid[1], bid[2])), \
        BlockID(bid[0], PartSetHeader(bid[1], bid[2]))
    bits = [rng.random() < 0.5 for _ in range(70)]

    def ba(cls):
        x = cls(len(bits))
        for i, v in enumerate(bits):
            x.set_index(i, v)
        return x

    jprop = JProposal(12, 2, 1, jbid, GENESIS_NS + 7, b(64))
    jvote = JVote(JSMT.PRECOMMIT, 12, 2, jbid, GENESIS_NS + 9, b(20), 5,
                  b(64))
    data = b(3000)
    jparts = JPartSet.from_data(data, part_size=1024)
    tparts = PartSet.from_data(data, part_size=1024)
    jpart, tpart = jparts.get_part(1), tparts.get_part(1)
    J, T = jmsgs, tmsgs
    return [
        (J.NewRoundStepMessage(12, 2, 6, 3, 1),
         T.NewRoundStepMessage(12, 2, 6, 3, 1)),
        (J.NewValidBlockMessage(12, 2, JPSH(3, bid[2]), ba(JBitArray), True),
         T.NewValidBlockMessage(12, 2, PartSetHeader(3, bid[2]),
                                ba(BitArray), True)),
        (J.ProposalMessageWire(jprop),
         T.ProposalMessageWire(convert.proposal_from_reference(
             jprop.encode()))),
        (J.ProposalPOLMessage(12, 1, ba(JBitArray)),
         T.ProposalPOLMessage(12, 1, ba(BitArray))),
        (J.BlockPartMessageWire(12, 2, jpart),
         T.BlockPartMessageWire(12, 2, tpart)),
        (J.VoteMessageWire(jvote),
         T.VoteMessageWire(convert.vote_from_reference(jvote.encode()))),
        (J.HasVoteMessage(12, 2, JSMT.PREVOTE, 69),
         T.HasVoteMessage(12, 2, SignedMsgType.PREVOTE, 69)),
        (J.VoteSetMaj23Message(12, 2, JSMT.PRECOMMIT, jbid),
         T.VoteSetMaj23Message(12, 2, SignedMsgType.PRECOMMIT, tbid)),
        (J.VoteSetBitsMessage(12, 2, JSMT.PREVOTE, jbid, ba(JBitArray)),
         T.VoteSetBitsMessage(12, 2, SignedMsgType.PREVOTE, tbid,
                              ba(BitArray))),
    ]


def test_every_message_encodes_alike_and_decodes_the_others():
    pairs = _seeded_messages(random.Random(11))
    assert len({type(t).__name__ for _, t in pairs}) == 9
    for jm, tm in pairs:
        jb, tb = jmsgs.encode_msg(jm), tmsgs.encode_msg(tm)
        assert jb == tb, type(tm).__name__
        assert tmsgs.encode_msg(tmsgs.decode_msg(jb)) == jb
        assert jmsgs.encode_msg(jmsgs.decode_msg(tb)) == tb
        assert type(tmsgs.decode_msg(jb)).__name__ == type(tm).__name__


def _wal_records(ns):
    """A WAL record sequence of each kind, fixed timestamps, built from the
    same seeded bytes in package ``ns`` (jwal or twal)."""
    rng = random.Random(5)
    parts = JPartSet.from_data(bytes(rng.getrandbits(8) for _ in range(2500)),
                               part_size=1024)
    jbid = JBlockID(b"\x07" * 32, parts.header())
    jprop = JProposal(3, 0, -1, jbid, GENESIS_NS + 1, b"\x05" * 64)
    jvote = JVote(JSMT.PREVOTE, 3, 0, jbid, GENESIS_NS + 2, b"\x09" * 20, 1,
                  b"\x06" * 64)
    if ns is jwal:
        msgs = [JProposalMsg(jprop), JBlockPartMsg(3, 0, parts.get_part(0)),
                JVoteMsg(jvote)]
    else:
        msgs = [tstate_mod.ProposalMessage(
                    convert.proposal_from_reference(jprop.encode())),
                tstate_mod.BlockPartMessage(3, 0, convert.part_from_reference(
                    parts.get_part(0).encode())),
                tstate_mod.VoteMessage(
                    convert.vote_from_reference(jvote.encode()))]

    def write(wal):
        wal.write_round_step(3, 0, 1, 100)
        wal.write_msg_info(msgs[0], "", 101, internal=True)
        wal.write_msg_info(msgs[1], "", 102, internal=True)
        wal.write_msg_info(msgs[2], "peer-1", 103, internal=False)
        wal.write_timeout(ns.TimeoutInfo(0.5, 3, 0, 3), 104)
        with wal.group():
            wal.write_msg_info(msgs[2], "peer-2", 105, internal=False)
            wal.write_end_height(3, 106)
        wal.write_round_step(4, 0, 1, 107)
    return write


def test_wal_files_are_byte_identical_and_read_each_other(tmp_path):
    jpath, tpath = str(tmp_path / "j.wal"), str(tmp_path / "t.wal")
    for ns, path in ((jwal, jpath), (twal, tpath)):
        w = ns.WAL(path)
        _wal_records(ns)(w)
        w.close()
    raw = open(jpath, "rb").read()
    assert raw == open(tpath, "rb").read() and len(raw) > 0

    def read(ns, path):
        return [(m.time_ns, m.type, m.data)
                for m in ns.WAL(path, repair=False).iter_messages()]

    want = read(jwal, jpath)
    assert len(want) == 9
    assert read(twal, jpath) == want and read(jwal, tpath) == want
    assert twal.WAL(jpath, repair=False).messages_after_end_height(3) == \
        [twal.WALMessage(*m) for m in want[-1:]]
    # a torn tail and a bad CRC stop both packages at the same record
    frames = []
    pos = 0
    while pos < len(raw):
        ln = int.from_bytes(raw[pos + 4:pos + 8], "big")
        frames.append(pos)
        pos += 8 + ln
    for i, cut in enumerate(frames[1:], start=1):
        for label, bad in (("torn", raw[:cut + 5]),
                           ("crc", raw[:cut + 8] + bytes([raw[cut + 8] ^ 1])
                            + raw[cut + 9:])):
            path = str(tmp_path / f"{label}{i}.wal")
            open(path, "wb").write(bad)
            got_j, got_t = read(jwal, path), read(twal, path)
            assert got_j == got_t == want[:i], (label, i)


def _signed_votes(n_vals, seed):
    """JAX MockPVs and their votes over rounds 0-2: per round a mix of
    block, other-block and nil prevotes and precommits, in seeded order."""
    rng = random.Random(seed)
    pvs = [JMockPV(jcrypto.Ed25519PrivKey.generate(bytes([0x21 + i]) * 32))
           for i in range(n_vals)]
    vals = JValidatorSet([JValidator(pv.get_pub_key().address(),
                                     pv.get_pub_key(), 10 + i % 3)
                          for i, pv in enumerate(pvs)])
    by_addr = {pv.get_pub_key().address(): pv for pv in pvs}
    blocks = [JBlockID(bytes([i + 1]) * 32, JPSH(1, bytes([i + 9]) * 32))
              for i in range(2)] + [JBlockID()]
    votes = []
    for r in range(3):
        for t in (JSMT.PREVOTE, JSMT.PRECOMMIT):
            for idx, v in enumerate(vals.validators):
                pick = rng.choices(range(3), weights=(6 - 2 * r, 1, r + 1))[0]
                vote = JVote(t, 4, r, blocks[pick], GENESIS_NS + idx,
                             v.address, idx)
                by_addr[v.address].sign_vote(CHAIN_ID, vote)
                votes.append(vote)
    rng.shuffle(votes)
    return vals, votes


def _answers(hvs):
    """Every +2/3 and POL answer of a HeightVoteSet over rounds 0-2, as
    bytes and bools."""
    out = []
    for r in range(3):
        for vs in (hvs.prevotes(r), hvs.precommits(r)):
            bid, ok = vs.two_thirds_majority()
            out.append((ok, bid.encode(), vs.has_two_thirds_any(),
                        vs.has_all(), vs.bit_array().encode()))
    pol_round, pol_bid = hvs.pol_info()
    out.append((pol_round, pol_bid.encode() if pol_bid else None))
    return out


def test_height_vote_sets_answer_alike():
    jvals, jvotes = _signed_votes(7, 3)
    tvals = convert.validator_set_from_reference(jvals.encode())
    jh = jrs.HeightVoteSet(CHAIN_ID, 4, jvals)
    th = trs.HeightVoteSet(CHAIN_ID, 4, tvals)
    jh.set_round(2)
    th.set_round(2)
    majorities, pols = 0, set()
    for jv in jvotes:
        tv = convert.vote_from_reference(jv.encode())
        assert jh.add_vote(jv, "p") == th.add_vote(tv, "p")
        want = _answers(jh)
        assert _answers(th) == want
        majorities = max(majorities, sum(a[0] is True for a in want[:-1]))
        pols.add(want[-1][0])
    # the sequence reached +2/3 in some sets and moved the POL round
    assert majorities >= 2 and len(pols) >= 2, (majorities, pols)


# -- differential: a single-validator port chain through the JAX package ------

def _jax_node():
    """The JAX package's node state for build_node's genesis: the same
    seeded validator key, chain and time."""
    pv = JMockPV(jcrypto.Ed25519PrivKey.generate(b"\x33" * 32))
    jgen = JGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
                       validators=[JGenesisValidator(pv.get_pub_key(), 10)])
    conns = JAppConns(jlocal(JKV()))
    conns.start()
    store = JStateStore(JMemDB())
    state = jstate_from_genesis(jgen)
    from tendermint_tpu.consensus.replay import Handshaker as JHandshaker

    state = JHandshaker(store, state, JBlockStore(JMemDB()),
                        jgen).handshake(conns.consensus, conns.query)
    store.save(state)
    execu = JBlockExecutor(store, conns.consensus, JNoOpMempool(),
                           JEmptyPool(), JBlockStore(JMemDB()))
    return state, execu, conns


def test_port_chain_replays_in_the_jax_package():
    rng = random.Random(17)
    txs = [b"d%02d=%08x" % (i, rng.getrandbits(32)) for i in range(40)]
    txs += [b"d00=\xff\xfe", b"raw-tx"]

    async def run():
        cs, mempool, app, bus, pv, extras = build_node()
        await cs.start()
        try:
            for i, tx in enumerate(txs):
                mempool.check_tx(tx)
                if i % 9 == 8:
                    await wait_for_height(bus, cs,
                                          cs.state.last_block_height + 1)
            await wait_for_height(bus, cs, 7)
        finally:
            await cs.stop()
        return cs, extras

    cs, (state_store, block_store, genesis, conns) = asyncio.run(run())
    with routed("host"):
        jstate, jexec, jconns = _jax_node()
        jvals = jstate.validators
        try:
            for h in range(1, 7):
                blk = block_store.load_block(h)
                jblk = JBlock.decode(blk.encode())
                assert jblk.hash() == blk.hash()
                bid = JBlockID(jblk.hash(), jblk.make_part_set().header())
                jstate, _ = jexec.apply_block(jstate, bid, jblk)
                want = cs.block_store.load_block(h + 1).header
                assert jstate.app_hash == want.app_hash
                assert jstate.last_results_hash == want.last_results_hash
                assert jstate.validators.hash() == want.validators_hash
                assert jstate.last_block_id.encode() == \
                    want.last_block_id.encode()
                seen = JCommit.decode(block_store.load_seen_commit(h).encode())
                jvals.verify_commit(CHAIN_ID, seen.block_id, h, seen)
        finally:
            jconns.stop()
    final = state_store.load()
    assert final.last_block_height >= 7
    assert sum(len(block_store.load_block(h).data.txs)
               for h in range(1, final.last_block_height + 1)) == len(txs)


# -- the fault pins (ROADMAP §3) ----------------------------------------------

def _cuda_route_node(monkeypatch):
    """A single-validator node whose LastCommit verifies take the port's
    cuda route (the plain versions on CPU tensors), so the armed
    ``device.batch_verify`` site is on its path; ``votes`` records every
    (height, round, type, block hash) the node signed."""
    monkeypatch.setenv(ROUTE, "cuda")
    cm = CryptoMetrics(Registry())
    tbatch.set_crypto_metrics(cm)
    node = build_node()
    cs = node[0]
    votes = []
    sign_add = cs._sign_add_vote

    def recorded(msg_type, hash_, header):
        votes.append((cs.rs.height, cs.rs.round, msg_type, hash_))
        return sign_add(msg_type, hash_, header)

    cs._sign_add_vote = recorded
    return node, cm, votes


def _arm_at_height(cs, height, spec):
    def arm(rs):
        if rs.height == height and rs.step == RoundStep.NEW_HEIGHT:
            tfaults.configure(spec)

    cs.new_round_step_listeners.append(arm)


def test_prevote_device_fault_is_no_nil_prevote(monkeypatch):
    (cs, mempool, app, bus, pv, _), cm, votes = _cuda_route_node(monkeypatch)
    faults_seen = []
    validate = cs.block_exec.validate_block

    def recorded(state, block):
        try:
            return validate(state, block)
        except Exception as e:
            faults_seen.append((block.header.height, cs.rs.step,
                                type(e).__name__))
            raise

    cs.block_exec.validate_block = recorded
    _arm_at_height(cs, 2, "device.batch_verify*1")

    async def run():
        await cs.start()
        try:
            await wait_for_height(bus, cs, 3, timeout=20.0)
        finally:
            await cs.stop()

    asyncio.run(run())
    # the fault hit the prevote's check at height 2 ...
    assert faults_seen == [(2, RoundStep.PROPOSE, "InjectedFault")]
    # ... and drew no nil prevote: the node prevoted the block after it
    prevotes_2 = [v for v in votes
                  if v[0] == 2 and v[2] == SignedMsgType.PREVOTE]
    assert prevotes_2 and all(v[3] for v in prevotes_2), votes
    assert cm.device_errors_total.value("injected", "votes") == 1
    assert tbatch.stats["device_errors"] == 1


def test_finalize_device_fault_stays_in_commit(monkeypatch):
    (cs, mempool, app, bus, pv, _), cm, votes = _cuda_route_node(monkeypatch)
    # skip the prevote's and the lock's checks: the finalize's is the third
    _arm_at_height(cs, 2, "device.batch_verify*1+2")
    retries = []
    handle_timeout = cs._handle_timeout

    def recorded(ti):
        if ti.step == int(RoundStep.COMMIT):
            retries.append((ti.height, cs.rs.height, cs.rs.step,
                            cs.block_store.height()))
        return handle_timeout(ti)

    cs._handle_timeout = recorded

    async def run():
        await cs.start()
        try:
            await wait_for_height(bus, cs, 3, timeout=20.0)
        finally:
            await cs.stop()

    asyncio.run(run())
    # the COMMIT timeout found height 2 still in COMMIT, unsaved, and
    # finalized it
    assert retries[:1] == [(2, 2, RoundStep.COMMIT, 1)], retries
    assert cs.state.last_block_height >= 3
    assert cm.device_errors_total.value("injected", "votes") == 1
    assert [v for v in votes if v[0] == 2 and not v[3]] == []


def test_apply_block_device_fault_executes_the_block_once(monkeypatch):
    """A fault of the card inside apply_block after the app executed the
    block (the Merkle app's commit hashes its dirty leaves on K9) is counted
    once and raised, not retried: the app executes height 2 once, and the
    height stays in COMMIT, as in the JAX package."""
    monkeypatch.setenv("TMTPU_MERKLE_DEVICE_MIN", "1")
    cm = CryptoMetrics(Registry())
    tbatch.set_crypto_metrics(cm)
    cs, mempool, app, bus, pv, _ = build_node(
        app=MerkleKVStoreApplication(interval=0))
    begun = []
    begin = app.begin_block

    def recorded(req):
        begun.append(req.header.height)
        return begin(req)

    app.begin_block = recorded
    armed = []
    hash_many = tmerkle._mf.sha256_many_device

    def failing(msgs, *args, **kwargs):
        if armed == [True]:
            armed.append(False)
            raise device.KernelUnavailable("sha256_many: injected")
        return hash_many(msgs, *args, **kwargs)

    monkeypatch.setattr(tmerkle._mf, "sha256_many_device", failing)

    def arm(rs):
        if rs.height == 2 and rs.step == RoundStep.NEW_HEIGHT and not armed:
            mempool.check_tx(b"k2=b")
            armed.append(True)

    cs.new_round_step_listeners.append(arm)

    async def run():
        await cs.start()
        try:
            for _ in range(500):
                if armed[1:]:
                    break
                await asyncio.sleep(0.01)
            # many COMMIT timeouts' worth
            await asyncio.sleep(50 * cs.config.timeout_commit)
        finally:
            await cs.stop()

    asyncio.run(run())
    assert armed == [True, False]
    assert begun.count(2) == 1, begun
    assert (cs.rs.height, cs.rs.step) == (2, RoundStep.COMMIT)
    assert cm.device_errors_total.value("unavailable", "merkle") == 1


def test_malformed_block_still_prevotes_nil(monkeypatch):
    (cs, mempool, app, bus, pv, _), cm, votes = _cuda_route_node(monkeypatch)
    create = cs.block_exec.create_proposal_block

    def malformed(height, state, commit, proposer):
        block, parts = create(height, state, commit, proposer)
        if height != 2 or cs.rs.round != 0:
            return block, parts
        bad = Block.decode(block.encode())
        bad.header.app_hash = b"\xff" * 8  # not the state's app hash
        return bad, bad.make_part_set()

    cs.block_exec.create_proposal_block = malformed

    async def run():
        await cs.start()
        try:
            await wait_for_height(bus, cs, 3, timeout=20.0)
        finally:
            await cs.stop()

    asyncio.run(run())
    assert (2, 0, SignedMsgType.PREVOTE, b"") in votes
    assert cs.block_store.load_seen_commit(2).round > 0
    assert cm.device_errors_total.value("injected", "votes") == 0
    assert tbatch.stats["device_errors"] == 0
