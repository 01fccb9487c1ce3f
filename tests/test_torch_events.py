"""The port's events plane (libs/pubsub.py, types/events.py,
types/event_bus.py) against the JAX package's.

Mirrors the six cases of tests/test_pubsub.py on the port, then drives
both packages' ``BlockExecutor.apply_block`` with an ``EventBus`` over the
same blocks (txs with app events, a validator update, duplicate-vote
evidence) and holds the published events equal: type, composite keys and
values, order, and each event's data.
"""

import asyncio

import pytest

import tendermint_tpu.crypto as jcrypto
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.types import event_bus as jeb
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.abci.example import kvstore as tkv
from tendermint_tpu_torch.abci.types import (Event, EventAttribute,
                                             ResponseDeliverTx)
from tendermint_tpu_torch.libs.pubsub import (PubSubServer, Query,
                                              SubscriptionCanceled)
from tendermint_tpu_torch.types import event_bus as teb
from tendermint_tpu_torch.types import events as tme
from tendermint_tpu_torch.types import evidence as tev
from tendermint_tpu_torch.types.basic import BlockID as TBlockID
from tendermint_tpu_torch.types.block import Commit as TCommit

from tests.test_torch_block_exec import (J, T, _Chain, _duplicate_vote,
                                         _seed, _sign_commit)
from tests.test_torch_light import _KNOBS, reset_port, routed


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS + ("TMTPU_MERKLE_DEVICE_MIN",):
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    device.set_default_device(None)


# -- mirrors of tests/test_pubsub.py -----------------------------------------

def test_query_parsing_and_matching():
    q = Query("tm.event='NewBlock'")
    assert q.matches({"tm.event": ["NewBlock"]})
    assert not q.matches({"tm.event": ["Tx"]})
    assert not q.matches({})

    q = Query("tm.event='Tx' AND tx.height>5")
    assert q.matches({"tm.event": ["Tx"], "tx.height": ["6"]})
    assert not q.matches({"tm.event": ["Tx"], "tx.height": ["5"]})

    q = Query("tx.hash EXISTS")
    assert q.matches({"tx.hash": ["AB"]})
    assert not q.matches({})

    q = Query("app.key CONTAINS 'ell'")
    assert q.matches({"app.key": ["hello"]})
    assert not q.matches({"app.key": ["world"]})

    # any-value semantics over repeated keys
    q = Query("app.key='x'")
    assert q.matches({"app.key": ["y", "x"]})


def test_query_parse_errors():
    with pytest.raises(ValueError):
        Query("tm.event=")
    with pytest.raises(ValueError):
        Query("tm.event='a' OR tm.event='b'")


def test_pubsub_routing():
    async def run():
        srv = PubSubServer()
        sub = srv.subscribe("c1", Query("tm.event='A'"))
        srv.publish("one", {"tm.event": ["A"]})
        srv.publish("two", {"tm.event": ["B"]})
        srv.publish("three", {"tm.event": ["A"]})
        assert (await sub.next()).data == "one"
        assert (await sub.next()).data == "three"
        srv.unsubscribe("c1", Query("tm.event='A'"))
        with pytest.raises(SubscriptionCanceled):
            await sub.next()

    asyncio.run(run())


def test_pubsub_capacity_cancels_slow_subscriber():
    async def run():
        srv = PubSubServer()
        sub = srv.subscribe("slow", Query("tm.event='A'"), out_capacity=2)
        for _ in range(3):
            srv.publish("x", {"tm.event": ["A"]})
        # third publish overflowed → canceled
        await sub.next()
        await sub.next()
        with pytest.raises(SubscriptionCanceled):
            await sub.next()

    asyncio.run(run())


def test_event_bus_tx_events():
    async def run():
        bus = teb.EventBus()
        sub = bus.subscribe("test", "tm.event='Tx' AND tx.height=5")
        bus.publish_event_tx(5, 0, b"hello", ResponseDeliverTx())
        bus.publish_event_tx(6, 0, b"other", ResponseDeliverTx())
        msg = await sub.next()
        assert msg.data.height == 5 and msg.data.tx == b"hello"
        assert sub.queue.empty()

    asyncio.run(run())


def test_event_bus_app_event_keys():
    async def run():
        bus = teb.EventBus()
        sub = bus.subscribe("test", "app.creator='alice'")
        res = ResponseDeliverTx(events=[Event(type="app", attributes=[
            EventAttribute(b"creator", b"alice", True)])])
        bus.publish_event_tx(1, 0, b"t", res)
        msg = await sub.next()
        assert msg.data.tx == b"t"

    asyncio.run(run())


# -- the executor's events against the JAX package's -------------------------

def _norm(msg):
    """An event as plain values: its type, its composite keys and values
    in order, and what its data says."""
    d, kind = msg.data, msg.events[tme.EVENT_TYPE_KEY][-1]
    if kind == tme.EVENT_NEW_BLOCK:
        body = (d.block.encode(), d.block_id.hash,
                d.block_id.part_set_header.hash)
    elif kind == tme.EVENT_NEW_BLOCK_HEADER:
        body = d.header.encode()
    elif kind == tme.EVENT_NEW_EVIDENCE:
        body = (d.evidence.wrapped(), d.height)
    elif kind == tme.EVENT_TX:
        r = d.result
        body = (d.height, d.index, d.tx, r.code, r.data, r.log,
                [(e.type, [(a.key, a.value, a.index) for a in e.attributes])
                 for e in r.events])
    elif kind == tme.EVENT_VALIDATOR_SET_UPDATES:
        body = [(v.pub_key.bytes(), v.voting_power)
                for v in d.validator_updates]
    else:
        raise AssertionError(f"unexpected event {kind}")
    return kind, [(k, list(v)) for k, v in msg.events.items()], body


def test_block_executor_fires_the_same_events_as_jax():
    """Three heights through both executors, each with a bus and one
    subscriber to every event: txs with app events, a validator update at
    height 2 (a ValidatorSetUpdates event), duplicate-vote evidence in
    height 3 (a NewEvidence event). The port's LastCommits verify on its
    cuda route (plain kernels on the CPU), the JAX package's on its
    host."""
    seeds = [_seed(i) for i in range(5)]
    jprivs = {p.pub_key().address(): p for p in
              (jcrypto.Ed25519PrivKey.generate(s) for s in seeds)}
    j = _Chain(J, seeds[:4], app=jkv.KVStoreApplication())
    t = _Chain(T, seeds[:4], app=tkv.KVStoreApplication())
    newval = jcrypto.Ed25519PrivKey.generate(seeds[4]).pub_key().bytes()

    async def run():
        jbus, tbus = jeb.EventBus(), teb.EventBus()
        j.executor.event_bus, t.executor.event_bus = jbus, tbus
        jsub = jbus.subscribe("all", "tm.event EXISTS", out_capacity=1000)
        tsub = tbus.subscribe("all", "tm.event EXISTS", out_capacity=1000)
        jlast = JCommit(0, 0, JBlockID(), [])
        tlast = TCommit(0, 0, TBlockID(), [])
        for h in range(1, 4):
            txs = [f"k{h}{i}=v{i}".encode() for i in range(3)]
            if h == 2:
                txs.append(f"val:{newval.hex()}!7".encode())
            jevidence = [_duplicate_vote(j.state.validators, jprivs, h - 1)] \
                if h == 3 else []
            tevidence = tev.decode_evidence_list(
                jev.encode_evidence_list(jevidence))
            jblock, jparts = j.propose(h, txs, jlast, jevidence)
            tblock, tparts = t.propose(h, txs, tlast, tevidence)
            jvals = j.state.validators
            with routed("host"):
                j.apply(jblock, jparts, JBlockID)
            with routed("cuda"):
                t.apply(tblock, tparts, TBlockID)
            jlast = _sign_commit(h, jblock, jparts, jvals, jprivs)
            tlast = convert.commit_from_reference(jlast.encode())
        out = []
        for sub in (jsub, tsub):
            got = []
            while not sub.queue.empty():
                got.append(_norm(await sub.next()))
            out.append(got)
        return out

    jgot, tgot = asyncio.run(run())
    kinds = [k for k, _, _ in tgot]
    # per height: NewBlock, NewBlockHeader, evidence, txs, updates
    assert kinds == (
        ["NewBlock", "NewBlockHeader"] + ["Tx"] * 3
        + ["NewBlock", "NewBlockHeader"] + ["Tx"] * 4
        + ["ValidatorSetUpdates"]
        + ["NewBlock", "NewBlockHeader", "NewEvidence"] + ["Tx"] * 3)
    assert tgot == jgot
