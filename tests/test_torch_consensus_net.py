"""In-process consensus networks on the port (tendermint_tpu_torch/p2p/
switch.py, inproc.py; consensus/reactor.py; mempool/reactor.py;
evidence/reactor.py), and one node against signing stub validators
(tools/validator_stubs.py).

* the cases of tests/test_consensus_net.py :91, :114, :142, :163 and :250
  (a 4-validator net makes progress, a tx gossips and commits everywhere,
  3 of 4 make progress, a late node catches up, a double prevote becomes
  committed duplicate-vote evidence, here gossiped by the evidence
  reactors too), on ``LocalNode``s;
* the mempool and evidence reactors' wire messages equal the JAX
  package's bytes, and each decodes the other's;
* one node against 19 stub validators (20 of equal power): the stubs
  propose from their replica at least once, the node's vote flushes take
  the device route (the plain version on CPU tensors), both sides commit
  the same blocks in round 0;
* the fault pin of the reactor (ROADMAP §3): a fault of the card in a
  vote's preverify drops that delivery, counts once, and the vote never
  reaches the batcher's host miss path; delivered again, it is verified
  on the device route and added on a cache hit.
"""

import asyncio

import numpy as np
import pytest
import torch

from tendermint_tpu import crypto as jcrypto
from tendermint_tpu.evidence import reactor as jev_reactor
from tendermint_tpu.mempool import reactor as jmp_reactor
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.basic import SignedMsgType as JSMT
from tendermint_tpu.types.evidence import \
    DuplicateVoteEvidence as JDuplicateVoteEvidence
from tendermint_tpu.types.priv_validator import MockPV as JMockPV
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch import crypto, device
from tendermint_tpu_torch.consensus.config import test_consensus_config
from tendermint_tpu_torch.consensus.msgs import VoteMessageWire, encode_msg
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.evidence import reactor as tev_reactor
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
from tendermint_tpu_torch.mempool import reactor as tmp_reactor
from tendermint_tpu_torch.p2p import VOTE_CHANNEL, InProcNetwork
from tendermint_tpu_torch.p2p.base import Peer
from tendermint_tpu_torch.state import state_from_genesis
from tendermint_tpu_torch.tools import commits, validator_stubs
from tendermint_tpu_torch.tools.validator_stubs import (LocalNode,
                                                        ValidatorStubs)
from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                        GenesisValidator, MockPV,
                                        PartSetHeader, SignedMsgType)
from tendermint_tpu_torch.types import events as tme
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.params import default_consensus_params
from tendermint_tpu_torch.types.vote import Vote

from tests.test_torch_light import _KNOBS, reset_port

CHAIN_ID = "net-chain"
GENESIS_NS = 1_700_000_000_000_000_000


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


def make_net(n, evidence=False):
    pvs = [MockPV(crypto.Ed25519PrivKey.generate(bytes([0x60 + i]) * 32))
           for i in range(n)]
    genesis = GenesisDoc(
        chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
        validators=[GenesisValidator(pv.get_pub_key(), 10) for pv in pvs])
    nodes = []
    for i, pv in enumerate(pvs):
        node = LocalNode(f"node{i}", genesis, pv)
        if evidence:
            # a real pool for the block executor and the state machine,
            # gossiped by the evidence reactor
            pool = EvidencePool(MemDB(), node.state_store, node.block_store)
            node.cs.evpool = node.block_exec.evpool = pool
            node.evidence_pool = pool
            node.switch.add_reactor("EVIDENCE",
                                    EvidenceReactor(pool, gossip_sleep=0.05))
        nodes.append(node)
    return nodes


async def wait_all_height(nodes, height, timeout=30.0):
    async def one(node):
        sub = node.event_bus.subscribe("netwait", tme.QUERY_NEW_BLOCK)
        try:
            while node.cs.state.last_block_height < height:
                await sub.next()
        finally:
            node.event_bus.unsubscribe_all("netwait")

    await asyncio.wait_for(asyncio.gather(*(one(nd) for nd in nodes)),
                           timeout)


async def start_net(nodes):
    net = InProcNetwork()
    for nd in nodes:
        net.add_switch(nd.switch)
    for nd in nodes:
        await nd.start()
    await net.connect_all()
    return net


async def stop_all(nodes):
    for nd in nodes:
        await nd.stop()


def test_four_validator_net_makes_progress():
    async def run():
        nodes = make_net(4)
        await start_net(nodes)
        try:
            await wait_all_height(nodes, 3)
        finally:
            await stop_all(nodes)
        assert min(nd.cs.state.last_block_height for nd in nodes) >= 3
        assert len({nd.block_store.load_block_meta(2).header.hash()
                    for nd in nodes}) == 1

    asyncio.run(run())


def test_tx_gossip_and_commit_all_nodes():
    async def run():
        nodes = make_net(4)
        await start_net(nodes)
        try:
            nodes[2].mempool.check_tx(b"gossip=works")
            deadline = asyncio.get_running_loop().time() + 30
            while not all(nd.app.state.get("gossip") == "works"
                          for nd in nodes):
                assert asyncio.get_running_loop().time() < deadline, \
                    [nd.app.state for nd in nodes]
                await asyncio.sleep(0.05)
        finally:
            await stop_all(nodes)

    asyncio.run(run())


def test_progress_with_one_node_down():
    async def run():
        live = make_net(4)[:3]  # 3/4 = 75% > 2/3
        await start_net(live)
        try:
            await wait_all_height(live, 2, timeout=60)
        finally:
            await stop_all(live)
        assert all(nd.cs.state.last_block_height >= 2 for nd in live)

    asyncio.run(run())


def test_late_node_catches_up():
    async def run():
        nodes = make_net(4)
        late = nodes[3]
        net = await start_net(nodes[:3])
        try:
            await wait_all_height(nodes[:3], 3, timeout=60)
            net.add_switch(late.switch)
            await late.start()
            for other in nodes[:3]:
                await net.connect(late.switch.node_id, other.switch.node_id)
            await wait_all_height([late], 3, timeout=60)
        finally:
            await stop_all(nodes)
        assert late.cs.state.last_block_height >= 3

    asyncio.run(run())


def test_byzantine_double_prevote_produces_evidence():
    async def run():
        nodes = make_net(4, evidence=True)
        nodes[0].cs.misbehaviors[2] = "double-prevote"
        await start_net(nodes)
        byz_addr = nodes[0].pv.get_pub_key().address()

        def evidence_committed():
            for nd in nodes[1:]:
                for h in range(2, nd.block_store.height() + 1):
                    blk = nd.block_store.load_block(h)
                    for ev in (blk.evidence if blk else []):
                        if isinstance(ev, DuplicateVoteEvidence):
                            assert ev.vote_a.validator_address == byz_addr
                            return True
            return False

        try:
            await wait_all_height(nodes, 8, timeout=90.0)
            deadline = asyncio.get_running_loop().time() + 90.0
            while not evidence_committed():
                if asyncio.get_running_loop().time() > deadline:
                    break
                await asyncio.sleep(0.1)
        finally:
            await stop_all(nodes)
        assert evidence_committed(), "duplicate-vote evidence never committed"

    asyncio.run(run())


# -- one node against the signing stubs ---------------------------------------

class InlineSigner:
    """``tools.commits.Signer``'s interface, signing in the calling thread
    (the stubs call it from an executor thread)."""

    def sign(self, jobs):
        return commits._sign_chunk(jobs)


def _stub_genesis(n, txs_a_height):
    rng = np.random.default_rng(7)
    privs = [ed.keygen(s)[0] for s in commits.seeds(rng, n)]
    pubs = [crypto.Ed25519PubKey(p[32:]) for p in privs]
    params = default_consensus_params()
    params.block.max_gas = txs_a_height
    genesis = GenesisDoc(chain_id="stub-chain", genesis_time_ns=GENESIS_NS,
                         validators=[GenesisValidator(p, 10) for p in pubs],
                         consensus_params=params)
    return genesis, privs, pubs


def test_node_against_stub_validators_takes_device_flushes():
    n, heights, per_height = 20, 2, 16
    genesis, privs, pubs = _stub_genesis(n, per_height)
    vals = state_from_genesis(genesis).validators
    # the node proposes height 2; the stubs the others
    p2 = vals.copy_increment_proposer_priority(1).get_proposer().address
    node_i = next(i for i, p in enumerate(pubs) if p.address() == p2)
    cfg = test_consensus_config()
    cfg.timeout_propose = 3.0
    node = LocalNode("node", genesis,
                     MockPV(crypto.Ed25519PrivKey(privs[node_i])), config=cfg,
                     broadcast_txs=False)
    # plain kernels on a busy CPU take seconds; gather a flush over 50 ms
    bv = node.cs.vote_verifier
    bv.device_timeout_s, bv.deadline_s = 120.0, 0.05
    stubs = ValidatorStubs(genesis, {pubs[i].address(): privs[i]
                                     for i in range(n) if i != node_i},
                           InlineSigner())
    txs = [b"s%d-%02d=v" % (h, i) for h in range(heights)
           for i in range(per_height)]

    async def run():
        net = InProcNetwork()
        net.add_switch(node.switch)
        await node.switch.start()
        await stubs.connect(net, "node")
        for tx in txs:
            node.mempool.check_tx(tx)
            stubs.mempool.check_tx(tx)
        await node.cs.start()
        stubs.drive()
        try:
            await wait_all_height([node], heights, timeout=60)
        finally:
            await stubs.stop()
            await node.stop()

    # the LastCommits verify on the host route; the flushes keep theirs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMTPU_DEVICE_THRESHOLD", "1000")
        # no resend while a plain flush is still running
        mp.setattr(validator_stubs, "RESEND_AFTER_S", 60.0)
        asyncio.run(run())
    assert bv.stats["device_batches"] > 0, dict(bv.stats)
    assert bv.stats["device_errors"] == 0
    assert stubs.stats["proposals"] >= 1
    committed = []
    for h in range(1, heights + 1):
        blk = node.block_store.load_block(h)
        assert stubs.commits[h][0] == blk.hash()
        assert node.block_store.load_seen_commit(h).round == 0
        committed += blk.data.txs
    assert committed == txs[:len(committed)] and \
        len(committed) == heights * per_height
    # height 2 was the node's own proposal, the others the stubs'
    assert node.block_store.load_block(2).header.proposer_address == p2
    assert node.block_store.load_block(1).header.proposer_address != p2


# -- the reactor's fault pin --------------------------------------------------

class _Peer(Peer):
    def __init__(self, peer_id):
        super().__init__(peer_id)

    def try_send(self, channel_id, msg):
        return True

    send = try_send

    def is_running(self):
        return True


def test_preverify_device_fault_drops_the_vote_without_host_verify():
    pvs = [MockPV(crypto.Ed25519PrivKey.generate(bytes([0x70 + i]) * 32))
           for i in range(4)]
    genesis = GenesisDoc(
        chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
        validators=[GenesisValidator(pv.get_pub_key(), 10) for pv in pvs])
    node = LocalNode("node", genesis, pvs[0])
    cs, reactor = node.cs, node.cs_reactor
    cm = CryptoMetrics(Registry())
    tbatch.set_crypto_metrics(cm)
    bv = cs.vote_verifier
    bv.min_device_batch = 1  # one vote rides the device route
    misses = []
    verify = bv.verify

    def spied(pub, msg, sig):
        if bv._key(pub.bytes(), msg, sig) not in bv._cache:
            misses.append(sig)
        return verify(pub, msg, sig)

    bv.verify = spied
    idx, val = cs.rs.validators.get_by_address(pvs[2].get_pub_key().address())
    vote = Vote(SignedMsgType.PREVOTE, 1, 0,
                BlockID(b"\x05" * 32, PartSetHeader(1, b"\x06" * 32)),
                GENESIS_NS + 1, val.address, idx)
    pvs[2].sign_vote(CHAIN_ID, vote)
    peer = _Peer("peer2")
    reactor.init_peer(peer)

    async def deliver():
        await reactor.receive(VOTE_CHANNEL, peer,
                              encode_msg(VoteMessageWire(vote)))
        while reactor._inflight:
            await asyncio.gather(*list(reactor._inflight))

    async def run():
        tfaults.configure("device.vote_flush*1")
        await deliver()
        tfaults.reset()
        dropped = cs._queue.qsize()
        await deliver()  # the same vote again, the fault gone
        forwarded = [cs._queue.get_nowait() for _ in range(cs._queue.qsize())]
        for mi in forwarded:
            cs._handle_msg(mi)
        return dropped, forwarded

    dropped, forwarded = asyncio.run(run())
    assert dropped == 0  # the faulted delivery never reached the machine
    assert reactor.stats["preverify_device_errors"] == 1
    assert reactor.stats["preverify_dropped_votes"] == 1
    assert cm.device_errors_total.value("injected", "votes") == 1
    assert len(forwarded) == 1
    assert misses == []  # no host verify through the miss path
    assert bv.stats["device_batches"] == 1 and bv.stats["cache_hits"] == 1
    assert cs.rs.votes.prevotes(0).get_by_index(idx) is not None


# -- the mempool and evidence reactors' wire messages -------------------------

def test_reactor_wire_messages_match_the_jax_package():
    txs = [b"a=1", b"\xff" * 40, b"k" * 300]
    jb = jmp_reactor.encode_txs(txs)
    assert tmp_reactor.encode_txs(txs) == jb
    assert tmp_reactor.decode_txs(jb) == jmp_reactor.decode_txs(jb) == txs
    pv = JMockPV(jcrypto.Ed25519PrivKey.generate(b"\x5a" * 32))
    vals = JValidatorSet([JValidator(pv.get_pub_key().address(),
                                     pv.get_pub_key(), 10)])
    votes = []
    for i in range(2):
        v = JVote(JSMT.PREVOTE, 3, 0,
                  JBlockID(bytes([i + 1]) * 32, JPSH(1, bytes([i + 7]) * 32)),
                  GENESIS_NS + 5, pv.get_pub_key().address(), 0)
        pv.sign_vote(CHAIN_ID, v)
        votes.append(v)
    jev = JDuplicateVoteEvidence.new(votes[0], votes[1], GENESIS_NS, vals)
    tev = convert.evidence_from_reference(jev.wrapped())
    jb = jev_reactor.encode_evidence_list_msg([jev, jev])
    assert tev_reactor.encode_evidence_list_msg([tev, tev]) == jb
    got = tev_reactor.decode_evidence_list_msg(jb)
    assert [e.hash() for e in got] == [tev.hash()] * 2
    assert [e.hash() for e in jev_reactor.decode_evidence_list_msg(
        tev_reactor.encode_evidence_list_msg([tev]))] == [jev.hash()]
