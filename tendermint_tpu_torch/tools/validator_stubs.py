"""Signing stub validators for one consensus node under test, and that node.

The reference drives one real state machine against the rest of a
validator set in its consensus tests (consensus/common_test.go:
``validatorStub``, ``signVote``, ``decideProposal``). ``ValidatorStubs`` is
that fixture over the port's wire: it holds the keys of N-1 validators of
an N-validator, equal-power Ed25519 set and reaches the node on an
``InProcNetwork`` as ``LINKS`` peers (switches ``stubs-0``, ``stubs-1``,
...), as a node's votes come from many peers. Validator ``i`` votes over
link ``i % LINKS``. Link 0 carries every message both ways; on the other
links the node's messages are blackholed (a ``LinkPolicy`` with
``blocked``), since link 0 hands the same messages to the same stubs. The
fixture acts only through the wire, as peers:

* it announces its height, round and step (NewRoundStep) on every link and
  tracks the node's from the node's own NewRoundStep messages;
* it decodes the node's Proposal and BlockPart messages (DATA_CHANNEL);
* when the proposer priority of its replica's ``ValidatorSet`` names one of
  its validators for a height at round 0, it builds the block with the
  replica's ``BlockExecutor.create_proposal_block``, signs the Proposal
  with that validator's key and sends it and its parts;
* once the node is at the height and the block is known, it sends every
  stub validator's signed prevote and then precommit for the block's
  ``BlockID`` (VOTE_CHANNEL); after its first vote of a height each link
  tells the node, with one VoteSetBits a vote type, that it holds every
  stub vote (a real peer says so with a HasVote a vote), so the node does
  not gossip the other links' votes back to it;
* its N-1 precommits are more than 2/3 of the power, so it then commits
  the block to its replica: the kvstore app and state of its own, kept by
  applying the blocks its precommits committed (their LastCommits check
  against verdicts it knows already: its own signatures, and the node's
  precommit, which it verifies on the host when it arrives, so the
  fixture launches no kernel);
* a stub proposer waits ``NODE_PRECOMMIT_WAIT_S`` (the test config's
  ``timeout_commit``) for the node's precommit of the last height before
  it builds its LastCommit;
* votes the node did not take (no HasVote came back after
  ``RESEND_AFTER_S``) are asked about with VoteSetMaj23, and the ones the
  node's VoteSetBits answer lacks are sent again; a NewValidBlock from the
  node gets the parts it lacks. Those are the reference reactor's own
  recovery paths, all on link 0.

Stub validators vote in round 0 only. Signing runs in ``signer`` (a
``tools.commits.Signer``: spawn workers), called from an executor thread,
so the node's event loop keeps running while the stubs sign. Txs reach
the stubs' replica from the caller (``mempool.check_tx``), not by gossip.
The fixture reads no attribute of the node's ``ConsensusState``.

``LocalNode`` builds one port node from its modules (kvstore app, stores,
mempool, ``ConsensusState``, the consensus and mempool reactors, a switch)
as the reference's consensus net tests build theirs.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..abci.example.kvstore import KVStoreApplication
from ..consensus.config import ConsensusConfig, test_consensus_config
from ..consensus.msgs import (BlockPartMessageWire, HasVoteMessage,
                              NewRoundStepMessage, NewValidBlockMessage,
                              ProposalMessageWire, VoteMessageWire,
                              VoteSetBitsMessage, VoteSetMaj23Message,
                              decode_msg, encode_msg)
from ..consensus.reactor import ConsensusReactor
from ..consensus.replay import Handshaker
from ..consensus.round_state import RoundStep
from ..consensus.state import ConsensusState
from ..crypto import batch as _batch
from ..libs.db import MemDB
from ..mempool import CListMempool
from ..mempool.reactor import MempoolReactor
from ..p2p import (DATA_CHANNEL, STATE_CHANNEL, VOTE_CHANNEL,
                   VOTE_SET_BITS_CHANNEL)
from ..p2p.base import ChannelDescriptor, Peer, Reactor
from ..p2p.switch import Switch
from ..proxy import AppConns, local_client_creator
from ..state import BlockExecutor, StateStore, state_from_genesis
from ..state.execution import EmptyEvidencePool
from ..store import BlockStore
from ..types import GenesisDoc
from ..types.basic import BlockID, BlockIDFlag, SignedMsgType
from ..types.block import Block, Commit, CommitSig
from ..types.event_bus import EventBus
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.vote import Vote

logger = logging.getLogger("tmtpu.tools.stubs")


#: how long a stub proposer waits for the node's last precommit
NODE_PRECOMMIT_WAIT_S = 0.01
#: the stubs' peers of the node: within the reference's defaults of 10
#: outbound and 40 inbound peers (config/config.go P2PConfig)
LINKS = 16
#: votes the node has not reported this long after they were sent are
#: asked about (the reference's peer_query_maj23_sleep_duration)
RESEND_AFTER_S = 2.0


class LocalNode:
    """One port node: kvstore app, in-memory stores, a CListMempool, an
    ``EmptyEvidencePool``, the consensus state machine with ``pv`` (no
    WAL) and the consensus and mempool reactors on a switch named
    ``name``. ``broadcast_txs`` False is the reference's
    ``mempool.broadcast = false``: the node gossips no txs."""

    def __init__(self, name: str, genesis: GenesisDoc, pv,
                 config: Optional[ConsensusConfig] = None,
                 broadcast_txs: bool = True):
        self.name = name
        self.pv = pv
        self.app = KVStoreApplication()
        self.conns = AppConns(local_client_creator(self.app))
        self.conns.start()
        self.state_store = StateStore(MemDB())
        self.block_store = BlockStore(MemDB())
        state = Handshaker(self.state_store, state_from_genesis(genesis),
                           self.block_store, genesis).handshake(
            self.conns.consensus, self.conns.query)
        self.state_store.save(state)
        self.mempool = CListMempool(self.conns.mempool)
        self.event_bus = EventBus()
        self.block_exec = BlockExecutor(self.state_store,
                                        self.conns.consensus, self.mempool,
                                        EmptyEvidencePool(), self.block_store,
                                        self.event_bus)
        self.cs = ConsensusState(config or test_consensus_config(), state,
                                 self.block_exec, self.block_store)
        self.cs.set_priv_validator(pv)
        self.cs.set_event_bus(self.event_bus)
        self.mempool.tx_available_callbacks.append(
            self.cs.notify_txs_available)
        self.switch = Switch(name)
        self.cs_reactor = ConsensusReactor(self.cs)
        self.switch.add_reactor("CONSENSUS", self.cs_reactor)
        self.mempool_reactor = MempoolReactor(self.mempool,
                                              broadcast=broadcast_txs,
                                              gossip_sleep=0.005)
        self.switch.add_reactor("MEMPOOL", self.mempool_reactor)

    async def start(self) -> None:
        await self.switch.start()
        await self.cs.start()

    async def stop(self) -> None:
        await self.cs.stop()
        await self.switch.stop()
        # settle the vote batcher's pending flush before the loop closes
        bv = self.cs.vote_verifier
        await bv.flush_now()
        if bv._flush_tasks:
            await asyncio.wait(list(bv._flush_tasks), timeout=30)
        self.conns.stop()


class _StubReactor(Reactor):
    """The stubs' end of the consensus channels on link ``link``: decodes
    the node's messages and hands them to ``ValidatorStubs``."""

    def __init__(self, stubs: "ValidatorStubs", link: int):
        super().__init__("CONSENSUS")
        self.stubs = stubs
        self.link = link

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(STATE_CHANNEL, priority=6),
                ChannelDescriptor(DATA_CHANNEL, priority=10),
                ChannelDescriptor(VOTE_CHANNEL, priority=7),
                ChannelDescriptor(VOTE_SET_BITS_CHANNEL, priority=1)]

    async def add_peer(self, peer: Peer) -> None:
        self.stubs._on_peer(self.link, peer)

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self.stubs._on_peer_gone(self.link, peer)

    async def receive(self, channel_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        self.stubs._on_message(decode_msg(msg_bytes))


class ValidatorStubs:
    """N-1 signing validators behind ``LINKS`` switches (the module
    docstring).

    ``keys`` maps each stub validator's address to the key ``signer.sign``
    takes (a 32-byte seed or the 64-byte private key). ``stats`` counts
    what the stubs did: ``proposals``, ``votes_sent`` a type, ``resent``,
    ``heights`` committed, ``node_precommits`` taken into a LastCommit.
    ``commits`` maps each height the stubs committed to (block hash, app
    hash after it). ``seconds`` sums the wall time the stubs spent signing
    (``sign``), applying blocks to the replica (``apply``) and building
    their proposals (``propose``)."""

    def __init__(self, genesis: GenesisDoc, keys: Dict[bytes, bytes],
                 signer):
        self.chain_id = genesis.chain_id
        self.keys = dict(keys)
        self.signer = signer
        self.app = KVStoreApplication()
        self.conns = AppConns(local_client_creator(self.app))
        self.conns.start()
        self.state_store = StateStore(MemDB())
        block_store = BlockStore(MemDB())
        self.state = Handshaker(self.state_store,
                                state_from_genesis(genesis), block_store,
                                genesis).handshake(self.conns.consensus,
                                                   self.conns.query)
        self.state_store.save(self.state)
        self.mempool = CListMempool(self.conns.mempool)
        self.block_exec = BlockExecutor(self.state_store,
                                        self.conns.consensus, self.mempool,
                                        EmptyEvidencePool(), block_store)
        self.switches = [Switch(f"stubs-{j}")
                         for j in range(min(LINKS, len(self.keys)))]
        for j, sw in enumerate(self.switches):
            sw.add_reactor("CONSENSUS", _StubReactor(self, j))
        self._peers: List[Optional[Peer]] = [None] * len(self.switches)
        self.stats = collections.Counter()
        self.seconds = collections.Counter()
        self.commits: Dict[int, Tuple[bytes, bytes]] = {}
        self._node_hrs = (0, -1, 0)
        self._wake = asyncio.Event()
        self._last_query = 0.0
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        # the height in hand
        self.height = 0
        self._block: Optional[Block] = None
        self._parts: Optional[PartSet] = None
        self._proposal: Optional[Proposal] = None
        # (height, round, type) -> {validator index: Vote} of the stubs
        self._votes: Dict[Tuple[int, int, int], Dict[int, Vote]] = {}
        self._sent_at: Dict[Tuple[int, int, int], float] = {}
        # (height, round, type) -> validator indexes the node reported
        self._node_has: Dict[Tuple[int, int, int], set] = \
            collections.defaultdict(set)
        # (height, round) -> the node's own precommit
        self._node_precommits: Dict[Tuple[int, int], Vote] = {}
        # height -> {(pubkey, sign bytes, signature): True} of the
        # precommits the stubs know to be valid
        self._known: Dict[int, Dict[Tuple[bytes, bytes, bytes], bool]] = \
            collections.defaultdict(dict)

    # -- lifecycle ------------------------------------------------------------

    async def connect(self, net, node_id: str) -> None:
        """Join ``net`` and connect every link to the node ``node_id``: the
        stubs track the node, but propose and vote only after
        :meth:`drive`."""
        for sw in self.switches:
            net.add_switch(sw)
            await sw.start()
        for j, sw in enumerate(self.switches):
            await net.connect(node_id, sw.node_id)
            if j:
                net.set_link_policy(node_id, sw.node_id, blocked=True)

    def drive(self) -> None:
        """Start proposing, voting and committing, height after height."""
        self._task = asyncio.create_task(self._drive())

    async def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for sw in self.switches:
            await sw.stop()
        self.conns.stop()

    # -- the wire -------------------------------------------------------------

    def _on_peer(self, link: int, peer: Peer) -> None:
        self._peers[link] = peer
        self._announce(RoundStep.NEW_HEIGHT)
        self._wake.set()

    def _on_peer_gone(self, link: int, peer: Peer) -> None:
        if self._peers[link] is peer:
            self._peers[link] = None

    def _send(self, channel_id: int, msg, link: int = 0) -> None:
        peer = self._peers[link]
        if peer is not None:
            peer.try_send(channel_id, msg if isinstance(msg, bytes)
                          else encode_msg(msg))

    def _announce(self, step: RoundStep) -> None:
        h = self.height or self.state.initial_height
        msg = encode_msg(NewRoundStepMessage(
            h, 0, int(step), 0, 0 if h > self.state.initial_height else -1))
        for link in range(len(self._peers)):
            self._send(STATE_CHANNEL, msg, link)

    def _on_message(self, msg) -> None:
        # the driver waits on the node's height, the block and the node's
        # precommit: only those messages wake it (one wake a vote the node
        # takes would cost the loop the node runs on)
        wake = True
        if isinstance(msg, NewRoundStepMessage):
            self._node_hrs = (msg.height, msg.round, msg.step)
        elif isinstance(msg, HasVoteMessage):
            self._node_has[(msg.height, msg.round, int(msg.type))].add(
                msg.index)
            wake = False
        elif isinstance(msg, ProposalMessageWire):
            self._on_proposal(msg.proposal)
        elif isinstance(msg, BlockPartMessageWire):
            self._on_part(msg)
        elif isinstance(msg, VoteMessageWire):
            self._on_node_vote(msg.vote)
        else:
            wake = False
            if isinstance(msg, VoteSetMaj23Message):
                self._on_maj23(msg)
            elif isinstance(msg, VoteSetBitsMessage):
                self._on_vote_set_bits(msg)
            elif isinstance(msg, NewValidBlockMessage):
                self._on_new_valid_block(msg)
        if wake:
            self._wake.set()

    def _on_proposal(self, proposal: Proposal) -> None:
        if (proposal.height != self.height or proposal.round != 0
                or self._parts is not None):
            return
        proposer = self.state.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
                proposal.sign_bytes(self.chain_id), proposal.signature):
            logger.warning("stubs: proposal %d/0 with a bad signature",
                           proposal.height)
            return
        self._proposal = proposal
        self._parts = PartSet.from_header(proposal.block_id.part_set_header)

    def _on_part(self, msg: BlockPartMessageWire) -> None:
        if (msg.height != self.height or msg.round != 0
                or self._parts is None or self._block is not None):
            return
        if self._parts.add_part(msg.part) and self._parts.is_complete():
            self._block = Block.decode(self._parts.get_reader())

    def _on_node_vote(self, vote: Vote) -> None:
        if vote.type != SignedMsgType.PRECOMMIT or vote.round != 0:
            return
        _, val = self.state.validators.get_by_index(vote.validator_index) \
            if vote.height == self.height else \
            self.state.last_validators.get_by_index(vote.validator_index)
        if val is None or val.address in self.keys:
            return
        sb = vote.sign_bytes(self.chain_id)
        if val.pub_key.verify_signature(sb, vote.signature):
            self._known[vote.height][(val.pub_key.bytes(), sb,
                                      vote.signature)] = True
            self._node_precommits[(vote.height, vote.round)] = vote

    def _on_maj23(self, msg: VoteSetMaj23Message) -> None:
        votes = self._votes.get((msg.height, msg.round, int(msg.type)), {})
        bits = _bit_array(self._vset_size(msg.height),
                          [i for i, v in votes.items()
                           if v.block_id == msg.block_id])
        self._send(VOTE_SET_BITS_CHANNEL, VoteSetBitsMessage(
            msg.height, msg.round, msg.type, msg.block_id, bits))

    def _on_vote_set_bits(self, msg: VoteSetBitsMessage) -> None:
        key = (msg.height, msg.round, int(msg.type))
        for i, v in sorted(self._votes.get(key, {}).items()):
            if v.block_id == msg.block_id and not msg.votes.get_index(i):
                self._send(VOTE_CHANNEL, VoteMessageWire(v))
                self.stats["resent"] += 1
        self._sent_at[key] = time.monotonic()

    def _on_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        parts = self._parts
        if (msg.height != self.height or parts is None
                or not parts.is_complete()
                or parts.header() != msg.block_part_set_header):
            return
        for i in range(parts.total):
            if not msg.block_parts.get_index(i):
                self._send(DATA_CHANNEL, BlockPartMessageWire(
                    self.height, 0, parts.get_part(i)))

    def _vset_size(self, height: int) -> int:
        return (self.state.validators if height == self.height
                else self.state.last_validators).size()

    # -- the driver -----------------------------------------------------------

    async def _wait(self, cond, timeout: Optional[float] = None) -> bool:
        """Wait until ``cond()`` holds (True) or ``timeout`` passes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not cond():
            if self._stopped:
                raise asyncio.CancelledError
            self._wake.clear()
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return False
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       min(0.25, left) if left else 0.25)
            except asyncio.TimeoutError:
                pass
            now = time.monotonic()
            if now - self._last_query >= 0.25:
                self._last_query = now
                self._query_stale_votes()
        return True

    def _node_height(self) -> int:
        return self._node_hrs[0]

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            state = self.state
            h = state.last_block_height + 1
            if h == 1:
                h = state.initial_height
            self.height = h
            self._block = self._parts = self._proposal = None
            self._announce(RoundStep.NEW_HEIGHT)
            proposer = state.validators.get_proposer()
            if proposer.address in self.keys:
                await self._propose(loop, h, proposer.address)
            await self._wait(lambda: self._node_height() >= h)
            if self._proposal is not None and self._block is not None \
                    and proposer.address in self.keys:
                self._announce(RoundStep.PROPOSE)
                self._send_proposal()
            await self._wait(lambda: self._block is not None)
            await self._vote(loop, h)
            await self._commit(loop, h)

    async def _sign(self, loop, jobs):
        t = time.perf_counter()
        sigs = await loop.run_in_executor(None, self.signer.sign, jobs)
        self.seconds["sign"] += time.perf_counter() - t
        return sigs

    async def _propose(self, loop, h: int, proposer_addr: bytes) -> None:
        state = self.state
        if h == state.initial_height:
            commit = Commit(0, 0, BlockID(), [])
        else:
            # the node's precommit of the last height, if it comes soon
            await self._wait(
                lambda: (h - 1, 0) in self._node_precommits,
                NODE_PRECOMMIT_WAIT_S)
            commit = self._last_commit(h - 1)
        t = time.perf_counter()
        block, parts = self.block_exec.create_proposal_block(
            h, state, commit, proposer_addr)
        proposal = Proposal(h, 0, -1, BlockID(block.hash(), parts.header()),
                            time.time_ns())
        self.seconds["propose"] += time.perf_counter() - t
        (sig,) = await self._sign(
            loop, [(self.keys[proposer_addr],
                    proposal.sign_bytes(self.chain_id))])
        proposal.signature = sig
        self._proposal, self._block, self._parts = proposal, block, parts
        self.stats["proposals"] += 1

    def _send_proposal(self) -> None:
        self._send(DATA_CHANNEL, ProposalMessageWire(self._proposal))
        for i in range(self._parts.total):
            self._send(DATA_CHANNEL, BlockPartMessageWire(
                self.height, 0, self._parts.get_part(i)))

    def _last_commit(self, height: int) -> Commit:
        """The commit of ``height`` from the stubs' precommits and the
        node's, if it came: validator order, absent where none."""
        vals = self.state.last_validators
        mine = self._votes.get((height, 0, int(SignedMsgType.PRECOMMIT)), {})
        node = self._node_precommits.get((height, 0))
        block_id = next(iter(mine.values())).block_id
        sigs = []
        for i, val in enumerate(vals.validators):
            v = mine.get(i)
            if v is None and node is not None and node.validator_index == i:
                v = node
                flag = (BlockIDFlag.COMMIT if node.block_id == block_id
                        else BlockIDFlag.NIL)
                self.stats["node_precommits"] += 1
            else:
                flag = BlockIDFlag.COMMIT
            sigs.append(CommitSig.new_absent() if v is None else
                        CommitSig(flag, v.validator_address, v.timestamp_ns,
                                  v.signature))
        return Commit(height, 0, block_id, sigs)

    async def _vote(self, loop, h: int) -> None:
        """Sign every stub validator's prevote and precommit for the block
        in one pass of the signer, then send the prevotes and the
        precommits, each over its validator's link: validators that sign
        in microseconds precommit right after the polka, so the node sees
        one burst, not two spaced by the fixture's slow signing."""
        block = self._block
        block_id = BlockID(block.hash(), self._parts.header())
        iota_ns = self.state.consensus_params.block.time_iota_ms * 1_000_000
        base = max(time.time_ns(), block.header.time_ns + iota_ns)
        vals = self.state.validators.validators
        types = (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)
        votes = [Vote(t, h, 0, block_id, base + 1_000 * i, val.address, i)
                 for t in types
                 for i, val in enumerate(vals) if val.address in self.keys]
        sbs = [v.sign_bytes(self.chain_id) for v in votes]
        sigs = await self._sign(loop, [(self.keys[v.validator_address], sb)
                                       for v, sb in zip(votes, sbs)])
        for v, sb, sig in zip(votes, sbs, sigs):
            v.signature = sig
            self._votes.setdefault((h, 0, int(v.type)), {})[
                v.validator_index] = v
            if v.type == SignedMsgType.PRECOMMIT:
                self._known[h][(vals[v.validator_index].pub_key.bytes(),
                                sb, sig)] = True
        held = _bit_array(len(vals), [v.validator_index for v in votes
                                      if v.type == SignedMsgType.PREVOTE])
        claims = [encode_msg(VoteSetBitsMessage(h, 0, t, block_id, held))
                  for t in types]
        links = len(self._peers)
        claimed = set()
        for t, step in zip(types, (RoundStep.PREVOTE, RoundStep.PRECOMMIT)):
            key = (h, 0, int(t))
            for i, v in sorted(self._votes[key].items()):
                link = i % links
                self._send(VOTE_CHANNEL, VoteMessageWire(v), link)
                # after the link's first vote, which gives the node its
                # vote bit arrays for this peer
                if link not in claimed:
                    claimed.add(link)
                    for claim in claims:
                        self._send(VOTE_SET_BITS_CHANNEL, claim, link)
            self._sent_at[key] = time.monotonic()
            self.stats[f"votes_sent_{t.name.lower()}"] += len(self._votes[key])
            self._announce(step)

    async def _commit(self, loop, h: int) -> None:
        """Apply the block the stubs' precommits committed to the replica,
        its LastCommit checked against verdicts the stubs know."""
        block = self._block
        block_id = BlockID(block.hash(), self._parts.header())
        known = self._known_for(block)

        def apply():
            token = _batch.precomputed_verdicts.set(known)
            try:
                return self.block_exec.apply_block(self.state, block_id,
                                                   block)
            finally:
                _batch.precomputed_verdicts.reset(token)

        t = time.perf_counter()
        self.state, _ = await loop.run_in_executor(None, apply)
        self.seconds["apply"] += time.perf_counter() - t
        self.commits[h] = (block.hash(), self.state.app_hash)
        self.stats["heights"] += 1
        # forget what no later height needs
        for store in (self._votes, self._sent_at, self._node_has,
                      self._node_precommits):
            for key in [k for k in store if k[0] < h - 1]:
                del store[key]
        for height in [k for k in self._known if k < h]:
            del self._known[height]

    def _known_for(self, block: Block) -> Dict[Tuple[bytes, bytes, bytes],
                                                bool]:
        """The verdict of every signature of the block's LastCommit: from
        what the stubs know, else the host spec (a signature the node
        relayed that the stubs never saw)."""
        commit = block.last_commit
        if commit is None or commit.size() == 0:
            return {}
        vals = self.state.last_validators
        known = self._known.get(commit.height, {})
        out = {}
        for val, cs, sb in zip(vals.validators, commit.signatures,
                               commit.vote_sign_bytes_all(self.chain_id)):
            if cs.absent():
                continue
            k = (val.pub_key.bytes(), sb, cs.signature)
            out[k] = known.get(k) or val.pub_key.verify_signature(
                sb, cs.signature)
        return out

    def _query_stale_votes(self) -> None:
        """VoteSetMaj23 for each set of the node's height whose votes the
        node has not all reported (HasVote) ``RESEND_AFTER_S`` after they
        were sent; its VoteSetBits answer gets the missing ones again."""
        h = self._node_height()
        now = time.monotonic()
        for key, votes in self._votes.items():
            if key[0] != h or now - self._sent_at.get(key, now) < \
                    RESEND_AFTER_S:
                continue
            if set(votes) <= self._node_has[key]:
                continue
            block_id = next(iter(votes.values())).block_id
            self._sent_at[key] = now
            self._send(STATE_CHANNEL, VoteSetMaj23Message(
                key[0], key[1], SignedMsgType(key[2]), block_id))


def _bit_array(size: int, idxs):
    from ..libs.bits import BitArray

    ba = BitArray(size)
    for i in idxs:
        ba.set_index(i, True)
    return ba
