"""The port's evidence plane (evidence/verify.py, evidence/pool.py)
against the JAX package's.

Both packages apply the same five heights of a 4-validator chain (the
kvstore app behind a local client, MemDB stores, an ``EvidencePool`` as
the executor's pool); the JAX package signs the LastCommits and every
piece of evidence, and the port decodes the bytes
(``convert.evidence_from_reference``). Then:

* ``verify_evidence`` on both kinds of light-client attack (lunatic:
  common height 2, conflicting height 4, signed by two of the validators
  and a phantom; equivocation: common = conflicting = 4), a valid
  duplicate vote and three forgeries (an equivocation whose commit has a
  zeroed signature inside the first two-thirds of power, a duplicate vote
  with a bad signature, one with the wrong validator power): the verdict
  and error text of the JAX package's ``verify_evidence`` on its host
  route (``TMTPU_BATCH_BACKEND=host``: no jitted kernel compiles) equal
  the port's on its host and its cuda route (the kernels' plain versions
  on the CPU);
* a duplicate vote's two signatures under the ``auto`` backend: below
  the break-even threshold, so the host verifies them — the routing rule,
  not a fallback;
* the non-net part of tests/test_evidence.py
  ``test_duplicate_vote_evidence_verify_and_pool`` (:54): the evidence is
  verified, pooled, proposed in the next block, applied and marked
  committed; block bytes, app hash, ABCI responses and the ABCI evidence
  list equal the JAX package's. Its gossip across a 4-node net, and the
  net case at :99, wait for the consensus and p2p port;
* the pool's add / pending / check / update / prune and the consensus
  buffer of conflicting votes, observation by observation against the
  JAX pool.
"""

import dataclasses

import pytest

import tendermint_tpu.crypto as jcrypto
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.evidence import pool as jpool
from tendermint_tpu.evidence import verify as jverify
from tendermint_tpu.libs import db as jdb
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import light_block as jlb
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.basic import SignedMsgType as JMsg
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.block import CommitSig as JCommitSig
from tendermint_tpu.types.block import Header as JHeader
from tendermint_tpu.types.canonical import vote_sign_bytes as jsign_bytes
from tendermint_tpu.types.validator import new_validator as jnew_validator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.abci.example import kvstore as tkv
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.evidence import (EvidencePool, verify_duplicate_vote,
                                           verify_evidence)
from tendermint_tpu_torch.evidence import pool as tpool
from tendermint_tpu_torch.libs import db as tdb
from tendermint_tpu_torch.types.basic import BlockID as TBlockID
from tendermint_tpu_torch.types.block import Commit as TCommit

from tests.test_torch_block_exec import (CHAIN_ID, J, T, _Chain, _seed,
                                         _sign_commit)
from tests.test_torch_light import _KNOBS, outcome, reset_port, routed

HEIGHTS = 5
PHANTOM = _seed(9)


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS + ("TMTPU_MERKLE_DEVICE_MIN",):
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    device.set_default_device(None)


class _Pair:
    """Both packages' chains of HEIGHTS heights, each with an
    EvidencePool as its executor's pool; ``jprivs`` by address."""

    def __init__(self, app=None, port_route="host"):
        seeds = [_seed(i) for i in range(4)]
        self.jprivs = {p.pub_key().address(): p for p in
                       (jcrypto.Ed25519PrivKey.generate(s)
                        for s in seeds + [PHANTOM])}
        self.j = _Chain(J, seeds, app=(app or jkv.KVStoreApplication)())
        self.t = _Chain(T, seeds, app=(app or tkv.KVStoreApplication)())
        self.jpool = jpool.EvidencePool(jdb.MemDB(), self.j.state_store,
                                        self.j.block_store)
        self.tpool = EvidencePool(tdb.MemDB(), self.t.state_store,
                                  self.t.block_store)
        for c, p in ((self.j, self.jpool), (self.t, self.tpool)):
            p.set_state(c.state)
            c.executor.evpool = p
        self.jlast = JCommit(0, 0, JBlockID(), [])
        self.tlast = TCommit(0, 0, TBlockID(), [])
        for h in range(1, HEIGHTS + 1):
            self.apply(h, [f"k{h}{i}=v".encode() for i in range(2)],
                       port_route=port_route)

    def apply(self, h, txs, jevidence=(), port_route="host"):
        """Height ``h`` through both executors; returns both blocks."""
        tevidence = [convert.evidence_from_reference(e.wrapped())
                     for e in jevidence]
        jblock, jparts = self.j.propose(h, txs, self.jlast, jevidence)
        tblock, tparts = self.t.propose(h, txs, self.tlast, tevidence)
        assert tblock.encode() == jblock.encode()
        jvals = self.j.state.validators
        with routed("host"):
            self.j.apply(jblock, jparts, JBlockID)
        with routed(port_route):
            self.t.apply(tblock, tparts, TBlockID)
        self.jlast = _sign_commit(h, jblock, jparts, jvals, self.jprivs)
        self.tlast = convert.commit_from_reference(self.jlast.encode())
        self.j.block_store.save_block(jblock, jparts, self.jlast)
        self.t.block_store.save_block(tblock, tparts, self.tlast)
        return jblock, tblock

    def meta(self, h):
        return self.j.block_store.load_block_meta(h)

    def vals(self, h):
        return self.j.state_store.load_validators(h)

    # -- evidence, made by the JAX package ---------------------------------

    def duplicate_vote(self, h, idx, bad_sig=False, power=None):
        vs = self.vals(h)
        val = vs.validators[idx]
        votes = []
        for tag in (b"\x01", b"\x02"):
            v = JVote(JMsg.PRECOMMIT, h, 0,
                      JBlockID(tag * 32, JPSH(1, b"\x09" * 32)),
                      self.meta(h).header.time_ns + 5, val.address, idx)
            v.signature = self.jprivs[val.address].sign(
                v.sign_bytes(CHAIN_ID))
            votes.append(v)
        ev = jev.DuplicateVoteEvidence.new(votes[0], votes[1],
                                           self.meta(h).header.time_ns, vs)
        if bad_sig:
            s = ev.vote_b.signature
            ev.vote_b.signature = s[:5] + bytes([s[5] ^ 1]) + s[6:]
        if power is not None:
            ev.validator_power = power
        return ev

    def light_attack(self, common, height, vals, app_hash, zero_idx=None):
        """A conflicting block at ``height`` signed by every member of
        ``vals`` (a JAX ValidatorSet), against common height ``common``."""
        trusted = self.meta(height).header
        hdr = JHeader(
            chain_id=CHAIN_ID, height=height, time_ns=trusted.time_ns + 1,
            last_block_id=self.meta(height - 1).block_id,
            last_commit_hash=b"\x01" * 32, data_hash=b"\x02" * 32,
            validators_hash=vals.hash(), next_validators_hash=vals.hash(),
            consensus_hash=b"\x03" * 32, app_hash=app_hash,
            last_results_hash=b"\x05" * 32, evidence_hash=b"\x06" * 32,
            proposer_address=vals.validators[0].address)
        bid = JBlockID(hdr.hash(), JPSH(1, b"\x07" * 32))
        sigs = []
        for i, v in enumerate(vals.validators):
            ts = hdr.time_ns + 1_000 * (i + 1)
            sig = self.jprivs[v.address].sign(jsign_bytes(
                CHAIN_ID, JMsg.PRECOMMIT, height, 0, bid, ts))
            if i == zero_idx:
                sig = bytes(64)
            sigs.append(JCommitSig(JFlag.COMMIT, v.address, ts, sig))
        cb = jlb.LightBlock(jlb.SignedHeader(hdr, JCommit(height, 0, bid,
                                                          sigs)), vals)
        return jev.LightClientAttackEvidence(
            cb, common, [], self.vals(common).total_voting_power(),
            self.meta(common).header.time_ns)

    def cases(self):
        chain_vals = self.vals(4)
        lunatic_vals = JValidatorSet(
            [jnew_validator(v.pub_key, 10) for v in chain_vals.validators[:2]]
            + [jnew_validator(jcrypto.Ed25519PrivKey.generate(PHANTOM)
                              .pub_key(), 10)])
        return {
            "lunatic": self.light_attack(2, 4, lunatic_vals, b"\xee" * 32),
            "equivocation": self.light_attack(4, 4, chain_vals,
                                              b"\xdd" * 32),
            "duplicate_vote": self.duplicate_vote(2, 1),
            "forged_commit": self.light_attack(5, 5, self.vals(5),
                                               b"\xcc" * 32, zero_idx=1),
            "forged_signature": self.duplicate_vote(3, 2, bad_sig=True),
            "forged_power": self.duplicate_vote(3, 3, power=11),
        }


VALID = {"lunatic", "equivocation", "duplicate_vote"}
REJECTED = {
    "forged_commit": ("ErrWrongSignature", "wrong signature (#1)"),
    "forged_signature": ("ValueError",
                         "verifying VoteB: invalid signature"),
    "forged_power": ("ValueError",
                     "validator power from evidence and our validator set "
                     "does not match (11 != 10)"),
}


@pytest.fixture(scope="module")
def pair():
    device.set_default_device("cpu")
    try:
        return _Pair()
    finally:
        device.set_default_device(None)


@pytest.mark.parametrize("case", ["lunatic", "equivocation", "duplicate_vote",
                                  "forged_commit", "forged_signature",
                                  "forged_power"])
def test_verify_evidence_matches_jax(pair, case):
    jcase = pair.cases()[case]
    tcase = convert.evidence_from_reference(jcase.wrapped())
    assert tcase.bytes() == jcase.bytes() and tcase.hash() == jcase.hash()
    with routed("host"):
        want = outcome(lambda: jverify.verify_evidence(
            jcase, pair.j.state, pair.j.state_store, pair.j.block_store))
    got = {}
    for route in ("host", "cuda"):
        with routed(route):
            got[route] = outcome(lambda: verify_evidence(
                tcase, pair.t.state, pair.t.state_store, pair.t.block_store))
    assert got == {"host": want, "cuda": want}
    if case in VALID:
        assert want is None
    else:
        kind, text = REJECTED[case]
        assert want[0] == kind and text in want[1], want


def test_auto_route_verifies_a_duplicate_vote_on_the_host(pair):
    """Two signatures sit below the break-even threshold: ``auto`` sends
    them to the host by its routing rule (no device error is involved)."""
    ev = convert.evidence_from_reference(
        pair.duplicate_vote(2, 1).wrapped())
    verify_duplicate_vote(ev, CHAIN_ID,
                          pair.t.state_store.load_validators(2))
    assert (tbatch.stats["host_batches"], tbatch.stats["host_sigs"],
            tbatch.stats["device_batches"], tbatch.stats["device_errors"]) \
        == (1, 2, 0, 0)
    assert tbatch.device_threshold() > 2


def _abci(evs):
    return [dataclasses.asdict(e) for e in evs]


def test_duplicate_vote_evidence_verify_and_pool():
    """tests/test_evidence.py:54 without the net: verify, pool, propose,
    apply on the cuda route, committed; everything equal to the JAX
    package's."""
    p = _Pair()
    jev_ = p.duplicate_vote(1, 0)
    tev_ = convert.evidence_from_reference(jev_.wrapped())
    verify_duplicate_vote(tev_, CHAIN_ID, p.t.state_store.load_validators(1))
    with routed("host"):
        p.jpool.add_evidence(jev_)
    with routed("cuda"):
        p.tpool.add_evidence(tev_)
    assert p.tpool.is_pending(tev_) and p.jpool.is_pending(jev_)
    h = HEIGHTS + 1
    jblock, _ = p.j.executor.create_proposal_block(
        h, p.j.state, p.jlast, p.j.state.validators.get_proposer().address)
    tblock, _ = p.t.executor.create_proposal_block(
        h, p.t.state, p.tlast, p.t.state.validators.get_proposer().address)
    assert tblock.encode() == jblock.encode()
    assert [e.hash() for e in tblock.evidence] == [tev_.hash()]
    p.apply(h, list(tblock.data.txs), [jev_], port_route="cuda")
    for pool, ev in ((p.tpool, tev_), (p.jpool, jev_)):
        assert pool.is_committed(ev) and not pool.is_pending(ev)
    assert p.t.state.app_hash == p.j.state.app_hash
    assert p.t.state_store.load_abci_responses(h).to_json() == \
        p.j.state_store.load_abci_responses(h).to_json()
    assert _abci(p.tpool.abci_evidence([tev_])) == \
        _abci(p.jpool.abci_evidence([jev_]))
    assert tbatch.stats["device_errors"] == 0


def test_pool_lifecycle_matches_jax(pair):
    """add / pending (with a byte cap) / check / update / prune and the
    consensus buffer, the same calls on both pools, every observation
    equal."""
    p = _Pair()
    e1, e2 = p.duplicate_vote(2, 1), p.duplicate_vote(3, 2)
    va, vb = p.duplicate_vote(4, 3).vote_a, p.duplicate_vote(4, 3).vote_b
    cross = {id(x): convert.evidence_from_reference(x.wrapped())
             for x in (e1, e2)}
    from tendermint_tpu_torch.types.vote import Vote as TVote

    def tvote(v):
        return TVote.decode(v.encode())

    def run(pool, state, conv, vote):
        seen = []
        with routed("host"):
            pool.add_evidence(conv(e1))
            pool.add_evidence(conv(e2))
            pool.add_evidence(conv(e1))  # already pending: a no-op
            evs, size = pool.pending_evidence(-1)
            seen.append(([e.hash() for e in evs], size))
            evs, size = pool.pending_evidence(len(conv(e1).wrapped()) + 4)
            seen.append(([e.hash() for e in evs], size))
            seen.append(outcome(lambda: pool.check_evidence(
                [conv(e1), conv(e1)])))
            pool.update(state, [conv(e1)])
            seen.append((pool.is_committed(conv(e1)),
                         pool.is_pending(conv(e1)),
                         pool.is_pending(conv(e2))))
            seen.append(outcome(lambda: pool.check_evidence([conv(e1)])))
            pool.add_evidence(conv(e1))  # committed: a no-op
            seen.append(pool.is_pending(conv(e1)))
            # conflicting votes from consensus wait for the next update
            pool.report_conflicting_votes(vote(va), vote(vb))
            seen.append(len(pool._consensus_buffer))
            pool.update(state, [])
            evs, _ = pool.pending_evidence(-1)
            seen.append(sorted(e.hash() for e in evs))
            # prune: past both the block and the time bound
            old = state.copy()
            params = old.consensus_params.evidence
            old.last_block_height += params.max_age_num_blocks + 10
            old.last_block_time_ns += params.max_age_duration_ns + 10
            pool.update(old, [])
            seen.append(pool.pending_evidence(-1)[1])
            seen.append(_abci(pool.abci_evidence([conv(e2)])))
        return seen

    got = run(p.tpool, p.t.state, lambda e: cross[id(e)], tvote)
    want = run(p.jpool, p.j.state, lambda e: e, lambda v: v)
    assert got == want
    assert got[2] == ("ValueError",
                      f"duplicate evidence in block: {e1.hash().hex()}")
    assert got[4] == ("ValueError",
                      f"evidence was already committed: {e1.hash().hex()}")
    assert len(got[7]) == 2 and got[8] == 0
    assert tpool._PENDING_PREFIX == jpool._PENDING_PREFIX
