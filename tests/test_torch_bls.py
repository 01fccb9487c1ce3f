"""The port's aggregated-commit (BLS12-381) slice against the JAX package.

Runs on the CPU: the port's ``cuda`` route runs the G2-add kernel's plain
PyTorch version there (the kernel itself is held against it on the card in
tests/test_torch_cuda.py). Every comparison is exact:

* the Montgomery product against Python ints and the JAX package's limb
  engine (numpy limbs, and one eager call on its jnp limbs);
* one tree round against ``vec.g2_add_vec`` under numpy, lane by lane,
  over the six lane classes, compared as plain integers (the two packages
  use different Montgomery radixes);
* the aggregate pubkey against the JAX package's scalar spec;
* routed verdicts, the verify-commit cases of
  tests/test_aggsig_differential.py through both packages on the same
  keys (the JAX package's commits decoded by convert.py), the rogue-key
  gates, VoteSet.make_commit bytes, and apply_block on a bls12381 chain;
* routing: KernelUnavailable without CUDA or a kernel; the fault site and
  every fault of a running kernel reach the caller; an open device breaker
  leaves the cuda route alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tendermint_tpu.crypto as jcrypto
import tendermint_tpu_torch.crypto as tcrypto
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.example import kvstore as jkv
from tendermint_tpu.consensus.state import check_aggregated_commit_time as \
    jcheck_time
from tendermint_tpu.crypto import bls12381 as jbls
from tendermint_tpu.crypto import schemes as jschemes
from tendermint_tpu.crypto.bls12381 import vec as jvec
from tendermint_tpu.libs import db as jdb
from tendermint_tpu.libs.bits import BitArray as JBitArray
from tendermint_tpu import proxy as jproxy
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state import state as jstate
from tendermint_tpu.state import store as jstore
from tendermint_tpu.store import block_store as jbs
from tendermint_tpu import types as jtypes
from tendermint_tpu.types import params as jparams
from tendermint_tpu.types.block import AggregatedCommit as JAggCommit
from tendermint_tpu.types.validator_set import \
    verify_commit_light_trusting_batched as jtrusting_batched
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.example import kvstore as tkv
from tendermint_tpu_torch.consensus.aggregated import \
    check_aggregated_commit_time as tcheck_time
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import bls12381 as tbls
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto import schemes as tschemes
from tendermint_tpu_torch.crypto.bls12381 import curve as tcurve
from tendermint_tpu_torch.crypto.bls12381 import vec as tvec
from tendermint_tpu_torch.crypto.bls12381.field import P
from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs import db as tdb
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch import proxy as tproxy
from tendermint_tpu_torch.state import execution as texec
from tendermint_tpu_torch.state import state as tstate
from tendermint_tpu_torch.state import store as tstore
from tendermint_tpu_torch.store import block_store as tbs
from tendermint_tpu_torch import types as ttypes
from tendermint_tpu_torch.types import params as tparams
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.types.block import AggregatedCommit as TAggCommit
from tendermint_tpu_torch.types.validator_set import \
    verify_commit_light_trusting_batched as ttrusting_batched
from tendermint_tpu_torch.tools import g2_lanes

SEED = 20261017
N = 6
HEIGHT = 9
TS0 = 1_700_000_000_000_000_000
JR_INV = pow(jvec.R_MONT, -1, P)


def _reset():
    tfaults.reset()
    tbreaker.reset()
    tphases.reset()
    tschemes.reset()
    tbls.reset()
    tvec.reset_stats()
    G.reset_launches()
    for k in tbatch.stats:
        tbatch.stats[k] = 0
    jschemes.reset()
    jbls.reset()


@pytest.fixture(autouse=True)
def env(monkeypatch):
    device.set_default_device("cpu")
    # both packages read this name: unset, the JAX package routes to its
    # scalar spec and the port to its cuda route (plain rounds on the CPU)
    monkeypatch.delenv("TMTPU_BLS_BACKEND", raising=False)
    monkeypatch.setenv("TMTPU_BATCH_BACKEND", "host")
    _reset()
    yield
    _reset()
    device.set_default_device(None)


def _rand_fq(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _jax_lanes(values, cfg):
    """Plain ints -> the JAX package's Montgomery limb rows (numpy)."""
    return jvec.int_to_vl(np, cfg, [v * jvec.R_MONT % P for v in values])


def _jax_ints(limbs, cfg):
    return [v * JR_INV % P for v in jvec.vl_to_int(cfg, limbs)]


# --- the kernel's arithmetic --------------------------------------------------

def test_fq_mul_matches_ints_and_jax_limbs():
    rng = np.random.default_rng(SEED)
    a = _rand_fq(rng, 61) + [0, 1, P - 1]
    b = _rand_fq(rng, 61) + [P - 1, P - 1, P - 1]
    want = [x * y % P for x, y in zip(a, b)]
    got = G.fq_from_limbs(G.fq_mul_plain(torch.from_numpy(G.fq_to_limbs(a)),
                                         torch.from_numpy(G.fq_to_limbs(b))))
    assert got == want
    np_prod = jvec.mont_mul(np, jvec.CFG_NP, _jax_lanes(a, jvec.CFG_NP),
                            _jax_lanes(b, jvec.CFG_NP))
    assert _jax_ints(np_prod, jvec.CFG_NP) == want
    # one eager call on the TPU limb geometry (30 x 13-bit int32)
    k = 4
    jnp_prod = jvec.mont_mul(
        jnp, jvec.CFG_JAX,
        jnp.asarray(_jax_lanes(a[-k:], jvec.CFG_JAX)),
        jnp.asarray(_jax_lanes(b[-k:], jvec.CFG_JAX)))
    assert _jax_ints(np.asarray(jnp_prod), jvec.CFG_JAX) == want[-k:]
    assert got[-k:] == want[-k:]


def test_round_matches_jax_lane_by_lane():
    """Three cycles of the lane classes of tools/g2_lanes.py."""
    ps, qs, kinds = g2_lanes.lane_pairs(np.random.default_rng(SEED + 1), 27)
    got = G.from_lanes(G.g2_add_round_plain(G.to_lanes(ps), G.to_lanes(qs)))

    def jax_pt(pts):
        return tuple(tuple(_jax_lanes([pt[c][k] for pt in pts], jvec.CFG_NP)
                           for k in range(2)) for c in range(3))

    jout = jvec.g2_add_vec(np, jvec.CFG_NP, jax_pt(ps), jax_pt(qs))
    coords = [[_jax_ints(jout[c][k], jvec.CFG_NP) for k in range(2)]
              for c in range(3)]
    want = [tuple((coords[c][0][i], coords[c][1][i]) for c in range(3))
            for i in range(len(ps))]
    assert got == want
    assert set(kinds) == set(g2_lanes.CLASSES)
    for i, kind in enumerate(kinds):
        if kind == "junk":
            continue
        s = None if got[i][2] == (0, 0) else tcurve.g2_to_affine(got[i])
        assert s == g2_lanes.spec_sum(ps[i], qs[i]), (i, kind)
        if kind == "cancel":  # the add formula's X and Y, Z = 0
            assert got[i][2] == (0, 0) and got[i][0] != (0, 0)
        if kind in ("p-inf", "both-inf"):
            assert got[i] == qs[i]
        if kind == "q-inf":
            assert got[i] == ps[i]


# --- the aggregate and the routed verify ---------------------------------------

def _keys(tag, n):
    return [jcrypto.Bls12381PrivKey.generate(tag + bytes([i]) * 4)
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17])
def test_aggregate_pubkeys_matches_jax(n):
    pks = [k.pub_key().bytes() for k in _keys(b"agg", n)]
    got = tvec.aggregate_pubkeys_vec(pks)
    assert got is not None and got == jbls.aggregate_pubkeys(pks)


def _jax_tree_root(affs):
    """The JAX package's aggregate tree (aggregate_pubkeys_vec's rounds of
    _g2_add_round on the numpy backend) over affine points: the root's
    Jacobian X, Y, Z as plain ints."""
    pt = jvec._points_to_lanes(np, jvec.CFG_NP, affs)
    lanes = int(np.asarray(pt[0][0]).shape[1])
    while lanes > 1:
        half = lanes // 2
        left = tuple(tuple(c[:, :half] for c in comp) for comp in pt)
        right = tuple(tuple(c[:, half:] for c in comp) for comp in pt)
        pt = jvec._g2_add_round("numpy", left, right, False)
        lanes = half
    return tuple(tuple(_jax_ints(c, jvec.CFG_NP)[0] for c in comp)
                 for comp in pt)


@pytest.mark.parametrize("n", [1, 2, 3, 150, 257])
def test_tree_sum_plain_matches_jax_tree(n):
    """The tree's order is the JAX tree's: the root's Jacobian coordinates
    are equal, not only its affine value, with a doubling and a cancel
    inside the tree (g2_lanes.tree_points); and the aggregate through both
    packages' aggregate_pubkeys_vec is the same point."""
    affs = g2_lanes.tree_points(np.random.default_rng(SEED + 3), n)
    root = G.from_lanes(G.tree_sum_plain(
        tvec._points_to_lanes(affs, torch.device("cpu"))))[0]
    assert root == _jax_tree_root(affs)
    pks = [tcurve.g2_compress(a) for a in affs]
    want = jvec.aggregate_pubkeys_vec(pks, backend="numpy")
    assert want is not None
    assert tvec.aggregate_pubkeys_vec(pks) == want == tcurve.g2_to_affine(root)


def test_tree_sum_refuses_lanes_past_a_commit_and_ragged_widths():
    """The tree takes a power of 2 of lanes up to 2^14, the padded width of
    a commit's most signers (MAX_VOTES_COUNT, 10,000), on the CPU as on
    the card."""
    assert G.TREE_MAX_LANES == 1 << 14
    assert G.TREE_MAX_LANES >= tvote.MAX_VOTES_COUNT
    for n in (3, 2 * G.TREE_MAX_LANES):
        lanes = torch.zeros((n, *G.LANE_SHAPE), dtype=torch.uint32)
        with pytest.raises(ValueError, match="tree_sum"):
            G.tree_sum(lanes)


def test_aggregate_pubkeys_invalid_and_infinite_give_none():
    pks = [k.pub_key().bytes() for k in _keys(b"bad", 3)]
    bad = pks[:2] + [bytes([pks[2][0] ^ 0x01]) + pks[2][1:]]
    assert jbls.aggregate_pubkeys(bad) is None
    assert tvec.aggregate_pubkeys_vec(bad) is None
    neg = tcurve.g2_compress(tcurve.g2_to_affine(tcurve.g2_neg(
        (*tbls.decompress_pubkey(pks[0]), (1, 0)))))
    for keys in ([pks[0], neg], [pks[1], pks[0], neg, pks[2]]):
        want = jbls.aggregate_pubkeys(keys)
        assert tvec.aggregate_pubkeys_vec(keys) == want
    assert tvec.aggregate_pubkeys_vec([pks[0], neg]) is None


def test_routed_verdicts_match_jax():
    keys = _keys(b"rtd", 5)
    pks = [k.pub_key().bytes() for k in keys]
    msg = b"routed message"
    sigs = [k.sign(msg) for k in keys]
    good = jbls.aggregate(sigs)
    cases = [(pks, good), (pks, jbls.aggregate(sigs[:4])),
             (pks[:4], good), (pks[:1], sigs[0]), (pks, sigs[0])]
    wants = []
    for keyset, agg in cases:
        want = jbls.fast_aggregate_verify(keyset, msg, agg)
        assert jvec.fast_aggregate_verify_routed(keyset, msg, agg) == want
        assert tvec.fast_aggregate_verify_routed(keyset, msg, agg) == want
        wants.append(want)
    assert wants == [True, False, False, True, False]
    assert tvec.stats["device_calls"] == len(cases)
    assert tvec.stats["device_errors"] == tvec.stats["scalar_calls"] == 0
    assert tvec.fast_aggregate_verify_routed(pks, msg, good,
                                             backend="scalar")
    assert tvec.stats["scalar_calls"] == 1
    segs = [r for r in tphases.recent_segments() if r["plane"] == "aggsig"]
    assert [r["sigs"] for r in segs] == [5, 5, 4, 1, 5]


# --- verify-commit cases through both packages ---------------------------------

BID = jtypes.BlockID(b"\x11" * 32, jtypes.PartSetHeader(1, b"\x22" * 32))


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the error's class and text are the outcome
        return type(e).__name__, str(e)
    return None


class Rig:
    """A bls12381 aggregated chain in the JAX package and its port twin on
    the same keys: JAX MockPVs sign, the JAX VoteSet assembles."""

    def __init__(self, chain_id, n=N, tag=b"diff"):
        self.chain_id = chain_id
        sig = jparams.SignatureParams("bls12381", True)
        jschemes.register_chain(chain_id, sig)
        tschemes.register_chain(chain_id, sig)
        self.pvs = [jtypes.MockPV(jcrypto.Bls12381PrivKey.generate(
            tag + bytes([i]) * 4)) for i in range(n)]
        self.jvs = jtypes.ValidatorSet([
            jtypes.Validator(pv.get_pub_key().address(), pv.get_pub_key(), 10)
            for pv in self.pvs])
        self.tvs = convert.validator_set_from_reference(self.jvs.encode())
        self.idx = {pv.get_pub_key().address():
                    self.jvs.get_by_address(pv.get_pub_key().address())[0]
                    for pv in self.pvs}

    def vote(self, pv, bid):
        addr = pv.get_pub_key().address()
        v = jtypes.Vote(jtypes.SignedMsgType.PRECOMMIT, HEIGHT, 0, bid,
                        TS0 + self.idx[addr], addr, self.idx[addr], b"")
        pv.sign_vote(self.chain_id, v)
        return v

    def make_commit(self, block_voters, nil_voters=()):
        vs = jtypes.VoteSet(self.chain_id, HEIGHT, 0,
                            jtypes.SignedMsgType.PRECOMMIT, self.jvs)
        for pv in self.pvs:
            i = self.idx[pv.get_pub_key().address()]
            if i in block_voters or i in nil_voters:
                assert vs.add_vote(self.vote(
                    pv, BID if i in block_voters else jtypes.BlockID()))
        return vs.make_commit()

    def aggregated(self, voters, sigs=None):
        """A commit built directly, as a byzantine proposer could ship it."""
        by_idx = {self.idx[pv.get_pub_key().address()]: pv for pv in self.pvs}
        if sigs is None:
            sigs = [self.vote(by_idx[i], BID).signature
                    for i in sorted(voters)]
        bits = JBitArray(len(self.pvs))
        for i in voters:
            bits.set_index(i, True)
        return JAggCommit(HEIGHT, 0, BID, [], signers=bits,
                          agg_sig=jbls.aggregate(sigs), timestamp_ns=TS0)

    def check(self, jcommit, modes=("full",), trust_vals=None):
        """Each mode's outcome in both packages; returns the JAX ones."""
        tcommit = convert.commit_from_reference(jcommit.encode())
        assert tcommit.encode() == jcommit.encode()
        out = []
        for mode in modes:
            got = []
            for vs, commit, bid in ((self.jvs, jcommit, BID),
                                    (self.tvs, tcommit, ttypes.BlockID(
                                        BID.hash, ttypes.PartSetHeader(
                                            1, BID.part_set_header.hash)))):
                if mode == "full":
                    fn = lambda: vs.verify_commit(self.chain_id, bid,  # noqa
                                                  HEIGHT, commit)
                elif mode == "light":
                    fn = lambda: vs.verify_commit_light(  # noqa: E731
                        self.chain_id, bid, HEIGHT, commit)
                else:
                    fn = lambda: vs.verify_commit_light_trusting(  # noqa
                        self.chain_id, commit, (1, 3), commit_vals=vs)
                got.append(_outcome(fn))
            assert got[0] == got[1], (mode, got)
            out.append(got[0])
        return out


ALL_MODES = ("full", "light", "trusting")


@pytest.fixture
def rig():
    return Rig("diff-bls")


def test_valid_commit_accepted_by_both(rig):
    c = rig.make_commit(set(range(N)))
    assert rig.check(c, ALL_MODES) == [None] * 3
    assert tvec.stats["device_calls"] == 3


def test_one_bad_signature_rejected_by_both(rig):
    c = rig.make_commit(set(range(N)))
    bad = JAggCommit(c.height, c.round, c.block_id, [], signers=c.signers,
                     agg_sig=bytes([c.agg_sig[0] ^ 0x01]) + c.agg_sig[1:],
                     timestamp_ns=c.timestamp_ns)
    other = rig.aggregated(set(range(N)), sigs=[
        pv.priv_key.sign(b"another message") for pv in rig.pvs])
    for commit in (bad, other):
        (res,) = rig.check(commit)
        assert res[0] == "ErrWrongSignature"


def test_sub_quorum_rejected_by_both(rig):
    (res,) = rig.check(rig.aggregated({0, 1, 2}))
    assert res[0] == "ErrNotEnoughVotingPowerSigned"


def test_duplicate_signer_rejected_by_both(rig):
    by_idx = {rig.idx[pv.get_pub_key().address()]: pv for pv in rig.pvs}
    sigs = {i: rig.vote(by_idx[i], BID).signature for i in range(N)}
    doubled = [sigs[0], sigs[0]] + [sigs[i] for i in range(2, N)]
    (res,) = rig.check(rig.aggregated(set(range(N)), sigs=doubled))
    assert res[0] == "ErrWrongSignature"


def test_nil_vote_mix_parity(rig):
    assert rig.check(rig.make_commit(set(range(5)), nil_voters={5}),
                     ALL_MODES) == [None] * 3
    (res,) = rig.check(rig.aggregated(set(range(4))))
    assert res[0] == "ErrNotEnoughVotingPowerSigned"


def test_aggregated_commit_time_window(rig):
    now, drift = TS0, 10_000_000_000
    c = rig.make_commit(set(range(N)))
    t = convert.commit_from_reference(c.encode())
    seen = [now - 2_000_000_000, now, now + 1_000_000_000]
    cases = [(now, seen), (now, []), (now + drift + 1, seen),
             (now + drift - 1, [now - 30_000_000_000]),
             (now - 60_000_000_000, seen)]
    outcomes = []
    for ts, seen_ts in cases:
        c.timestamp_ns = t.timestamp_ns = ts
        want = _outcome(lambda: jcheck_time(c, seen_ts, now, drift))
        assert _outcome(lambda: tcheck_time(t, seen_ts, now, drift)) == want
        outcomes.append(want and want[0])
    assert outcomes == [None, None, "ValueError", "ValueError", "ValueError"]


def test_trusting_across_a_validator_set_change():
    commit_rig = Rig("agg-batched", n=5, tag=b"lbat")
    commit = commit_rig.aggregated(set(range(5)))
    jtrusted = jtypes.ValidatorSet([v.copy() for v in
                                    commit_rig.jvs.validators[:4]])
    ttrusted = convert.validator_set_from_reference(jtrusted.encode())
    tcommit = convert.commit_from_reference(commit.encode())
    trust = (1, 3)
    jres = jtrusting_batched([
        (jtrusted, "agg-batched", commit, trust, commit_rig.jvs),
        (jtrusted, "agg-batched", commit, trust)])
    tres = ttrusting_batched([
        (ttrusted, "agg-batched", tcommit, trust, commit_rig.tvs),
        (ttrusted, "agg-batched", tcommit, trust)])
    assert jres[0] is None and tres[0] is None
    assert type(jres[1]).__name__ == type(tres[1]).__name__ == \
        "ErrInvalidCommitSignatures"
    assert str(jres[1]) == str(tres[1])
    assert _outcome(lambda: ttrusted.verify_commit_light_trusting(
        "agg-batched", tcommit, trust, commit_vals=commit_rig.tvs)) is None


# --- the rogue-key gates -----------------------------------------------------------

def _params(ns):
    return ns.ConsensusParams(validator=ns.ValidatorParams(["bls12381"]),
                              signature=ns.SignatureParams("bls12381", True))


def test_genesis_pop_gate_matches_jax():
    keys = _keys(b"gen", 3)
    ed = jcrypto.Ed25519PrivKey.generate(b"\x01" * 32).pub_key()
    cases = {
        "good": [(k.pub_key(), k.pop()) for k in keys],
        "missing": [(keys[0].pub_key(), b"")],
        "replayed": [(keys[0].pub_key(), keys[0].pop()),
                     (keys[1].pub_key(), keys[0].pop())],
        "wrong scheme": [(ed, b"")],
    }
    for name, vals in cases.items():
        outcomes = []
        for ns, tmod, bls in ((jtypes, jparams, jbls),
                              (ttypes, tparams, tbls)):
            bls.reset()
            crypto_ns = jcrypto if ns is jtypes else tcrypto
            gen = ns.GenesisDoc(
                chain_id="bls-gen", genesis_time_ns=TS0,
                consensus_params=_params(tmod),
                validators=[ns.GenesisValidator(
                    crypto_ns.pubkey_from_type_and_bytes(pk.type_name,
                                                         pk.bytes()),
                    10, pop=pop) for pk, pop in vals])
            outcomes.append((_outcome(gen.validate_and_complete),
                             [bls.is_registered(pk.bytes())
                              for pk, _ in vals]))
        assert outcomes[0] == outcomes[1], name
        assert (outcomes[0][0] is None) == (name == "good")


def test_validator_update_pop_gate_matches_jax():
    k1, k2 = _keys(b"upd", 2)
    p1, p2 = k1.pub_key().bytes(), k2.pub_key().bytes()
    steps = [(p1, 10, k1.pop()), (p2, 10, b""), (p2, 10, k1.pop()),
             (p2, 0, b""), (p1, 20, b""), (p1, 20, k1.pop())]
    outcomes = []
    for pk, power, pop in steps:
        got = []
        for ns, tmod, bls, exe in ((jabci, jparams, jbls, jexec),
                                   (tabci, tparams, tbls, texec)):
            res = _outcome(lambda: exe.validate_validator_updates(
                [ns.ValidatorUpdate("bls12381", pk, power, pop=pop)],
                _params(tmod)))
            got.append((res, bls.is_registered(p1), bls.is_registered(p2)))
        assert got[0] == got[1]
        outcomes.append(got[0][0] is None)
    assert outcomes == [True, False, False, True, False, True]


# --- VoteSet and block execution ------------------------------------------------

def test_make_commit_bytes_match_jax(rig):
    tpvs = [ttypes.MockPV(tcrypto.Bls12381PrivKey(pv.priv_key.bytes()))
            for pv in rig.pvs]
    tvs = ttypes.VoteSet(rig.chain_id, HEIGHT, 0,
                         ttypes.SignedMsgType.PRECOMMIT, rig.tvs)
    tbid = ttypes.BlockID(BID.hash, ttypes.PartSetHeader(
        1, BID.part_set_header.hash))
    voters = set(range(5))
    for pv in tpvs:
        addr = pv.get_pub_key().address()
        i = rig.idx[addr]
        bid = tbid if i in voters else ttypes.BlockID()
        v = ttypes.Vote(ttypes.SignedMsgType.PRECOMMIT, HEIGHT, 0, bid,
                        TS0 + i, addr, i, b"")
        pv.sign_vote(rig.chain_id, v)
        assert tvs.add_vote(v)
    tcommit = tvs.make_commit()
    jcommit = rig.make_commit(voters, nil_voters={5})
    assert isinstance(tcommit, TAggCommit)
    assert tcommit.encode() == jcommit.encode()
    assert len(tcommit.agg_sig) == 48


GENESIS_NS = 1_700_000_000_000_000_000
CHAIN_ID = "torch-bls-chain"


class _Chain:
    def __init__(self, ns, keys):
        c = ns.crypto
        genesis = ns.gen.GenesisDoc(
            chain_id=CHAIN_ID, genesis_time_ns=GENESIS_NS,
            consensus_params=_params(ns.params),
            validators=[ns.gen.GenesisValidator(
                c.Bls12381PrivKey(k).pub_key(), 10,
                pop=c.Bls12381PrivKey(k).pop()) for k in keys])
        self.ns = ns
        self.pvs = [ns.types.MockPV(c.Bls12381PrivKey(k)) for k in keys]
        self.state = ns.st.state_from_genesis(genesis)
        self.app = ns.kv.MerkleKVStoreApplication(interval=4)
        conns = ns.proxy.AppConns(ns.proxy.local_client_creator(self.app))
        conns.start()
        self.state_store = ns.store.StateStore(ns.db.MemDB())
        self.block_store = ns.bs.BlockStore(ns.db.MemDB())
        self.executor = ns.exe.BlockExecutor(
            self.state_store, conns.consensus, ns.exe.NoOpMempool(),
            ns.exe.EmptyEvidencePool(), self.block_store)
        self.state_store.save(self.state)

    def step(self, height, txs, last_commit):
        t = self.ns.types
        st = self.state
        block, parts = st.make_block(height, txs, last_commit, [],
                                     st.validators.get_proposer().address)
        bid = t.BlockID(block.hash(), parts.header())
        vals = st.validators
        self.state, _ = self.executor.apply_block(st, bid, block)
        vs = t.VoteSet(CHAIN_ID, height, 0, t.SignedMsgType.PRECOMMIT, vals)
        for pv in self.pvs:
            addr = pv.get_pub_key().address()
            i, _ = vals.get_by_address(addr)
            v = t.Vote(t.SignedMsgType.PRECOMMIT, height, 0, bid,
                       block.header.time_ns + 1_000_000 * (i + 1), addr, i,
                       b"")
            pv.sign_vote(CHAIN_ID, v)
            assert vs.add_vote(v)
        commit = vs.make_commit()
        self.block_store.save_block(block, parts, commit)
        return block, commit


def test_apply_block_on_a_bls_chain_matches_jax():
    from types import SimpleNamespace

    keys = [jcrypto.Bls12381PrivKey.generate(b"exec" + bytes([i]) * 4).bytes()
            for i in range(4)]
    J = SimpleNamespace(crypto=jcrypto, gen=jtypes.genesis, params=jparams,
                        types=jtypes, st=jstate, kv=jkv, proxy=jproxy,
                        store=jstore, db=jdb, bs=jbs, exe=jexec)
    T = SimpleNamespace(crypto=tcrypto, gen=ttypes.genesis, params=tparams,
                        types=ttypes, st=tstate, kv=tkv, proxy=tproxy,
                        store=tstore, db=tdb, bs=tbs, exe=texec)
    j, t = _Chain(J, keys), _Chain(T, keys)
    assert tschemes.aggregated(CHAIN_ID) and jschemes.aggregated(CHAIN_ID)
    jlast = jtypes.Commit(0, 0, jtypes.BlockID(), [])
    tlast = ttypes.Commit(0, 0, ttypes.BlockID(), [])
    rng = np.random.default_rng(SEED + 5)
    for h in (1, 2):
        txs = [f"{rng.bytes(8).hex()}={rng.bytes(16).hex()}".encode()
               for _ in range(12)]
        jblock, jlast = j.step(h, txs, jlast)
        tblock, tlast = t.step(h, txs, tlast)
        assert tblock.encode() == jblock.encode()
        assert tlast.encode() == jlast.encode()
        assert isinstance(tlast, TAggCommit)
        assert t.state.app_hash == j.state.app_hash
        assert tstore._state_to_json(t.state_store.load()) == \
            jstore._state_to_json(j.state_store.load())
        assert t.block_store.load_block(h).encode() == jblock.encode()
        assert t.block_store.load_seen_commit(h).encode() == jlast.encode()
    # height 2's LastCommit (aggregated) was verified on the port's cuda
    # route: one device call, the 4-key tree, no error
    assert tvec.stats["device_calls"] == 1
    assert tvec.stats["device_errors"] == tvec.stats["scalar_calls"] == 0


def test_bls_validator_sets_and_commits_convert(rig):
    c = rig.make_commit(set(range(N)))
    tc = convert.commit_from_reference(c.encode())
    assert isinstance(tc, TAggCommit) and tc.encode() == c.encode()
    assert tc.signers.true_indices() == c.signers.true_indices()
    assert rig.tvs.encode() == rig.jvs.encode()
    assert rig.tvs.hash() == rig.jvs.hash()
    assert all(isinstance(v.pub_key, tcrypto.Bls12381PubKey)
               for v in rig.tvs.validators)
    assert tcrypto.pubkey_from_type_and_bytes(
        "bls12381", rig.jvs.validators[0].pub_key.bytes()) == \
        rig.tvs.validators[0].pub_key


# --- routing ------------------------------------------------------------------------

@pytest.fixture
def signed():
    keys = _keys(b"rte", 3)
    msg = b"routing"
    return ([k.pub_key().bytes() for k in keys], msg,
            jbls.aggregate([k.sign(msg) for k in keys]))


def test_missing_cuda_raises_at_the_caller(monkeypatch, signed):
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelUnavailable, match="CUDA is not available"):
        tvec.fast_aggregate_verify_routed(*signed)
    assert tvec.stats == dict.fromkeys(tvec.stats, 0)
    assert tbreaker.state == "closed"


def test_kernel_build_failure_raises_at_the_caller(monkeypatch, tmp_path,
                                                   signed):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: cannot compile' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(G.build.PACKAGE, "build_dir", tmp_path / "_build")
    monkeypatch.setattr(G, "default_device", lambda: torch.device("cuda", 0))
    with pytest.raises(KernelUnavailable, match="cannot compile"):
        tvec.fast_aggregate_verify_routed(*signed)
    assert tvec.stats == dict.fromkeys(tvec.stats, 0)
    assert tbreaker.state == "closed"


def test_fault_site_reaches_the_caller(signed):
    """The armed fault site raises at the caller: the scalar spec does not
    take over, and the shared device breaker is left alone."""
    tfaults.configure("crypto.bls_verify*1")
    pks, msg, agg = signed
    with pytest.raises(InjectedFault):
        tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert tvec.stats == {"device_calls": 0, "scalar_calls": 0,
                          "device_errors": 1}
    assert tbreaker.state == "closed" and not tbreaker.stats
    assert tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert tvec.stats["device_calls"] == 1


class _FaultAtFetch(torch.Tensor):
    """A tree's output whose device fault surfaces when it is fetched, as
    an asynchronous CUDA error does."""

    def cpu(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


def _broken_kernels(monkeypatch, where):
    """The tree and the round (the one-key probe's launch), faulting at
    their launch, at the fetch of their sum, or returning infinity."""
    tree, round_ = G.tree_sum, G.g2_add_round

    def broken(plain):
        def run(*lanes):
            if where == "launch":
                raise RuntimeError("bls_g2_tree_sum: CUDA error 700 at "
                                   "launch")
            if where == "fetch":
                return plain(*lanes).as_subclass(_FaultAtFetch)
            inf = torch.zeros_like(lanes[-1][-1:])
            return plain(*(inf.expand(x.shape).contiguous() for x in lanes))
        return run

    monkeypatch.setattr(G, "tree_sum", broken(tree))
    monkeypatch.setattr(G, "g2_add_round", broken(round_))


@pytest.mark.parametrize("where", ["launch", "fetch", "probe"])
def test_running_kernel_fault_reaches_the_caller(monkeypatch, signed, where):
    """A fault of the running kernel (at its launch, surfacing at the fetch
    of the sum, or a one-key probe that does not return its key) reaches
    the caller, with no scalar re-verify and no breaker strike."""
    _broken_kernels(monkeypatch, where)
    pks, msg, agg = signed
    if where == "probe":
        pks, agg = pks[:1], _keys(b"rte", 1)[0].sign(msg)
    match = "key \\+ infinity" if where == "probe" else "CUDA error"
    with pytest.raises(RuntimeError, match=match):
        tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert tvec.stats == {"device_calls": 0, "scalar_calls": 0,
                          "device_errors": 1}
    assert tbreaker.state == "closed" and not tbreaker.stats


def test_open_breaker_leaves_the_cuda_route_alone(signed):
    """The shared device breaker, opened by Ed25519 verify faults, does not
    send aggregated verifies to the scalar spec."""
    while tbreaker.state != "open":
        tbreaker.record_failure()
    pks, msg, agg = signed
    assert tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert not tvec.fast_aggregate_verify_routed(pks, b"x", agg)
    assert tvec.stats == {"device_calls": 2, "scalar_calls": 0,
                          "device_errors": 0}


def test_backend_from_env(monkeypatch):
    for value, want in (("cuda", "cuda"), ("scalar", "scalar"),
                        (" SCALAR ", "scalar"), ("jax", "cuda"),
                        ("numpy", "cuda"), ("", "cuda")):
        monkeypatch.setenv("TMTPU_BLS_BACKEND", value)
        assert tvec.backend_from_env() == want
    monkeypatch.delenv("TMTPU_BLS_BACKEND")
    assert tvec.backend_from_env() == "cuda"
    with pytest.raises(ValueError, match="unknown bls backend"):
        tvec.fast_aggregate_verify_routed([b"k"], b"m", b"s", backend="jax")
