"""The port's light client (tendermint_tpu_torch/light/: verifier, store,
provider, client) against the JAX package's (tendermint_tpu/light/).

Chains are built and signed once with the JAX package's own types
(tests/test_light_client.py's builders), carried into the port through
``convert.light_block_from_reference`` (the proto wire bytes), and checked
by both packages. Every comparison is exact: ``None``, or an exception of
the same class name with the same ``str``.

* the cases of tests/test_light_batched.py and of tests/test_light_client.py
  that need no node (:70, :94, :104, :115, :137, :229), through the port,
  each outcome equal to the JAX package's;
* ``verify``, ``verify_chain_batched`` and ``LightClient`` on a table of
  accepting and rejecting cases;
* ``LightStore`` writes the same bytes, and each package reads the other's;
* the port's batch accounting: ``verify_chain_batched`` is one device
  batch for the whole range, after which ``precomputed_batches`` rises by
  one per adjacent step and two per non-adjacent step.

The JAX package runs on its host route (``TMTPU_BATCH_BACKEND=host``, as
its own light tests do below its threshold; its jitted kernel is never
compiled here). The port runs on ``backend="host"`` and on its ``cuda``
route, which on the CPU runs the verify kernels' plain PyTorch versions
(about half a second a batch here, so the cuda cases are few and batched).
"""

import asyncio
import copy
import os

import numpy as np
import pytest

from tendermint_tpu import crypto as jcrypto
from tendermint_tpu.libs.db import MemDB as JMemDB
from tendermint_tpu.light import verifier as jver
from tendermint_tpu.light.client import LightClient as JLightClient
from tendermint_tpu.light.client import TrustOptions as JTrustOptions
from tendermint_tpu.light.provider import MockProvider as JMockProvider
from tendermint_tpu.light.store import LightStore as JLightStore
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types import validator_set as jvs_mod
from tendermint_tpu.types.basic import BlockID as JBlockID
from tendermint_tpu.types.basic import BlockIDFlag as JFlag
from tendermint_tpu.types.basic import PartSetHeader as JPSH
from tendermint_tpu.types.basic import SignedMsgType as JSMT
from tendermint_tpu.types.block import Commit as JCommit
from tendermint_tpu.types.block import CommitSig as JCommitSig
from tendermint_tpu.types.canonical import vote_sign_bytes as jvsb
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch import light as tlight
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto import schemes as tschemes
from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.crypto.breaker import reset_lane_breakers
from tendermint_tpu_torch.crypto.ed25519_cuda import multidevice as MD
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.libs.db import MemDB as TMemDB
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.light import verifier as tver
from tendermint_tpu_torch.light.client import DivergenceError as TDivergence
from tendermint_tpu_torch.light.client import LightClient as TLightClient
from tendermint_tpu_torch.light.client import TrustOptions as TTrustOptions
from tendermint_tpu_torch.light.provider import MockProvider as TMockProvider
from tendermint_tpu_torch.light.store import LightStore as TLightStore
from tendermint_tpu_torch.types import canonical as tcanon
from tendermint_tpu_torch.types import validator_set as tvs_mod
from tendermint_tpu_torch.types.errors import ErrNotEnoughVotingPowerSigned

from tests.test_light_client import (  # noqa: F401  (the JAX chain builders)
    CHAIN,
    T0,
    _keys,
    _mk_chain,
    _resign,
    _val_set,
)

NOW = T0 + 100 * 1_000_000_000
PERIOD = 3600.0
DRIFT = 10.0
ROUTE = "TMTPU_BATCH_BACKEND"

#: the knobs that route this file's paths; other tests in the same process
#: may leave them set (tools/crashmatrix.py ``run_matrix`` sets
#: TMTPU_BATCH_BACKEND for good)
_KNOBS = (ROUTE, "TMTPU_DEVICE_THRESHOLD", "TMTPU_VERIFY_DEVICES",
          "TMTPU_DEVICE_BREAKER_THRESHOLD", "TMTPU_DEVICE_BREAKER_COOLDOWN_S")


def reset_port():
    tfaults.reset()
    tbreaker.reset()
    reset_lane_breakers()
    tphases.reset()
    MD.reset_pool()
    TV.reset_launches()
    G.reset_launches()
    for k in tbatch.stats:
        tbatch.stats[k] = 0


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    tschemes.reset()
    device.set_default_device(None)


# -- carrying across and running each side -----------------------------------

def port_lb(lb):
    return convert.light_block_from_reference(lb.encode())


def port_blocks(blocks):
    return {h: port_lb(lb) for h, lb in blocks.items()}


def outcome(fn):
    """None, or (exception class name, str) — the verdict under comparison."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the verdict IS the exception
        return type(e).__name__, str(e)
    return None


class routed:
    """A context in which both packages' BatchVerifiers default to
    ``backend`` (they read the same variable)."""

    def __init__(self, backend):
        self.backend = backend

    def __enter__(self):
        self.old = os.environ.get(ROUTE)
        os.environ[ROUTE] = self.backend

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(ROUTE, None)
        else:
            os.environ[ROUTE] = self.old


def on_jax(fn):
    with routed("host"):
        return outcome(fn)


def on_port(fn, backend):
    with routed(backend):
        return outcome(fn)


_CHAINS = {}


def chains():
    """The JAX-built chains every test shares (built once): a stable
    4-validator chain of 10 heights, one whose set rotates completely at
    height 5, and a forked copy of the stable one, re-signed by the same
    keys (an equivocation fork that verifies on its own)."""
    if not _CHAINS:
        keys = _keys(0x20, 4)
        stable = _mk_chain([keys], 10)
        a, b = _keys(0x30, 4), _keys(0x40, 4)
        rotated = _mk_chain([a] * 4 + [b] * 6, 10)
        forked = _mk_chain([keys], 10)
        for lb in forked.values():
            lb.signed_header.header.app_hash = b"\xee" * 32
        forked = _resign(forked, keys)
        _CHAINS.update(stable=stable, rotated=rotated, forked=forked,
                       keys=keys)
    return _CHAINS


def _variant(name):
    """(JAX blocks, port blocks) of a named chain variant."""
    c = chains()
    if name in ("stable", "rotated", "forked"):
        jb = c[name]
    else:
        jb = copy.deepcopy(c["stable"])
        if name == "bad_sig":      # a zeroed signature at commit index 0
            jb[6].signed_header.commit.signatures[0].signature = b"\x00" * 64
        elif name == "late_sig":   # corrupt past the 2/3 early exit
            s = jb[2].signed_header.commit.signatures[3]
            s.signature = s.signature[:5] + bytes([s.signature[5] ^ 1]) + \
                s.signature[6:]
        elif name == "tampered":   # header changed, commit not re-signed
            jb[2].signed_header.header.app_hash = b"\xff" * 32
        elif name == "wrong_vals":  # the untrusted set is another set
            jb[6].validator_set = _val_set(_keys(0x90, 4))
        else:
            raise KeyError(name)
    key = "port:" + name
    if key not in c:
        c[key] = port_blocks(jb)
    return jb, c[key]


#: (name, chain variant, trusted h, target h, trusting period s, now ns)
VERIFY_CASES = [
    ("adjacent", "stable", 1, 2, PERIOD, NOW),
    ("non_adjacent", "stable", 1, 10, PERIOD, NOW),
    ("middle_span", "stable", 2, 7, PERIOD, NOW),
    ("expired", "stable", 1, 2, 1.0, NOW),
    ("expired_skip", "stable", 1, 8, 1.0, NOW),
    ("future_header", "stable", 1, 10, PERIOD, T0),
    ("same_height", "stable", 3, 3, PERIOD, NOW),
    ("rotated_skip", "rotated", 1, 10, PERIOD, NOW),
    ("rotated_adjacent", "rotated", 4, 5, PERIOD, NOW),
    ("bad_sig", "bad_sig", 1, 6, PERIOD, NOW),
    ("bad_sig_adjacent", "bad_sig", 5, 6, PERIOD, NOW),
    ("late_sig", "late_sig", 1, 2, PERIOD, NOW),
    ("tampered", "tampered", 1, 2, PERIOD, NOW),
    ("wrong_vals", "wrong_vals", 1, 6, PERIOD, NOW),
    ("forked_from_honest", "forked", 1, 4, PERIOD, NOW),
]


def _verify_call(ver, blocks, th, h, period, now):
    return lambda: ver.verify(
        blocks[th].signed_header, blocks[th].validator_set,
        blocks[h].signed_header, blocks[h].validator_set, period, now, DRIFT)


def expected_verdicts():
    """The JAX package's verdict of every VERIFY_CASES row (computed once)."""
    c = chains()
    if "verdicts" not in c:
        c["verdicts"] = {
            name: on_jax(_verify_call(jver, _variant(var)[0], th, h, p, n))
            for name, var, th, h, p, n in VERIFY_CASES}
    return c["verdicts"]


# -- test_light_batched.py ----------------------------------------------------

CHAIN_B = "light-batched-test"


def _mk_val_set(n, seed=7):
    rng = np.random.default_rng(seed)
    keys, vals = {}, []
    for _ in range(n):
        sk = jcrypto.Ed25519PrivKey.generate(
            bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        pub = sk.pub_key()
        keys[pub.address()] = sk
        vals.append(JValidator(pub.address(), pub, 10))
    return JValidatorSet(vals), keys


def _sign_commit(vs, keys, height, nil_every=0):
    bid = JBlockID(height.to_bytes(8, "big") * 4, JPSH(1, b"\x02" * 32))
    sigs = []
    for i, v in enumerate(vs.validators):
        ts = 1_700_000_000_000_000_000 + height * 1_000_000 + i
        flag = (JFlag.NIL if nil_every and i % nil_every == 0
                else JFlag.COMMIT)
        cs_bid = bid if flag == JFlag.COMMIT else JBlockID()
        msg = jvsb(CHAIN_B, JSMT.PRECOMMIT, height, 0, cs_bid, ts)
        sigs.append(JCommitSig(flag, v.address, ts, keys[v.address].sign(msg)))
    return JCommit(height, 0, bid, sigs), bid


def _t_entries(entries):
    return [(convert.validator_set_from_reference(vs.encode()), cid,
             convert.commit_from_reference(c.encode()), tl)
            for vs, cid, c, tl in entries]


def _batched_outcomes(results):
    return [None if r is None else (type(r).__name__, str(r))
            for r in results]


def test_vote_sign_bytes_batch_matches_per_index():
    from tendermint_tpu.types.canonical import vote_sign_bytes_batch as jbatch
    from tendermint_tpu_torch.types.basic import BlockID as TBlockID
    from tendermint_tpu_torch.types.basic import PartSetHeader as TPSH
    from tendermint_tpu_torch.types.basic import SignedMsgType as TSMT

    rows = [((b"\x11" * 32, 3, b"\x22" * 32), 1_700_000_000_123_456_789),
            (None, 0),                        # zero time: still emitted
            ((b"\x11" * 32, 3, b"\x22" * 32), 1),  # 1 ns: nanos only
            (None, 2_000_000_000_000_000_000),
            ((b"\x11" * 32, 3, b"\x22" * 32), 999_999_999)]

    def bids(BlockID, PSH):
        return [BlockID() if r is None else BlockID(r[0], PSH(r[1], r[2]))
                for r, _ in rows]

    ts = [t for _, t in rows]
    got = tcanon.vote_sign_bytes_batch(CHAIN_B, TSMT.PRECOMMIT, 77, 2,
                                       bids(TBlockID, TPSH), ts)
    want = [tcanon.vote_sign_bytes(CHAIN_B, TSMT.PRECOMMIT, 77, 2, b, t)
            for b, t in zip(bids(TBlockID, TPSH), ts)]
    assert got == want
    assert got == jbatch(CHAIN_B, JSMT.PRECOMMIT, 77, 2, bids(JBlockID, JPSH),
                         ts)


def test_commit_vote_sign_bytes_all_matches_and_memoizes():
    vs, keys = _mk_val_set(7)
    jcommit, _ = _sign_commit(vs, keys, 9, nil_every=3)
    commit = convert.commit_from_reference(jcommit.encode())
    all_sb = commit.vote_sign_bytes_all(CHAIN_B)
    assert all_sb == [commit.vote_sign_bytes(CHAIN_B, i)
                      for i in range(len(vs.validators))]
    assert all_sb == jcommit.vote_sign_bytes_all(CHAIN_B)
    assert commit.vote_sign_bytes_all(CHAIN_B) is all_sb  # memo hit
    assert commit.vote_sign_bytes_all("other") != all_sb  # keyed by chain


def test_trusting_batched_matches_sequential_and_jax():
    vs, keys = _mk_val_set(7)
    trust = (1, 3)
    commits = [_sign_commit(vs, keys, h)[0] for h in range(2, 6)]
    # an EARLY-position corrupt signature errors its entry; a LATE one past
    # the trust-level early exit is never examined
    sig = bytearray(commits[1].signatures[0].signature)
    sig[0] ^= 1
    commits[1].signatures[0].signature = bytes(sig)
    sig = bytearray(commits[2].signatures[-1].signature)
    sig[0] ^= 1
    commits[2].signatures[-1].signature = bytes(sig)
    entries = [(vs, CHAIN_B, c, trust) for c in commits]
    with routed("host"):
        want = _batched_outcomes(
            jvs_mod.verify_commit_light_trusting_batched(entries))
    assert want[0] is None and want[2] is None and want[3] is None
    assert want[1][0] == "ErrWrongSignature"
    t_entries = _t_entries(entries)
    with routed("cuda"):  # one batch over every entry's candidates
        got = tvs_mod.verify_commit_light_trusting_batched(t_entries)
    assert tbatch.stats["device_batches"] == 1
    assert _batched_outcomes(got) == want
    for (tvs, cid, c, tl), w in zip(t_entries, want):
        assert on_port(lambda: tvs.verify_commit_light_trusting(cid, c, tl),
                       "host") == w


def test_trusting_batched_insufficient_power_and_zero_denominator():
    vs, keys = _mk_val_set(6)
    commit, _ = _sign_commit(vs, keys, 3)
    for i in range(1, 6):  # absent: not enough power for a 2/3 trust level
        commit.signatures[i] = JCommitSig.new_absent()
    entries = [(vs, CHAIN_B, commit, (2, 3)), (vs, CHAIN_B, commit, (1, 0))]
    with routed("host"):
        want = _batched_outcomes(
            jvs_mod.verify_commit_light_trusting_batched(entries))
        got = tvs_mod.verify_commit_light_trusting_batched(
            _t_entries(entries))
    assert isinstance(got[0], ErrNotEnoughVotingPowerSigned)
    assert isinstance(got[1], ValueError)
    assert _batched_outcomes(got) == want


def test_trusting_batched_foreign_addresses_skipped():
    """Signatures from validators outside the trusted set don't count (the
    light client's core trust rule)."""
    vs, _ = _mk_val_set(5)
    other_vs, other_keys = _mk_val_set(5, seed=99)
    commit, _ = _sign_commit(other_vs, other_keys, 4)
    entries = [(vs, CHAIN_B, commit, (1, 3))]
    with routed("host"):
        want = _batched_outcomes(
            jvs_mod.verify_commit_light_trusting_batched(entries))
        got = tvs_mod.verify_commit_light_trusting_batched(
            _t_entries(entries))
    assert isinstance(got[0], ErrNotEnoughVotingPowerSigned)
    assert _batched_outcomes(got) == want


# -- test_light_client.py -----------------------------------------------------

def test_verify_adjacent_and_rules():
    jb, tb = _variant("stable")
    tver.verify_adjacent(tb[1].signed_header, tb[2].signed_header,
                         tb[2].validator_set, PERIOD, NOW, DRIFT)
    bad = copy.deepcopy(tb[2].signed_header)
    bad.header.app_hash = b"\xff" * 32
    jbad = copy.deepcopy(jb[2].signed_header)
    jbad.header.app_hash = b"\xff" * 32
    for period, jh, th in ((PERIOD, jbad, bad),
                           (1.0, jb[2].signed_header, tb[2].signed_header)):
        want = on_jax(lambda: jver.verify_adjacent(
            jb[1].signed_header, jh, jb[2].validator_set, period, NOW, DRIFT))
        got = on_port(lambda: tver.verify_adjacent(
            tb[1].signed_header, th, tb[2].validator_set, period, NOW, DRIFT),
            "host")
        assert got == want and got is not None
    assert want[0] == "ErrOldHeaderExpired"


def test_verify_non_adjacent_trusting():
    _, tb = _variant("stable")
    with routed("cuda"):
        tver.verify_non_adjacent(tb[1].signed_header, tb[1].validator_set,
                                 tb[10].signed_header, tb[10].validator_set,
                                 PERIOD, NOW, DRIFT)
    # the trusting check, then the light check: two device batches
    assert tbatch.stats["device_batches"] == 2


def test_verify_non_adjacent_rotated_set_cant_be_trusted():
    _, tb = _variant("rotated")
    with pytest.raises(tver.ErrNewValSetCantBeTrusted):
        tver.verify_non_adjacent(tb[1].signed_header, tb[1].validator_set,
                                 tb[10].signed_header, tb[10].validator_set,
                                 PERIOD, NOW, DRIFT)


@pytest.mark.parametrize("name", [c[0] for c in VERIFY_CASES])
def test_verify_matches_jax(name):
    _, var, th, h, period, now = next(c for c in VERIFY_CASES
                                      if c[0] == name)
    _, tb = _variant(var)
    got = on_port(_verify_call(tver, tb, th, h, period, now), "host")
    assert got == expected_verdicts()[name]


def test_verify_on_the_cuda_route_matches_jax():
    """A single ``verify`` on the cuda route (plain versions here): an
    accepted skip, a bad signature and a set that cannot be trusted."""
    want = expected_verdicts()
    for name in ("non_adjacent", "bad_sig", "rotated_skip"):
        _, var, th, h, period, now = next(c for c in VERIFY_CASES
                                          if c[0] == name)
        _, tb = _variant(var)
        assert on_port(_verify_call(tver, tb, th, h, period, now),
                       "cuda") == want[name], name
    # two batches for the skip, one for the trusting check that meets the
    # bad signature, none for a trusted set with no signer in the commit
    assert tbatch.stats["device_batches"] == 3
    assert tbatch.stats["host_batches"] == 0


def _run_client(client_cls, trust_cls, blocks, witness_blocks, height,
                skipping, store=None):
    async def run():
        primary = (TMockProvider if client_cls is TLightClient
                   else JMockProvider)(CHAIN, blocks)
        witness = (TMockProvider if client_cls is TLightClient
                   else JMockProvider)(CHAIN, witness_blocks)
        witness.id = lambda: "witness-1"  # ids name providers in messages
        client = client_cls(
            CHAIN, trust_cls(PERIOD, 1, blocks[1].signed_header.header.hash()),
            primary, [witness], store=store, skipping=skipping)
        lb = await client.verify_light_block_at_height(height, now_ns=NOW)
        return (lb.signed_header.header.hash(), client.store.heights(),
                len(witness.evidence))

    box = {}

    def call():
        box["r"] = asyncio.run(run())

    err = outcome(call)
    return err if err is not None else box["r"]


def _both_clients(name, witness, height, skipping, backend="host"):
    jb, tb = _variant(name)
    jw, tw = _variant(witness)
    with routed("host"):
        want = _run_client(JLightClient, JTrustOptions, jb, jw, height,
                           skipping)
    with routed(backend):
        got = _run_client(TLightClient, TTrustOptions, tb, tw, height,
                          skipping)
    return want, got


def test_client_bisection_through_rotation():
    want, got = _both_clients("rotated", "rotated", 10, True)
    assert got == want
    _hash, heights, _ev = got
    assert heights[-1] == 10 and len(heights) >= 2


def test_client_detects_divergent_witness():
    want, got = _both_clients("stable", "forked", 5, True)
    assert got == want
    assert got[0] == "DivergenceError"
    # the port's own: the witness got the evidence and was struck
    tb, tw = _variant("stable")[1], _variant("forked")[1]

    async def run():
        witness = TMockProvider(CHAIN, tw)
        client = TLightClient(
            CHAIN, TTrustOptions(PERIOD, 1, tb[1].signed_header.header.hash()),
            TMockProvider(CHAIN, tb), [witness])
        with pytest.raises(TDivergence):
            await client.verify_light_block_at_height(5, now_ns=NOW)
        assert witness.evidence, "divergence must be reported to the witness"
        assert client.scoreboard.banned(witness.id())

    with routed("host"):
        asyncio.run(run())


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_client_sequential_matches_jax(backend):
    want, got = _both_clients("stable", "stable", 8, False, backend)
    assert got == want
    assert got[1] == list(range(1, 9))
    if backend == "cuda":
        # the trust height's own check, then the range 2..8 in ONE batch;
        # every step of the replay finds its verdicts precomputed
        assert tbatch.stats["device_batches"] == 2
        assert tbatch.stats["precomputed_batches"] == 7
        assert tbatch.stats["host_batches"] == 0


def test_client_bisection_rejects_a_bad_signature_like_jax():
    want, got = _both_clients("bad_sig", "bad_sig", 6, True)
    assert got == want
    assert got[0] == "ErrWrongSignature"  # the trusting check meets it


def test_verify_chain_batched_parity():
    """verify_chain_batched makes the same accept/reject decisions as the
    JAX package's, with all signatures in one batch."""
    for name, period, lo in (("stable", PERIOD, 1), ("bad_sig", PERIOD, 1),
                             ("stable", 1.0, 1), ("rotated", PERIOD, 1),
                             ("late_sig", PERIOD, 1), ("tampered", PERIOD, 1)):
        jb, tb = _variant(name)
        hs = range(lo + 1, 9)
        want = on_jax(lambda: jver.verify_chain_batched(
            jb[lo], [jb[h] for h in hs], period, NOW, DRIFT))
        for backend in ("host", "cuda") if name in ("stable", "bad_sig") \
                else ("host",):
            reset_port()
            got = on_port(lambda: tver.verify_chain_batched(
                tb[lo], [tb[h] for h in hs], period, NOW, DRIFT), backend)
            assert got == want, (name, period, backend)
            batches = tbatch.stats["device_batches" if backend == "cuda"
                                   else "host_batches"]
            assert batches == 1, (name, backend, tbatch.stats)


def test_chain_batched_counts_one_batch_and_its_hits():
    """One device batch for the whole range; the replay then hits the
    precomputed verdicts once per adjacent step (verify_commit_light) and
    twice per non-adjacent step (the trusting check, then the light
    check) — a key built on one side that the other side does not find
    would show here as an extra device batch."""
    jb, tb = _variant("stable")
    hs = [2, 3, 5, 8, 9, 10]  # adjacent 1-2, 2-3, 8-9, 9-10; skips 3-5, 5-8
    want = on_jax(lambda: jver.verify_chain_batched(
        jb[1], [jb[h] for h in hs], PERIOD, NOW, DRIFT))
    with routed("cuda"):
        got = outcome(lambda: tver.verify_chain_batched(
            tb[1], [tb[h] for h in hs], PERIOD, NOW, DRIFT))
    assert got is None and want is None
    assert tbatch.stats["device_batches"] == 1
    assert tbatch.stats["device_sigs"] == 4 * len(hs)
    assert tbatch.stats["precomputed_batches"] == 4 * 1 + 2 * 2
    assert tbatch.stats["host_batches"] == 0


def test_jax_light_block_survives_the_carry_across():
    jb, _ = _variant("stable")
    for h in (1, 5, 10):
        lb = port_lb(jb[h])
        assert lb.signed_header.header.hash() == \
            jb[h].signed_header.header.hash()
        assert lb.validator_set.hash() == jb[h].validator_set.hash()
        assert lb.encode() == jb[h].encode()
        sh = convert.signed_header_from_reference(
            jb[h].signed_header.encode())
        assert sh.encode() == jb[h].signed_header.encode()
        assert sh.commit.hash() == jb[h].signed_header.commit.hash()
        lb.validate_basic(CHAIN)


def test_light_store_bytes_match_and_cross_read():
    jb, tb = _variant("stable")
    jstore, tstore = JLightStore(JMemDB()), TLightStore(TMemDB())
    for h in (3, 1, 7, 5):
        jstore.save(jb[h])
        tstore.save(tb[h])
    jrows = list(jstore.db.iterate(None, None))
    trows = list(tstore.db.iterate(None, None))
    assert jrows == trows and len(trows) == 4
    assert tstore.heights() == jstore.heights() == [1, 3, 5, 7]
    assert (tstore.first_height(), tstore.latest_height()) == (1, 7)
    # each package reads the other's rows
    jread, tread = JLightStore(JMemDB()), TLightStore(TMemDB())
    for k, v in trows:
        jread.db.set(k, v)
    for k, v in jrows:
        tread.db.set(k, v)
    for h in (1, 3, 5, 7):
        assert jread.get(h).encode() == tstore.get(h).encode()
        assert tread.get(h).encode() == jstore.get(h).encode()
    assert tread.latest().encode() == jb[7].encode()
    assert tread.get(2) is None
    tstore.prune(2)
    jstore.prune(2)
    assert tstore.heights() == jstore.heights() == [5, 7]


def test_trust_level_rules_and_header_expiry_match_jax():
    for lvl in ((1, 3), (2, 3), (1, 1), (1, 4), (4, 3), (0, 0), (1, 0)):
        assert outcome(lambda: tver.validate_trust_level(lvl)) == \
            outcome(lambda: jver.validate_trust_level(lvl))
    jb, tb = _variant("stable")
    for period, now in ((1.0, NOW), (PERIOD, NOW), (99.0, T0 + 100 * 10**9),
                        (100.0, T0 + 100 * 10**9)):
        assert tver.header_expired(tb[1].signed_header, period, now) == \
            jver.header_expired(jb[1].signed_header, period, now)
    assert set(tlight.__dict__) >= {"verify", "verify_adjacent",
                                    "verify_backwards", "verify_non_adjacent",
                                    "header_expired", "LightClient",
                                    "TrustOptions"}


def test_verify_backwards_matches_jax():
    jb, tb = _variant("stable")
    jt, tt = _variant("tampered")
    for (ju, jtr), (tu, ttr) in (
            ((jb[4], jb[5]), (tb[4], tb[5])),     # linked: accepted
            ((jb[5], jb[4]), (tb[5], tb[4])),     # wrong order
            ((jt[2], jt[3]), (tt[2], tt[3])),     # hash does not link
            ((jb[3], jb[5]), (tb[3], tb[5]))):    # not the parent
        want = outcome(lambda: jver.verify_backwards(
            ju.signed_header.header, jtr.signed_header.header))
        got = outcome(lambda: tver.verify_backwards(
            tu.signed_header.header, ttr.signed_header.header))
        assert got == want
