"""The port's commit-verification slice as a whole, against the JAX package.

Commits are built and signed with the JAX package's own types, carried into
the port through tendermint_tpu_torch.convert (the proto wire bytes), and
verified by both packages: VerifyCommit, VerifyCommitLight,
VerifyCommitLightTrusting and the window-batched variants must give the
same outcome — success, or the same exception class with the same
arguments. The JAX side runs on its host route (its own tests hold that
route byte-identical to its kernels); the port side goes through its
device route, which on the CPU runs the kernels' plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

from tendermint_tpu import crypto as jcrypto
from tendermint_tpu.types import BlockID, BlockIDFlag, PartSetHeader
from tendermint_tpu.types import SignedMsgType, ValidatorSet
from tendermint_tpu.types import validator_set as jvs_mod
from tendermint_tpu.types.block import Commit, CommitSig
from tendermint_tpu.types.canonical import vote_sign_bytes
from tendermint_tpu.types.validator import new_validator
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch.crypto import Ed25519PubKey as TPub
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.types import validator_set as tvs_mod

CHAIN_ID = "torch-port-chain"
HEIGHT = 5


def _reset_port():
    tfaults.reset()
    tbreaker.reset()
    tphases.reset()
    TV.reset_launches()
    for k in tbatch.stats:
        tbatch.stats[k] = 0


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    # every port batch takes the device route (the plain versions here)
    monkeypatch.setenv("TMTPU_DEVICE_THRESHOLD", "1")
    monkeypatch.delenv("TMTPU_BATCH_BACKEND", raising=False)
    _reset_port()
    yield
    _reset_port()
    device.set_default_device(None)


def _make_set(n, seed, powers=None):
    rng = np.random.default_rng(seed)
    privs = [jcrypto.Ed25519PrivKey.generate(
        bytes(rng.integers(0, 256, 32, dtype=np.uint8))) for _ in range(n)]
    powers = powers or [10] * n
    vs = ValidatorSet([new_validator(p.pub_key(), w)
                       for p, w in zip(privs, powers)])
    return vs, {p.pub_key().address(): p for p in privs}


def _make_commit(vs, privs, seed, absent=(), nil=(), corrupt=()):
    rng = np.random.default_rng(seed)
    block_id = BlockID(bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                       PartSetHeader(1, b"\x02" * 32))
    sigs = []
    base = 1_700_000_000_000_000_000
    for i, val in enumerate(vs.validators):
        if i in absent:
            sigs.append(CommitSig.new_absent())
            continue
        ts = base + int(rng.integers(300_000_000, 999_999_999))
        vote_bid = BlockID() if i in nil else block_id
        flag = BlockIDFlag.NIL if i in nil else BlockIDFlag.COMMIT
        sb = vote_sign_bytes(CHAIN_ID, SignedMsgType.PRECOMMIT, HEIGHT, 0,
                             vote_bid, ts)
        sig = privs[val.address].sign(sb)
        if i in corrupt:
            sig = sig[:20] + bytes([sig[20] ^ 1]) + sig[21:]
        sigs.append(CommitSig(flag, val.address, ts, sig))
    return Commit(HEIGHT, 0, block_id, sigs), block_id


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome under comparison
        return type(e).__name__, e.args
    return None


def _both(monkeypatch, jax_fn, port_fn):
    """(JAX outcome on its host route, port outcome on its device route)."""
    with monkeypatch.context() as m:
        m.setenv("TMTPU_BATCH_BACKEND", "host")
        want = _outcome(jax_fn)
    return want, _outcome(port_fn)


def _port(vs, commit):
    return (convert.validator_set_from_reference(vs.encode()),
            convert.commit_from_reference(commit.encode()))


@pytest.mark.parametrize("n, absent, nil, corrupt, expect", [
    (8, (), (), (), None),
    (12, (), (), (3,), "ErrWrongSignature"),
    (10, (1,), (2,), (), None),
    (9, (0, 1, 2, 3), (), (), "ErrNotEnoughVotingPowerSigned"),
    (12, (), (), (11,), "ErrWrongSignature"),  # after the light quorum
    (48, (5,), (), (30,), "ErrWrongSignature"),
])
def test_verify_commit_variants_match_jax(monkeypatch, n, absent, nil,
                                          corrupt, expect):
    vs, privs = _make_set(n, seed=n)
    commit, bid = _make_commit(vs, privs, seed=n + 100, absent=absent,
                               nil=nil, corrupt=corrupt)
    tvs, tcommit = _port(vs, commit)
    assert tvs.hash() == vs.hash() and tcommit.hash() == commit.hash()
    outcomes = []
    for name in ("verify_commit", "verify_commit_light"):
        want, got = _both(
            monkeypatch,
            lambda: getattr(vs, name)(CHAIN_ID, bid, HEIGHT, commit),
            lambda: getattr(tvs, name)(CHAIN_ID, tcommit.block_id, HEIGHT,
                                       tcommit))
        assert got == want, name
        outcomes.append(got)
    want, got = _both(
        monkeypatch,
        lambda: vs.verify_commit_light_trusting(CHAIN_ID, commit, (1, 3)),
        lambda: tvs.verify_commit_light_trusting(CHAIN_ID, tcommit, (1, 3)))
    assert got == want
    assert (outcomes[0] or (None,))[0] == expect
    assert tbatch.stats["device_sigs"] > 0
    assert tbatch.stats["device_errors"] == 0


def test_wrong_shape_errors_match(monkeypatch):
    vs, privs = _make_set(8, seed=1)
    commit, bid = _make_commit(vs, privs, seed=2)
    tvs, tcommit = _port(vs, commit)
    smaller, _ = _make_set(7, seed=3)
    tsmaller = convert.validator_set_from_reference(smaller.encode())
    for jax_fn, port_fn in (
        (lambda: vs.verify_commit(CHAIN_ID, bid, HEIGHT + 1, commit),
         lambda: tvs.verify_commit(CHAIN_ID, tcommit.block_id, HEIGHT + 1,
                                   tcommit)),
        (lambda: smaller.verify_commit(CHAIN_ID, bid, HEIGHT, commit),
         lambda: tsmaller.verify_commit(CHAIN_ID, tcommit.block_id, HEIGHT,
                                        tcommit)),
        (lambda: vs.verify_commit_light_trusting(CHAIN_ID, commit, (1, 0)),
         lambda: tvs.verify_commit_light_trusting(CHAIN_ID, tcommit, (1, 0))),
    ):
        want, got = _both(monkeypatch, jax_fn, port_fn)
        assert got == want and want is not None


def test_trusting_subset_and_double_vote_match(monkeypatch):
    vs, privs = _make_set(16, seed=4)
    commit, bid = _make_commit(vs, privs, seed=5)
    # a trusted set holding 6 of the 16 signers
    trusted = ValidatorSet([v.copy() for v in vs.validators[:6]])
    ttrusted = convert.validator_set_from_reference(trusted.encode())
    tcommit = convert.commit_from_reference(commit.encode())
    for level in ((1, 3), (2, 3)):
        want, got = _both(
            monkeypatch,
            lambda: trusted.verify_commit_light_trusting(CHAIN_ID, commit,
                                                         level),
            lambda: ttrusted.verify_commit_light_trusting(CHAIN_ID, tcommit,
                                                          level))
        assert got == want
    # the same validator's vote twice: the double-vote error
    dup = Commit(HEIGHT, 0, bid, list(commit.signatures))
    dup.signatures[2] = commit.signatures[1]
    tdup = convert.commit_from_reference(dup.encode())
    tvs = convert.validator_set_from_reference(vs.encode())
    want, got = _both(
        monkeypatch,
        lambda: vs.verify_commit_light_trusting(CHAIN_ID, dup, (1, 3)),
        lambda: tvs.verify_commit_light_trusting(CHAIN_ID, tdup, (1, 3)))
    assert got == want and want[0] == "ValueError"
    assert "double vote" in want[1][0]


def test_window_batched_variants_match(monkeypatch):
    sets = [_make_set(n, seed=20 + n) for n in (8, 10, 12)]
    commits = [
        _make_commit(sets[0][0], sets[0][1], seed=30),
        _make_commit(sets[1][0], sets[1][1], seed=31, corrupt=(4,)),
        _make_commit(sets[2][0], sets[2][1], seed=32, absent=(0, 1, 2, 3, 4)),
    ]
    entries = [(vs, CHAIN_ID, bid, HEIGHT, c)
               for (vs, _), (c, bid) in zip(sets, commits)]
    entries.append((sets[0][0], CHAIN_ID, commits[0][1], HEIGHT + 1,
                    commits[0][0]))  # shape error, per entry
    tentries = []
    for vs, cid, _, h, c in entries:
        tc = convert.commit_from_reference(c.encode())
        tentries.append((convert.validator_set_from_reference(vs.encode()),
                         cid, tc.block_id, h, tc))
    with monkeypatch.context() as m:
        m.setenv("TMTPU_BATCH_BACKEND", "host")
        want = jvs_mod.verify_commit_light_batched(entries)
        want_t = jvs_mod.verify_commit_light_trusting_batched(
            [(vs, CHAIN_ID, c, (1, 3)) for vs, _, _, _, c in entries])
    got = tvs_mod.verify_commit_light_batched(tentries)
    got_t = tvs_mod.verify_commit_light_trusting_batched(
        [(vs, CHAIN_ID, c, (1, 3)) for vs, _, _, _, c in tentries])

    def norm(rs):
        return [None if r is None else (type(r).__name__, r.args) for r in rs]

    assert norm(got) == norm(want)
    assert norm(got_t) == norm(want_t)
    assert [r is None for r in norm(got)] == [True, False, False, False]
    assert tbatch.stats["device_batches"] == 2


def _items(seed, corrupt=(2,)):
    vs, privs = _make_set(8, seed=seed)
    commit, bid = _make_commit(vs, privs, seed=seed + 1, corrupt=corrupt)
    tvs, tcommit = _port(vs, commit)
    sb = tcommit.vote_sign_bytes_all(CHAIN_ID)
    return [(tvs.validators[i].pub_key, sb[i],
             tcommit.signatures[i].signature) for i in range(8)]


def _cuda_verify(items):
    bv = tbatch.BatchVerifier(backend="cuda")
    for pub, msg, sig in items:
        bv.add(pub, msg, sig)
    return bv.verify()


def test_device_fault_reverifies_on_host():
    """An armed device.batch_verify site reaches the caller: the batch is
    not re-verified on the host, the error is counted, and the breaker is
    not struck."""
    items = _items(40)
    tfaults.configure("device.batch_verify*1")
    with pytest.raises(InjectedFault):
        _cuda_verify(items)
    assert tbatch.stats["device_errors"] == 1
    assert tbatch.stats["host_sigs"] == 0 and tbatch.stats["device_sigs"] == 0
    assert tbreaker.state == "closed" and not tbreaker.stats
    # the site fired once: the next batch runs on the device path again
    assert _cuda_verify(items)[1].tolist() == [i != 2 for i in range(8)]
    assert tbatch.stats["device_sigs"] == 8
    assert isinstance(items[0][0], TPub)


class _FaultAtFetch(torch.Tensor):
    """A verdict tensor whose device fault surfaces when it is fetched, as
    an asynchronous CUDA error does."""

    def numpy(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


@pytest.mark.parametrize("where", ["launch", "fetch"])
def test_running_kernel_fault_reaches_the_caller(monkeypatch, where):
    """A fault of the running verify kernel, at its launch or surfacing at
    the fetch, reaches the caller: no host re-verify, no breaker strike."""
    plain = TV.verify_dense

    def broken(*args):
        if where == "launch":
            raise RuntimeError("ed25519_verify_dense: CUDA error 700 at "
                               "launch")
        return plain(*args).as_subclass(_FaultAtFetch)

    monkeypatch.setattr(TV, "verify_dense", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _cuda_verify(_items(42))
    assert tbatch.stats["device_errors"] == 1
    assert tbatch.stats["host_sigs"] == 0 and tbatch.stats["device_sigs"] == 0
    assert tbreaker.state == "closed" and not tbreaker.stats


def test_open_breaker_leaves_the_cuda_route_alone():
    """An open device breaker does not send a cuda batch to the host, and
    the route neither reads nor strikes it."""
    while tbreaker.state != "open":
        tbreaker.record_failure()
    stats = dict(tbreaker.stats)
    items = _items(44)
    assert _cuda_verify(items)[1].tolist() == [i != 2 for i in range(8)]
    assert tbatch.stats["device_sigs"] == 8 and tbatch.stats["host_sigs"] == 0
    assert tbreaker.state == "open" and tbreaker.stats == stats


@pytest.mark.parametrize("route", ["auto", "cuda"])
def test_missing_cuda_raises_at_the_caller(monkeypatch, route):
    """No CUDA and no set_default_device("cpu"): verify_commit raises
    KernelUnavailable instead of re-verifying on the host."""
    vs, privs = _make_set(16, seed=60)
    commit, bid = _make_commit(vs, privs, seed=61)
    tvs, tcommit = _port(vs, commit)
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbatch, "_calibrated_threshold", None)
    if route == "auto":  # the threshold calibration meets the missing card
        monkeypatch.delenv("TMTPU_DEVICE_THRESHOLD")
    else:
        monkeypatch.setenv("TMTPU_BATCH_BACKEND", route)
    with pytest.raises(KernelUnavailable, match="CUDA is not available"):
        tvs.verify_commit(CHAIN_ID, tcommit.block_id, HEIGHT, tcommit)
    assert tbatch.stats["device_errors"] == 0
    assert tbatch.stats["host_sigs"] == 0
    assert tbreaker.state == "closed"


def test_kernel_build_failure_raises_at_the_caller(monkeypatch, tmp_path):
    """A verify kernel that does not build reaches the caller as
    KernelUnavailable: no host re-verify, no breaker failure."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: cannot compile' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(TV.build.PACKAGE, "build_dir", tmp_path / "_build")
    monkeypatch.setattr(TV, "default_device", lambda: torch.device("cuda", 0))
    vs, privs = _make_set(8, seed=62)
    commit, bid = _make_commit(vs, privs, seed=63)
    tvs, tcommit = _port(vs, commit)
    sb = tcommit.vote_sign_bytes_all(CHAIN_ID)
    bv = tbatch.BatchVerifier(backend="cuda")
    for i in range(8):
        bv.add(tvs.validators[i].pub_key, sb[i],
               tcommit.signatures[i].signature)
    with pytest.raises(KernelUnavailable, match="cannot compile"):
        bv.verify()
    assert tbatch.stats["device_errors"] == 0
    assert tbatch.stats["host_sigs"] == 0
    assert tbreaker.state == "closed"


def test_precomputed_verdicts_skip_the_device():
    vs, privs = _make_set(8, seed=50)
    commit, bid = _make_commit(vs, privs, seed=51)
    tvs, tcommit = _port(vs, commit)
    sb = tcommit.vote_sign_bytes_all(CHAIN_ID)
    items = [(tvs.validators[i].pub_key, sb[i], tcommit.signatures[i].signature)
             for i in range(8)]
    verdicts = tbatch.precompute(items, backend="cuda")
    assert all(verdicts.values()) and len(verdicts) == 8
    launched = dict(tbatch.stats)
    token = tbatch.precomputed_verdicts.set(verdicts)
    try:
        tvs.verify_commit(CHAIN_ID, tcommit.block_id, HEIGHT, tcommit)
    finally:
        tbatch.precomputed_verdicts.reset(token)
    assert tbatch.stats["precomputed_sigs"] == 8
    assert tbatch.stats["device_sigs"] == launched["device_sigs"]
