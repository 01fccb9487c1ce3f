"""The port's vote micro-batcher (crypto/vote_batcher.py).

Mirrors tests/test_vote_batcher_liveness.py (:34, :78) and adds the
port's own contract. Departures from the JAX batcher, on purpose (ROADMAP
§3): a device flush that fails or outlives ``device_timeout_s`` is not
re-verified on the host — its fault (``DeviceFlushTimeout``, a
``TimeoutError``, for the stall) reaches every preverify future of the
flush, counts one ``device_errors``, and caches nothing; there is no
``_device_warming`` state, so the next flush rides the device again; the
batcher neither reads nor strikes ``device_breaker``; the verify kernels
are loaded once per batcher before the first timed wait, so a slow first
build is no timeout.

The JAX batcher's device call is replaced by the host spec (as its own
tests do: its jitted kernel is not compiled here); the port's runs the
kernels' plain versions on the CPU unless a test replaces it.
"""

import asyncio
import collections
import dataclasses
import threading
import time

import numpy as np
import pytest

import tendermint_tpu.crypto as jcrypto
from tendermint_tpu.crypto import vote_batcher as jvb
from tendermint_tpu_torch import crypto as tcrypto
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import ed25519_cuda as ED
from tendermint_tpu_torch.crypto import vote_batcher as vb
from tendermint_tpu_torch.crypto.breaker import device_breaker as tbreaker
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.types import SignedMsgType, ValidatorSet, VoteSet
from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader
from tendermint_tpu_torch.types.validator import new_validator
from tendermint_tpu_torch.types.vote import Vote

from tests.test_torch_light import _KNOBS, reset_port

CHAIN = "vote-batch-chain"


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    device.set_default_device(None)


def _mk_votes(n, seed=5, bad=()):
    """(pubkey bytes, msg, sig) triples signed by seeded keys; the rows in
    ``bad`` carry a flipped signature bit."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        priv = jcrypto.Ed25519PrivKey.generate(
            bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        msg = b"vote-%d-%d" % (seed, i)
        sig = priv.sign(msg)
        if i in bad:
            sig = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
        out.append((priv.pub_key().bytes(), msg, sig))
    return out


def _port(votes):
    return [(tcrypto.Ed25519PubKey(p), m, s) for p, m, s in votes]


async def _preverify_all(bv, votes):
    return await asyncio.gather(*(bv.preverify(p, m, s) for p, m, s in votes),
                                return_exceptions=True)


class _NoHost:
    """Counts host spec verifies (none may happen inside a device flush)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = tcrypto.Ed25519PubKey.verify_signature

        def counted(pub, msg, sig):
            self.calls += 1
            return orig(pub, msg, sig)

        monkeypatch.setattr(tcrypto.Ed25519PubKey, "verify_signature",
                            counted)


def test_stalled_device_flush_raises_without_host_verify(monkeypatch):
    """tests/test_vote_batcher_liveness.py:34, with the port's rule: the
    stalled flush's futures raise DeviceFlushTimeout within the timeout,
    no vote is verified on the host, the next flush rides the device
    again, and the card's late verdicts enter the cache."""
    release = threading.Event()
    calls = []

    def stuck_kernel(pks, msgs, sigs, chunk=2048, columns=None):
        calls.append(len(pks))
        release.wait(30)  # a stalled call: far beyond the timeout
        return np.ones(len(pks), dtype=bool)

    monkeypatch.setattr(ED, "batch_verify_stream", stuck_kernel)
    host = _NoHost(monkeypatch)

    async def run():
        bv = vb.BatchVoteVerifier(
            min_device_batch=4, deadline_s=0.005, device_timeout_s=0.3)
        votes = _port(_mk_votes(8))
        t0 = time.monotonic()
        results = await _preverify_all(bv, votes)
        elapsed = time.monotonic() - t0
        assert all(isinstance(r, vb.DeviceFlushTimeout) for r in results)
        assert all(isinstance(r, TimeoutError) for r in results)
        assert elapsed < 5, f"preverify blocked {elapsed:.1f}s on the stall"
        assert bv.stats["device_timeouts"] == 1
        assert bv.stats["device_errors"] == 1
        assert bv.stats["host_sigs"] == 0 and host.calls == 0
        assert not bv._cache
        assert not hasattr(bv, "_device_warming")

        # no warming state: the next flush goes to the device and stalls
        more = _port(_mk_votes(8, seed=6))
        results = await _preverify_all(bv, more)
        assert all(isinstance(r, vb.DeviceFlushTimeout) for r in results)
        assert len(calls) == 2 and bv.stats["device_errors"] == 2

        # the calls complete: their verdicts are the card's, and cached
        release.set()
        for _ in range(100):
            if len(bv._cache) == 16:
                break
            await asyncio.sleep(0.05)
        assert bv.stats["late_device_sigs"] == 16
        assert all(bv.verify(p, m, s) for p, m, s in votes + more)
        assert bv.stats["cache_hits"] == 16 and host.calls == 0

    asyncio.run(run())


def test_late_failure_of_a_timed_out_flush_is_consumed(monkeypatch, caplog):
    release = threading.Event()

    def failing_kernel(pks, msgs, sigs, chunk=2048, columns=None):
        release.wait(30)
        raise RuntimeError("kernel fault after the timeout")

    monkeypatch.setattr(ED, "batch_verify_stream", failing_kernel)

    async def run():
        bv = vb.BatchVoteVerifier(
            min_device_batch=4, deadline_s=0.005, device_timeout_s=0.2)
        results = await _preverify_all(bv, _port(_mk_votes(6)))
        assert all(isinstance(r, vb.DeviceFlushTimeout) for r in results)
        release.set()
        await asyncio.sleep(0.3)
        assert not bv._cache and bv.stats["late_device_sigs"] == 0
        return bv

    with caplog.at_level("INFO", logger="tmtpu.votebatch"):
        bv = asyncio.run(run())
    assert "kernel fault after the timeout" in caplog.text
    assert bv.stats["device_errors"] == 1


def test_fast_device_flush_still_rides_device():
    """tests/test_vote_batcher_liveness.py:78 on the port's own device
    route (the kernels' plain versions on the CPU)."""
    async def run():
        bv = vb.BatchVoteVerifier(
            min_device_batch=4, deadline_s=0.005, device_timeout_s=30.0)
        votes = _port(_mk_votes(6, seed=9, bad={0}))
        results = await _preverify_all(bv, votes)
        assert results[0] is False
        assert all(r is True for r in results[1:])
        assert bv.stats["device_batches"] == 1
        assert bv.stats["device_timeouts"] == 0
        assert TV.launches == dict.fromkeys(TV.launches, 0)  # CPU: plain

    asyncio.run(run())


def _jax_host_stream(pks, msgs, sigs, chunk=2048):
    from tendermint_tpu.crypto import ed25519 as host

    return np.array([host.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)])


def test_verdicts_and_cache_accounting_equal_the_jax_batcher(monkeypatch):
    """Mixed valid and invalid votes, a device flush of 20 and a host
    flush of 5, then every vote through ``verify`` twice (hits, then host
    misses): verdicts and every stats counter equal the JAX batcher's."""
    import tendermint_tpu.crypto.ed25519_jax as ed_jax

    monkeypatch.setattr(ed_jax, "batch_verify_stream", _jax_host_stream)
    raw = _mk_votes(25, seed=11, bad={0, 7, 19, 21})

    async def drive(bv, votes):
        first = await _preverify_all(bv, votes[:20])
        second = await _preverify_all(bv, votes[20:])
        hits = [bv.verify(p, m, s) for p, m, s in votes]
        misses = [bv.verify(p, m, s) for p, m, s in votes]
        return first + second, hits, misses

    jbv = jvb.BatchVoteVerifier(max_batch=20, deadline_s=0.005)
    tbv = vb.BatchVoteVerifier(max_batch=20, deadline_s=0.005)
    want = asyncio.run(drive(jbv, [(jcrypto.Ed25519PubKey(p), m, s)
                                   for p, m, s in raw]))
    got = asyncio.run(drive(tbv, _port(raw)))
    assert got == want
    assert got[0] == [i not in {0, 7, 19, 21} for i in range(25)]
    assert tbv.stats == jvb.collections.Counter(jbv.stats)
    assert tbv.stats["device_batches"] == 1 and tbv.stats["host_batches"] == 1
    assert tbv.stats["cache_hits"] == 25 and tbv.stats["sync_host_sigs"] == 25


def test_armed_fault_reaches_every_future_and_is_not_cached(monkeypatch):
    host = _NoHost(monkeypatch)
    tfaults.configure("device.vote_flush*1")

    async def run():
        bv = vb.BatchVoteVerifier(min_device_batch=4, deadline_s=0.005)
        votes = _port(_mk_votes(8, seed=13, bad={3}))
        results = await _preverify_all(bv, votes)
        assert all(isinstance(r, InjectedFault) for r in results)
        assert bv.stats["device_errors"] == 1 and not bv._cache
        assert bv.stats["device_batches"] == 0 and host.calls == 0
        # the fault was no verdict: the same votes verify afresh
        results = await _preverify_all(bv, votes)
        assert results == [i != 3 for i in range(8)]
        assert bv.stats["device_batches"] == 1 and len(bv._cache) == 8
        assert host.calls == 0

    asyncio.run(run())


def test_kernel_unavailable_reaches_every_future(monkeypatch):
    """No CUDA and no set_default_device("cpu"): the flush raises
    KernelUnavailable to each future; nothing moves to the host."""
    device.set_default_device(None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    host = _NoHost(monkeypatch)

    async def run():
        bv = vb.BatchVoteVerifier(min_device_batch=4, deadline_s=0.005)
        results = await _preverify_all(bv, _port(_mk_votes(5, seed=15)))
        assert all(isinstance(r, KernelUnavailable) for r in results)
        assert bv.stats["device_errors"] == 1 and not bv._cache
        assert not bv._kernels_loaded and host.calls == 0

    asyncio.run(run())


def test_breaker_is_neither_read_nor_struck():
    while tbreaker.state != "open":
        tbreaker.record_failure()
    stats = dict(tbreaker.stats)
    tfaults.configure("device.vote_flush*1")

    async def run():
        bv = vb.BatchVoteVerifier(min_device_batch=4, deadline_s=0.005)
        faulted = await _preverify_all(bv, _port(_mk_votes(4, seed=17)))
        assert all(isinstance(r, InjectedFault) for r in faulted)
        ok = await _preverify_all(bv, _port(_mk_votes(4, seed=18)))
        assert ok == [True] * 4
        assert bv.stats["device_batches"] == 1
        assert bv.stats["device_errors"] == 1

    asyncio.run(run())
    assert tbreaker.state == "open" and tbreaker.stats == stats


def test_slow_first_build_is_not_read_as_a_timeout(monkeypatch):
    """The first device flush loads the kernels (an nvcc build on the
    card) before its timed wait: a build slower than device_timeout_s
    delays that flush, once per batcher, and times nothing out."""
    loads = []
    orig = TV.kernel_device

    def slow_build():
        loads.append(threading.current_thread().name)
        time.sleep(0.8)
        return orig()

    def instant_kernel(pks, msgs, sigs, chunk=2048, columns=None):
        from tendermint_tpu_torch.crypto import ed25519 as host

        return np.array([host.verify(p, m, s)
                         for p, m, s in zip(pks, msgs, sigs)])

    monkeypatch.setattr(TV, "kernel_device", slow_build)
    monkeypatch.setattr(ED, "batch_verify_stream", instant_kernel)

    async def run():
        bv = vb.BatchVoteVerifier(
            min_device_batch=4, deadline_s=0.005, device_timeout_s=0.3)
        first = await _preverify_all(bv, _port(_mk_votes(4, seed=21)))
        second = await _preverify_all(bv, _port(_mk_votes(4, seed=22)))
        assert first == second == [True] * 4
        assert bv.stats["device_timeouts"] == 0
        assert bv.stats["device_batches"] == 2 and len(loads) == 1
        assert loads[0] != threading.current_thread().name  # off the loop

    asyncio.run(run())


def test_vote_set_consumes_the_preverified_verdicts():
    """A VoteSet whose verifier is the batcher: votes the reactor
    preverified are cache hits in add_vote; one it never saw is verified
    on the host (the miss path), and a bad signature is refused."""
    privs = [tcrypto.Ed25519PrivKey.generate(bytes([0x60 + i]) * 32)
             for i in range(6)]
    vs = ValidatorSet([new_validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(b"\x0b" * 32, PartSetHeader(1, b"\x0c" * 32))
    votes = []
    for i, v in enumerate(vs.validators):
        vote = Vote(SignedMsgType.PREVOTE, 3, 0, bid, 1_700_000_000 * 10**9
                    + 1000 * i, v.address, i)
        vote.signature = by_addr[v.address].sign(vote.sign_bytes(CHAIN))
        votes.append(vote)
    bad = dataclasses.replace(votes[5], signature=votes[5].signature[:-1]
                              + bytes([votes[5].signature[-1] ^ 1]))

    async def run():
        bv = vb.BatchVoteVerifier(min_device_batch=4, deadline_s=0.005)
        pre = await _preverify_all(bv, [
            (vs.validators[v.validator_index].pub_key,
             v.sign_bytes(CHAIN), v.signature) for v in votes[:5]])
        assert pre == [True] * 5
        return bv

    bv = asyncio.run(run())
    vset = VoteSet(CHAIN, 3, 0, SignedMsgType.PREVOTE, vs, verifier=bv)
    for v in votes[:5]:
        assert vset.add_vote(v)
    assert bv.stats["cache_hits"] == 5 and bv.stats["sync_host_sigs"] == 0
    with pytest.raises(Exception, match="invalid signature|Invalid"):
        vset.add_vote(bad)
    assert vset.add_vote(votes[5])
    assert bv.stats["sync_host_sigs"] == 2
    assert collections.Counter(bv.stats)["device_errors"] == 0
