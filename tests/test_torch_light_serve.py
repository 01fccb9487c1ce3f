"""The port's light-serving plane (tendermint_tpu_torch/light/serve.py)
against the JAX package's (tendermint_tpu/light/serve.py).

* the pure planning math (``bisection_skeleton``, ``plan_flushes``,
  ``fanout_queue_plan``) equal on 200 seeded inputs each, and the cases of
  tests/test_light_serve.py:51-168 (token bucket, header cache, limiter);
* the coalescer: every verdict class of tests/test_light_client.py's
  chains, and BLS aggregated commits, through ONE flush in both packages:
  each request's verdict equal to the JAX coalescer's and to the port's
  own ``verify`` run one request at a time (class name and ``str``); its
  ``stats`` equal to the JAX coalescer's on a stream that flushes by size
  only; dedup, the verdict cache, the size trigger, the queue-full and
  shutdown sheds, cancelled clients (test_light_serve.py:224-394);
* ``ServeProvider`` and its ``lightserve.lying_server`` seam; the plane
  over stub stores, 64 concurrent clients and admission
  (test_light_serve.py:469, :507), its header documents equal to the JAX
  plane's; ``enc_header`` / ``enc_commit`` equal dicts.

Departure, on purpose (ROADMAP §3): an armed ``device.batch_verify`` fault
(and ``KernelUnavailable``) reaches every request of its flush as that
exception, ``stats["device_errors"]`` counts one, and no request is
accepted; the JAX package re-verifies that flush on its host instead
(test_coalesced_parity_survives_armed_device_fault).

The JAX package runs on its host route; the port on ``host`` and on its
``cuda`` route (the verify kernels' plain versions on the CPU).
"""

import asyncio
import json
import random

import pytest

from tendermint_tpu.crypto import bls12381 as jbls
from tendermint_tpu.crypto import schemes as jschemes
from tendermint_tpu.light import serve as jserve
from tendermint_tpu.rpc import json_enc as jenc
from tendermint_tpu.types.params import SignatureParams as JSigParams
from tendermint_tpu_torch import device
from tendermint_tpu_torch.config import LightServeConfig
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import bls12381 as tbls
from tendermint_tpu_torch.crypto import schemes as tschemes
from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.light import serve as tserve
from tendermint_tpu_torch.light import verifier as tver
from tendermint_tpu_torch.light.provider import ErrLightBlockNotFound
from tendermint_tpu_torch.rpc import json_enc as tenc
from tendermint_tpu_torch.types.params import SignatureParams as TSigParams

from tests.test_light_client import CHAIN, T0, _keys, _mk_chain, _resign
from tests.test_light_serve import _mk_bls_chain
from tests.test_torch_light import (NOW, PERIOD, VERIFY_CASES, _KNOBS,
                                    _variant, expected_verdicts, outcome,
                                    port_blocks, reset_port, routed)

BLS_CHAIN = "lightserve-bls"


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS + ("TMTPU_BLS_BACKEND",):
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    tschemes.reset()
    tbls.reset()
    device.set_default_device(None)


# -- pure planning math ------------------------------------------------------

def test_planning_math_equals_jax_on_seeded_inputs():
    rng = random.Random(20261018)
    for _ in range(200):
        lo = rng.randrange(0, 500)
        hi = lo + rng.choice((0, 1, 2, 3, rng.randrange(0, 5000)))
        cap = rng.choice((1, 2, 8, 64, 200))
        assert tserve.bisection_skeleton(lo, hi, cap) == \
            jserve.bisection_skeleton(lo, hi, cap)
        t, arrivals = 0.0, []
        for _ in range(rng.randrange(0, 40)):
            t += rng.choice((0.0, rng.random() * 0.004, rng.random()))
            arrivals.append(t)
        deadline = rng.choice((0.0, 0.001, 0.002, 0.005, 0.1))
        batch = rng.randrange(1, 12)
        assert tserve.plan_flushes(arrivals, deadline, batch) == \
            jserve.plan_flushes(arrivals, deadline, batch)
        n, drained = rng.randrange(0, 300), rng.randrange(-5, 300)
        size = rng.randrange(1, 64)
        assert tserve.fanout_queue_plan(n, drained, size) == \
            jserve.fanout_queue_plan(n, drained, size)
    for mod in (tserve, jserve):
        with pytest.raises(ValueError):
            mod.plan_flushes([], 0.005, 0)
        with pytest.raises(ValueError):
            mod.plan_flushes([0.0], -1.0, 4)
        with pytest.raises(ValueError):
            mod.fanout_queue_plan(1, 0, 0)


def test_bisection_skeleton_orders_shallowest_first():
    sk = tserve.bisection_skeleton(1, 17)
    assert sk[0] == 9 and sk[1:3] == [5, 13]
    assert len(sk) == len(set(sk)) and all(1 < h < 17 for h in sk)
    assert tserve.bisection_skeleton(5, 5) == []
    assert tserve.bisection_skeleton(5, 6) == []
    assert len(tserve.bisection_skeleton(1, 10_000, cap=8)) == 8


def test_plan_flushes_deadline_and_size_triggers():
    assert tserve.plan_flushes([0.0, 0.001, 0.002], 0.005, 64) == \
        [(0.005, 3)]
    assert tserve.plan_flushes([0.0, 0.001, 0.002], 0.005, 2) == \
        [(0.001, 2), (0.007, 1)]
    assert tserve.plan_flushes([0.0, 1.0], 0.005, 64) == \
        [(0.005, 1), (1.005, 1)]


def test_fanout_queue_plan_bounds_and_evicts():
    assert tserve.fanout_queue_plan(10, 10, 4) == (0, False)
    assert tserve.fanout_queue_plan(10, 7, 4) == (3, False)
    assert tserve.fanout_queue_plan(10, 0, 4) == (4, True)


def test_token_bucket_refills_on_injected_clock():
    t = [0.0]
    tb = tserve.TokenBucket(rate=1.0, burst=2.0, clock=lambda: t[0])
    assert tb.allow() and tb.allow() and not tb.allow()
    t[0] = 1.0
    assert tb.allow() and not tb.allow()


def test_header_cache_lru_and_pinned_eviction():
    for mod in (tserve, jserve):
        c = mod.HeaderCache(capacity=3)
        c.put(1, "a")
        c.put(2, "b", pinned=True)
        c.put(3, "c")
        assert c.get(1) == "a"
        c.put(4, "d")  # evicts 3 (oldest UNPINNED; 2 is pinned)
        assert c.peek(3) is None and c.peek(2) == "b"
        assert c.stats == {"hits": 1, "misses": 0, "evictions": 1}
        c2 = mod.HeaderCache(capacity=2)
        for h in (1, 2, 3):
            c2.put(h, str(h), pinned=True)
        assert len(c2) == 2 and c2.peek(1) is None
        assert c2.pinned_count() == 2
        before = dict(c2.stats)
        c2.peek(2)
        assert c2.stats == before
        with pytest.raises(ValueError):
            mod.HeaderCache(capacity=0)


class _StubScoreboard:
    def __init__(self, ban_after=3):
        self.strikes = {}
        self.ban_after = ban_after
        self.reasons = []

    def banned(self, pid):
        return self.strikes.get(pid, 0) >= self.ban_after

    def record_failure(self, pid, reason="error", severe=False):
        self.strikes[pid] = self.strikes.get(pid, 0) + 1
        self.reasons.append(reason)

    def record_success(self, pid):
        self.strikes[pid] = 0


def test_client_limiter_sheds_are_reason_labeled_and_ban():
    runs = []
    for mod in (tserve, jserve):
        t = [0.0]
        sb = _StubScoreboard(ban_after=3)
        lim = mod.ClientLimiter(rate=1.0, burst=2.0, scoreboard=sb,
                                clock=lambda: t[0])
        lim.admit("c1")
        lim.admit("c1")
        reasons = []
        for _ in range(4):
            with pytest.raises(mod.ShedError) as ei:
                lim.admit("c1")
            reasons.append(ei.value.reason)
        lim.admit("c2")
        mod.ClientLimiter(rate=0.0, burst=1.0).admit("anyone")
        runs.append((reasons, dict(lim.stats), sb.reasons))
    assert runs[0] == runs[1]
    assert runs[0][0] == ["client-rate"] * 3 + ["banned"]
    assert runs[0][1] == {"admitted": 3, "rate_sheds": 3, "ban_sheds": 1}


def test_peerscore_matches_jax():
    from tendermint_tpu.libs.peerscore import PeerScoreboard as J
    from tendermint_tpu_torch.libs.peerscore import PeerScoreboard as T

    snaps = []
    for cls in (T, J):
        t = [0.0]
        sb = cls(ban_threshold=3, seed=5, name="light", clock=lambda: t[0])
        events = []
        for i in range(12):
            t[0] += 0.3
            pid = f"p{i % 3}"
            if i % 4 == 3:
                sb.record_success(pid)
            else:
                events.append(sb.record_failure(pid, "timeout",
                                                severe=(i == 10)))
            events.append(tuple(sb.eligible(["p0", "p1", "p2"])))
        snaps.append((events, sb.snapshot(), sb.ban_count()))
    assert snaps[0] == snaps[1]


# -- the coalescer ----------------------------------------------------------

def _reqs(serve_mod, side, rows, key=None):
    """VerifyRequests of ``rows`` = (chain variant, trusted h, h, period,
    now) on one side (0: JAX blocks, 1: port blocks)."""
    out = []
    for i, (var, th, h, period, now) in enumerate(rows):
        b = _variant(var)[side] if isinstance(var, str) else var[side]
        out.append(serve_mod.VerifyRequest(
            b[th].signed_header, b[th].validator_set, b[h].signed_header,
            b[h].validator_set, period, now, 10.0, (1, 3),
            cache_key=None if key is None else key(i)))
    return out


def _coalesce(serve_mod, reqs, backend=None, flush_max=None):
    async def run():
        co = serve_mod.VerifyCoalescer(
            flush_deadline_s=0.01, flush_max=flush_max or max(len(reqs), 1),
            backend=backend)
        try:
            return await asyncio.gather(
                *[co.submit(r) for r in reqs], return_exceptions=True), co
        finally:
            co.stop()

    return asyncio.run(run())


def _verdict(res):
    return None if res is None else (type(res).__name__, str(res))


def _scalar(ver, req):
    return outcome(lambda: ver.verify(
        req.trusted_sh, req.trusted_vals, req.untrusted_sh,
        req.untrusted_vals, req.trusting_period_s, req.now_ns,
        req.max_clock_drift_s, req.trust_level))


_ROWS = [(var, th, h, p, n) for _, var, th, h, p, n in VERIFY_CASES]


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_coalesced_verdicts_match_jax_and_scalar(backend):
    """Every verdict class of the verify table in ONE flush: one batched
    call in the port (one device batch on the cuda route), each verdict
    equal to the JAX coalescer's and to the port's own scalar verify."""
    with routed("host"):
        jres, jco = _coalesce(jserve, _reqs(jserve, 0, _ROWS), "host")
    reqs = _reqs(tserve, 1, _ROWS)
    tres, tco = _coalesce(tserve, reqs, backend)
    want = expected_verdicts()
    assert [_verdict(r) for r in jres] == [want[c[0]] for c in VERIFY_CASES]
    assert [_verdict(r) for r in tres] == [_verdict(r) for r in jres]
    assert tco.stats["flushes"] == 1 and tco.stats["device_errors"] == 0
    assert tco.stats["batched_sigs"] == jco.stats["batched_sigs"] > 0
    assert tbatch.stats["device_batches" if backend == "cuda"
                        else "host_batches"] == 1
    # the replay found every signature check precomputed
    assert tbatch.stats["device_batches"] + tbatch.stats["host_batches"] == 1
    with routed("host"):
        assert [_scalar(tver, r) for r in reqs] == \
            [_verdict(r) for r in tres]


_BLS = {}


def _bls_blocks():
    """A 4-validator bls12381 chain of 4 heights with aggregated commits
    (the JAX package's VoteSet.make_commit), and a copy whose aggregate at
    height 3 is tampered: ((JAX, port) blocks, (JAX, port) bad blocks).
    Registers the chain with both packages (the fixture resets them)."""
    jschemes.register_chain(BLS_CHAIN, JSigParams("bls12381", True))
    tschemes.register_chain(BLS_CHAIN, TSigParams("bls12381", True))
    if not _BLS:
        import copy

        from tendermint_tpu import crypto as jcrypto
        from tendermint_tpu.types import MockPV

        pvs = [MockPV(jcrypto.Bls12381PrivKey.generate(
            b"lsrv" + bytes([i]) * 4)) for i in range(4)]
        jb = _mk_bls_chain(BLS_CHAIN, pvs, 4)
        bad = copy.deepcopy(jb)
        c = bad[3].signed_header.commit
        c.agg_sig = bytes([c.agg_sig[0] ^ 0x01]) + c.agg_sig[1:]
        _BLS["good"] = (jb, port_blocks(jb))
        _BLS["bad"] = (bad, port_blocks(bad))
    return _BLS["good"], _BLS["bad"]


def test_coalesced_bls_aggregated_match_jax(monkeypatch):
    try:
        good, bad = _bls_blocks()
        rows = [(good, 1, 4, PERIOD, NOW),    # skip over aggregated commits
                (good, 2, 3, PERIOD, NOW),    # adjacent
                (bad, 1, 3, PERIOD, NOW),     # tampered aggregate
                (good, 1, 4, 1.0, NOW)]       # expired
        with routed("host"):
            jres, _ = _coalesce(jserve, _reqs(jserve, 0, rows), "host")
        reqs = _reqs(tserve, 1, rows)
        with routed("cuda"):  # the apk on the tree's plain version here
            tres, tco = _coalesce(tserve, reqs, "cuda")
        assert [_verdict(r) for r in tres] == [_verdict(r) for r in jres]
        assert tres[0] is None and tres[1] is None
        assert _verdict(tres[2])[0] == "ErrWrongSignature"
        # aggregated commits pair inline: nothing enters the ed25519 batch
        assert tco.stats["batched_sigs"] == 0
        assert tbatch.stats["device_batches"] == 0
        # on the CPU the tree's plain version runs and counts no launch;
        # phase light of chip_smoke.py counts one per aggregate check
        assert G.launches["bls_g2_tree_sum"] == 0
        # the port's own verify, one request at a time (its BLS scalar spec)
        monkeypatch.setenv("TMTPU_BLS_BACKEND", "scalar")
        with routed("host"):
            assert [_scalar(tver, r) for r in reqs] == \
                [_verdict(r) for r in tres]
    finally:
        jschemes.reset()
        jbls.reset()


def test_armed_device_fault_reaches_every_request_of_its_flush():
    """The JAX coalescer re-verifies such a flush on its host; the port
    hands the fault to every request, counts one device error, and
    verifies nothing on the host."""
    reqs = _reqs(tserve, 1, _ROWS)
    tfaults.configure("device.batch_verify@1", seed=7)
    res, co = _coalesce(tserve, reqs, "cuda")
    assert all(isinstance(r, InjectedFault) for r in res), res
    assert len({id(r) for r in res}) == 1  # the one exception of the flush
    assert co.stats["device_errors"] == 1
    assert co.stats["verified_requests"] == len(reqs)
    assert co.stats["batched_sigs"] == 0
    assert tbatch.stats["device_errors"] == 1
    assert tbatch.stats["host_batches"] == tbatch.stats["host_sigs"] == 0
    assert tbatch.stats["device_batches"] == 0


def test_device_fault_is_not_cached_as_a_keyed_verdict():
    """A keyed request that failed under an armed device fault is verified
    afresh when the same key comes back: the fault is no verdict, so the
    coalescer's verdict cache does not keep it."""
    _, blocks = _variant("stable")

    def req():
        return tserve.VerifyRequest(
            blocks[1].signed_header, blocks[1].validator_set,
            blocks[5].signed_header, blocks[5].validator_set, PERIOD, NOW,
            10.0, (1, 3), cache_key=("k", 1, 5))

    async def run():
        co = tserve.VerifyCoalescer(flush_deadline_s=0.005, flush_max=64,
                                    backend="cuda")
        try:
            tfaults.configure("device.batch_verify@1", seed=7)
            first = await co.submit(req())
            assert isinstance(first, InjectedFault), first
            assert co.stats["device_errors"] == 1
            tfaults.reset()
            assert await co.submit(req()) is None
            assert co.stats["verdict_cache_hits"] == 0
            assert co.stats["verified_requests"] == 2
            assert co.stats["device_errors"] == 1
            assert await co.submit(req()) is None  # the spec's verdict is kept
            assert co.stats["verdict_cache_hits"] == 1
        finally:
            co.stop()

    asyncio.run(run())
    assert tbatch.stats["device_batches"] == 1
    assert tbatch.stats["host_batches"] == 0


def test_kernel_unavailable_reaches_every_request_of_its_flush(monkeypatch):
    """No card while the default device is the card: KernelUnavailable
    reaches every request, nothing runs on the host."""
    import torch

    reqs = _reqs(tserve, 1, _ROWS[:3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.set_default_device("cuda")
    try:
        res, co = _coalesce(tserve, reqs, "cuda")
    finally:
        device.set_default_device("cpu")
    assert all(isinstance(r, KernelUnavailable) for r in res), res
    assert co.stats["device_errors"] == 1
    assert tbatch.stats["host_batches"] == 0


def test_concurrent_flushes_calibrate_once(monkeypatch):
    """Flushes run in executor threads and may ask for the break-even
    threshold at once: the calibration (the K11 probe's three round trips)
    runs once, and every thread gets its value."""
    import sys
    import threading
    import time

    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV

    calls = []

    def probe(device=None):
        calls.append(threading.get_ident())
        time.sleep(0.001)
        return 1e-3

    monkeypatch.setattr(TV, "probe_dispatch_seconds", probe)
    monkeypatch.setattr(tbatch, "_calibrated_threshold", None)
    barrier, got = threading.Barrier(16), []

    def ask():
        barrier.wait(5)
        got.append(tbatch.device_threshold())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 3
    assert got == [max(tbatch.DEFAULT_DEVICE_THRESHOLD,
                       int(1e-3 * tbatch._HOST_SIGS_PER_SEC_ESTIMATE
                           * tbatch._CALIBRATION_SAFETY))] * 16


_STREAM_ROWS = {"A": ("stable", 1, 8, PERIOD),
                "B": ("bad_sig", 1, 6, PERIOD),
                "C": ("stable", 4, 5, PERIOD),
                "D": ("rotated", 1, 10, PERIOD),
                "E": ("wrong_vals", 1, 6, PERIOD),
                "F": ("stable", 2, 7, PERIOD),
                "G": ("stable", 3, 9, PERIOD),
                "H": ("stable", 1, 8, 1.0)}
#: two waves of (row, keyed?). Wave one queues 8 requests and 4 more ride
#: in-flight duplicates; the flush its fourth request starts runs after the
#: other submits and takes all 8. Wave two answers 2 from the verdict cache
#: and queues 4 (one flush). Nothing waits for the deadline.
_WAVES = (["A+", "A+", "B+", "C", "D+", "A+", "E", "F+", "B+", "G", "H+",
           "H+"],
          ["A+", "C", "B+", "G", "E", "F"])


def _run_stream(serve_mod, side, backend):
    def reqs_of(wave):
        rows = [_STREAM_ROWS[w[0]] + (NOW,) for w in wave]
        keys = [w[0] if w.endswith("+") else None for w in wave]
        return _reqs(serve_mod, side, rows, key=lambda i: keys[i])

    async def run():
        co = serve_mod.VerifyCoalescer(flush_deadline_s=30.0, flush_max=4,
                                       backend=backend)
        out = []
        try:
            for wave in _WAVES:
                res = await asyncio.wait_for(asyncio.gather(
                    *[co.submit(r) for r in reqs_of(wave)]), timeout=60)
                out += [_verdict(r) for r in res]
            return out, dict(co.stats)
        finally:
            co.stop()

    return asyncio.run(run())


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_coalescer_stats_equal_jax_on_size_flushes(backend):
    with routed("host"):
        jv, jstats = _run_stream(jserve, 0, "host")
    tv, tstats = _run_stream(tserve, 1, backend)
    assert tv == jv
    assert tstats.pop("device_errors") == 0
    assert tstats == jstats
    assert (tstats["coalesced_dupes"], tstats["verdict_cache_hits"],
            tstats["flushes"]) == (4, 2, 2)


def test_coalescer_dedup_and_verdict_cache():
    _, blocks = _variant("stable")

    def req():
        return tserve.VerifyRequest(
            blocks[1].signed_header, blocks[1].validator_set,
            blocks[5].signed_header, blocks[5].validator_set, PERIOD, NOW,
            10.0, (1, 3), cache_key=("k", 1, 5))

    async def run():
        co = tserve.VerifyCoalescer(flush_deadline_s=0.005, flush_max=64,
                                    backend="host")
        try:
            r = await asyncio.gather(*[co.submit(req()) for _ in range(8)])
            assert all(v is None for v in r)
            assert co.stats["requests"] == 8
            assert co.stats["verified_requests"] == 1
            assert co.stats["coalesced_dupes"] == 7
            flushes = co.stats["flushes"]
            assert await co.submit(req()) is None
            assert co.stats["verdict_cache_hits"] == 1
            assert co.stats["flushes"] == flushes
        finally:
            co.stop()

    asyncio.run(run())


def test_coalescer_size_trigger_and_queue_full_shed():
    _, b = _variant("stable")
    r15, r26 = _reqs(tserve, 1, [("stable", 1, 5, PERIOD, NOW),
                                 ("stable", 2, 6, PERIOD, NOW)])

    async def run():
        co = tserve.VerifyCoalescer(flush_deadline_s=30.0, flush_max=2,
                                    backend="host")
        try:
            r = await asyncio.wait_for(
                asyncio.gather(co.submit(r15), co.submit(r26)), timeout=5.0)
            assert r == [None, None]
            assert co.stats["largest_flush"] == 2
        finally:
            co.stop()

        co2 = tserve.VerifyCoalescer(flush_deadline_s=30.0, flush_max=64,
                                     queue_limit=1, backend="host")
        t1 = asyncio.ensure_future(co2.submit(r15))
        await asyncio.sleep(0)
        with pytest.raises(tserve.ShedError) as ei:
            await co2.submit(r26)
        assert ei.value.reason == "queue-full"
        assert co2.stats["sheds"] == 1
        co2.stop()
        with pytest.raises(tserve.ShedError) as ei:
            await t1
        assert ei.value.reason == "shutdown"

    asyncio.run(run())


def test_coalescer_survives_cancelled_clients():
    async def run():
        co = tserve.VerifyCoalescer(flush_deadline_s=0.005, flush_max=64,
                                    backend="host")
        try:
            k = ("same", 1, 5)
            r1, r2 = _reqs(tserve, 1, [("stable", 1, 5, PERIOD, NOW)] * 2,
                           key=lambda i: k)
            t1 = asyncio.ensure_future(co.submit(r1))
            t2 = asyncio.ensure_future(co.submit(r2))
            await asyncio.sleep(0)
            t1.cancel()
            assert await asyncio.wait_for(t2, timeout=5.0) is None
        finally:
            co.stop()

    asyncio.run(run())


# -- ServeProvider + the tamper seam -----------------------------------------

def test_serve_provider_caches_and_tampers_only_when_armed():
    keys = _keys(0x20, 4)
    _, blocks = _variant("stable")
    forged = port_blocks(_resign(_mk_chain([keys], 6), keys))

    async def run():
        p = tserve.ServeProvider(CHAIN, blocks, forged={4: forged[4]},
                                 name="w1")
        assert (await p.light_block(4)) is blocks[4]
        await p.light_block(4)
        assert p.cache.stats["hits"] == 1
        assert (await p.light_block(0)).signed_header.header.height == 10
        with pytest.raises(ErrLightBlockNotFound):
            await p.light_block(99)
        assert p.id() == "w1"
        tfaults.configure("lightserve.lying_server@1", seed=3)
        try:
            assert (await p.light_block(4)) is forged[4]
            assert (await p.light_block(3)) is blocks[3]  # not forged
        finally:
            tfaults.reset()

    asyncio.run(run())


# -- the serving plane over stub stores -------------------------------------

class _BlockStoreStub:
    def __init__(self, blocks):
        self.blocks = blocks

    def height(self):
        return max(self.blocks)

    def load_block_meta(self, h):
        from types import SimpleNamespace
        lb = self.blocks.get(h)
        return None if lb is None else SimpleNamespace(
            header=lb.signed_header.header)

    def load_block_commit(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.signed_header.commit

    load_seen_commit = load_block_commit


class _StateStoreStub:
    def __init__(self, blocks):
        self.blocks = blocks

    def load_validators(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.validator_set


def _mk_plane(serve_mod, cfg_cls, blocks, **overrides):
    cfg = cfg_cls()
    # the chain's header times are 2023: a ten-year trusting period keeps
    # them unexpired against the plane's wall clock
    cfg.trusting_period_s = 10 * 365 * 24 * 3600.0
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return serve_mod.LightServePlane(block_store=_BlockStoreStub(blocks),
                                     state_store=_StateStoreStub(blocks),
                                     chain_id=CHAIN, config=cfg)


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_plane_serves_64_concurrent_clients(backend):
    _, blocks = _variant("stable")
    plane = _mk_plane(tserve, LightServeConfig, blocks)

    async def run():
        try:
            async def one(i):
                if i % 2:
                    return await plane.serve_verify(
                        8, 1 + (i % 3), client_id=f"c{i}")
                return plane.serve_header(8, trusted_height=1,
                                          client_id=f"c{i}")

            return await asyncio.gather(*[one(i) for i in range(64)])
        finally:
            plane.stop()

    with routed(backend):
        results = asyncio.run(run())
    for i, res in enumerate(results):
        if i % 2:
            assert res is None, f"client {i} rejected: {res!r}"
        else:
            assert res["signed_header"]["header"]["height"] == "8"
            assert res["canonical"] is True
    st = plane.status()
    co = st["coalescer"]
    assert co["requests"] == 32 and co["flushes"] >= 1
    assert co["verified_requests"] <= 6
    assert co["coalesced_dupes"] + co["verdict_cache_hits"] >= 26
    assert co["device_errors"] == 0
    assert st["cache"]["hits"] >= 30
    assert st["served"]["prefetched"] > 0 and st["cache"]["pinned"] > 0
    assert st["served"]["headers_served"] == 32
    assert st["served"]["verifies_served"] == 32
    assert tbatch.stats["device_batches" if backend == "cuda"
                        else "host_batches"] == co["flushes"]


def test_plane_header_docs_equal_jax():
    from tendermint_tpu.config import LightServeConfig as JCfg

    jb, tb = _variant("stable")
    jplane = _mk_plane(jserve, JCfg, jb, prefetch_limit=4)
    tplane = _mk_plane(tserve, LightServeConfig, tb, prefetch_limit=4)
    try:
        for h, th in ((8, 1), (10, 0), (3, 2), (8, 1), (0, 0)):
            assert tplane.serve_header(h, trusted_height=th) == \
                jplane.serve_header(h, trusted_height=th)
        assert tplane.status()["cache"] == jplane.status()["cache"]
        assert tplane.stats == jplane.stats
        tfaults.configure("lightserve.lying_server@1", seed=3)
        doc = tplane.serve_header(5)
        assert doc["signed_header"]["header"]["app_hash"][:2] == "ff"
        tfaults.reset()
        for plane in (tplane, jplane):
            with pytest.raises(KeyError):
                plane.serve_header(42)
    finally:
        tplane.stop()
        jplane.stop()


def test_plane_verify_rejections_and_admission():
    _, blocks = _variant("stable")

    async def run():
        plane = _mk_plane(tserve, LightServeConfig, blocks)
        try:
            with routed("host"):
                assert await plane.serve_verify(5, 1) is None
            with pytest.raises(KeyError):
                await plane.serve_verify(1, 5)
        finally:
            plane.stop()

        plane2 = _mk_plane(tserve, LightServeConfig, blocks,
                           per_client_rate=0.001, per_client_burst=2,
                           abuse_ban_threshold=3)
        try:
            reasons = []
            for _ in range(8):
                try:
                    plane2.serve_header(2, client_id="abuser")
                except tserve.ShedError as e:
                    reasons.append(e.reason)
            assert reasons.count("client-rate") == 3
            assert reasons.count("banned") == 3
            doc = plane2.serve_header(2, client_id="polite")
            assert doc["signed_header"]["header"]["height"] == "2"
            assert plane2.limiter.stats["rate_sheds"] == 3
            assert plane2.limiter.stats["ban_sheds"] == 3
        finally:
            plane2.stop()

    asyncio.run(run())


def test_json_docs_equal_jax():
    jb, tb = _variant("stable")
    for h in (1, 6, 10):
        assert tenc.enc_header(tb[h].signed_header.header) == \
            jenc.enc_header(jb[h].signed_header.header)
        assert tenc.enc_commit(tb[h].signed_header.commit) == \
            jenc.enc_commit(jb[h].signed_header.commit)
        for tv, jv in zip(tb[h].validator_set.validators,
                          jb[h].validator_set.validators):
            assert tenc.enc_validator(tv) == jenc.enc_validator(jv)
    assert tenc.enc_commit(None) is None and tenc.enc_block_id(None) == \
        jenc.enc_block_id(None)
    for ns in (0, 1, T0 + 123, -62135596800 * 10**9):
        assert tenc.rfc3339(ns) == jenc.rfc3339(ns)
    # an aggregated commit's document (the signer bitmap, the aggregate)
    try:
        good, _ = _bls_blocks()
        for h in (2, 4):
            assert tenc.enc_commit(good[1][h].signed_header.commit) == \
                jenc.enc_commit(good[0][h].signed_header.commit)
        assert json.dumps(tenc.enc_commit(good[1][2].signed_header.commit))
    finally:
        jschemes.reset()
        jbls.reset()
