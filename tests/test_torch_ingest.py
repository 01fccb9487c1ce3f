"""The port's mempool ingest plane (mempool/ingest.py, clist_mempool.py,
libs/txlife.py, libs/metrics.py) and the counter app.

Mirrors the 21 cases of tests/test_ingest_plane.py that need no net (the
live-net case at :436 waits for the consensus and p2p port) and the six
of tests/test_mempool_v1_counter.py, on the port's classes. Where a case
is differential in the JAX file (batched against scalar), the port's
responses are also held equal to the JAX package's scalar path, code and
log, tx by tx, and the envelopes equal the JAX package's bytes.

Departure, on purpose (ROADMAP §3): the breaker case (:349) becomes
``test_device_fault_reaches_each_broadcast_and_resubmission_is_admitted``.
When a flush's batched call raises (the armed ``device.batch_verify``
site, ``KernelUnavailable``), every broadcast of that flush gets the
exception, ``stats["device_errors"]`` counts one, no verdict is stored,
no tx of the flush is admitted, each lifecycle record is sealed
(``error``), the intake bound is released, and a resubmission of the same
txs is admitted as the scalar path admits them. The JAX pipeline settles
such a batch on its host instead.
"""

import asyncio
import hashlib

import pytest

import tendermint_tpu.crypto as jcrypto
from tendermint_tpu.abci.client import LocalClient as JLocalClient
from tendermint_tpu.abci.example.kvstore import \
    KVStoreApplication as JKVStoreApplication
from tendermint_tpu.mempool import ingest as jingest
from tendermint_tpu_torch import crypto
from tendermint_tpu_torch import device
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.example.counter import CounterApplication
from tendermint_tpu_torch.abci.example.kvstore import KVStoreApplication
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.batch import BatchVerifier
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.libs.metrics import MempoolMetrics, Registry
from tendermint_tpu_torch.libs.txlife import STAGES, TxLifecycle
from tendermint_tpu_torch.mempool.clist_mempool import (
    ErrTxInCache,
    MempoolError,
    init_mempool_wal,
)
from tendermint_tpu_torch.mempool.ingest import (
    MALFORMED,
    SIGNED,
    UNSIGNED,
    IngestPipeline,
    ShardedMempool,
    make_signed_tx,
    parse_signed_tx,
    replay_mempool_wal,
    signed_tx_head,
    tx_fee,
    tx_sender,
    verify_signed_tx_scalar,
)
from tendermint_tpu_torch.proxy import AppConns, local_client_creator

from tests.test_torch_light import _KNOBS, reset_port

KEYS = [crypto.Ed25519PrivKey.generate(bytes([0x40 + i]) * 32)
        for i in range(4)]
JKEYS = [jcrypto.Ed25519PrivKey.generate(bytes([0x40 + i]) * 32)
         for i in range(4)]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    yield
    reset_port()
    device.set_default_device(None)


def _mk(**kw):
    kw.setdefault("lanes", 4)
    return ShardedMempool(LocalClient(KVStoreApplication()), **kw)


def _flip_sig(tx: bytes) -> bytes:
    return tx[:-1] + bytes([tx[-1] ^ 1])


# --- signed-tx envelope ------------------------------------------------------

class TestEnvelope:
    def test_roundtrip(self):
        tx = make_signed_tx(KEYS[0], b"k=v", nonce=9, fee=42)
        status, stx = parse_signed_tx(tx)
        assert status == SIGNED
        assert stx.pubkey == KEYS[0].pub_key().bytes()
        assert (stx.fee, stx.nonce, stx.payload) == (42, 9, b"k=v")
        assert stx.sign_bytes == tx[:-64] and stx.sig == tx[-64:]
        assert tx_fee(tx) == 42
        assert tx_sender(tx) == KEYS[0].pub_key().bytes().hex()
        # the JAX package's envelope of the same key and fields
        assert tx == jingest.make_signed_tx(JKEYS[0], b"k=v", nonce=9, fee=42)

    def test_classification(self):
        assert parse_signed_tx(b"a=1")[0] == UNSIGNED
        assert parse_signed_tx(b"stx1-too-short")[0] == MALFORMED
        assert parse_signed_tx(b"stx1" + b"\x00" * 111)[0] == MALFORMED
        assert parse_signed_tx(b"stx1" + b"\x00" * 112)[0] == SIGNED

    def test_fixture_envelopes_equal_make_signed_tx(self):
        """``tools/commits.py`` ``signed_txs`` (the chip phase's txs, signed
        in a pool) builds the same bytes as ``make_signed_tx``."""
        from tendermint_tpu_torch.crypto import ed25519 as ed
        from tendermint_tpu_torch.tools import commits

        class _LocalSigner:
            def sign(self, jobs):
                return [ed.sign(ed.keygen(sd)[0], m) for sd, m in jobs]

        seeds = [bytes([0x40 + i]) * 32 for i in range(2)]
        pubs = [k.pub_key().bytes() for k in KEYS[:2]]
        specs = [(1, b"b=2", 7, 3), (0, b"a=1", 0, 0), (1, b"c=3", 8, 0)]
        got = commits.signed_txs(_LocalSigner(), seeds, pubs, specs)
        assert got == [make_signed_tx(KEYS[i], p, n, f)
                       for i, p, n, f in specs]
        assert got[0][:-64] == signed_tx_head(pubs[1], b"b=2", 7, 3)

    def test_scalar_verdicts(self):
        good = make_signed_tx(KEYS[0], b"payload", 1, 5)
        assert verify_signed_tx_scalar(good) == (True, "sig")
        assert verify_signed_tx_scalar(_flip_sig(good)) == (False, "sig")
        assert verify_signed_tx_scalar(b"plain") == (True, UNSIGNED)
        assert verify_signed_tx_scalar(b"stx1oops") == (False, MALFORMED)

    def test_unsigned_txs_hash_shard(self):
        # every unsigned tx is its own "sender": per-sender controls can
        # never collapse foreign-format traffic onto one bucket
        assert tx_sender(b"a=1") != tx_sender(b"b=2")


# --- tx-side sign columns ----------------------------------------------------

class TestTxSignColumns:
    def test_reconstructs_byte_identical(self):
        from tendermint_tpu_torch.crypto.signcols import \
            sign_columns_from_rows

        rows = [make_signed_tx(KEYS[i % 2], b"p" * 16, nonce=i,
                               fee=3)[:-64] for i in range(8)]
        cols = sign_columns_from_rows(rows)
        assert cols is not None and len(cols) == 8
        assert cols.rows() == rows
        assert [cols[i] for i in range(8)] == rows
        # nonce bytes vary; the shared magic/fee prefix does not
        assert 0 < cols.cols.shape[0] < len(rows[0]) // 2

    def test_guards(self):
        from tendermint_tpu_torch.crypto.signcols import \
            sign_columns_from_rows

        assert sign_columns_from_rows([b"one"]) is None  # too few
        assert sign_columns_from_rows([b"aa", b"abc"]) is None  # ragged
        import os

        dense = [os.urandom(32) for _ in range(4)]  # no shared structure
        assert sign_columns_from_rows(dense) is None


# --- sharded lanes -----------------------------------------------------------

class TestShardedLanes:
    def test_lane_keying_is_deterministic_per_sender(self):
        mp = _mk()
        a1 = make_signed_tx(KEYS[0], b"a", 1, 0)
        a2 = make_signed_tx(KEYS[0], b"b", 2, 0)
        b1 = make_signed_tx(KEYS[1], b"c", 1, 0)
        assert mp.lane_for(a1) == mp.lane_for(a2)  # same sender, same lane
        for tx in (a1, a2, b1):
            assert mp.check_tx(tx).is_ok()
        assert sum(mp.lane_depths()) == 3
        assert mp.lane_depths()[mp.lane_for(a1)] >= 2
        jmp = jingest.ShardedMempool(JLocalClient(JKVStoreApplication()),
                                     lanes=4)
        assert [jmp.lane_for(t) for t in (a1, a2, b1)] == \
            [mp.lane_for(t) for t in (a1, a2, b1)]

    def test_entries_after_global_admission_order(self):
        mp = _mk()
        txs = [make_signed_tx(KEYS[i % 4], b"x", i, 0) for i in range(8)]
        for tx in txs:
            mp.check_tx(tx)
        entries, cursor = mp.entries_after(0)
        assert cursor == 8
        assert [e.tx for e in entries] == txs  # seq order across lanes
        tail, _ = mp.entries_after(6)
        assert [e.tx for e in tail] == txs[6:]

    def test_dedup_is_global_across_lanes(self):
        mp = _mk()
        tx = make_signed_tx(KEYS[0], b"once", 1, 0)
        assert mp.check_tx(tx, sender="peerA").is_ok()
        with pytest.raises(ErrTxInCache):
            mp.check_tx(tx, sender="peerB")
        entries, _ = mp.entries_after(0)
        assert entries[0].senders == {"peerA", "peerB"}

    def test_depth_gauges_and_bytes(self):
        mp = _mk()
        m = MempoolMetrics(Registry())
        mp.metrics = m
        txs = [b"a=1", b"bb=2", make_signed_tx(KEYS[0], b"x", 1, 0)]
        for tx in txs:
            mp.check_tx(tx)
        assert m.size.value() == 3
        assert m.size_bytes.value() == sum(len(t) for t in txs)
        assert mp.tx_bytes() == sum(len(t) for t in txs)
        mp.flush()
        assert m.size.value() == 0 and mp.size() == 0

    def test_full_rejection_seals_lifecycle_record(self):
        mp = _mk(max_txs=1)
        tl = TxLifecycle(sample_rate=1.0)
        mp.txlife = tl
        assert mp.check_tx(b"first=1").is_ok()
        with pytest.raises(MempoolError, match="full"):
            mp.check_tx(b"second=2")
        snap = tl.snapshot(10)
        assert snap["active"] == 1  # only the admitted tx's live record
        sealed = {r["key"]: r for r in snap["records"]}
        k2 = hashlib.sha256(b"second=2").digest().hex()
        assert sealed[k2]["terminal"] == "rejected"

    def test_recheck_reuses_preverification_verdicts(self):
        mp = _mk()
        m = MempoolMetrics(Registry())
        mp.metrics = m
        signed = [make_signed_tx(KEYS[i], b"keep", i, 0) for i in range(3)]
        for tx in signed:
            assert mp.check_tx(tx).is_ok()
        assert m.preverified_txs_total.value("scalar") == 3
        mp.lock()
        try:
            mp.update(2, [signed[0]], [abci.ResponseCheckTx(code=0)])
        finally:
            mp.unlock()
        assert mp.size() == 2
        # both survivors recheck against the app, zero new sig verifies
        assert m.preverify_cache_hits_total.value("recheck") == 2
        assert m.preverified_txs_total.value("scalar") == 3


# --- MempoolWAL replay through the lanes ------------------------------------

class TestWALReplay:
    def test_crash_replay_repopulates_lanes_no_dup_admits(self, tmp_path):
        wal_dir = str(tmp_path / "mpwal")
        mp = _mk()
        init_mempool_wal(mp, wal_dir)
        txs = [make_signed_tx(KEYS[i % 4], b"w", i, i) for i in range(6)]
        txs.append(b"plain=tx")
        for tx in txs:
            assert mp.check_tx(tx).is_ok()
        mp._wal.close()  # crash

        fresh = _mk()  # the restarted node's empty lanes
        replayed, skipped = replay_mempool_wal(fresh, wal_dir)
        assert (replayed, skipped) == (7, 0)
        assert fresh.size() == 7
        assert sorted(t.tx for t in fresh.entries_after(0)[0]) == sorted(txs)
        # lane placement re-derives deterministically
        assert fresh.lane_depths() == mp.lane_depths()
        # replay is idempotent: a second pass admits nothing new
        replayed2, skipped2 = replay_mempool_wal(fresh, wal_dir)
        assert (replayed2, skipped2) == (0, 7)
        assert fresh.size() == 7
        # and replay never re-appends to the log it reads
        lines = open(f"{wal_dir}/wal", "rb").read().splitlines()
        assert len(lines) == 7


# --- async admission control -------------------------------------------------

def _run(coro):
    return asyncio.run(coro)


class TestAdmissionControl:
    def test_queue_full_shed(self):
        async def main():
            mp = _mk()
            m = MempoolMetrics(Registry())
            mp.metrics = m
            pipe = IngestPipeline(mp, batch_deadline_s=0.2, queue_limit=3)
            pipe.metrics = m
            # 3 fill the intake; the 4th sheds with an explicit reason
            futs = [asyncio.ensure_future(pipe.submit(b"q%d=1" % i))
                    for i in range(3)]
            await asyncio.sleep(0)
            shed = await pipe.submit(b"q3=1")
            assert shed.code == 1 and "queue-full" in shed.log
            assert shed.codespace == "ingest"
            assert m.shed_txs_total.value("queue-full") == 1
            await pipe.flush_now()
            assert all(r.is_ok() for r in await asyncio.gather(*futs))
            assert mp.size() == 3
            assert pipe.queue_depth() == 0

        _run(main())

    def test_fee_floor_shed(self):
        async def main():
            mp = _mk()
            pipe = IngestPipeline(mp, batch_deadline_s=0.01, queue_limit=64,
                                  fee_floor=10)
            cheap = make_signed_tx(KEYS[0], b"c", 1, fee=3)
            rich = make_signed_tx(KEYS[0], b"r", 2, fee=10)
            r1 = await pipe.submit(cheap)
            assert r1.code == 1 and "fee-floor" in r1.log
            assert (await pipe.submit(rich)).is_ok()
            # unsigned txs carry fee 0: a fee floor gates them out too
            r3 = await pipe.submit(b"plain")
            assert "fee-floor" in r3.log
            assert pipe.stats["shed_fee-floor"] == 2

        _run(main())

    def test_per_sender_rate_shed(self):
        async def main():
            mp = _mk()
            pipe = IngestPipeline(mp, batch_deadline_s=0.01, queue_limit=64,
                                  per_sender_rate=2.0)
            spam = [make_signed_tx(KEYS[0], b"s", i, 0) for i in range(5)]
            results = [await pipe.submit(tx) for tx in spam]
            sheds = [r for r in results if "sender-rate" in r.log]
            assert len(sheds) == 3  # burst of 2, then throttled
            # an unrelated sender is untouched
            ok = await pipe.submit(make_signed_tx(KEYS[1], b"o", 1, 0))
            assert ok.is_ok()

        _run(main())

    def test_shed_discards_txlife_phantom(self):
        async def main():
            mp = _mk()
            tl = TxLifecycle(sample_rate=1.0)
            mp.txlife = tl
            pipe = IngestPipeline(mp, batch_deadline_s=0.2, queue_limit=1)
            raw0, raw1 = b"keep=1", b"shed=1"
            for raw in (raw0, raw1):
                tl.mark(hashlib.sha256(raw).digest(), "rpc_received")
            fut = asyncio.ensure_future(pipe.submit(raw0))
            await asyncio.sleep(0)
            shed = await pipe.submit(raw1)
            assert shed.code == 1
            await pipe.flush_now()
            assert (await fut).is_ok()
            snap = tl.snapshot(10)
            # the shed tx's front-door phantom is gone, not "lost"
            assert snap["active"] == 1  # only the admitted tx's record
            assert all(r["terminal"] != "lost" for r in snap["records"])

        _run(main())


# --- batched pre-verification: the differential contract ---------------------

def _mixed_batch():
    """valid / bad-sig / malformed / unsigned / duplicate — every
    classification the pre-verifier can meet, in one arrival order."""
    good = [make_signed_tx(KEYS[i % 4], b"p%d" % i, i, i % 3)
            for i in range(6)]
    bad = [_flip_sig(make_signed_tx(KEYS[0], b"evil%d" % i, 100 + i, 0))
           for i in range(2)]
    malformed = [b"stx1short", b"stx1" + b"\x01" * 60]
    unsigned = [b"u%d=v" % i for i in range(3)]
    return good + bad + malformed + unsigned + [good[0]]  # trailing dup


def _response(mp, tx):
    """(code, log) of one scalar admission; (class name, text) of the
    mempool's refusal (ErrTxInCache, MempoolError) in either package."""
    try:
        r = mp.check_tx(tx)
        return r.code, r.log
    except Exception as e:  # noqa: BLE001 — the refusal IS the response
        return type(e).__name__, str(e)


def _scalar(batch):
    """The scalar path, one tx at a time: the port's and the JAX
    package's responses (equal), and the port's mempool."""
    scalar = _mk()
    jscalar = jingest.ShardedMempool(JLocalClient(JKVStoreApplication()),
                                     lanes=4)
    out = [_response(scalar, tx) for tx in batch]
    assert [_response(jscalar, tx) for tx in batch] == out
    return out, scalar


def _accepts(responses):
    return [r[0] == 0 for r in responses]


async def _pipeline(batch, factory=None, mp=None):
    mp = mp or _mk()
    pipe = IngestPipeline(mp, batch_max=len(batch) + 1, batch_deadline_s=5.0,
                          queue_limit=256, verifier_factory=factory)
    futs = [asyncio.ensure_future(pipe.submit(tx)) for tx in batch]
    await asyncio.sleep(0)
    await pipe.flush_now()
    got = await asyncio.gather(*futs, return_exceptions=True)
    return got, mp, pipe


class TestDifferential:
    @pytest.mark.parametrize("route", ["auto", "cuda"])
    def test_batched_accept_reject_matches_scalar(self, route):
        batch = _mixed_batch()
        scalar_out, scalar = _scalar(batch)
        factory = (None if route == "auto" else
                   lambda: BatchVerifier(backend="cuda", plane="ingest"))
        got, mp, pipe = _run(_pipeline(batch, factory))
        assert [(r.code, r.log) for r in got][:-1] == scalar_out[:-1]
        # the trailing duplicate: the scalar path raises ErrTxInCache,
        # the pipeline answers it as a code-1 response of the same text
        assert (got[-1].code, got[-1].log) == (1, scalar_out[-1][1])
        assert _accepts([(r.code,) for r in got]) == _accepts(scalar_out)
        assert pipe_contents(mp) == pipe_contents(scalar)
        assert _run_stats_sigs(batch) > 0
        # one call for the flush's 9 signed rows (the duplicate too): under
        # the break-even threshold on auto, on the device when pinned
        assert pipe.stats["batches"] == 1 and pipe.stats["batched_sigs"] == 9
        key = "host_sigs" if route == "auto" else "device_sigs"
        assert tbatch.stats[key] == 9

    def test_device_fault_reaches_each_broadcast_and_resubmission_is_admitted(
            self):
        """The JAX file's breaker case (:349), with the port's rule."""
        batch = _mixed_batch()
        scalar_out, scalar = _scalar(batch)
        tfaults.configure("device.batch_verify*1", seed=7)
        errors_before = tbatch.stats["device_errors"]

        async def main():
            mp = _mk()
            tl = TxLifecycle(sample_rate=1.0)
            mp.txlife = tl
            for tx in batch[:-1]:
                tl.mark(hashlib.sha256(tx).digest(), "rpc_received")
            factory = lambda: BatchVerifier(backend="cuda",  # noqa: E731
                                            plane="ingest")
            got, _, pipe = await _pipeline(batch, factory, mp)
            assert all(isinstance(r, InjectedFault) for r in got)
            assert pipe.stats["device_errors"] == 1
            assert mp.size() == 0 and not mp.sig_verdicts
            assert pipe.queue_depth() == 0 and pipe._inflight == 0
            assert not any(mp.cache.has(hashlib.sha256(tx).digest())
                           for tx in batch)
            snap = tl.snapshot(20)
            assert snap["active"] == 0 and snap["evicted_total"] == 0
            assert {r["terminal"] for r in snap["records"]} == {"error"}
            # resubmitted: admitted exactly as the scalar path admits
            again, _, pipe2 = await _pipeline(batch, factory, mp)
            return again, mp, pipe2

        try:
            again, mp, pipe2 = _run(main())
        finally:
            tfaults.reset()
        assert [(r.code, r.log) for r in again][:-1] == scalar_out[:-1]
        assert pipe_contents(mp) == pipe_contents(scalar)
        assert tbatch.stats["device_errors"] == errors_before + 1
        assert pipe2.stats["device_errors"] == 0

    def test_kernel_unavailable_reaches_each_broadcast(self, monkeypatch):
        device.set_default_device(None)
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        batch = _mixed_batch()
        factory = lambda: BatchVerifier(backend="cuda",  # noqa: E731
                                        plane="ingest")
        got, mp, pipe = _run(_pipeline(batch, factory))
        assert all(isinstance(r, KernelUnavailable) for r in got)
        assert pipe.stats["device_errors"] == 1 and pipe.queue_depth() == 0
        assert mp.size() == 0 and not mp.sig_verdicts

    def test_verdict_cache_spares_resubmission(self):
        async def main():
            mp = _mk()
            m = MempoolMetrics(Registry())
            mp.metrics = m
            pipe = IngestPipeline(mp, batch_deadline_s=0.002, queue_limit=64)
            pipe.metrics = m
            tx = make_signed_tx(KEYS[2], b"cached", 1, 0)
            assert (await pipe.submit(tx)).is_ok()
            dup = await pipe.submit(tx)  # same tx again: cache verdict
            assert dup.code == 1 and "cache" in dup.log
            assert m.preverify_cache_hits_total.value("batch") == 1

        _run(main())

    def test_txlife_preverified_stage(self):
        assert "preverified" in STAGES
        assert STAGES.index("preverified") == STAGES.index("rpc_received") + 1

        async def main():
            mp = _mk()
            tl = TxLifecycle(sample_rate=1.0)
            mp.txlife = tl
            pipe = IngestPipeline(mp, batch_deadline_s=0.002, queue_limit=64)
            good = make_signed_tx(KEYS[1], b"ok", 1, 0)
            bad = _flip_sig(make_signed_tx(KEYS[1], b"no", 2, 0))
            for raw in (good, bad):
                tl.mark(hashlib.sha256(raw).digest(), "rpc_received")
            r_good = await pipe.submit(good)
            r_bad = await pipe.submit(bad)
            assert r_good.is_ok() and r_bad.code == 1
            recs = {r["key"]: r for r in tl.snapshot(10)["records"]}
            bad_rec = recs[hashlib.sha256(bad).digest().hex()]
            assert bad_rec["terminal"] == "rejected"
            assert [m[0] for m in bad_rec["marks"]] == \
                ["rpc_received", "preverified"]
            # the admitted tx's live record carries the full front chain
            active_stages = [m[0] for m in tl._active[
                hashlib.sha256(good).digest()]["marks"]]
            assert active_stages == ["rpc_received", "preverified",
                                     "checktx_done", "mempool_admitted"]

        _run(main())


def pipe_contents(mp) -> set:
    entries, _ = mp.entries_after(0)
    return {e.tx for e in entries}


def _run_stats_sigs(batch) -> int:
    # sanity: the mixed batch really contains signature work
    return sum(1 for tx in batch if parse_signed_tx(tx)[0] == SIGNED)


# --- mirrors of tests/test_mempool_v1_counter.py -----------------------------

class PrioApp(Application):
    """Assigns priority = first byte of the tx (the app-priority seam
    unsigned txs fall back to; signed txs carry their envelope fee)."""

    def check_tx(self, req):
        if req.tx == b"":
            return abci.ResponseCheckTx(code=1, log="empty")
        return abci.ResponseCheckTx(code=0, priority=req.tx[0], gas_wanted=1)


def _mk_prio(maxtxs=3, **kw):
    conns = AppConns(local_client_creator(PrioApp()))
    conns.start()
    return ShardedMempool(conns.mempool, max_txs=maxtxs, lanes=4, **kw)


def test_priority_ordering_and_reap():
    mp = _mk_prio(maxtxs=10)
    for tx in (b"\x05low", b"\x50mid", b"\xa0high"):
        assert mp.check_tx(tx).code == 0
    # merged reap across lanes: priority desc, arrival asc
    assert mp.reap_max_txs(10) == [b"\xa0high", b"\x50mid", b"\x05low"]
    # byte/gas caps respected (skip-what-doesn't-fit, v1 semantics)
    assert mp.reap_max_bytes_max_gas(7, -1) == [b"\xa0high"]
    assert len(mp.reap_max_bytes_max_gas(-1, 2)) == 2


def test_eviction_of_lower_priority_when_full():
    mp = _mk_prio(maxtxs=3)
    for tx in (b"\x10a", b"\x20b", b"\x30c"):
        assert mp.check_tx(tx).code == 0
    # lower-priority incoming is rejected outright (explicit full error)
    with pytest.raises(MempoolError, match="full"):
        mp.check_tx(b"\x01z")
    assert mp.size() == 3
    # higher-priority incoming evicts the lowest resident
    assert mp.check_tx(b"\x99hi").code == 0
    assert mp.size() == 3
    txs = mp.reap_max_txs(10)
    assert b"\x99hi" in txs and b"\x10a" not in txs
    # the evicted tx left the dedup cache too (not a cache-dup rejection):
    # resubmitting it fails on capacity again, not ErrTxInCache
    with pytest.raises(MempoolError, match="full"):
        mp.check_tx(b"\x10a")


def test_equal_priority_is_fifo():
    """Ties break by arrival order — with flat priorities the merged reap
    degenerates to the v0 FIFO, whatever lane each tx landed in."""
    mp = _mk_prio(maxtxs=10)
    txs = [b"\x20" + bytes([i]) * 3 for i in range(6)]
    for tx in txs:
        assert mp.check_tx(tx).code == 0
    assert mp.reap_max_txs(-1) == txs


def test_update_removes_committed_and_rechecks():
    mp = _mk_prio(maxtxs=10)
    mp.check_tx(b"\x10a")
    mp.check_tx(b"\x20b")
    mp.lock()
    try:
        mp.update(2, [b"\x10a"], [abci.ResponseCheckTx(code=0)])
    finally:
        mp.unlock()
    assert mp.reap_max_txs(10) == [b"\x20b"]
    # committed tx stays cached: re-adding is rejected
    with pytest.raises(ErrTxInCache):
        mp.check_tx(b"\x10a")
    assert mp.size() == 1


def test_ttl_expiry_purges_on_update():
    mp = _mk_prio(maxtxs=10, ttl_num_blocks=2)
    mp._height = 5
    assert mp.check_tx(b"\x10old").code == 0
    mp.lock()
    try:
        mp.update(8, [], [])  # height 8: admitted at 5, ttl 2 -> expired
    finally:
        mp.unlock()
    assert mp.size() == 0
    # and purged from the cache, so it may be resubmitted
    assert mp.check_tx(b"\x10old").code == 0


def test_counter_app_serial_semantics():
    app = CounterApplication(serial=True)
    conns = AppConns(local_client_creator(app))
    conns.start()
    c = conns.consensus
    # correct nonce order accepted
    for i in range(3):
        assert c.deliver_tx(abci.RequestDeliverTx(
            tx=i.to_bytes(8, "big"))).code == 0
    # replay and skip rejected
    assert c.deliver_tx(abci.RequestDeliverTx(
        tx=(1).to_bytes(8, "big"))).code == 2
    assert c.deliver_tx(abci.RequestDeliverTx(
        tx=(9).to_bytes(8, "big"))).code == 2
    # CheckTx rejects stale nonces
    assert conns.mempool.check_tx(abci.RequestCheckTx(
        tx=(0).to_bytes(8, "big"))).code == 2
    assert conns.mempool.check_tx(abci.RequestCheckTx(
        tx=(5).to_bytes(8, "big"))).code == 0
    assert c.commit().data == (3).to_bytes(8, "big")
