"""The port's multi-device stream (crypto/ed25519_cuda/multidevice.py) on
CPU lanes, against the JAX package's (tests/test_multidevice_stream.py).

* ``plan_segments`` and ``_seg_chunks_from_cost_model`` equal the JAX
  functions;
* the pool: disabled by ``TMTPU_VERIFY_DEVICES`` <= 1, a bad value raises,
  CPU lanes only when the knob names them; lane labels ``cpu:0/<k>``;
* verdicts equal the single-device path's through windowed submission and
  the columnar sign-bytes, with the stub kernels (P1/P3) and with the real
  kernels' plain versions through ``verify_commit``;
* a sick lane (its breaker open, or its ``device.lane.cpu:0/1`` site armed)
  re-shards onto a healthy lane and drops nothing; every lane failing
  raises ``AllLanesFailed`` through ``BatchVerifier`` and ``verify_commit``
  with nothing verified on the host;
* parity with the JAX ``MultiDeviceStream`` (2 CPU devices) on the dense
  and the sparse wire formats, stub kernels on both sides: P1 and P3
  against the JAX stubs.
"""

import functools

import numpy as np
import pytest

import jax

from tendermint_tpu.crypto.ed25519_jax import multidevice as JMD
from tendermint_tpu.crypto.ed25519_jax import verify as JV
from tendermint_tpu.libs.toolbox import load_tool
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import Ed25519PubKey
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_cuda as tcuda
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto.breaker import (OPEN, device_breaker,
                                                 lane_breaker,
                                                 reset_lane_breakers)
from tendermint_tpu_torch.crypto.ed25519_cuda import multidevice as MD
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.tools import commits
from tendermint_tpu_torch.tools import device_profile as tprofile

jprofile = load_tool("device_profile")

CHUNK = 128


def _reset():
    tfaults.reset()
    device_breaker.reset()
    reset_lane_breakers()
    tphases.reset()
    MD.reset_pool()
    TV.reset_launches()
    for k in tbatch.stats:
        tbatch.stats[k] = 0


#: the knobs that route and gate this file's paths. Other tests in the
#: same process may leave them set: tools/crashmatrix.py ``run_matrix``,
#: run in process by tests/test_crashmatrix.py, sets TMTPU_BATCH_BACKEND to
#: "host" for good, and verify_commit then never reaches the pool.
_KNOBS = (MD.ENV_DEVICES, MD.ENV_MIN_SIGS, MD.ENV_PROFILE, "TMTPU_SEG_CHUNKS",
          "TMTPU_BATCH_BACKEND", "TMTPU_DEVICE_THRESHOLD",
          "TMTPU_DEVICE_BREAKER_THRESHOLD", "TMTPU_DEVICE_BREAKER_COOLDOWN_S")


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    _reset()
    yield
    _reset()
    device.set_default_device(None)


@pytest.fixture
def stubs():
    restore = tprofile.install_stub_kernels(TV)
    yield
    restore()


def _lanes(k):
    return MD.MultiDeviceStream(devices=[device.default_device()] * k,
                                min_sigs=0)


def _workload(n, seed=7, invalid_every=11):
    """Dissimilar equal-length messages (the dense wire format) with
    host-invalid rows mixed in: bad lengths and s >= L."""
    rng = np.random.default_rng(seed)
    pks = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(120) for _ in range(n)]
    sigs = [rng.bytes(63) + b"\x00" for _ in range(n)]
    for i in range(0, n, invalid_every):
        sigs[i] = sigs[i][:32] + b"\xff" * 32
    pks[3] = pks[3][:31]
    sigs[5] = sigs[5][:63]
    return pks, msgs, sigs


def _single(pks, msgs, sigs, columns=None):
    return TV._verify_segmented(pks, msgs, sigs, CHUNK, columns=columns)


# -- planning -----------------------------------------------------------------

def test_plan_segments_equals_jax():
    for k in (0, 1, 2, 3, 8, 16, 17, 64, 100, 257):
        for lanes in (1, 2, 3, 4, 7, 8):
            for sc in (1, 2, 5, 10, 64):
                plan = MD.plan_segments(k, lanes, sc)
                assert plan == JMD.plan_segments(k, lanes, sc), (k, lanes, sc)
                assert sum(s for s, _ in plan) == k


def test_seg_chunks_from_cost_model_equals_jax():
    docs = [{"results": {"fixed_dispatch_ms": {"min": ms},
                         "transfer": {"bandwidth_mbps": bw}}}
            for ms in (0.01, 0.05, 1.0, 80.0, 500.0)
            for bw in (None, 0, 10.0, 1000.0, 25000.0)]
    docs += [{}, {"results": {}}, {"results": {"fixed_dispatch_ms": "x"}}]
    for doc in docs:
        for chunk in (128, 2048):
            assert (MD._seg_chunks_from_cost_model(doc, chunk)
                    == JMD._seg_chunks_from_cost_model(doc, chunk)), doc
    doc = docs[12]  # 1 ms fixed, 10 MB/s
    assert 2 <= MD._seg_chunks_from_cost_model(doc) <= 64


def test_default_seg_chunks_reads_the_profile(monkeypatch, tmp_path):
    path = tmp_path / "profile.json"
    doc = tprofile.make_doc("cost-model", {}, dict(
        tprofile.SELF_TEST_SAMPLES["cost-model"],
        fixed_dispatch_ms={"min": 80.0, "med": 80.0}))
    path.write_text(__import__("json").dumps(doc))
    monkeypatch.setenv(MD.ENV_PROFILE, str(path))
    assert MD.default_seg_chunks() == MD._seg_chunks_from_cost_model(doc)
    monkeypatch.setenv("TMTPU_SEG_CHUNKS", "3")
    assert MD.default_seg_chunks() == TV.SEG_CHUNKS


# -- the pool -----------------------------------------------------------------

def test_pool_env(monkeypatch):
    assert MD.pool() is None  # one CPU device and no knob
    MD.reset_pool()
    monkeypatch.setenv(MD.ENV_DEVICES, "1")
    assert MD.pool() is None
    MD.reset_pool()
    monkeypatch.setenv(MD.ENV_DEVICES, "4")
    p = MD.pool()
    assert p is not None and MD.pool() is p
    assert [l.label for l in p.lanes] == [f"cpu:0/{i}" for i in range(4)]
    MD.reset_pool()
    monkeypatch.setenv(MD.ENV_DEVICES, "two")
    with pytest.raises(ValueError):
        MD.pool()
    with MD.disabled():
        assert MD.pool() is None


def test_lane_labels():
    import torch

    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert MD.lane_labels([c0, c1]) == ["cuda:0", "cuda:1"]
    assert MD.lane_labels([c0, c0]) == ["cuda:0/0", "cuda:0/1"]
    assert MD.lane_labels([c0, c1, c0]) == ["cuda:0/0", "cuda:1", "cuda:0/1"]
    md = _lanes(2)
    assert [l.label for l in md.lanes] == ["cpu:0/0", "cpu:0/1"]
    assert md.lanes[1].breaker is lane_breaker("cpu:0/1")
    md.shutdown()


# -- verdict parity -----------------------------------------------------------

def test_parity_through_windowed_submission(stubs):
    """More segments than the 2-per-lane window (seg_chunks 1, 2 lanes, 10
    chunks): the refill path reassembles in order, the phase records carry
    the lane labels."""
    pks, msgs, sigs = _workload(1280, seed=29)
    want = _single(pks, msgs, sigs)
    assert 0 < want.sum() < len(pks)
    tphases.reset()
    md = MD.MultiDeviceStream(devices=[device.default_device()] * 2,
                              min_sigs=0, seg_chunks=1)
    got = md.verify(pks, msgs, sigs, chunk=CHUNK)
    np.testing.assert_array_equal(got, want)
    recs = tphases.recent_segments()
    assert {r["device"] for r in recs} == {"cpu:0/0", "cpu:0/1"}
    assert sum(r["sigs"] for r in recs) == 1280 and len(recs) == 10
    md.shutdown()


def test_columns_ride_the_pool(stubs):
    from tendermint_tpu_torch.types import BlockID, PartSetHeader
    from tendermint_tpu_torch.types import SignedMsgType
    from tendermint_tpu_torch.types.canonical import (
        vote_sign_bytes_batch, vote_sign_bytes_columns_batch)

    n = 512
    bid = BlockID(b"\xaa" * 32, PartSetHeader(1, b"\xbb" * 32))
    ts = [1_700_000_000_500_000_000 + 1000 * i for i in range(n)]
    cols = vote_sign_bytes_columns_batch(
        "chain-md", SignedMsgType.PRECOMMIT, 7, 0, [bid] * n, ts)
    msgs = vote_sign_bytes_batch(
        "chain-md", SignedMsgType.PRECOMMIT, 7, 0, [bid] * n, ts)
    rng = np.random.default_rng(5)
    pks = [rng.bytes(32) for _ in range(n)]
    sigs = [rng.bytes(63) + b"\x00" for _ in range(n)]
    want = _single(pks, msgs, sigs, columns=cols)
    md = _lanes(3)
    got = md.verify(pks, msgs, sigs, chunk=CHUNK, columns=cols)
    np.testing.assert_array_equal(got, want)
    md.shutdown()


class _LocalSigner:
    """commits.Signer's interface, in this process."""

    workers = 1

    def pubkeys(self, seeds):
        return [ed.keygen(s)[1] for s in seeds]

    def sign(self, jobs):
        return [ed.sign(ed.keygen(s)[0], m) for s, m in jobs]


@pytest.fixture(scope="module")
def commit_fixture():
    return commits.CommitFixture(_LocalSigner(), np.random.default_rng(17),
                                 300, "torch-md-chain", 9)


@pytest.fixture
def pooled(monkeypatch):
    """verify_commit's batches go through a 2-lane CPU pool: whole chunks
    of 128 and the pool engaged from 256 signatures."""
    monkeypatch.setenv(MD.ENV_DEVICES, "2")
    monkeypatch.setenv(MD.ENV_MIN_SIGS, "256")
    monkeypatch.setenv("TMTPU_DEVICE_THRESHOLD", "1")
    monkeypatch.setattr(TV, "SEG_MIN_SIGS", 256)
    monkeypatch.setattr(tcuda, "batch_verify_stream", functools.partial(
        TV.batch_verify_stream, chunk=CHUNK))


def test_verify_commit_through_the_pool(pooled, commit_fixture):
    """The real kernels' plain versions on two CPU lanes: a 300-validator
    commit verifies, its segments carry the lane labels, and a corrupt
    signature is rejected at its index."""
    from tendermint_tpu_torch.types.errors import ErrWrongSignature

    commit_fixture.verify()
    recs = tphases.recent_segments()
    assert {r["device"] for r in recs} == {"cpu:0/0", "cpu:0/1"}
    assert sum(r["sigs"] for r in recs) == 300
    assert tbatch.stats["device_sigs"] == 300
    sigs = list(commit_fixture.sigs)
    sigs[201] = bytes([sigs[201][0] ^ 1]) + sigs[201][1:]
    bad = commit_fixture.with_signatures(sigs)
    with pytest.raises(ErrWrongSignature) as e:
        commit_fixture.verify(bad)
    assert str(e.value) == str(ErrWrongSignature(201, sigs[201]))
    assert tbatch.stats["host_sigs"] == 0
    assert MD.pool().stats["calls"] == 2


# -- degradation --------------------------------------------------------------

@pytest.mark.parametrize("how", ["fault-site", "breaker-open"])
def test_one_sick_lane_reshards_and_drops_nothing(monkeypatch, stubs, how):
    monkeypatch.setenv("TMTPU_DEVICE_BREAKER_THRESHOLD", "2")
    reset_lane_breakers()
    pks, msgs, sigs = _workload(1280, seed=13)
    want = _single(pks, msgs, sigs)
    site = MD.LANE_SITE_PREFIX + "cpu:0/1"
    md = _lanes(4)
    if how == "fault-site":
        tfaults.configure(site)  # every dispatch on lane 1 fails
    else:
        while lane_breaker("cpu:0/1").state != OPEN:
            lane_breaker("cpu:0/1").record_failure()
    tphases.reset()
    got = md.verify(pks, msgs, sigs, chunk=CHUNK)
    np.testing.assert_array_equal(got, want)  # no signature dropped
    assert lane_breaker("cpu:0/1").state == OPEN
    used = {r["device"] for r in tphases.recent_segments()}
    assert "cpu:0/1" not in used and len(used) == 3
    if how == "fault-site":
        assert md.stats["resharded_segments"] >= 1
        assert tfaults.fires(site) >= 2
    else:
        assert md.stats["resharded_segments"] == 0
        assert tfaults.fires(site) == 0
    # the open breaker keeps the lane out of the next call up front
    fired = tfaults.fires(site)
    np.testing.assert_array_equal(md.verify(pks, msgs, sigs, chunk=CHUNK),
                                  want)
    assert tfaults.fires(site) == fired
    md.shutdown()


def test_all_lanes_failing_reaches_the_caller(monkeypatch, stubs, pooled,
                                              commit_fixture):
    """Every lane's site armed: AllLanesFailed from the stream, through
    BatchVerifier and through verify_commit; nothing verified on the
    host."""
    monkeypatch.setenv("TMTPU_DEVICE_BREAKER_THRESHOLD", "1")
    reset_lane_breakers()
    tfaults.configure(",".join(MD.LANE_SITE_PREFIX + f"cpu:0/{i}"
                               for i in range(2)))
    md = _lanes(2)
    pks, msgs, sigs = _workload(512, seed=17)
    with pytest.raises(MD.AllLanesFailed):
        md.verify(pks, msgs, sigs, chunk=CHUNK)
    md.shutdown()

    reset_lane_breakers()
    bv = tbatch.BatchVerifier(backend="cuda")
    for p, m, s in zip(pks, msgs, sigs):
        bv.add(Ed25519PubKey(p if len(p) == 32 else bytes(32)), m, s)
    with pytest.raises(MD.AllLanesFailed):
        bv.verify()
    assert tbatch.stats["device_errors"] == 1
    assert tbatch.stats["host_sigs"] == 0
    assert device_breaker.state == "closed" and not device_breaker.stats

    reset_lane_breakers()
    with pytest.raises(MD.AllLanesFailed):
        commit_fixture.verify()
    assert tbatch.stats["device_errors"] == 2
    assert tbatch.stats["host_sigs"] == 0 and tbatch.stats["device_sigs"] == 0


# -- parity with the JAX package ----------------------------------------------

@pytest.fixture
def stubs_both_sides():
    restore_j = jprofile.install_stub_kernels(JV)
    restore_t = tprofile.install_stub_kernels(TV)
    yield
    restore_t()
    restore_j()


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_stream_matches_jax_multidevice(stubs_both_sides, fmt):
    """The same batch through the JAX MultiDeviceStream (2 CPU devices)
    and the port's (2 CPU lanes): the same plan, the same packed bytes, the
    same stub verdicts (P1 on the dense format, P3 on the sparse one)."""
    if fmt == "dense":
        pks, msgs, sigs = _workload(1024, seed=31)
    else:
        pks, msgs, sigs = tprofile.build_workload(1024, seed=32)
        sigs[4] = sigs[4][:32] + b"\xff" * 32
        pks[6] = pks[6][:31]
    jmd = JMD.MultiDeviceStream(devices=jax.devices()[:2], min_sigs=0,
                                seg_chunks=2)
    try:
        want = jmd.verify(pks, msgs, sigs, chunk=CHUNK)
    finally:
        jmd.shutdown()
    md = MD.MultiDeviceStream(devices=[device.default_device()] * 2,
                              min_sigs=0, seg_chunks=2)
    got = md.verify(pks, msgs, sigs, chunk=CHUNK)
    md.shutdown()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(pks)
    # the format each side took
    sparse = TV.pack_sparse(pks[:CHUNK], msgs[:CHUNK], sigs[:CHUNK], CHUNK)
    assert (sparse is not None) == (fmt == "sparse")
