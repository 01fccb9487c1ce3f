"""Device faults in the port: one exported counter, and never a verdict.

* every counting site moves ``crypto_device_errors_total{reason, plane}``
  of the registry set by ``crypto.batch.set_crypto_metrics`` by exactly
  one, with the fault's kind and the caller's plane: ``BatchVerifier``
  (crypto/batch.py), the vote batcher's flush, the ingest pipeline's
  flush, the light-serving coalescer's flush, the BLS aggregate route
  (crypto/bls12381/vec.py) and the Merkle device tier
  (crypto/merkle.py ``_batch_sha256``); the old ``device_fallbacks_total``
  series is gone;
* ``device.is_device_fault`` tells a fault of the card from a fault in
  the data;
* the places that turn exceptions into verdicts re-raise a device fault:
  ``verify_commit_light_batched`` and its trusting variant on an
  aggregated commit, and ``light.verifier.verify`` (adjacent and not).
  The JAX package verifies the same inputs on its host after the fault
  and returns ``None``: the departure is stated by each test. Malformed
  data still gives the JAX package's exact error.
"""

import asyncio

import pytest
import torch

from tendermint_tpu.crypto import bls12381 as jbls
from tendermint_tpu.crypto.breaker import device_breaker as jbreaker
from tendermint_tpu.libs.faults import faults as jfaults
from tendermint_tpu.light import verifier as jver
from tendermint_tpu.types import validator_set as jvs_mod
from tendermint_tpu_torch import convert, device
from tendermint_tpu_torch import types as ttypes
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto import merkle_fast as tmerkle_fast
from tendermint_tpu_torch.crypto import schemes as tschemes
from tendermint_tpu_torch.crypto import vote_batcher as vb
from tendermint_tpu_torch.crypto.batch import BatchVerifier
from tendermint_tpu_torch.crypto.bls12381 import vec as tvec
from tendermint_tpu_torch.crypto.ed25519_cuda.multidevice import \
    AllLanesFailed
from tendermint_tpu_torch.device import KernelUnavailable, is_device_fault
from tendermint_tpu_torch.libs.faults import InjectedFault
from tendermint_tpu_torch.libs.faults import faults as tfaults
from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
from tendermint_tpu_torch.light import serve as tserve
from tendermint_tpu_torch.light import verifier as tver
from tendermint_tpu_torch.types import validator_set as tvs_mod

from tests.test_torch_bls import BID, HEIGHT, Rig
from tests.test_torch_ingest import _mixed_batch, _pipeline
from tests.test_torch_light import (_KNOBS, DRIFT, NOW, PERIOD, _variant,
                                    outcome, reset_port, routed)
from tests.test_torch_light_serve import _ROWS, _coalesce, _reqs
from tests.test_torch_vote_batcher import _mk_votes, _port, _preverify_all


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    device.set_default_device("cpu")
    for knob in _KNOBS + ("TMTPU_BLS_BACKEND", "TMTPU_MERKLE_DEVICE_MIN"):
        monkeypatch.delenv(knob, raising=False)
    reset_port()
    jfaults.reset()
    jbreaker.reset()
    yield
    reset_port()
    jfaults.reset()
    jbreaker.reset()
    tbatch.set_crypto_metrics(None)
    tschemes.reset()
    jbls.reset()
    device.set_default_device(None)


@pytest.fixture
def metrics():
    m = CryptoMetrics(Registry())
    tbatch.set_crypto_metrics(m)
    return m


def series(m):
    """{(reason, plane): count} of every moved device_errors_total series."""
    return {k: v for k, v in m.device_errors_total._values.items() if v}


def no_cuda(monkeypatch):
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# -- the counter -------------------------------------------------------------

def test_dead_fallback_series_is_gone(metrics):
    assert not hasattr(metrics, "device_fallbacks_total")
    text = metrics.device_errors_total.render()
    assert "device_fallbacks" not in "".join(text)
    assert metrics.device_errors_total.label_names == ("reason", "plane")


def test_batch_verifier_counts_an_armed_fault_on_its_plane(metrics):
    rows = _port(_mk_votes(20, seed=3))
    bv = BatchVerifier(backend="cuda", plane="evidence")
    for p, m, s in rows:
        bv.add(p, m, s)
    tfaults.configure("device.batch_verify*1")
    with pytest.raises(InjectedFault):
        bv.verify()
    assert series(metrics) == {("injected", "evidence"): 1}
    assert tbatch.stats["device_errors"] == 1


def test_batch_verifier_counts_kernel_unavailable(metrics, monkeypatch):
    no_cuda(monkeypatch)
    bv = BatchVerifier(backend="cuda", plane="votes")
    for p, m, s in _port(_mk_votes(4, seed=4)):
        bv.add(p, m, s)
    with pytest.raises(KernelUnavailable):
        bv.verify()
    assert series(metrics) == {("unavailable", "votes"): 1}
    # the stats count running kernels' faults only, as before
    assert tbatch.stats["device_errors"] == 0


def test_vote_flush_counts_once_on_votes(metrics):
    tfaults.configure("device.vote_flush*1")

    async def run():
        bv = vb.BatchVoteVerifier(min_device_batch=4, deadline_s=0.005)
        got = await _preverify_all(bv, _port(_mk_votes(8, seed=13)))
        assert all(isinstance(r, InjectedFault) for r in got)
        return bv

    bv = asyncio.run(run())
    assert bv.stats["device_errors"] == 1
    assert series(metrics) == {("injected", "votes"): 1}


def test_ingest_flush_counts_once_on_ingest(metrics):
    """The flush's BatchVerifier counts the fault; the pipeline's own
    ``_fail_flush`` sees it marked and does not count it again."""
    tfaults.configure("device.batch_verify*1", seed=7)

    async def run():
        got, _, pipe = await _pipeline(
            _mixed_batch(), lambda: BatchVerifier(backend="cuda",
                                                  plane="ingest"))
        assert all(isinstance(r, InjectedFault) for r in got)
        return pipe

    pipe = asyncio.run(run())
    assert pipe.stats["device_errors"] == 1
    assert series(metrics) == {("injected", "ingest"): 1}


def test_coalescer_flush_counts_once_on_light(metrics):
    tfaults.configure("device.batch_verify@1", seed=7)
    res, co = _coalesce(tserve, _reqs(tserve, 1, _ROWS[:3]), "cuda")
    assert all(isinstance(r, InjectedFault) for r in res)
    assert co.stats["device_errors"] == 1
    assert series(metrics) == {("injected", "light"): 1}


def _bls_signed():
    keys = [jbls_key(i) for i in range(3)]
    msg = b"device-faults"
    return ([k.pub_key().bytes() for k in keys], msg,
            jbls.aggregate([k.sign(msg) for k in keys]))


def jbls_key(i):
    from tendermint_tpu.crypto import Bls12381PrivKey

    return Bls12381PrivKey.generate(b"dfault" + bytes([i]) * 4)


def test_bls_route_counts_on_aggsig(metrics, monkeypatch):
    pks, msg, agg = _bls_signed()
    tfaults.configure("crypto.bls_verify*1")
    with pytest.raises(InjectedFault):
        tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert tvec.fast_aggregate_verify_routed(pks, msg, agg)
    no_cuda(monkeypatch)
    with pytest.raises(KernelUnavailable):
        tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert series(metrics) == {("injected", "aggsig"): 1,
                               ("unavailable", "aggsig"): 1}
    assert tvec.stats["device_errors"] == 1


@pytest.mark.parametrize("fault", ["unavailable", "runtime_error"])
def test_merkle_device_tier_counts_on_merkle(metrics, monkeypatch, fault):
    monkeypatch.setenv("TMTPU_MERKLE_DEVICE_MIN", "4")
    items = [b"leaf-%04d" % i for i in range(8)]
    if fault == "unavailable":
        no_cuda(monkeypatch)
        exc = KernelUnavailable
    else:
        def broken(x):
            raise RuntimeError("CUDA error: an illegal memory access")
        monkeypatch.setattr(tmerkle_fast.kernel, "sha256_many", broken)
        exc = RuntimeError
    with pytest.raises(exc):
        tmerkle.fast_hash_from_byte_slices(items)
    assert series(metrics) == {(fault, "merkle"): 1}


# -- telling the card's faults from the data's --------------------------------

def test_is_device_fault():
    marked = ValueError("a kernel's fault, counted")
    from tendermint_tpu_torch.device import mark_device_fault

    assert mark_device_fault(marked) and not mark_device_fault(marked)
    yes = [KernelUnavailable("x"), AllLanesFailed("x"),
           vb.DeviceFlushTimeout("x"), InjectedFault("device.batch_verify"),
           InjectedFault("device.lane.cuda:0/2"),
           InjectedFault("crypto.bls_verify"), marked]
    no = [InjectedFault("db.write_batch"), InjectedFault("wal.fsync"),
          ValueError("bad commit"), RuntimeError("CUDA error")]
    assert [is_device_fault(e) for e in yes] == [True] * len(yes)
    assert [is_device_fault(e) for e in no] == [False] * len(no)


# -- the verdict-catching sites re-raise the fault ----------------------------

@pytest.fixture
def bls_rig():
    return Rig("fault-bls", n=4, tag=b"dflt")


def _bls_entries(rig, jcommit):
    tcommit = convert.commit_from_reference(jcommit.encode())
    tbid = ttypes.BlockID(BID.hash, ttypes.PartSetHeader(
        1, BID.part_set_header.hash))
    return ([(rig.jvs, rig.chain_id, BID, HEIGHT, jcommit)],
            [(rig.tvs, rig.chain_id, tbid, HEIGHT, tcommit)],
            [(rig.jvs, rig.chain_id, jcommit, (1, 3))],
            [(rig.tvs, rig.chain_id, tcommit, (1, 3))])


def _names(results):
    return [None if r is None else (type(r).__name__, str(r))
            for r in results]


def test_aggregated_entry_fault_is_no_entry_error(bls_rig, metrics):
    """A 4-key aggregated commit with ``crypto.bls_verify`` armed: the port
    raises the fault from both batched calls; disarmed, both pass. The JAX
    package verifies BLS on its host and returns [None] either way."""
    jl, tl, jt, tt = _bls_entries(bls_rig, bls_rig.make_commit(set(range(4))))
    assert _names(tvs_mod.verify_commit_light_batched(tl)) == [None]
    assert _names(tvs_mod.verify_commit_light_trusting_batched(tt)) == [None]
    for call, entries in ((tvs_mod.verify_commit_light_batched, tl),
                          (tvs_mod.verify_commit_light_trusting_batched, tt)):
        tfaults.configure("crypto.bls_verify*1")
        with pytest.raises(InjectedFault, match="crypto.bls_verify"):
            call(entries)
    assert series(metrics) == {("injected", "aggsig"): 2}
    jfaults.configure("crypto.bls_verify*2")
    assert _names(jvs_mod.verify_commit_light_batched(jl)) == [None]
    assert _names(jvs_mod.verify_commit_light_trusting_batched(jt)) == [None]


def test_aggregated_entry_bad_data_keeps_the_jax_error(bls_rig):
    """A commit that is wrong in itself (3 of 4 sign, the aggregate of only
    two): stored as the entry's outcome, equal to the JAX package's."""
    c = bls_rig.aggregated({0, 1, 2}, sigs=[
        bls_rig.vote(pv, BID).signature for pv in bls_rig.pvs[:2]])
    jl, tl, jt, tt = _bls_entries(bls_rig, c)
    want = _names(jvs_mod.verify_commit_light_batched(jl))
    assert want[0] is not None
    assert _names(tvs_mod.verify_commit_light_batched(tl)) == want
    assert _names(tvs_mod.verify_commit_light_trusting_batched(tt)) == \
        _names(jvs_mod.verify_commit_light_trusting_batched(jt))


@pytest.mark.parametrize("th,h,spec", [(1, 2, "*1"), (1, 6, "+1*1")])
def test_light_verify_raises_the_fault_not_a_bad_header(th, h, spec,
                                                        metrics):
    """4-validator chain, the cuda route forced: with ``device.batch_verify``
    armed at the light check (adjacent; after the trusting check when not
    adjacent), ``verify`` raises the fault itself, not ErrInvalidHeader.
    The JAX package re-verifies on its host and accepts."""
    jb, tb = _variant("stable")

    def call(ver, b):
        return lambda: ver.verify(
            b[th].signed_header, b[th].validator_set, b[h].signed_header,
            b[h].validator_set, PERIOD, NOW, DRIFT)

    with routed("cuda"):
        assert outcome(call(tver, tb)) is None
        tfaults.configure("device.batch_verify" + spec)
        with pytest.raises(InjectedFault):
            call(tver, tb)()
    assert series(metrics) == {("injected", "light"): 1}
    # the JAX package's device route falls back to its host after the
    # fault (both of its calls fire: its kernel is never compiled here)
    jfaults.configure("device.batch_verify*2")
    with routed("jax"):
        assert outcome(call(jver, jb)) is None


def test_light_verify_bad_signature_keeps_the_jax_error():
    jb, tb = _variant("bad_sig")

    def call(ver, b):
        return lambda: ver.verify(
            b[5].signed_header, b[5].validator_set, b[6].signed_header,
            b[6].validator_set, PERIOD, NOW, DRIFT)

    with routed("host"):
        want = outcome(call(jver, jb))
    assert want[0] == "ErrInvalidHeader"
    with routed("cuda"):
        assert outcome(call(tver, tb)) == want
