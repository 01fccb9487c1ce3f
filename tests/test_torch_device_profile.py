"""The port's device-profile tool (tendermint_tpu_torch/tools/device_profile.py),
its stub kernels' plain versions (crypto/ed25519_cuda/stub.py, P1-P3), P4 on
``probe_sum_u8``, and the entry-hook counterparts (tendermint_tpu_torch/
entry.py), on the CPU.

* the tool's own self-test pieces: schema samples and mutations,
  ``build_workload``, a micro cost-model, sweep and scale cell on CPU
  shards with the stubs; the CLI asks for the card unless ``--device cpu``,
  and ``--workload auto`` means the real kernels;
* the stubs' verdicts (with LCG rounds burned) equal the JAX tool's stubs on
  the same batch, dense and sparse; P4's sum equals the JAX tool's
  ``touch``;
* ``entry()``'s example batch equals ``__graft_entry__``'s, and
  ``dryrun_multichip`` raises without cards and passes on explicit CPU
  shards (its commit-scale case cut to 100 signatures; the card's run
  signs and verifies all 10,240).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from tendermint_tpu.crypto.ed25519_jax import verify as JV
from tendermint_tpu.libs.toolbox import load_tool
from tendermint_tpu_torch import device, entry
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto.ed25519_cuda import stub as TST
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.device import KernelUnavailable
from tendermint_tpu_torch.tools import device_profile as tprofile

jprofile = load_tool("device_profile")


@pytest.fixture(autouse=True)
def _port_state():
    device.set_default_device("cpu")
    tphases.reset()
    TV.reset_launches()
    TST.reset_launches()
    yield
    tphases.reset()
    device.set_default_device(None)


# -- schema and workload ------------------------------------------------------

@pytest.mark.parametrize("kind", tprofile.KINDS)
def test_schema_samples_and_mutations(kind):
    doc = tprofile.make_doc(kind, {"sample": True},
                            tprofile.SELF_TEST_SAMPLES[kind])
    assert tprofile.validate_profile(doc) == []
    assert tprofile.to_markdown(doc).startswith("### device_profile")
    assert doc["schema"] == jprofile.SCHEMA
    assert tprofile.REQUIRED_RESULTS == jprofile.REQUIRED_RESULTS
    for key in tprofile.REQUIRED_RESULTS[kind]:
        broken = json.loads(json.dumps(doc))
        del broken["results"][key]
        errs = tprofile.validate_profile(broken)
        assert errs and key in errs[0], errs
    assert tprofile.validate_profile({"schema": "nope"})
    assert tprofile.validate_profile([1, 2])


def test_bandwidth_must_be_finite():
    doc = tprofile.make_doc("cost-model", {}, json.loads(json.dumps(
        tprofile.SELF_TEST_SAMPLES["cost-model"])))
    doc["results"]["transfer"]["bandwidth_mbps"] = None
    assert tprofile.validate_profile(doc) == []
    doc["results"]["transfer"]["bandwidth_mbps"] = float("inf")
    assert any("bandwidth" in e for e in tprofile.validate_profile(doc))


def test_workload_equals_jax_tool():
    got = tprofile.build_workload(256, seed=3)
    want = jprofile.build_workload(256, seed=3)
    assert got == want
    pks, msgs, sigs = got
    assert len({len(m) for m in msgs}) == 1 and all(s[63] == 0 for s in sigs)
    assert TV.pack_sparse(pks, msgs, sigs, 128) is not None


def test_auto_means_the_real_kernels():
    assert tprofile.resolve_workload("auto") == "ed25519"
    assert tprofile.resolve_workload("synthetic") == "synthetic"


# -- the subcommands on the CPU -----------------------------------------------

def test_micro_cost_model_on_the_cpu(tmp_path):
    out = tmp_path / "cost.json"
    assert tprofile.main(["cost-model", "--device", "cpu", "--payload-mb",
                          "0.0625", "--runs", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert tprofile.validate_profile(doc) == []
    assert doc["results"]["kernel"] == "probe_sum_u8"
    assert doc["platform"]["backend"] == "cpu"
    assert TV.launches["probe_sum_u8"] == 0  # the plain version on the CPU


def test_micro_sweep_with_stubs():
    doc = tprofile.make_doc("sweep", {"sigs": 512}, tprofile.run_sweep(
        sigs=512, chunks=[128], seg_chunks=[2], workload="synthetic",
        runs=1, seg_min_sigs=0))
    assert tprofile.validate_profile(doc) == []
    row = doc["results"]["table"][0]
    assert row["sigs_per_sec"] > 0 and row["segments"] >= 2
    assert row["overlap_ratio"] is not None
    # the stubs were put back
    assert TV.verify_dense.__module__ == TV.__name__


def test_micro_scale_cell_on_cpu_shards():
    doc = tprofile.make_doc("scale", {"devices": [2]}, tprofile.run_scale(
        "cpu", [2], chunks=[128], sigs=256, workload="synthetic", runs=1,
        threads=None, device_work=16))
    assert tprofile.validate_profile(doc) == []
    modes = {r["mode"] for r in doc["results"]["table"]}
    assert modes == {"sharded", "threads", "multidev"}
    assert all(r["devices"] == 2 for r in doc["results"]["table"])


def test_cli_asks_for_the_card(monkeypatch):
    """No CUDA and no --device cpu: the tool raises instead of measuring
    the CPU; a scale count above the cards raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelUnavailable):
        tprofile.main(["cost-model", "--payload-mb", "0.0625", "--runs", "1"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        tprofile.scale_devices("cuda", 2)


# -- the stubs against the JAX tool's ------------------------------------------

@pytest.mark.parametrize("work", [0, 37])
def test_stub_dense_matches_jax_stub(work):
    """P1: the same verdict per item as the JAX stub kernel, LCG rounds
    burned or not, with padded rows and two block counts."""
    pks, msgs, sigs = tprofile.build_workload(200, seed=9)
    msgs[3] = msgs[3] + b"x" * 100
    blocks_w, nblk, s_words, ok = TV.prepare_batch(pks, msgs, sigs)
    restore = jprofile.install_stub_kernels(JV, device_work=work)
    try:
        want = np.asarray(JV._verify_kernel(*JV.pack_device_inputs(
            blocks_w, nblk, s_words, JV._pad_to(200)))).reshape(-1)[:200]
    finally:
        restore()
    args = TV._dense_args(blocks_w, nblk, s_words, torch.device("cpu"))
    verdict, burned, sums = TST.stub_verify_dense(*args, work)
    np.testing.assert_array_equal(verdict.numpy(), want)
    assert sums is None and burned.dtype == torch.int32
    assert ((burned.numpy() & 1) == 0).tolist() == want.tolist()
    assert TST.launches["stub_verify_dense"] == 0


@pytest.mark.parametrize("work", [0, 37])
def test_stub_sparse_matches_jax_stub(work):
    """P3: the same verdict per item as the JAX sparse stub."""
    pks, msgs, sigs = tprofile.build_workload(256, seed=10)
    restore = jprofile.install_stub_kernels(JV, device_work=work)
    try:
        jargs, _ = JV.prepare_sparse_stream(pks, msgs, sigs, 128)
        want = np.asarray(JV._verify_sparse_stream_kernel(*jargs)) \
            .reshape(-1)[:256]
    finally:
        restore()
    args, _ok = TV.prepare_sparse_stream(pks, msgs, sigs, 128,
                                         device=torch.device("cpu"))
    templates, cols, diff_vals, mlen, r, a, s = args
    verdict, burned = TST.stub_verify_sparse(diff_vals, mlen, r, a, s, work)
    np.testing.assert_array_equal(verdict.numpy(), want)
    assert TST.launches["stub_verify_sparse"] == 0


def test_stub_tally_matches_masked_sum():
    pks, msgs, sigs = tprofile.build_workload(300, seed=12)
    blocks_w, nblk, s_words, ok = TV.prepare_batch(pks, msgs, sigs)
    args = TV._dense_args(blocks_w, nblk, s_words, torch.device("cpu"))
    limbs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (300, 8), dtype=np.int32))
    verdict, _, sums = TST.stub_verify_dense(*args, 5, limbs=limbs)
    want = limbs.to(torch.int64)[verdict].sum(0)
    assert torch.equal(sums, want)


def test_lcg_closed_form_matches_the_loop():
    for rounds in (0, 1, 2, 3, 37, 1000, 20000):
        a, c = TST.lcg_coefficients(rounds)
        for x in (0, 1, 0xFFFFFFFF, 123456789):
            y = x
            for _ in range(rounds):
                y = (y * TST.LCG_MUL + TST.LCG_ADD) & TST.M32
            assert (a * x + c) & TST.M32 == y
    x = torch.tensor([0, 1, 0xFFFFFFFF, 123456789], dtype=torch.int64)
    a, c = TST.lcg_coefficients(20000)
    want = [(a * int(v) + c) & TST.M32 for v in x]
    assert TST._burn_plain(x, 20000).tolist() == want
    with pytest.raises(ValueError):
        TST.stub_verify_dense(torch.zeros(1, 1, 32, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, 8, dtype=torch.int32), -1)


@pytest.mark.parametrize("nbytes", [4 << 10, 4 << 20])
def test_p4_probe_sum_equals_jax_touch(nbytes):
    """P4 (the JAX tool's touch) maps onto K11: the int32 sum of a uint8
    payload, 4 KB to 4 MB."""
    x = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                               dtype=np.uint8)
    want = int(jax.jit(lambda a: jnp.sum(a, dtype=jnp.int32))(x))
    assert int(TV.probe_sum(torch.from_numpy(x)).item()) == want


# -- the entry hooks ----------------------------------------------------------

def test_entry_matches_graft_entry():
    assert entry._example_sigs(8) == graft._example_sigs(8)
    fn, args = entry.entry()
    assert fn is TV.verify_dense
    assert args[0].shape[0] == 64 and bool(fn(*args).all())


def test_dryrun_multichip_raises_without_cards(monkeypatch):
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelUnavailable):
        entry.dryrun_multichip(2)
    device.set_default_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("shards", [1, 2])
def test_dryrun_multichip_on_cpu_shards(monkeypatch, shards, capsys):
    """32 signatures, then the commit-scale case cut to 100 signatures (two
    invalid, powers 2^40; the 10,240 of the card's run take minutes to
    sign and verify on this CPU)."""
    monkeypatch.setattr(entry, "COMMIT_SCALE_SIGS", 100)
    entry.dryrun_multichip(shards, mesh=[torch.device("cpu")] * shards)
    out = capsys.readouterr().out
    assert f"32 sigs verified over {shards}-device mesh, tally = 528" in out
    assert (f"100 sigs (2 invalid) over {shards}-device mesh, exact tally = "
            f"{98 << 40}") in out
    with pytest.raises(ValueError, match="mesh of 1 devices"):
        entry.dryrun_multichip(2, mesh=[torch.device("cpu")])
