"""The port's sharded verify-and-tally (crypto/ed25519_cuda/sharded.py, K8's
plain version on CPU shards) against the host spec and the JAX package.

* ``verify_tally_plain`` and ``batch_verify_sharded`` over 1, 2 and 4 CPU
  shards: verdicts equal the host spec (``tendermint_tpu/crypto/ed25519.py``)
  and totals equal the JAX package's ``_power_limbs`` planes recombined in
  Python ints, for host-invalid rows (no power), totals above 2^63 and
  2^64, and a negative power (its uint64 pattern), as exact integers.
* The sharding and the tally against the JAX package's own
  ``batch_verify_sharded`` on a 2-device mesh of the conftest's CPU
  devices, with the device-profile stub kernels on both sides (P1 and the
  tally path, without compiling the JAX verify kernel): verdicts equal,
  totals equal as Python ints.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import ed25519 as host
from tendermint_tpu.crypto.ed25519_jax import sharded as JS
from tendermint_tpu.crypto.ed25519_jax import verify as JV
from tendermint_tpu.libs.toolbox import load_tool
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import phases as tphases
from tendermint_tpu_torch.crypto.ed25519_cuda import curve as TC
from tendermint_tpu_torch.crypto.ed25519_cuda import sharded as TS
from tendermint_tpu_torch.crypto.ed25519_cuda import stub as TST
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.tools import device_profile as tprofile

jprofile = load_tool("device_profile")

L = host.L


@pytest.fixture(autouse=True)
def _port_state():
    device.set_default_device("cpu")
    TV.reset_launches()
    TST.reset_launches()
    tphases.reset()
    yield
    tphases.reset()
    device.set_default_device(None)


def _signed(n, seed):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for _ in range(n):
        sd = rng.bytes(32)
        pk = host.pubkey_from_seed(sd)
        msg = rng.bytes(24)
        pks.append(pk)
        msgs.append(msg)
        sigs.append(host.sign(sd + pk, msg))
    return pks, msgs, sigs


def _mixed(n=37, seed=3):
    """An uneven batch with one corrupt signature and host-invalid rows: a
    bad signature length, a bad key length, and s >= L."""
    pks, msgs, sigs = _signed(n, seed)
    sigs[5] = bytes([sigs[5][0] ^ 1]) + sigs[5][1:]
    sigs[9] = sigs[9][:63]
    pks[14] = pks[14][:31]
    s = int.from_bytes(sigs[20][32:], "little") + L
    sigs[20] = sigs[20][:32] + s.to_bytes(32, "little")
    return pks, msgs, sigs


def _spec(pks, msgs, sigs):
    return np.array([host.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)],
                    dtype=bool)


def _jax_total(powers, accepted):
    """The JAX package's limb planes of ``powers`` over the accepted rows,
    summed per limb and recombined in Python ints."""
    pw = np.asarray(powers, dtype=np.int64) * accepted
    n = len(pw)
    pad = -(-n // JV.LANE) * JV.LANE
    planes = JS._power_limbs(pw, pad, pad // JV.LANE).reshape(8, -1)
    return sum(int(planes[j].astype(np.int64).sum()) << (8 * j)
               for j in range(8))


def test_power_limbs_match_jax():
    powers = np.array([0, 1, 255, 256, -1, -5, (1 << 63) - 1, -(1 << 63),
                       1 << 40, 123456789012345], dtype=np.int64)
    got = TS._power_limbs(powers)
    want = JS._power_limbs(powers, JV.LANE, 1).reshape(8, -1)[:, :10].T
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (10, 8)


def test_verify_tally_plain_matches_spec_and_jax_limbs():
    pks, msgs, sigs = _mixed()
    blocks_w, nblk, s_words, ok = TV.prepare_batch(pks, msgs, sigs)
    powers = np.arange(1, 38, dtype=np.int64) * 1_000_003
    limbs = TS._power_limbs(powers * ok)
    args = TV._dense_args(blocks_w, nblk, s_words, device.default_device())
    import torch

    verdict, sums = TV.verify_tally(*args, torch.from_numpy(limbs),
                                    TC.base_table("cpu"))
    want = _spec(pks, msgs, sigs)
    got = verdict.numpy() & ok
    np.testing.assert_array_equal(got, want)
    assert sums.dtype == torch.int64 and sums.shape == (8,)
    total = sum(int(sums[j]) << (8 * j) for j in range(8))
    assert total == _jax_total(powers, want)
    assert total == int(sum(int(p) for p, w in zip(powers, want) if w))
    # the plain version is what the wrapper took on the CPU
    assert TV.launches["ed25519_verify_tally"] == 0


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_matches_host_and_jax(shards):
    pks, msgs, sigs = _mixed(seed=shards)
    powers = list(range(1, 38))
    verdict, total = TS.batch_verify_sharded(
        pks, msgs, sigs, powers=powers, mesh=TS.make_mesh(shards))
    want = _spec(pks, msgs, sigs)
    np.testing.assert_array_equal(verdict, want)
    assert not want[[5, 9, 14, 20]].any() and want.sum() == 33
    assert total == _jax_total(powers, want)
    assert total == sum(p for p, w in zip(powers, want) if w)
    rec = tphases.recent_segments()[-1]
    assert rec["device"] == f"mesh[{shards}]" and rec["sigs"] == 37


def test_shard_counts_agree_on_extreme_powers():
    """Three powers of 2^63 - 1 (total above 2^64) and a negative power
    (counted as its uint64 pattern, as in the JAX package): the same exact
    total over 1, 2 and 4 shards."""
    pks, msgs, sigs = _signed(5, seed=11)
    sigs[3] = sigs[3][:-1] + bytes([sigs[3][-1] ^ 0x40])  # s >= L or wrong
    powers = [(1 << 63) - 1] * 3 + [-5, 7]
    want = _spec(pks, msgs, sigs)
    assert want.tolist() == [True, True, True, False, True]
    results = [TS.batch_verify_sharded(pks, msgs, sigs, powers=powers,
                                       mesh=TS.make_mesh(d))
               for d in (1, 2, 4)]
    for verdict, total in results:
        np.testing.assert_array_equal(verdict, want)
        assert total == 3 * ((1 << 63) - 1) + 7
        assert total > 1 << 64
        assert total == _jax_total(powers, want)
    pks2, msgs2, sigs2 = _signed(2, seed=12)
    for d in (1, 2, 4):
        _, total = TS.batch_verify_sharded(pks2, msgs2, sigs2,
                                           powers=[-5, 1], mesh=[
                                               device.default_device()] * d)
        assert total == (1 << 64) - 5 + 1 == _jax_total([-5, 1], [1, 1])


def test_exact_tally_bound_raises_like_jax():
    n = TS.MAX_EXACT_SIGS + 1
    assert TS.MAX_EXACT_SIGS == JS.MAX_EXACT_SIGS == 1 << 22
    big = [b""] * n
    with pytest.raises(ValueError, match="exact-tally bound"):
        TS.batch_verify_sharded(big, big, big, mesh=TS.make_mesh(2))
    with pytest.raises(ValueError, match="exact-tally bound"):
        JS.batch_verify_sharded(big, big, big, mesh=JS.make_mesh(2))


def test_make_mesh_needs_cards(monkeypatch):
    import torch

    device.set_default_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        TS.make_mesh(2)
    assert TS.make_mesh(1) == [torch.device("cuda", 0)]


@pytest.fixture
def stubs_both_sides(monkeypatch):
    monkeypatch.setattr(JS, "_STEP_CACHE", {})  # no real step from elsewhere
    restore_j = jprofile.install_stub_kernels(JV, sharded=JS)
    restore_t = tprofile.install_stub_kernels(TV, sharded=TS)
    yield
    restore_t()
    restore_j()


def _jax_sharded(pks, msgs, sigs, powers):
    return JS.batch_verify_sharded(pks, msgs, sigs, powers=powers,
                                   mesh=JS.make_mesh(2))


def test_stub_sharding_and_tally_match_jax(stubs_both_sides):
    """P1 and the sharded tally path against the JAX package, stubs on both
    sides: a mixed batch with host-invalid rows, powers 1..n."""
    pks, msgs, sigs = tprofile.build_workload(300, seed=5)
    sigs[7] = sigs[7][:32] + b"\xff" * 32    # s >= L
    pks[8] = pks[8][:31]                      # bad key length
    msgs[9] = msgs[9] + b"longer-message" * 10  # a second block count
    powers = list(range(1, 301))
    want_v, want_t = _jax_sharded(pks, msgs, sigs, powers)
    assert 0 < want_v.sum() < 300
    for d in (1, 2, 4):
        got_v, got_t = TS.batch_verify_sharded(pks, msgs, sigs,
                                               powers=powers,
                                               mesh=TS.make_mesh(d))
        np.testing.assert_array_equal(got_v, want_v)
        assert got_t == want_t
    assert TST.launches == dict.fromkeys(TST.launches, 0)  # CPU: plain


def test_stub_commit_scale_tally_matches_jax(stubs_both_sides):
    """Powers of 2^40 over 10,240 rows: the exact total is far above 2^31,
    equal on both sides and to the Python sum."""
    pks, msgs, sigs = tprofile.build_workload(10_240, seed=6)
    for i in range(0, 10_240, 97):
        sigs[i] = sigs[i][:32] + b"\xff" * 32  # host-invalid: no power
    powers = [1 << 40] * 10_240
    want_v, want_t = _jax_sharded(pks, msgs, sigs, powers)
    got_v, got_t = TS.batch_verify_sharded(pks, msgs, sigs, powers=powers,
                                           mesh=TS.make_mesh(2))
    np.testing.assert_array_equal(got_v, want_v)
    assert got_t == want_t == int(want_v.sum()) << 40
    assert got_t > 1 << 50 and not want_v[::97].any()
