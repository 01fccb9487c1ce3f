"""The port's batched Ed25519 verification (crypto/ed25519_cuda) on the CPU
against the JAX package: verdicts against the host spec
``tendermint_tpu.crypto.ed25519.verify`` (and the JAX ``batch_verify`` at a
shape tests/test_ed25519_jax.py already compiles), host packing and sparse
preimage assembly against the JAX package's bytes. Every comparison is
exact.

On the CPU each kernel wrapper runs its plain PyTorch version; the
kernels themselves are held against those versions on the card by
tests/test_torch_cuda.py (marker ``cuda``) and chip_smoke.py.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519 as ed
from tendermint_tpu.crypto.ed25519_jax import batch_verify as jax_batch_verify
from tendermint_tpu.crypto.ed25519_jax import verify as JV
from tendermint_tpu.crypto.signcols import SignColumns as JSignColumns
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import phases
from tendermint_tpu_torch.crypto.ed25519_cuda import curve as TC
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.crypto.signcols import SignColumns


@pytest.fixture(autouse=True)
def _port_state():
    device.set_default_device("cpu")
    phases.reset()
    TV.reset_launches()
    yield
    phases.reset()
    device.set_default_device(None)


def _differential(cases, verify=TV.batch_verify):
    pks, msgs, sigs = (list(x) for x in zip(*cases)) if cases else ([], [], [])
    got = verify(pks, msgs, sigs)
    want = np.array([ed.verify(p, m, s) for p, m, s in cases], dtype=bool)
    assert got.dtype == bool
    assert got.tolist() == want.tolist()
    return want


def _valid_cases(n, seed, msg_len=40):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        priv, pub = ed.keygen(bytes(rng.randrange(256) for _ in range(32)))
        msg = bytes(rng.randrange(256) for _ in range(msg_len))
        out.append((pub, msg, ed.sign(priv, msg)))
    return out


def test_valid_batch_matches_jax_kernel():
    """32 sigs, 40-byte messages: the (pad 128, NBLK 1) JAX kernel shape
    tests/test_ed25519_jax.py compiles."""
    cases = _valid_cases(32, seed=1)
    want = _differential(cases)
    assert want.all()
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    assert jax_batch_verify(pks, msgs, sigs).tolist() == want.tolist()
    assert TV.launches["ed25519_verify_dense"] == 0  # CPU: plain version


def test_corrupted_batch():
    rng = random.Random(2)
    cases = []
    for pub, msg, sig in _valid_cases(12, seed=3):
        which = rng.randrange(3)
        if which == 0:
            b = bytearray(sig)
            b[rng.randrange(64)] ^= 1 << rng.randrange(8)
            sig = bytes(b)
        elif which == 1:
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        else:
            b = bytearray(pub)
            b[rng.randrange(32)] ^= 1 << rng.randrange(8)
            pub = bytes(b)
        cases.append((pub, msg, sig))
    assert not _differential(cases).all()


def _adversarial():
    priv, pub = ed.keygen(b"\x07" * 32)
    msg = b"adversarial"
    sig = ed.sign(priv, msg)
    s_int = int.from_bytes(sig[32:], "little")
    id_pub = b"\x01" + b"\x00" * 31  # y = 1, x = 0: the identity point
    s = 12345
    sB = ed._pt_mul(s, (ed.B[0], ed.B[1], 1, ed.B[0] * ed.B[1] % ed.P))
    forged = ed._pt_encode(sB) + s.to_bytes(32, "little")
    return [
        (pub, msg, sig),                                               # valid
        (pub, msg, sig[:32] + (s_int + ed.L).to_bytes(32, "little")),  # s >= L
        (pub, msg, sig[:32] + (ed.L - 1).to_bytes(32, "little")),      # s = L-1
        ((ed.P + 1).to_bytes(32, "little"), msg, sig),                 # y >= p
        ((2**255 - 1).to_bytes(32, "little"), msg, sig),               # y >= p
        ((ed.P - 1).to_bytes(32, "little"), msg, sig),                 # y = p-1
        (b"\x01" + b"\x00" * 30 + b"\x80", msg, sig),                  # x = 0, sign 1
        (id_pub, msg, sig),                                            # identity A
        (id_pub, msg, forged),                  # identity A, forged sig
        (b"\x00" * 32, msg, sig),                                      # y = 0
        (pub, msg, b"\x00" * 64),                                      # zero sig
        (pub, msg, (b"\x01" + b"\x00" * 31) + b"\x00" * 32),           # R = id, s = 0
        (bytes(pub[:31]) + bytes([pub[31] ^ 0x80]), msg, sig),         # flipped sign
        (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),                     # corrupt R
    ]


def test_adversarial_batch():
    want = _differential(_adversarial())
    assert want[0] and not want[1:8].any()


def test_identity_pubkey_with_forged_sig():
    """A = identity: [s]B - [h]A = [s]B, so R = [s]B passes the cofactorless
    equation. The port must agree with the spec (it accepts)."""
    assert _differential(_adversarial()[8:9]).all()


def test_wrong_lengths_and_empty():
    priv, pub = ed.keygen(b"\x09" * 32)
    sig = ed.sign(priv, b"m")
    _differential([(pub[:31], b"m", sig), (pub, b"m", sig[:63]),
                   (pub + b"\x00", b"m", sig), (pub, b"m", sig + b"\x00"),
                   (pub, b"m", sig)])
    assert TV.batch_verify([], [], []).shape == (0,)
    assert TV.batch_verify_stream([], [], []).shape == (0,)


def test_mixed_buckets_and_block_boundaries():
    """Messages across the 1/2/4-block buckets: grouped per bucket, the
    preimage crossing a block at 48 and 176 bytes."""
    rng = random.Random(4)
    priv, pub = ed.keygen(b"\x0b" * 32)
    cases = []
    for n in (0, 47, 48, 175, 176, 300):
        msg = bytes(rng.randrange(256) for _ in range(n))
        sig = ed.sign(priv, msg)
        cases += [(pub, msg, sig), (pub, msg, sig[:40] + bytes([sig[40] ^ 2])
                                    + sig[41:])]
    want = _differential(cases)
    assert want[::2].all() and not want[1::2].any()


def test_prepare_batch_matches_jax_bytes():
    cases = _adversarial() + _valid_cases(3, seed=5, msg_len=130)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    pks.append(b"\x01" * 31)  # malformed rows zero-substitute alike
    msgs.append(b"x")
    sigs.append(b"\x02" * 64)
    for kw in ({}, {"rows": 24, "min_nblk": 4}):
        got = TV.prepare_batch(pks, msgs, sigs, **kw)
        want = JV.prepare_batch(pks, msgs, sigs, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _commit_like(n, seed, ncols=2, nsigned=6):
    """Equal-length messages differing in ``ncols`` byte columns (commit
    sign-bytes differ only in timestamp bytes); the first ``nsigned`` rows
    carry real signatures, the rest random ones."""
    rng = random.Random(seed)
    keys = [ed.keygen(bytes([i + 1]) * 32) for i in range(4)]
    base = bytes(rng.randrange(256) for _ in range(110))
    cases = []
    for i in range(n):
        priv, pub = keys[i % len(keys)]
        m = bytearray(base)
        for c in range(ncols):
            m[40 + 7 * c] = (i * (c + 3)) % 256
        m = bytes(m)
        sig = (ed.sign(priv, m) if i < nsigned
               else bytes(rng.randrange(256) for _ in range(64)))
        cases.append((pub, m, sig))
    return cases


def _columns_of(msgs, cls):
    arr = np.frombuffer(b"".join(msgs), np.uint8).reshape(len(msgs), -1)
    cols = np.flatnonzero((arr != arr[0]).any(axis=0)).astype(np.int32)
    return cls(arr[0], cols, arr[:, cols])


@pytest.mark.parametrize("use_columns", [False, True])
def test_sparse_pack_matches_jax_wire_format(use_columns):
    """Host half of K7: the port's item-major arrays are the JAX package's
    (K, C, B, 128) lane arrays, read back item by item — padded rows and
    duplicated pad columns included."""
    cases = _commit_like(300, seed=6, nsigned=0)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    chunk = 128
    tcols = _columns_of(msgs, SignColumns) if use_columns else None
    jcols = _columns_of(msgs, JSignColumns) if use_columns else None
    tpl, cols, dv, ml, r, a, s, ok = TV.pack_sparse(pks, msgs, sigs, chunk,
                                                    columns=tcols)
    jargs, jok = JV.prepare_sparse_stream(pks, msgs, sigs, chunk,
                                          columns=jcols)
    jtpl, jcol, jdv, jml, jr, ja, js = (np.asarray(x) for x in jargs)
    k = jtpl.shape[0]

    def items(x):  # (k, W, b, LANE) -> (k * chunk, W)
        return x.reshape(k, x.shape[1], chunk).transpose(0, 2, 1).reshape(
            k * chunk, x.shape[1])

    # two real diff columns padded to the 4-bucket with duplicates: column
    # 0 (row discovery) or the first diff column (caller's columns)
    pad_col = cols[0] if use_columns else 0
    assert cols.shape[0] == 4 and (cols[2:] == pad_col).all()
    assert np.array_equal(tpl, jtpl) and np.array_equal(cols, jcol)
    assert np.array_equal(dv, items(jdv))
    assert np.array_equal(ml, jml.reshape(-1))
    for mine, theirs in ((r, jr), (a, ja), (s, js)):
        assert np.array_equal(mine, items(theirs))
    assert ml.shape[0] == 384 and (ml[300:] == 0).all()  # padded rows
    assert np.array_equal(ok, jok)


def test_sparse_assembly_matches_jax_and_prepare_batch():
    """K7's preimage assembly: the port's plain version against the JAX
    _assemble_blocks (eager) and against prepare_batch's dense bytes, for
    real rows; padded rows (mlen 0, zero R/A) against the JAX assembly."""
    cases = _commit_like(150, seed=7, nsigned=0)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    chunk = 128
    tpl, cols, dv, ml, r, a, s, ok = TV.pack_sparse(pks, msgs, sigs, chunk)
    words, nblk = TV.assemble_blocks_plain(
        *(torch.from_numpy(x) for x in (tpl, cols, dv, ml, r, a)), chunk)
    dense, dnblk, _, _ = TV.prepare_batch(pks, msgs, sigs)
    assert np.array_equal(words.numpy()[:150].astype(np.uint32), dense)
    assert np.array_equal(nblk.numpy()[:150], dnblk)
    for c in range(2):  # each chunk has its own template
        lo, hi = c * chunk, (c + 1) * chunk
        jw, jn = JV._assemble_blocks(
            jnp.asarray(tpl[c]), jnp.asarray(cols), jnp.asarray(dv[lo:hi].T),
            jnp.asarray(ml[lo:hi]), jnp.asarray(r[lo:hi].T),
            jnp.asarray(a[lo:hi].T))
        jw = np.asarray(jw).transpose(2, 0, 1)           # (chunk, NBLK, 32)
        assert np.array_equal(words.numpy()[lo:hi].astype(np.uint32), jw)
        assert np.array_equal(nblk.numpy()[lo:hi], np.asarray(jn))


def test_stream_sparse_segmented_matches_spec(monkeypatch):
    """Above SEG_MIN_SIGS the stream splits into pipeline segments (here 3
    chunks of 128 -> [2, 1]) on the worker pool, through the sparse path
    with the caller's columns."""
    monkeypatch.setattr(TV, "SEG_MIN_SIGS", 256)
    cases = _commit_like(300, seed=8)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    b = bytearray(sigs[2])
    b[9] ^= 8
    sigs[2] = bytes(b)
    cases[2] = (pks[2], msgs[2], sigs[2])
    cols = _columns_of(msgs, SignColumns)
    assert TV._segment_sizes(3) == [2, 1]
    got = TV.batch_verify_stream(pks, msgs, sigs, chunk=128, columns=cols)
    want = [ed.verify(*c) for c in cases]
    assert got.tolist() == want
    assert sum(want) == 5
    segs = phases.recent_segments()
    assert [(r["seg"], r["n_segs"], r["sigs"]) for r in segs
            if r["n_segs"] == 2] == [(0, 2, 256), (1, 2, 44)]


def test_stream_dense_dissimilar_messages():
    """More than MAX_SPARSE_COLS differing columns: the dense stream path
    over two padded chunks."""
    rng = random.Random(9)
    priv, pub = ed.keygen(b"\x0c" * 32)
    cases = []
    for i in range(140):
        msg = bytes(rng.randrange(256) for _ in range(110))
        sig = (ed.sign(priv, msg) if i % 35 == 0
               else bytes(rng.randrange(256) for _ in range(64)))
        cases.append((pub, msg, sig))
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    assert TV.pack_sparse(pks, msgs, sigs, 128) is None
    got = TV.batch_verify_stream(pks, msgs, sigs, chunk=128)
    assert got.tolist() == [ed.verify(*c) for c in cases]
    assert got.sum() == 4


def test_wrappers_check_inputs_and_run_plain_on_cpu():
    cases = _valid_cases(2, seed=10)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    bw, nblk, sw, ok = TV.prepare_batch(pks, msgs, sigs)
    args = [torch.from_numpy(TV._as_i32(bw)),
            torch.from_numpy(nblk.astype(np.int32)),
            torch.from_numpy(TV._as_i32(sw))]
    table = TC.base_table("cpu")
    assert TV.verify_dense(*args, table).tolist() == [True, True]
    with pytest.raises(TypeError):
        TV.verify_dense(args[0].to(torch.int64), *args[1:], table)
    with pytest.raises(ValueError):
        TV.verify_dense(args[0], args[1][:1], args[2], table)
    with pytest.raises(ValueError):  # no block to read R and A from
        TV.verify_dense(args[0][:, :0].contiguous(), *args[1:], table)
    with pytest.raises(ValueError):
        TV.verify_dense(torch.cat([args[0], args[0]], dim=2)[:, :, ::2],
                        *args[1:], table)  # strided: not contiguous
    x = torch.from_numpy(np.arange(256 * 128, dtype=np.int64).astype(
        np.uint8).reshape(256, 128))
    assert TV.probe_sum(x).item() == int(x.numpy().astype(np.int64).sum())
    assert TV.probe_dispatch_seconds() > 0
    assert TV.launches == {"ed25519_verify_dense": 0,
                           "ed25519_verify_sparse": 0,
                           "ed25519_verify_tally": 0, "probe_sum_u8": 0}


def test_pk_cache_evicts_least_recently_used(monkeypatch):
    """The pk-plane cache keeps a key set it was just asked for: a hit
    refreshes its place, so the oldest untouched entry goes first."""
    monkeypatch.setattr(TV, "_PK_DEVICE_CACHE", type(TV._PK_DEVICE_CACHE)())
    cpu = torch.device("cpu")
    arrs = [np.full((4, 32), i, dtype=np.uint8)
            for i in range(TV._PK_CACHE_MAX + 1)]
    first = TV._device_cached(arrs[0], cpu)
    for a in arrs[1:TV._PK_CACHE_MAX]:
        TV._device_cached(a, cpu)
    assert TV._device_cached(arrs[0], cpu) is first  # hit: now the newest
    TV._device_cached(arrs[-1], cpu)                 # evicts arrs[1]
    assert len(TV._PK_DEVICE_CACHE) == TV._PK_CACHE_MAX
    assert TV._device_cached(arrs[0], cpu) is first
    kept = {k[0] for k in TV._PK_DEVICE_CACHE}
    assert hashlib.sha256(arrs[1].tobytes()).digest() not in kept
    assert torch.equal(first, torch.from_numpy(arrs[0]))
