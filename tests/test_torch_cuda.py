"""The port's CUDA kernels on the card (marker ``cuda``).

These need an NVIDIA GPU and skip without one: the CUDA kernels have no
CPU mode. The file imports neither ``jax`` nor ``tendermint_tpu``, so it
runs where only the port is installed. On the card, from the repository
root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py pins JAX to the CPU and needs jax.)
Each kernel is held against its plain PyTorch version on the same card
tensors, item by item, and its results against the host spec
(``tendermint_tpu_torch/crypto/ed25519.py``, the JAX package's spec
copied verbatim; hashlib for SHA-256; the BLS12-381 curve spec
``crypto/bls12381/curve.py`` for the G2-add round).
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke

from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import Ed25519PubKey
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto.ed25519_cuda import curve as TC
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto.ed25519_cuda import multidevice as TMD
from tendermint_tpu_torch.crypto.ed25519_cuda import sharded as TSH
from tendermint_tpu_torch.crypto.ed25519_cuda import stub as TST
from tendermint_tpu_torch.crypto.ed25519_cuda import verify as TV
from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as TS
from tendermint_tpu_torch.crypto import bls12381 as tbls
from tendermint_tpu_torch.crypto.bls12381 import curve as tcurve
from tendermint_tpu_torch.crypto.bls12381 import vec as tvec
from tendermint_tpu_torch.crypto.bls12381.field import P as BLS_P
from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as TG
from tendermint_tpu_torch.tools import device_profile as tprofile
from tendermint_tpu_torch.tools import g2_lanes

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    device.set_default_device(dev)
    TV.reset_launches()
    TS.reset_launches()
    TG.reset_launches()
    TST.reset_launches()
    yield dev
    device.set_default_device(None)


def _cases(n_valid, seed, msg_len):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_valid):
        priv, pub = ed.keygen(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        msg = bytes(rng.integers(0, 256, msg_len + i % 3, dtype=np.uint8))
        sig = ed.sign(priv, msg)
        out.append((pub, msg, sig))
        out.append((pub, msg, sig[:33] + bytes([sig[33] ^ 4]) + sig[34:]))
    priv, pub = ed.keygen(b"\x07" * 32)
    msg = out[0][1]
    sig = ed.sign(priv, msg)
    s_int = int.from_bytes(sig[32:], "little")
    out += [
        (pub, msg, sig),
        (pub, msg, sig[:32] + (s_int + ed.L).to_bytes(32, "little")),
        ((ed.P + 1).to_bytes(32, "little"), msg, sig),
        ((2**255 - 1).to_bytes(32, "little"), msg, sig),
        (b"\x01" + b"\x00" * 30 + b"\x80", msg, sig),
        (b"\x01" + b"\x00" * 31, msg, sig),
        (b"\x00" * 32, msg, sig),
        (pub, msg, b"\x00" * 64),
        (pub[:31], msg, sig),
    ]
    return out


@pytest.mark.parametrize("msg_len", [20, 110])  # NBLK 1 and 2
def test_dense_kernel_matches_plain_and_spec(_card, msg_len):
    cases = _cases(12, seed=msg_len, msg_len=msg_len)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    bw, nblk, sw, ok = TV.prepare_batch(pks, msgs, sigs)
    args = [torch.from_numpy(x).to(_card) for x in
            (TV._as_i32(bw), nblk.astype(np.int32), TV._as_i32(sw))]
    table = TC.base_table(_card)
    got = TV.verify_dense(*args, table).cpu().numpy()
    assert TV.launches["ed25519_verify_dense"] == 1
    assert got.tolist() == TV.verify_dense_plain(*args,
                                                 table).cpu().tolist()
    assert (got & ok).tolist() == [ed.verify(*c) for c in cases]


def test_dense_kernel_bounds_block_counts(_card):
    """Block counts outside [0, NBLK] (not produced by prepare_batch) are
    clamped to the row, as the plain version's mask does: no read past
    the row, same verdicts."""
    cases = _cases(4, seed=9, msg_len=20)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    bw, nblk, sw, _ = TV.prepare_batch(pks, msgs, sigs)
    nblk = nblk.astype(np.int32)
    nblk[::3] = 7
    nblk[1::3] = -2
    args = [torch.from_numpy(x).to(_card) for x in
            (TV._as_i32(bw), nblk, TV._as_i32(sw))]
    table = TC.base_table(_card)
    got = TV.verify_dense(*args, table)
    torch.cuda.synchronize()
    assert got.cpu().tolist() == TV.verify_dense_plain(*args,
                                                       table).cpu().tolist()


def test_sparse_kernel_matches_plain_and_spec(_card):
    rng = np.random.default_rng(3)
    base = bytes(rng.integers(0, 256, 110, dtype=np.uint8))
    cases = []
    for i in range(20):
        priv, pub = ed.keygen(bytes([i + 1]) * 32)
        m = bytearray(base)
        m[50], m[77] = i, (3 * i) % 256
        sig = ed.sign(priv, bytes(m))
        if i % 4 == 1:
            sig = sig[:9] + bytes([sig[9] ^ 1]) + sig[10:]
        cases.append((pub, bytes(m), sig))
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    packed = TV.pack_sparse(pks, msgs, sigs, 8)  # 3 chunks, 4 padded rows
    args = [torch.from_numpy(np.array(x)).to(_card) for x in packed[:7]]
    table = TC.base_table(_card)
    got = TV.verify_sparse(*args, 8, table).cpu().numpy()
    assert got.shape == (24,)
    assert got.tolist() == TV.verify_sparse_plain(*args, 8,
                                                  table).cpu().tolist()
    assert (got[:20] & packed[7]).tolist() == [ed.verify(*c) for c in cases]


def _lane_cases(seed):
    """Valid and corrupted signatures over messages of 1, 2 and 3 SHA-512
    blocks (so a warp's eight groups hash different block counts), and the
    adversarial classes of chip_smoke.py for one of them."""
    rng = np.random.default_rng(seed)
    base = []
    for i in range(12):
        priv, pub = ed.keygen(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        msg = bytes(rng.integers(0, 256, (20, 110, 200)[i % 3], np.uint8))
        sig = ed.sign(priv, msg)
        base += [(pub, msg, sig), (pub, msg, sig[:5] + bytes([sig[5] ^ 1])
                                   + sig[6:])]
    seed_b = b"\x09" * 32
    priv, pub = ed.keygen(seed_b)
    msg = base[0][1]
    adv = chip_smoke._adversarial(ed, seed_b, msg, ed.sign(priv, msg))
    return base, adv


@pytest.mark.parametrize("n", chip_smoke.RAGGED_NS)
def test_dense_kernel_on_ragged_groups_and_lanes(_card, n):
    """K5/K6 on four lanes a signature: at counts that end a group or a
    warp ragged, with NBLK 1-3 mixed inside warps and every adversarial
    class at every position of a warp, equal to the plain version on
    every item and to the spec."""
    base, adv = _lane_cases(11)
    items = chip_smoke._lane_items(base, adv, max(n, 8 * 8 * len(adv)))[:n]
    pks, msgs, sigs = (list(x) for x in zip(*items))
    bw, nblk, sw, ok = TV.prepare_batch(pks, msgs, sigs)
    args = [torch.from_numpy(x).to(_card) for x in
            (TV._as_i32(bw), nblk.astype(np.int32), TV._as_i32(sw))]
    table = TC.base_table(_card)
    got = TV.verify_dense(*args, table).cpu().numpy()
    assert got.tolist() == TV.verify_dense_plain(*args,
                                                 table).cpu().tolist()
    spec = {c: ed.verify(*c) for c in set(items)}
    assert (got & ok).tolist() == [spec[c] for c in items]


@pytest.mark.parametrize("n", chip_smoke.RAGGED_NS)
def test_sparse_kernel_on_ragged_groups_and_lanes(_card, n):
    """K7 on four lanes a signature: rows of 40 to 56 bytes (one or two
    SHA-512 blocks inside a warp) in chunks of 64, every adversarial class
    at every position of a warp, equal to the plain version on every row
    and to the spec."""
    rng = np.random.default_rng(12)
    prefix = bytes(rng.integers(0, 256, 40, np.uint8))
    base = []
    for i in range(17):
        priv, pub = ed.keygen(bytes([i + 40]) * 32)
        msg = prefix + bytes(rng.integers(0, 256, i, np.uint8))
        sig = ed.sign(priv, msg)
        if i % 4 == 3:
            sig = sig[:44] + bytes([sig[44] ^ 16]) + sig[45:]
        base.append((pub, msg, sig))
    seed_b = b"\x0a" * 32
    priv, pub = ed.keygen(seed_b)
    adv = chip_smoke._adversarial(ed, seed_b, base[5][1],
                                  ed.sign(priv, base[5][1]))
    items = chip_smoke._lane_items(base, adv, max(n, 8 * 8 * len(adv)))[:n]
    packed = TV.pack_sparse(*(list(x) for x in zip(*items)), 64)
    args = [torch.from_numpy(np.array(x)).to(_card) for x in packed[:7]]
    table = TC.base_table(_card)
    got = TV.verify_sparse(*args, 64, table).cpu().numpy()
    assert got.tolist() == TV.verify_sparse_plain(*args, 64,
                                                  table).cpu().tolist()
    spec = {c: ed.verify(*c) for c in set(items)}
    assert (got[:n] & packed[7]).tolist() == [spec[c] for c in items]


def test_probe_kernel_matches_plain(_card):
    x = torch.randint(0, 256, (256, 128), dtype=torch.uint8, device=_card)
    assert TV.probe_sum(x).item() == TV.probe_sum_plain(x).item()
    assert TV.probe_dispatch_seconds(_card) > 0
    assert TV.launches["probe_sum_u8"] == 2


def test_probe_kernel_is_a_grid_reduction(_card):
    """K11/P4 over many blocks: equal to the plain version at 32 KB, 4 MB,
    on 9 MB of 0xFF (a sum that wraps past 2^31) and on unaligned and
    ragged slices, one after another on one stream (the last block of each
    sets the finished-block counter back to 0) and on a second stream; one
    block at 32 KB, more than one from 64 KB up."""
    assert TV.probe_blocks(32 << 10) == 1
    assert TV.probe_blocks(64 << 10) > 1 and TV.probe_blocks(4 << 20) > 1
    g = torch.Generator().manual_seed(3)
    big = torch.randint(0, 256, ((4 << 20) + 64,), dtype=torch.uint8,
                        generator=g).to(_card)
    cases = [big[:32 << 10], big[:4 << 20],
             torch.full((9 << 20,), 0xFF, dtype=torch.uint8, device=_card)]
    cases += [big[off:off + size] for off in (1, 3, 15)
              for size in (0, 1, 15, 17, 4099, (64 << 10) + 5)]
    # every output is kept until all ran: a launch that left its output
    # unwritten cannot read back an earlier result from a reused block
    outs = [TV.probe_sum(x) for x in cases]
    for x, out in zip(cases, outs):
        want = int(x.to(torch.int64).sum().item()) & 0xFFFFFFFF
        got = out.item()
        assert got == TV.probe_sum_plain(x).item()
        assert got & 0xFFFFFFFF == want
    assert TV.probe_sum(cases[2]).item() == 2_406_481_920 - (1 << 32)
    side = torch.cuda.Stream(_card)
    side.wait_stream(torch.cuda.current_stream(_card))
    with torch.cuda.stream(side):
        got = [TV.probe_sum(x) for x in cases[:3]]
    side.synchronize()
    assert [g.item() for g in got] == [TV.probe_sum_plain(x).item()
                                       for x in cases[:3]]


def test_batch_verifier_on_card(_card):
    """The seam end to end on the card: BatchVerifier -> batch_verify ->
    the dense kernel, verdicts equal to the spec."""
    cases = _cases(40, seed=5, msg_len=110)
    bv = tbatch.BatchVerifier(backend="cuda")
    for pub, msg, sig in cases:
        bv.add(Ed25519PubKey(pub), msg, sig)
    before = tbatch.stats["device_errors"]
    _, verdicts = bv.verify()
    assert verdicts.tolist() == [ed.verify(*c) for c in cases]
    assert tbatch.stats["device_errors"] == before
    assert TV.launches["ed25519_verify_dense"] >= 1


def test_device_cache_record_stream_survives_eviction(_card):
    """ROADMAP §3 item 2: K7 reads a ``_device_cached`` key buffer on a
    side stream (busy first, so the read comes late) while the default
    stream evicts it, then allocates and overwrites tensors of its size.
    With ``record_stream`` the freed block is not handed out while the
    side stream runs and the verdicts equal the plain version's; with it
    made a no-op the next allocation takes the block and the verdicts
    differ (chip_smoke.py phase votes runs the same check)."""
    out = chip_smoke.record_stream_check(_card)
    assert out["side_busy"] and out["side_busy_without"]
    assert out["equal"] and not out["reused"]
    assert out["reused_without_record_stream"]
    assert out["equal_without_record_stream"] is False
    assert TV._PK_DEVICE_CACHE == {}


def test_tally_kernel_matches_plain_and_spec(_card):
    """K8: verdicts and limb sums equal to the plain version, verdicts to
    the spec, and the sharded total over 1 and 4 shards of the card equal
    to the exact Python sum (powers above 2^63 included)."""
    cases = _cases(30, seed=8, msg_len=110)
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    want = [ed.verify(*c) for c in cases]
    powers = [(1 << 63) - 1 - i if i % 5 else -i for i in range(len(cases))]
    bw, nblk, sw, ok = TV.prepare_batch(pks, msgs, sigs)
    limbs = TSH._power_limbs(np.array(powers, dtype=np.int64) * ok)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(_card) for x in
            (TV._as_i32(bw), nblk, TV._as_i32(sw), limbs)]
    table = TC.base_table(_card)
    v, sums = TV.verify_tally(*args, table)
    torch.cuda.synchronize()
    assert TV.launches["ed25519_verify_tally"] == 1
    pv, psums = TV.verify_tally_plain(*args, table)
    assert torch.equal(v, pv) and torch.equal(sums, psums)
    assert (v.cpu().numpy() & ok).tolist() == want
    exact = sum(p % (1 << 64) for p, w in zip(powers, want) if w)
    for d in (1, 4):
        verdict, total = TSH.batch_verify_sharded(pks, msgs, sigs, powers,
                                                  mesh=[_card] * d)
        assert verdict.tolist() == want and total == exact


@pytest.mark.parametrize("n", chip_smoke.RAGGED_NS)
def test_tally_kernel_on_ragged_groups_and_lanes(_card, n):
    """K8 at counts that end a warp or a block ragged, NBLK 1-3 mixed
    inside warps and every adversarial class at every position of a warp:
    verdicts and limb sums equal to the plain version, verdicts to the
    spec."""
    base, adv = _lane_cases(13)
    items = chip_smoke._lane_items(base, adv, max(n, 8 * 8 * len(adv)))[:n]
    pks, msgs, sigs = (list(x) for x in zip(*items))
    bw, nblk, sw, ok = TV.prepare_batch(pks, msgs, sigs)
    powers = np.random.default_rng(n).integers(1, 2**62, n) * ok
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(_card) for x in
            (TV._as_i32(bw), nblk.astype(np.int32), TV._as_i32(sw),
             TSH._power_limbs(powers))]
    table = TC.base_table(_card)
    pv, psums = TV.verify_tally_plain(*args, table)
    spec = {c: ed.verify(*c) for c in set(items)}
    v, sums = TV.verify_tally(*args, table)
    assert torch.equal(v, pv) and torch.equal(sums, psums)
    assert (v.cpu().numpy() & ok).tolist() == [spec[c] for c in items]


#: rows [lo, hi) of the stub checks' batch: all of it, slices that start at
#: an odd row (unaligned diff columns), ragged warps, one item
STUB_SLICES = ((0, 1000), (1, 1000), (3, 36), (33, 34), (31, 95))


def _shifted(t, nbytes):
    """A copy of ``t`` whose data starts ``nbytes`` past a 16-byte
    boundary: the kernels' reads below 16-byte words."""
    if t.numel() == 0:
        return t
    buf = torch.zeros(t.numel() * t.element_size() + 32, dtype=torch.uint8,
                      device=t.device)
    start = (-buf.data_ptr()) % 16 + nbytes
    out = buf[start:start + t.numel() * t.element_size()].view(
        t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


@pytest.mark.parametrize("work", [0, 1, 15, 16, 17, 63, 64, 65, 1000])
def test_stub_kernels_match_plain(_card, work):
    """P1/P2 (with and without the tally) and P3: verdicts, burned words
    and limb sums equal to the plain versions, on the whole batch and on
    slices that start at an odd row, at 0, 1, 4, 5 and the packer's diff
    columns, and on a second stream."""
    pks, msgs, sigs = tprofile.build_workload(1000, seed=work)
    bw, nblk, sw, _ = TV.prepare_batch(pks, msgs, sigs)
    dense = TV._dense_args(bw, nblk, sw, _card)
    limbs = torch.randint(0, 256, (1000, 8), dtype=torch.int32,
                          device=_card)
    packed = TV.pack_sparse(pks, msgs, sigs, 256)
    _, _, dv, ml, r, a, s = [torch.from_numpy(np.array(x)).to(_card)
                             for x in packed[:7]]
    gen = torch.Generator().manual_seed(work)
    diffs = [dv] + [torch.randint(0, 256, (1000, c), dtype=torch.uint8,
                                  generator=gen).to(_card)
                    for c in (0, 1, 4, 5)]
    # the same rows 4 bytes (int32 words) and 1 byte (bytes) past a 16-byte
    # boundary
    def shift(x):
        return _shifted(x, 1 if x.dtype == torch.uint8 else 4)

    inputs = [(dense, limbs, [(d, ml, r, a, s) for d in diffs]),
              ([shift(x) for x in dense], shift(limbs),
               [[shift(x) for x in (d, ml, r, a, s)] for d in diffs])]
    side = torch.cuda.Stream(device=_card)
    launched = {"stub_verify_dense": 0, "stub_verify_sparse": 0}
    for stream in (torch.cuda.current_stream(_card), side):
        with torch.cuda.stream(stream):
            got_d, want_d, got_s, want_s = [], [], [], []
            for (dn, lm, sp), (lo, hi) in (
                    (i, sl) for i in inputs for sl in STUB_SLICES):
                for lb in (None, lm):
                    args = [x[lo:hi] for x in dn]
                    lbs = None if lb is None else lb[lo:hi]
                    got_d.append(TST.stub_verify_dense(*args, work,
                                                       limbs=lbs))
                    want_d.append(TST.stub_verify_dense_plain(
                        *args, work, limbs=lbs))
                    launched["stub_verify_dense"] += 1
                for cols in sp:
                    args = [x[lo:hi] for x in cols]
                    got_s.append(TST.stub_verify_sparse(*args, work))
                    want_s.append(TST.stub_verify_sparse_plain(*args, work))
                    launched["stub_verify_sparse"] += 1
        torch.cuda.synchronize(_card)
        for got, want in zip(got_d, want_d):
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
        for got, want in zip(got_s, want_s):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TST.launches == launched


@pytest.mark.parametrize("rounds", [0, 1, 17, 256, 257, 20_000])
def test_stub_chain_matches_closed_form(_card, rounds):
    """The one-warp chain that measures a round's latency: its words equal
    the closed form, and its clock counts grow with the rounds."""
    out, cycles = TST.stub_chain(rounds, _card)
    assert torch.equal(out.cpu(), TST.stub_chain_plain(rounds))
    assert int(cycles.min()) >= 0
    if rounds >= 1000:
        assert int(cycles.min()) >= rounds


def test_two_lanes_on_one_card(_card):
    """The multi-device stream over two lanes of one card: verdicts equal
    to the single-device stream's and the spec's, segments on both
    lanes."""
    cases = _cases(150, seed=6, msg_len=110) * 2
    pks, msgs, sigs = (list(x) for x in zip(*cases))
    want = TV._verify_segmented(pks, msgs, sigs, 128)
    md = TMD.MultiDeviceStream(devices=[_card, _card], min_sigs=0)
    try:
        got = md.verify(pks, msgs, sigs, 128)
    finally:
        md.shutdown()
    assert got.tolist() == want.tolist() == [ed.verify(*c) for c in cases]
    assert md.stats["calls"] == 1 and not md.stats["lane_errors"]


@pytest.mark.parametrize("length", [0, 51, 55, 56, 64, 65, 119, 300])
def test_sha256_kernel_matches_plain_and_hashlib(_card, length):
    rng = np.random.default_rng(length)
    raw = rng.integers(0, 256, (3000, length), dtype=np.uint8)
    x = torch.from_numpy(raw).to(_card)
    got = TS.sha256_many(x)
    torch.cuda.synchronize()
    assert TS.launches["sha256_many"] == 1
    assert torch.equal(got, TS.sha256_many_plain(x))
    assert got.cpu().numpy().tobytes() == b"".join(
        hashlib.sha256(raw[i].tobytes()).digest() for i in range(3000))


def test_merkle_device_tier_on_card(_card, monkeypatch):
    """crypto/merkle.py's device tier on the card: the root equals the
    recursive hashlib spec and the kernel ran."""
    monkeypatch.setenv("TMTPU_MERKLE_DEVICE_MIN", "64")
    items = [b"%05d" % i for i in range(1000)]
    before = tmerkle.stats["device"]
    assert tmerkle.fast_hash_from_byte_slices(items) == \
        tmerkle.hash_from_byte_slices(items)
    assert TS.launches["sha256_many"] >= 4
    assert tmerkle.stats["device"] > before


def test_bls_g2_add_round_matches_plain_and_spec(_card):
    """4,096 lanes of every class: bit-equal to the plain version, and a
    sample equal to the curve spec's sum."""
    ps, qs, kinds = g2_lanes.lane_pairs(np.random.default_rng(10), 4096)
    p, q = TG.to_lanes(ps, _card), TG.to_lanes(qs, _card)
    got = TG.g2_add_round(p, q)
    torch.cuda.synchronize()
    assert TG.launches["bls_g2_add_round"] == 1
    want = TG.g2_add_round_plain(p, q)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    out = TG.from_lanes(got[:360])
    for i in range(360):
        if kinds[i] == "junk":
            continue
        s = None if out[i][2] == (0, 0) else \
            g2_lanes.curve.g2_to_affine(out[i])
        assert s == g2_lanes.spec_sum(ps[i], qs[i]), (i, kinds[i])


def test_bls_fq_mul_matches_plain_on_edge_limbs(_card):
    """The carry-chain product on the card against the plain version and
    integers: 0, 1, p - 1, Montgomery one, values just under 2^384 mod p
    and random limbs, once and three times in a row."""
    P = BLS_P
    rng = np.random.default_rng(12)
    vals = [0, 1, 2, P - 1, P - 2, pow(2, 384, P), (2**384 - 1) % P,
            (2**384 - 2**32) % P] + [int.from_bytes(rng.bytes(48), "little")
                                     % P for _ in range(24)]
    a_int = [x for x in vals for _ in vals]
    b_int = [y for _ in vals for y in vals]
    a = torch.from_numpy(TG.fq_to_limbs(a_int)).to(_card)
    b = torch.from_numpy(TG.fq_to_limbs(b_int)).to(_card)
    for reps in (1, 3):
        got = TG.fq_mul(a, b, reps)
        want = a
        for _ in range(reps):
            want = TG.fq_mul_plain(want, b)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert TG.fq_from_limbs(TG.fq_mul(a, b)) == [
        x * y % P for x, y in zip(a_int, b_int)]


@pytest.mark.parametrize("n", [1, 2, 3, 150, 257, 1000, 1024, 5000, 10000])
def test_bls_g2_tree_sum_matches_plain_and_spec(_card, n):
    """The one-launch tree over n keys (padded to a power of 2) equals the
    plain tree on every limb of the root's Jacobian X, Y and Z, with a
    doubling and a cancel inside the tree; its affine value is the curve
    spec's sum. From 2^13 lanes (5,000 and 10,000 keys, the most signers of
    a commit) a block asks for more than 48 KB of shared memory."""
    affs = g2_lanes.tree_points(np.random.default_rng(13), n)
    lanes = tvec._points_to_lanes(affs, _card)
    want = TG.tree_sum_plain(lanes)
    TG.reset_launches()
    got = TG.tree_sum(lanes)
    torch.cuda.synchronize()
    assert TG.launches == {"bls_g2_add_round": 0, "bls_g2_tree_sum": 1,
                           "bls_fq_mul": 0}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    root = TG.from_lanes(got)[0]
    pt = (*affs[0], (1, 0))
    for a in affs[1:]:
        pt = tcurve.g2_add(pt, (*a, (1, 0)))
    assert tcurve.g2_to_affine(root) == tcurve.g2_to_affine(pt)


def test_bls_aggregate_150_on_the_card_matches_the_spec(_card):
    tbls.reset()
    tvec.reset_stats()
    pks = [tbls.sk_to_pk(tbls.sk_from_seed(bytes([i % 256, i // 256]) * 4))
           for i in range(150)]
    assert tvec.aggregate_pubkeys_vec(pks) == tbls.aggregate_pubkeys(pks)
    assert TG.launches["bls_g2_tree_sum"] == 1
    msg = b"aggregate on the card"
    sks = [tbls.sk_from_seed(bytes([i % 256, i // 256]) * 4)
           for i in range(150)]
    agg = tbls.sign(sum(sks) % tbls.R, msg)
    assert tvec.fast_aggregate_verify_routed(pks, msg, agg)
    assert not tvec.fast_aggregate_verify_routed(pks, b"other", agg)
    assert tvec.stats["device_calls"] == 2
    assert tvec.stats["device_errors"] == 0
    assert TG.launches["bls_g2_tree_sum"] == 3
    assert TG.launches["bls_g2_add_round"] == 0
    tbls.reset()
