#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

Phases, each reported on its own line:

1. card: the device's name and power limit; build the CUDA kernels from
   the sources in this checkout (nvcc, sm_90a).
2. kernels: each kernel against its plain PyTorch version on the same card
   tensors, item by item, and against the host spec on a sample.
3. the main path, through the port's user entry points: a 150-validator
   commit (ValidatorSet.verify_commit -> BatchVerifier -> batch_verify ->
   the dense kernel), a 10,240-validator commit (verify_commit and
   verify_commit_light -> the sparse kernel in two pipelined segments), a
   stream of 4,096 dissimilar messages (the dense kernel over two chunks),
   and a commit with one bad signature, which must be rejected at its
   index. Launch counters are zeroed just before and read just after.
4. times: each kernel (CUDA events) at the main path's shapes beside its
   plain version and its bound; verify_commit signatures per second.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It exits non-zero without CUDA or outside a checkout, and when any phase
fails. The last line is the run's JSON summary.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261017
CHAIN_ID = "chip-smoke-chain"

# sizes: the north star's 150- and 10,240-validator commits, and a stream of
# 4,096 dissimilar messages (two chunks of CHUNK)
N_SMALL = 150
N_BIG = 10_240
N_STREAM = 4096
N_SPARSE_CHECK = 4000
BAD_IDX = 7777
CHUNK = 2048

# Hopper (H100 SXM): INT32 lanes per SM
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12

# limb products (32x32->64 multiply-adds) of one verify in the kernels:
# 100 per field multiply or squaring, and per verify
#   decompress 7 + pow_p58 262 + 6, [h](-A) 14*9 + 64*(4*8 + 9),
#   [s]B 64*7, final add 9, encode: inversion 265 + 2
FIELD_MULS_PER_VERIFY = (7 + 262 + 6) + (14 * 9 + 64 * (4 * 8 + 9)) \
    + 64 * 7 + 9 + (265 + 2)
PRODUCTS_PER_FIELD_MUL = 100

TPU_KERNELS = {
    "ed25519_verify_dense": (
        "tendermint_tpu/crypto/ed25519_jax/verify.py:83 (_verify_kernel, "
        "K5) + :117 (_verify_stream_kernel, K6)"),
    "ed25519_verify_sparse": (
        "tendermint_tpu/crypto/ed25519_jax/verify.py:173 "
        "(_verify_sparse_stream_kernel + _assemble_blocks, K7)"),
    "probe_sum_u8": "tendermint_tpu/crypto/batch.py:75 (device_threshold "
                    "probe, K11)",
}
SOURCES = {
    "ed25519_verify_dense":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/verify.cu",
    "ed25519_verify_sparse":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/verify.cu",
    "probe_sum_u8": "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/probe.cu",
}


def say(*parts) -> None:
    print(*parts, flush=True)


# --- data -------------------------------------------------------------------

def _adversarial(ed, seed, msg, sig):
    pub = ed.keygen(seed)[1]
    s_int = int.from_bytes(sig[32:], "little")
    id_pub = b"\x01" + b"\x00" * 31
    s = 12345
    sb = ed._pt_mul(s, (ed.B[0], ed.B[1], 1, ed.B[0] * ed.B[1] % ed.P))
    forged = ed._pt_encode(sb) + s.to_bytes(32, "little")
    return [
        (pub, msg, sig[:32] + (s_int + ed.L).to_bytes(32, "little")),
        ((ed.P + 1).to_bytes(32, "little"), msg, sig),
        ((2**255 - 1).to_bytes(32, "little"), msg, sig),
        ((ed.P - 1).to_bytes(32, "little"), msg, sig),
        (b"\x01" + b"\x00" * 30 + b"\x80", msg, sig),
        (id_pub, msg, sig),
        (id_pub, msg, forged),
        (b"\x00" * 32, msg, sig),
        (pub, msg, b"\x00" * 64),
        (pub, msg, (b"\x01" + b"\x00" * 31) + b"\x00" * 32),
        (bytes(pub[:31]) + bytes([pub[31] ^ 0x80]), msg, sig),
        (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),
        (pub[:31], msg, sig),
        (pub, msg, sig[:63]),
    ]


def _flip(b: bytes, i: int, bit: int = 1) -> bytes:
    return b[:i] + bytes([b[i] ^ bit]) + b[i + 1:]


# --- timing -----------------------------------------------------------------

def _time_ms(fn, dev, reps=5, warmup=1):
    """Mean ms of ``fn`` over ``reps`` runs after ``warmup``: CUDA events
    on the card (the host clock for a CPU rehearsal)."""
    import torch

    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _wall_s(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(dev, smi: str, int32_peak: float) -> dict:
    """Phases 2-4 on ``dev``; returns the kernels' JSON records. Raises on
    any failed check."""
    import numpy as np
    import torch

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.crypto import Ed25519PubKey
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto import phases
    from tendermint_tpu_torch.crypto.breaker import device_breaker
    from tendermint_tpu_torch.crypto.ed25519_cuda import curve
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types.errors import ErrWrongSignature

    tdevice.set_default_device(dev)
    products = FIELD_MULS_PER_VERIFY * PRODUCTS_PER_FIELD_MUL

    def bound(n_verify, nbytes):
        ops_s = n_verify * products / int32_peak
        bytes_s = nbytes / HBM_BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    # -- seeded keys, commits and signatures ---------------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    with commits.Signer() as signer:
        small = commits.CommitFixture(signer, rng, N_SMALL, CHAIN_ID, 7)
        big = commits.CommitFixture(signer, rng, N_BIG, CHAIN_ID, 9)
        seeds_stream = commits.seeds(rng, 64)
        pubs_stream = signer.pubkeys(seeds_stream)
        stream_jobs = [(seeds_stream[i % 64],
                        bytes(rng.integers(0, 256, 110, dtype="uint8")))
                       for i in range(N_STREAM)]
        short_jobs = [(seeds_stream[i % 64],
                       bytes(rng.integers(0, 256, 1 + i % 40, dtype="uint8")))
                      for i in range(256)]
        sigs = signer.sign(stream_jobs + short_jobs)
        workers = signer.workers
    say(f"phase sign: {N_SMALL + N_BIG + 64} keys, "
        f"{N_SMALL + N_BIG + len(sigs)} signatures with {workers} workers in "
        f"{time.perf_counter() - t0:.1f} s")
    sigs_big = big.sigs
    stream = [(pubs_stream[i % 64], m, s)
              for i, ((_, m), s) in enumerate(zip(stream_jobs, sigs))]
    short = [(pubs_stream[i % 64], m, s) for i, ((_, m), s) in
             enumerate(zip(short_jobs, sigs[N_STREAM:]))]
    table = curve.base_table(dev)

    # -- 2. kernels against their plain versions ----------------------------
    # dense: 4,096 items, NBLK 1 (short messages) and 2 (110-byte ones):
    # valid, corrupted and adversarial
    adv = _adversarial(ed, seeds_stream[0], short[0][1], short[0][2])
    items = list(short)
    items += [(p, m, _flip(s, i % 64, 1 << (i % 8)))
              for i, (p, m, s) in enumerate(short)]
    items += adv
    for i in range(N_STREAM - len(items)):
        p, m, s = stream[i]
        if i % 3 == 1:
            s = _flip(s, (7 * i) % 64, 1 << (i % 8))
        elif i % 3 == 2:
            m = _flip(m, i % 110, 4)
        items.append((p, m, s))
    pks, msgs, sgs = (list(x) for x in zip(*items))
    bw, nblk, sw, ok = V.prepare_batch(pks, msgs, sgs)
    dense_args = [torch.from_numpy(x).to(dev) for x in
                  (V._as_i32(bw), nblk.astype(np.int32), V._as_i32(sw))]
    k_np = V.verify_dense(*dense_args, table).cpu().numpy()
    p_np = V.verify_dense_plain(*dense_args, table).cpu().numpy()
    dense_err = int(np.abs(k_np.astype(np.int64) - p_np).max())
    if not (k_np == p_np).all():
        raise AssertionError("ed25519_verify_dense != plain at items "
                             f"{np.nonzero(k_np != p_np)[0][:20].tolist()}")
    lo = 2 * len(short)
    sample = list(range(lo, lo + len(adv))) + list(range(0, len(items), 13))
    want = [ed.verify(*items[i]) for i in sample]
    if (k_np & ok)[sample].tolist() != want:
        raise AssertionError("ed25519_verify_dense disagrees with the spec")
    say(f"phase kernels: ed25519_verify_dense == plain on {len(items)} items "
        f"(NBLK {sorted(set(nblk.tolist()))}, {int((k_np & ok).sum())} "
        f"valid), == spec on {len(sample)} incl. {len(adv)} adversarial")

    # sparse: rows of the big commit (every 17th signature flipped) packed in
    # chunks of CHUNK, padded rows included
    sb_big = big.commit.vote_sign_bytes_all(CHAIN_ID)
    sp_items = [(big.valset.validators[i].pub_key.bytes(), sb_big[i],
                 sigs_big[i] if i % 17 else _flip(sigs_big[i], 40, 2))
                for i in range(N_SPARSE_CHECK)]
    pks, msgs, sgs = (list(x) for x in zip(*sp_items))
    packed = V.pack_sparse(pks, msgs, sgs, CHUNK)
    sp_args = [torch.from_numpy(np.array(x)).to(dev) for x in packed[:7]]
    k_np = V.verify_sparse(*sp_args, CHUNK, table).cpu().numpy()
    p_np = V.verify_sparse_plain(*sp_args, CHUNK, table).cpu().numpy()
    sparse_err = int(np.abs(k_np.astype(np.int64) - p_np).max())
    if not (k_np == p_np).all():
        raise AssertionError("ed25519_verify_sparse != plain at rows "
                             f"{np.nonzero(k_np != p_np)[0][:20].tolist()}")
    verdict = k_np[:N_SPARSE_CHECK] & packed[7]
    sample = list(range(0, N_SPARSE_CHECK, 15)) + [0, 17, 34, 51]
    if verdict[sample].tolist() != [ed.verify(*sp_items[i]) for i in sample]:
        raise AssertionError("ed25519_verify_sparse disagrees with the spec")
    if verdict.tolist() != [bool(i % 17) for i in range(N_SPARSE_CHECK)]:
        raise AssertionError("ed25519_verify_sparse: wrong verdicts")
    say(f"phase kernels: ed25519_verify_sparse == plain on {k_np.shape[0]} "
        f"rows ({packed[1].shape[0]} diff columns, "
        f"{k_np.shape[0] - N_SPARSE_CHECK} padded), == spec on {len(sample)}")

    x = torch.randint(0, 256, (256, 128), dtype=torch.uint8, device=dev)
    k_sum, p_sum = V.probe_sum(x).item(), V.probe_sum_plain(x).item()
    if not k_sum == p_sum == int(x.to(torch.int64).sum().item()):
        raise AssertionError(f"probe_sum_u8 {k_sum} != plain {p_sum}")
    probe_err = abs(k_sum - p_sum)
    say(f"phase kernels: probe_sum_u8 == plain ({k_sum})")

    # -- 3. the main path ----------------------------------------------------
    main_launches = dict.fromkeys(V.launches, 0)

    def run_main(label, kernel, fn):
        V.reset_launches()
        before = B.stats["device_sigs"]
        t0 = time.perf_counter()
        result = fn()
        dt = time.perf_counter() - t0
        for k, n in V.launches.items():
            main_launches[k] += n
        if V.launches[kernel] == 0:
            raise AssertionError(f"{label}: {kernel} never launched")
        if B.stats["device_sigs"] <= before:
            raise AssertionError(f"{label}: no signature reached the device")
        if B.stats["device_errors"] or device_breaker.state != "closed":
            raise AssertionError(f"{label}: device errors {B.stats}, breaker "
                                 f"{device_breaker.state}")
        say(f"phase {label}: ok in {dt * 1e3:.2f} ms; launches "
            f"{dict(V.launches)}; device_sigs {B.stats['device_sigs']}")
        return result

    run_main(f"commit-{N_SMALL}", "ed25519_verify_dense", small.verify)
    say(f"  (first call: routing probe, device threshold "
        f"{B.device_threshold()})")
    if main_launches["probe_sum_u8"] == 0:
        raise AssertionError("the routing probe never launched")
    phases.reset()
    run_main(f"commit-{N_BIG}", "ed25519_verify_sparse", big.verify)
    seg_sigs = [r["sigs"] for r in phases.recent_segments()]
    want_segs, lo = [], 0
    for k in V._segment_sizes(-(-N_BIG // CHUNK)):
        want_segs.append(min(lo + k * CHUNK, N_BIG) - lo)
        lo += want_segs[-1]
    if seg_sigs != want_segs:
        raise AssertionError(f"segments {seg_sigs}, expected {want_segs}")
    say(f"  segments of {seg_sigs} signatures")
    run_main(f"commit-light-{N_BIG}", "ed25519_verify_sparse",
             big.verify_light)

    stream_items = [(p, m, s if i % 5 else _flip(s, 50, 8))
                    for i, (p, m, s) in enumerate(stream)]

    def stream_verify():
        bv = B.BatchVerifier(plane="votes")
        for p, m, s in stream_items:
            bv.add(Ed25519PubKey(p), m, s)
        return bv.verify()

    all_ok, verdicts = run_main(f"stream-{N_STREAM}", "ed25519_verify_dense",
                                stream_verify)
    if all_ok or verdicts.tolist() != [bool(i % 5) for i in range(N_STREAM)]:
        raise AssertionError("stream verdicts are wrong")

    bad = big.with_signatures(sigs_big[:BAD_IDX]
                              + [_flip(sigs_big[BAD_IDX], 3)]
                              + sigs_big[BAD_IDX + 1:])

    def expect_reject():
        try:
            big.verify(bad)
        except ErrWrongSignature as e:
            return e
        raise AssertionError("the bad-signature commit was accepted")

    err = run_main("commit-bad-sig", "ed25519_verify_sparse", expect_reject)
    if str(err) != str(ErrWrongSignature(
            BAD_IDX, bad.signatures[BAD_IDX].signature)):
        raise AssertionError(f"rejected at the wrong index: {err}")
    say(f"  rejected: {err}")
    say(f"phase main: launches {main_launches}")
    for k, n in main_launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {k}")

    # -- 4. times --------------------------------------------------------------
    vc_small = _wall_s(small.verify, 20)
    vc_big = _wall_s(big.verify, 5)
    rates = {str(N_SMALL): N_SMALL / vc_small, str(N_BIG): N_BIG / vc_big}
    say(f"times: verify_commit {N_SMALL}: {vc_small * 1e3:.3f} ms = "
        f"{rates[str(N_SMALL)]:.0f} sigs/s; {N_BIG}: {vc_big * 1e3:.3f} ms = "
        f"{rates[str(N_BIG)]:.0f} sigs/s ({smi})")
    kernels = []

    # dense at the stream's shape: N_STREAM items, NBLK 2, two chunks
    pks, msgs, sgs = (list(x) for x in zip(*stream_items))
    (bw, nblk, sw), _ = V._pack_stream_dense(pks, msgs, sgs, CHUNK)
    d_args = [torch.from_numpy(x).to(dev) for x in
              (V._as_i32(bw), nblk.astype(np.int32), V._as_i32(sw))]
    d_ms = _time_ms(lambda: V.verify_dense(*d_args, table), dev)
    d_plain = _time_ms(lambda: V.verify_dense_plain(*d_args, table), dev, 1)
    d_bound, d_by = bound(bw.shape[0], bw.nbytes + nblk.nbytes + sw.nbytes
                          + bw.shape[0] + table.numel() * 4)
    # dense at the small commit's shape
    bw1, nb1, sw1, _ = V.prepare_batch(
        [v.pub_key.bytes() for v in small.valset.validators],
        small.commit.vote_sign_bytes_all(CHAIN_ID), small.sigs)
    d1 = [torch.from_numpy(x).to(dev) for x in
          (V._as_i32(bw1), nb1.astype(np.int32), V._as_i32(sw1))]
    d1_ms = _time_ms(lambda: V.verify_dense(*d1, table), dev, 20)
    say(f"times: ed25519_verify_dense {bw.shape[0]} x NBLK {bw.shape[1]}: "
        f"{d_ms:.4f} ms (plain {d_plain:.1f} ms, bound {d_bound:.4f} ms by "
        f"{d_by}); {N_SMALL} x NBLK {bw1.shape[1]}: {d1_ms:.4f} ms ({smi})")
    kernels.append({"name": "ed25519_verify_dense",
                    "shape": f"{bw.shape[0]} items x NBLK {bw.shape[1]}",
                    "launches": main_launches["ed25519_verify_dense"],
                    "max_abs_err": dense_err, "ms": d_ms,
                    "plain_ms": d_plain, "bound_ms": d_bound,
                    "bound_by": d_by, "library_ms": None})

    # sparse at the big commit's segment launches
    cols = big.commit.vote_sign_bytes_columns(CHAIN_ID)
    pk_big = [v.pub_key.bytes() for v in big.valset.validators]
    seg_args, seg_bytes, seg_rows, lo = [], table.numel() * 4, 0, 0
    for k in V._segment_sizes(-(-N_BIG // CHUNK)):
        hi = min(lo + k * CHUNK, N_BIG)
        pk = V.pack_sparse(pk_big[lo:hi], sb_big[lo:hi], sigs_big[lo:hi],
                           CHUNK, columns=cols.slice(lo, hi))
        seg_bytes += sum(a.nbytes for a in pk[:7]) + pk[3].shape[0]
        seg_rows += pk[3].shape[0]
        seg_args.append([torch.from_numpy(np.array(a)).to(dev)
                         for a in pk[:7]])
        lo = hi
    s_ms = _time_ms(lambda: [V.verify_sparse(*a, CHUNK, table)
                             for a in seg_args], dev)
    s_plain = _time_ms(lambda: [V.verify_sparse_plain(*a, CHUNK, table)
                                for a in seg_args], dev, 1)
    s_bound, s_by = bound(seg_rows, seg_bytes)
    say(f"times: ed25519_verify_sparse {N_BIG} in {len(seg_args)} launches "
        f"({seg_sigs}): {s_ms:.4f} ms (plain {s_plain:.1f} ms, bound "
        f"{s_bound:.4f} ms by {s_by}) ({smi})")
    kernels.append({"name": "ed25519_verify_sparse",
                    "shape": f"{N_BIG} items in launches of {seg_sigs}",
                    "launches": main_launches["ed25519_verify_sparse"],
                    "max_abs_err": sparse_err, "ms": s_ms,
                    "plain_ms": s_plain, "bound_ms": s_bound,
                    "bound_by": s_by, "library_ms": None})

    x = torch.from_numpy(np.frombuffer(os.urandom(256 * 128), np.uint8)
                         .reshape(256, 128).copy()).to(dev)
    p_ms = _time_ms(lambda: V.probe_sum(x), dev, 50)
    p_plain = _time_ms(lambda: V.probe_sum_plain(x), dev, 50)
    p_lib = _time_ms(lambda: torch.sum(x, dtype=torch.int32), dev, 50)
    p_ops_s = x.numel() / int32_peak
    p_bytes_s = (x.numel() + 4) / HBM_BYTES_PER_S
    p_bound = max(p_ops_s, p_bytes_s) * 1e3
    p_by = "operations" if p_ops_s >= p_bytes_s else "bytes"
    rt = V.probe_dispatch_seconds(dev)
    say(f"times: probe_sum_u8 32 KB: {p_ms:.4f} ms (plain {p_plain:.4f} ms, "
        f"torch.sum {p_lib:.4f} ms, bound {p_bound:.6f} ms by {p_by}); "
        f"routing round trip {rt * 1e3:.4f} ms ({smi})")
    kernels.append({"name": "probe_sum_u8", "shape": "32768 bytes",
                    "launches": main_launches["probe_sum_u8"],
                    "max_abs_err": probe_err, "ms": p_ms,
                    "plain_ms": p_plain, "bound_ms": p_bound,
                    "bound_by": p_by, "library_ms": p_lib})
    for k in kernels:
        k["route"] = "cuda"
        k["source"] = SOURCES[k["name"]]
        k["replaces"] = TPU_KERNELS[k["name"]]
    return {"kernels": kernels, "verify_commit_sigs_per_s": rates}


def main() -> int:
    if not (ROOT / "tendermint_tpu_torch" / "crypto" / "ed25519_cuda"
            / "csrc" / "verify.cu").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(tendermint_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tendermint_tpu_torch.crypto.ed25519_cuda import build

    t_start = time.perf_counter()
    # -- 1. card --------------------------------------------------------------
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    smi = _nvidia_smi("name,power.limit")
    max_sm_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    say(f"card: {torch.cuda.get_device_name(dev)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {props.multi_processor_count} SMs, max "
        f"SM clock {max_sm_mhz} MHz")
    say(smi)
    t0 = time.perf_counter()
    build.build_all()
    for lib in build.SOURCES:
        build.library(lib)
    for lib, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {lib}: {line.strip()}")
    say(f"phase card: kernels built in {time.perf_counter() - t0:.1f} s")
    int32_peak = (props.multi_processor_count * INT32_LANES_PER_SM
                  * max_sm_mhz * 1e6)

    result = run(dev, smi, int32_peak)
    say(f"card and power limit: {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"verify_commit_sigs_per_s":
                    result["verify_commit_sigs_per_s"], "card": smi}))
    say(json.dumps({"kernels": result["kernels"]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
