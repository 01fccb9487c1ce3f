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
4b. sharded: the sharded verify-and-tally kernel (``ed25519_verify_tally``,
   K8) against its plain version on the big commit's 10,240 signatures
   (every 97th invalid, powers 2^40) as one shard and as four shards of the
   card, the device-profile stub kernels (``stub_verify_dense``, P1/P2, and
   ``stub_verify_sparse``, P3, at 0, 1, 15, 16, 17, 63, 64, 65 and 20,000
   LCG rounds, on the whole pack and on slices from odd rows) and P4
   (``probe_sum_u8`` at 4 MB) against theirs; the latency of one dependent
   LCG round (one warp's chain of unrolled blocks of 256 rounds,
   ``stub_chain``) and, from ``cuobjdump -sass``, the stubs' chains of
   IMADs (the phase fails without cuobjdump); then the paths that run them:
   ``batch_verify_sharded`` over 1 and 4 shards with its exact tally,
   ``entry.dryrun_multichip(1)``, the MultiDeviceStream over two lanes of
   the card (20,480 signatures, verdicts equal to the single-device
   stream's), ``device_profile cost-model`` (P4) and a synthetic scale cell
   (P1-P3); then their times, the stubs' beside their chain floor (rounds
   x the round's latency) and the kernel alone (torch.profiler): the phase
   fails when the kernel alone takes more than 2x the floor.
4c. light: the light client and its serving plane over header chains of
   1,000 Ed25519 validators of equal power (the first 1,000 keys of the
   10,240 commit; headers at heights 1-32, times fixed, never the wall
   clock): ``LightClient(skipping=False)`` from trust height 1 to 32 (the
   trust height's own check, then one ``verify_chain_batched`` batch of
   31,000 signatures whose replay hits the precomputed verdicts 31 times;
   the first call calibrates with the K11 probe); ``LightClient(
   skipping=True)`` over a chain whose set changes at height 17, with a
   ``ServeProvider`` witness that carries a re-signed fork of height 32:
   disarmed it verifies to 32, armed (``lightserve.lying_server``) it
   raises ``DivergenceError``; 256 concurrent ``VerifyCoalescer.submit``
   requests (flush_max 64; seeded spans with duplicates and every
   rejection class: a zeroed signature at index 37, a wrong untrusted set,
   an expired trusted header, the rotated span), each verdict equal to the
   port's ``verify`` run one request at a time on the card, with the
   calibration raced by concurrent flushes and run once; then three
   trusting verifies over a 150-validator bls12381 chain of aggregated
   commits (one ``bls_g2_tree_sum`` launch per aggregate check, nothing in
   the Ed25519 batch). It holds the launches to the route's own counts
   (the trust height one K5 launch after the calibration's three K11
   probes, the range one launch a pipeline segment, bisection one K5
   launch a device batch) and prints which thread, device and stream each
   launch ran on (a flush launches from an executor thread), wall ms,
   signatures or verifies per second, kernel ms, the sequential client's
   host time by part (the store's saves, ``validate_basic``, the batched
   call, the replay) and the launches, which the kernels line adds to
   K5/K6, K7, K11 and K10's.
4d. evidence, votes, ingest (one CryptoMetrics registry wired through
   ``set_crypto_metrics``; the launches go to K5/K6, K7 and K11's rows).
   evidence: 1,000 validators of equal power (the light phase's set)
   apply 8 heights through ``BlockExecutor`` with the kvstore app, an
   ``EvidencePool`` and an ``EventBus`` with one subscriber (the first
   batch calibrates with K11); a lunatic light-client attack (common
   height 4, conflicting 6, signed by 500 of the set), an equivocation
   (both 6), 16 duplicate votes of distinct validators and three
   forgeries (a commit with a zeroed signature at index 400, a bad
   signature, a wrong validator power) go through ``add_evidence``, each
   verdict and error text equal to the port's ``verify_evidence`` on the
   host route (run in the spawn pool); height 9 carries the pending
   evidence, which is then committed, and the subscriber sees one
   NewEvidence per piece. votes: a prevote and a precommit round of the
   10,240 validators (every 97th signature invalid) preverified by 64
   peer tasks through a ``BatchVoteVerifier`` at its defaults (one K5
   launch a device flush, from executor threads), every verdict equal
   to the host spec, then ``VoteSet.add_vote`` over every vote on cache
   hits alone; an armed ``device.vote_flush`` reaches every future of its
   flush and caches nothing; then ``_device_cached``'s ``record_stream``
   under a race on the card (K7 on a side stream, its key buffer evicted
   and overwritten from the default stream). ingest: 5,700 concurrent
   broadcasts (4,500 signed by 500 senders, 500 unsigned, 400 bad
   signatures, 100 malformed, 200 resubmitted) through ``IngestPipeline``
   (batches of 256, 5 ms) into a ``ShardedMempool`` of 5,000 (Tendermint
   v0.34's ``[mempool] size``), each response equal to the scalar path's;
   the reap order; a commit of 1,000 rechecks on the verdict cache; an
   armed ``device.batch_verify`` reaches each broadcast of its flush and
   a resubmission is admitted.
4e. fastsync (``BASELINE.json`` config #5 at its width, 1,000 validators
   of equal power, the light phase's keys; 64 blocks of 256 kvstore txs
   plus the block that carries the last commit, one tx in eight on a key
   another tx of its block also writes): a source node records every
   height's app, results and validators hash; ``verify_commit_light_
   batched`` over 4 windows of 16 (every outcome None; a copy of height
   20's commit with signature #400 zeroed gives ``ErrWrongSignature`` at
   the entry the host route gives; the first call calibrates with K11);
   a fresh node replays the chain through ``BlockchainReactor`` under
   ``execution.version`` v0 and v1 (``bench.py``'s pipeline drive: stage A
   verifies both signature planes of a window in one ``BatchVerifier``
   call, K7 in about two segments, from an executor thread one window
   ahead; ``apply_block``'s ``verify_commit`` hits the precomputed
   verdicts and launches nothing), each height's hashes equal the
   source's, v1 re-executes its conflicts; the card's busy share of one
   window under torch.profiler; then an armed ``device.batch_verify``
   before the first window strikes no peer and redoes nothing (counted on
   ``device_errors_total{reason="injected", plane="light"}``), and a block
   with a flipped LastCommit signature from peer ``evil`` strikes it and
   redoes the height; both syncs complete with the source's hashes.
4f. consensus (``BASELINE.json`` config #4's shape, then configs 2, 3
   and 5's validator sets): the consensus state machine (no WAL), its
   reactor, the mempool reactor and the in-process switch. A: 4 port nodes
   (kvstore, MockPV, a full mesh) run 6 heights while 64 seeded txs go
   into node 0's mempool; every node commits the same block and app hash
   at every height, every tx once, and every seen commit verifies on the
   host spec route; its votes and 4-signature commits stay under the
   device thresholds (launches printed). B: one port node against
   ``tools/validator_stubs.py`` (the other validators sign in the spawn
   pool and act through the wire, as 16 peers of the node) at 150
   validators for 8 heights and 1,000 for 4, 256 kvstore txs a height
   (genesis ``max_gas`` 256; the node gossips no txs): every height
   commits in round 0; K5 launches from vote flushes (executor threads,
   at least one at each size) and from ``validate_block``'s LastCommit
   verify (the loop),
   K11 once for the calibration, no K7; ``crypto_device_errors_total`` 0;
   each LastCommit's verdicts on the card equal the host spec's, the app
   hash the kvstore spec's; heights/s, votes/s, the flushes, the K5
   launches a height and their threads, the ``validate_block`` calls a
   height and the card's busy share of one profiled height. Then an armed
   ``device.vote_flush`` at height 2 of a 150-validator chain: the
   reactor counts one fault and drops its votes, none reaches the host
   miss path, and the chain commits (every flush on the device route
   there; its launches are not counted on the main path).
5. apply: block execution on a 150-validator chain with the Merkle kvstore
   app over an app state of 2^20 keys (BlockExecutor.apply_block ->
   validate_block -> verify_commit on the dense kernel; BeginBlock,
   DeliverTx, EndBlock; Commit -> IncrementalMerkle -> the SHA-256
   kernel). Four seed blocks of 262,144 txs build the state; then two
   insert heights (a full rebuild: 7 kernel launches each) and two update
   heights (the patch path: none) are measured, each split into validate,
   execute and commit+persist, with the merkle root time and the kernel's
   device time inside commit. The last app hash must equal the recursive
   hashlib spec over the whole state.
6. bls: aggregated BLS12-381 commits. The G2-add round
   (``bls_g2_add_round``, K10) against its plain version on 4,096 lanes of
   every lane class and against the curve spec on a sample, the Fq product
   (``bls_fq_mul``) on edge limbs, and the one-launch tree
   (``bls_g2_tree_sum``) against the plain tree on every limb of the root
   at 1, 150, 257, 1,000, 1,024 and 10,000 keys (the most signers of a
   commit) with a doubling and a cancel in the tree; aggregated commits of
   150 and 1,000 validators through verify_commit, verify_commit_light and
   verify_commit_light_trusting (one tree launch each), three commits that
   must be rejected (a wrong aggregate, a sub-quorum bitmap, a single
   signer: the one-key probe, one round); the kernels' times (the
   product's latency alone and the tree's critical path), the
   verify rate on the cuda and scalar routes, and where a verify spends
   its time; then a 150-validator
   bls12381 chain (proof of possession for every genesis key) applied for
   three heights whose LastCommit is an aggregated commit made by the
   VoteSet from 150 MockPV precommits.

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
# 9 MB of 0xFF: a byte sum past 2^31 that the probe's int32 result wraps
PROBE_WRAP_BYTES = 9 << 20

# block execution: BASELINE.json config 2's 150 validators, the node's
# kvstore-merkle app (snapshot every 4 heights), an app state of 2^20 keys
# (16-hex-char keys, 32-hex-char values) built by SEED_BLOCKS blocks, then
# MEASURED_TXS txs at each measured height
APPLY_VALIDATORS = 150
STATE_KEYS = 1 << 20
SEED_BLOCKS = 4
MEASURED_TXS = 4096
MEASURED = (("insert", 2), ("update", 2))
# messages per length when the SHA-256 kernel is held against its plain
# version (the leaf items of this state are 51 bytes with the prefix,
# inner nodes 65)
SHA_CHECK_N = 1 << 17
SHA_CHECK_LENGTHS = (51, 65)
SHA_SPEC_LENGTHS = (0, 55, 56, 63, 64, 65, 119)

# Hopper (H100 SXM): INT32 lanes per SM
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12

# field multiplies and squarings of one verify (the one-thread algorithm;
# the four-lane core computes the same products, spread over its lanes):
#   decompress 7 + pow_p58 262 + 6, [h](-A) 14*9 + 64*(4*8 + 9),
#   [s]B 64*7, final add 9, encode: inversion 265 + 2
FIELD_MULS_PER_VERIFY = (7 + 262 + 6) + (14 * 9 + 64 * (4 * 8 + 9)) \
    + 64 * 7 + 9 + (265 + 2)
# of which squarings: decompress 4 + pow_p58 251, 4 in each of the 256
# doublings, the inversion 254
FIELD_SQS_PER_VERIFY = 4 + 251 + 256 * 4 + 254
# limb products (32x32->64 multiply-adds): 100 a multiply, 55 a squaring
# (csrc/field.cuh fe_sq)
PRODUCTS_PER_VERIFY = (FIELD_MULS_PER_VERIFY - FIELD_SQS_PER_VERIFY) * 100 \
    + FIELD_SQS_PER_VERIFY * 55

# the fewest 32-bit integer instructions of one SHA-256 compression on
# this ISA (a rotate is one funnel shift, a three-input xor, Ch or Maj one
# LOP3, three addends one IADD3): 64 rounds of 14 (Sigma1 3 + 1, Ch 1,
# T1 2, Sigma0 3 + 1, Maj 1, new a 1, new e 1), 48 schedule words of 10
# (sigma0 3 + 1, sigma1 3 + 1, sum 2), 8 final adds. Counting each source
# operation instead (26 a round, 13 a word) gives 2,296, which the kernel
# beats: ptxas fuses them.
SHA256_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8

# aggregated BLS commits: the validator counts users run (BASELINE.json
# config 2; bench.py::bench_aggsig's 1,000), the kernel check's lanes, and
# a 150-validator bls12381 chain over a small app state (phase apply
# already covers 2^20 keys)
BLS_CHAIN_ID = "chip-smoke-bls"
BLS_SIZES = (150, 1000)
BLS_CHECK_LANES = 4096
BLS_APPLY_VALIDATORS = 150
BLS_APPLY_HEIGHTS = 3
BLS_APPLY_TXS = 256
# the kernel's own work: Fq products of a lane that adds two finite
# points (44) or doubles (39), each 300 32x32->64 multiply-adds (CIOS on
# 12 limbs), and 3 lanes of 288 bytes moved per lane (P, Q read, sum
# written); the tree's check sizes; the product levels of one addition
# (its critical path) and the dependent products timed alone
FQ_MULS_ADD = 44
FQ_MULS_DBL = 39
PRODUCTS_PER_FQ_MUL = 300
G2_LANE_BYTES = 288
BLS_TREE_CHECK_SIZES = (1, 150, 257, 1000, 1024, 10000)
G2_PRODUCT_LEVELS = 5
FQ_CHAIN_REPS = 20_000

TPU_KERNELS = {
    "ed25519_verify_dense": (
        "tendermint_tpu/crypto/ed25519_jax/verify.py:83 (_verify_kernel, "
        "K5) + :117 (_verify_stream_kernel, K6)"),
    "ed25519_verify_sparse": (
        "tendermint_tpu/crypto/ed25519_jax/verify.py:173 "
        "(_verify_sparse_stream_kernel + _assemble_blocks, K7)"),
    "probe_sum_u8": "tendermint_tpu/crypto/batch.py:75 (device_threshold "
                    "probe, K11)",
    "sha256_many": "tendermint_tpu/crypto/merkle_fast.py:122 (_device_fn, "
                   "K9)",
    "bls_g2_add_round": "tendermint_tpu/crypto/bls12381/vec.py:285 "
                        "(_g2_add_round over g2_add_vec :227 and mont_mul "
                        ":141, K10)",
    "bls_g2_tree_sum": "tendermint_tpu/crypto/bls12381/vec.py:285 "
                       "(_g2_add_round, K10, one launch a level from "
                       "aggregate_pubkeys_vec :321)",
    "ed25519_verify_tally": (
        "tendermint_tpu/crypto/ed25519_jax/sharded.py:78 (full_step, built "
        "by _sharded_step :66, jit :94, K8)"),
    "stub_verify_dense": (
        "tools/device_profile.py:291-297 (_kern / stub_kernel, P1) + "
        ":299-303 (stub_stream, P2)"),
    "stub_verify_sparse": "tools/device_profile.py:305-317 (stub_sparse, P3)",
    "probe_sum_u8 (P4)": "tools/device_profile.py:357 (touch, P4)",
}
SOURCES = {
    "ed25519_verify_dense":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/verify.cu",
    "ed25519_verify_sparse":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/verify.cu",
    "probe_sum_u8": "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/probe.cu",
    "sha256_many": "tendermint_tpu_torch/crypto/merkle_cuda/csrc/sha256.cu",
    "bls_g2_add_round":
        "tendermint_tpu_torch/crypto/bls12381_cuda/csrc/g2_add.cu",
    "bls_g2_tree_sum":
        "tendermint_tpu_torch/crypto/bls12381_cuda/csrc/g2_add.cu",
    "ed25519_verify_tally":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/tally.cu",
    "stub_verify_dense": "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/stub.cu",
    "stub_verify_sparse":
        "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/stub.cu",
    "probe_sum_u8 (P4)": "tendermint_tpu_torch/crypto/ed25519_cuda/csrc/probe.cu",
}
# the kernels phase main drives (the tally and the stubs have their own
# paths, driven in phase sharded)
MAIN_KERNELS = ("ed25519_verify_dense", "ed25519_verify_sparse",
                "probe_sum_u8")


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


def _i32(x: int) -> int:
    """x mod 2^32 as a signed 32-bit integer (an int32 sum that wraps)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >> 31 else x


def _flip(b: bytes, i: int, bit: int = 1) -> bytes:
    return b[:i] + bytes([b[i] ^ bit]) + b[i + 1:]


# the item counts at which K5-K7 are held against their plain versions:
# groups of four lanes and warps of eight signatures that end ragged, the
# small commit, the stream's shape
RAGGED_NS = (1, 7, 8, 9, N_SMALL, N_STREAM)


def _lane_items(base, adv, n):
    """n items cycling through ``base``, with adversarial class k at
    position p of warp 8k + p (8 signatures a warp) for every class k and
    every p in 0..7."""
    items = [base[i % len(base)] for i in range(n)]
    for k, case in enumerate(adv):
        for p in range(8):
            if 8 * (8 * k + p) + p < n:
                items[8 * (8 * k + p) + p] = case
    return items


def _ptxas_lines(log: str):
    """One line per kernel entry point of an nvcc -Xptxas -v log: its
    registers, stack frame, spill stores and loads, and shared memory."""
    import re

    out, props, entries, name = [], {}, set(), None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entries.add(name)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props[name] = m.groups()
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name in entries:
            stack, st, ld = props.get(name, ("?", "?", "?"))
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append(f"{name}: {m.group(1)} registers, {stack} bytes "
                       f"stack, {st} bytes spill stores, {ld} bytes spill "
                       f"loads, {smem.group(1) if smem else 0} bytes smem")
    return out


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


def run(dev, smi: str, int32_peak: float, signer) -> dict:
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
    products = PRODUCTS_PER_VERIFY

    def bound(n_verify, nbytes):
        ops_s = n_verify * products / int32_peak
        bytes_s = nbytes / HBM_BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    # -- seeded keys, commits and signatures ---------------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
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
    # preimages of three SHA-512 blocks (messages of 176 bytes and up)
    long_jobs = [(seeds_stream[i % 64],
                  bytes(rng.integers(0, 256, 176 + i, dtype="uint8")))
                 for i in range(32)]
    sb_big = big.commit.vote_sign_bytes_all(CHAIN_ID)
    adv_job = [(seeds_stream[0], sb_big[0])]
    sigs = signer.sign(stream_jobs + short_jobs + long_jobs + adv_job)
    workers = signer.workers
    say(f"phase sign: {N_SMALL + N_BIG + 64} keys, "
        f"{N_SMALL + N_BIG + len(sigs)} signatures with {workers} workers in "
        f"{time.perf_counter() - t0:.1f} s")
    sigs_big = big.sigs
    stream = [(pubs_stream[i % 64], m, s)
              for i, ((_, m), s) in enumerate(zip(stream_jobs, sigs))]
    short = [(pubs_stream[i % 64], m, s) for i, ((_, m), s) in
             enumerate(zip(short_jobs, sigs[N_STREAM:]))]
    long_ = [(pubs_stream[i % 64], m, s) for i, ((_, m), s) in
             enumerate(zip(long_jobs, sigs[N_STREAM + 256:]))]
    table = curve.base_table(dev)

    # -- 2. kernels against their plain versions ----------------------------
    # dense: 4,096 items whose warps mix NBLK 1, 2 and 3 (short, 110-byte and
    # long messages), valid, corrupted, and every adversarial class at every
    # position of a warp; held equal to the plain version item by item at
    # each count of RAGGED_NS (prefixes of the batch)
    adv = _adversarial(ed, seeds_stream[0], short[0][1], short[0][2])
    base = []
    for i, (p, m, s) in enumerate(stream):
        if i % 3 == 1:
            s = _flip(s, (7 * i) % 64, 1 << (i % 8))
        elif i % 3 == 2:
            m = _flip(m, i % 110, 4)
        j = i % len(short)
        base += [short[j], (p, m, s), long_[i % len(long_)],
                 (short[j][0], short[j][1], _flip(short[j][2], i % 64,
                                                  1 << (i % 8)))]
    items = _lane_items(base, adv, N_STREAM)
    pks, msgs, sgs = (list(x) for x in zip(*items))
    bw, nblk, sw, ok = V.prepare_batch(pks, msgs, sgs)
    dense_args = [torch.from_numpy(x).to(dev) for x in
                  (V._as_i32(bw), nblk.astype(np.int32), V._as_i32(sw))]
    dense_err = 0
    for n_ in RAGGED_NS:
        part = [x[:n_] for x in dense_args]
        k_np = V.verify_dense(*part, table).cpu().numpy()
        p_np = V.verify_dense_plain(*part, table).cpu().numpy()
        dense_err = max(dense_err,
                        int(np.abs(k_np.astype(np.int64) - p_np).max()))
        if not (k_np == p_np).all():
            raise AssertionError(
                f"ed25519_verify_dense != plain at n={n_}, items "
                f"{np.nonzero(k_np != p_np)[0][:20].tolist()}")
    adv_at = [i for i in (8 * (8 * k + p) + p for k in range(len(adv))
                          for p in range(8)) if i < N_SPARSE_CHECK]
    sample = adv_at + list(range(0, len(items), 13))
    spec = {}

    def spec_of(item):
        if item not in spec:
            spec[item] = ed.verify(*item)
        return spec[item]

    want = [spec_of(items[i]) for i in sample]
    if (k_np & ok)[sample].tolist() != want:
        raise AssertionError("ed25519_verify_dense disagrees with the spec")
    mixed = sum(len(set(nblk[w:w + 8].tolist())) > 1
                for w in range(0, N_STREAM, 8))
    say(f"phase kernels: ed25519_verify_dense == plain on every item at n = "
        f"{', '.join(map(str, RAGGED_NS))} (NBLK {sorted(set(nblk.tolist()))}"
        f" mixed in {mixed} of {N_STREAM // 8} warps; "
        f"{int((k_np & ok).sum())} valid), == spec on {len(sample)} incl. "
        f"{len(adv)} adversarial classes at every position of a warp")

    # sparse: rows of the big commit (every 17th signature flipped) packed in
    # chunks of CHUNK, padded rows included, with every adversarial class at
    # every position of a warp; held equal to the plain version at each
    # count of RAGGED_NS and on the whole
    adv_sp = _adversarial(ed, seeds_stream[0], sb_big[0], sigs[-1])
    sp_items = [(big.valset.validators[i].pub_key.bytes(), sb_big[i],
                 sigs_big[i] if i % 17 else _flip(sigs_big[i], 40, 2))
                for i in range(N_SPARSE_CHECK)]
    sp_items = _lane_items(sp_items, adv_sp, N_SPARSE_CHECK)
    pks, msgs, sgs = (list(x) for x in zip(*sp_items))
    packed = V.pack_sparse(pks, msgs, sgs, CHUNK)
    sp_args = [torch.from_numpy(np.array(x)).to(dev) for x in packed[:7]]
    sparse_err = 0
    for n_ in sorted(set(RAGGED_NS + (sp_args[3].shape[0],))):
        part = [sp_args[0][:-(-n_ // CHUNK)], sp_args[1]] + \
            [x[:n_] for x in sp_args[2:]]
        k_np = V.verify_sparse(*part, CHUNK, table).cpu().numpy()
        p_np = V.verify_sparse_plain(*part, CHUNK, table).cpu().numpy()
        sparse_err = max(sparse_err,
                         int(np.abs(k_np.astype(np.int64) - p_np).max()))
        if not (k_np == p_np).all():
            raise AssertionError(
                f"ed25519_verify_sparse != plain at n={n_}, rows "
                f"{np.nonzero(k_np != p_np)[0][:20].tolist()}")
    verdict = k_np[:N_SPARSE_CHECK] & packed[7]
    expect = [bool(i % 17) for i in range(N_SPARSE_CHECK)]
    for i in adv_at:
        expect[i] = spec_of(sp_items[i])
    sample = list(range(0, N_SPARSE_CHECK, 15)) + [0, 17, 34, 51]
    if verdict[sample].tolist() != [spec_of(sp_items[i]) for i in sample]:
        raise AssertionError("ed25519_verify_sparse disagrees with the spec")
    if verdict.tolist() != expect:
        raise AssertionError("ed25519_verify_sparse: wrong verdicts")
    say(f"phase kernels: ed25519_verify_sparse == plain on every row at n = "
        f"{', '.join(map(str, RAGGED_NS))} and {k_np.shape[0]} "
        f"({packed[1].shape[0]} diff columns, "
        f"{k_np.shape[0] - N_SPARSE_CHECK} padded), every adversarial class "
        f"at every position of a warp, == spec on {len(sample)}")

    # the probe at 32 KB, and on 9 MB of 0xFF, whose sum (2,406,481,920)
    # wraps past 2^31
    probe_err = 0
    for x in (torch.randint(0, 256, (256, 128), dtype=torch.uint8,
                            device=dev),
              torch.full((PROBE_WRAP_BYTES,), 0xFF, dtype=torch.uint8,
                         device=dev)):
        k_sum, p_sum = V.probe_sum(x).item(), V.probe_sum_plain(x).item()
        if not k_sum == p_sum == _i32(int(x.to(torch.int64).sum().item())):
            raise AssertionError(f"probe_sum_u8 at {x.numel()} bytes: "
                                 f"{k_sum} != plain {p_sum}")
        probe_err = max(probe_err, abs(k_sum - p_sum))
        say(f"phase kernels: probe_sum_u8 == plain at {x.numel()} bytes "
            f"({k_sum}) in {V.probe_blocks(x.numel())} blocks")

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
    for k in MAIN_KERNELS:
        if main_launches[k] == 0:
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
    d1_plain = _time_ms(lambda: V.verify_dense_plain(*d1, table), dev, 1)
    d1_bound, d1_by = bound(bw1.shape[0], bw1.nbytes + nb1.nbytes
                            + sw1.nbytes + bw1.shape[0] + table.numel() * 4)
    say(f"times: ed25519_verify_dense {bw.shape[0]} x NBLK {bw.shape[1]}: "
        f"{d_ms:.4f} ms (plain {d_plain:.1f} ms, bound {d_bound:.4f} ms by "
        f"{d_by}); {N_SMALL} x NBLK {bw1.shape[1]}: {d1_ms:.4f} ms (plain "
        f"{d1_plain:.1f} ms, bound {d1_bound:.4f} ms by {d1_by}) ({smi})")
    kernels.append({"name": "ed25519_verify_dense",
                    "shape": f"{bw.shape[0]} items x NBLK {bw.shape[1]}",
                    "launches": main_launches["ed25519_verify_dense"],
                    "max_abs_err": dense_err, "ms": d_ms,
                    "plain_ms": d_plain, "bound_ms": d_bound,
                    "bound_by": d_by, "library_ms": None,
                    f"shape_{N_SMALL}": f"{N_SMALL} items x NBLK "
                                        f"{bw1.shape[1]}",
                    f"ms_{N_SMALL}": d1_ms, f"plain_ms_{N_SMALL}": d1_plain,
                    f"bound_ms_{N_SMALL}": d1_bound,
                    f"bound_by_{N_SMALL}": d1_by})

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
    for a in seg_args:
        k_seg = V.verify_sparse(*a, CHUNK, table)
        sparse_err = max(sparse_err, _same(
            f"ed25519_verify_sparse at {a[3].shape[0]} rows", k_seg,
            V.verify_sparse_plain(*a, CHUNK, table)))
    say(f"phase kernels: ed25519_verify_sparse == plain on every row of the "
        f"{N_BIG}-signature commit's segments ({seg_rows} rows)")
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
    return {"kernels": kernels, "verify_commit_sigs_per_s": rates,
            "big_items": (pk_big, sb_big, sigs_big),
            "keys": [(v.pub_key, big.seed_of[v.address]) for v in
                     big.valset.validators]}


# --- 5b. light: the light client and its serving plane over a header chain
# of 1,000 validators (BASELINE.json config #3) -----------------------------

LIGHT_CHAIN_ID = "chip-smoke-light"
LIGHT_VALIDATORS = 1000
LIGHT_HEIGHTS = 32
LIGHT_ROTATE_AT = 17      # the bisection chain's new set signs from here
LIGHT_KEEP = 300          # validators of the old set kept in the new one
LIGHT_PERIOD_S = 3600.0
LIGHT_DRIFT_S = 10.0
LIGHT_REQUESTS = 256
LIGHT_FLUSH_MAX = 64
LIGHT_SPANS = 96          # distinct honest spans the requests draw from
LIGHT_BAD_HEIGHT = 20
LIGHT_BAD_IDX = 37        # not a multiple of 32: inside a warp
LIGHT_BLS_VALIDATORS = 150
LIGHT_BLS_HEIGHTS = 4
LIGHT_BLS_SPANS = ((1, 3), (1, 4), (2, 4))


class _LaunchLog:
    """Wraps the kernels the light path launches (K5/K6, K7, K11, K10's
    tree) to record, for each launch on the card, the calling thread, the
    current device and stream, and CUDA events around it. Counting stays
    with the wrappers' own ``launches``."""

    def __init__(self):
        from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
        from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V

        self.targets = [(V, "verify_dense", "ed25519_verify_dense"),
                        (V, "verify_sparse", "ed25519_verify_sparse"),
                        (V, "probe_sum", "probe_sum_u8"),
                        (G, "tree_sum", "bls_g2_tree_sum")]
        self.records = []

    def _wrap(self, fn, name):
        import threading

        import torch

        def wrapper(*args, **kw):
            dev = args[0].device
            if dev.type != "cuda":
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.records.append({
                "kernel": name, "thread": threading.current_thread().name,
                "device": str(dev),
                "current_device": torch.cuda.current_device(),
                "stream": torch.cuda.current_stream().cuda_stream,
                "events": (start, end)})
            return out
        return wrapper

    def __enter__(self):
        self._orig = [getattr(m, a) for m, a, _ in self.targets]
        for (m, a, name), fn in zip(self.targets, self._orig):
            setattr(m, a, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self.targets, self._orig):
            setattr(m, a, fn)

    def take(self):
        """The records so far, with each launch's device ms; clears."""
        import torch

        recs, self.records = self.records, []
        if recs:
            torch.cuda.synchronize()
        for r in recs:
            a, b = r.pop("events")
            r["ms"] = a.elapsed_time(b)
        return recs


class _PartClock:
    """Sums the host time spent inside each of ``parts`` (name -> (owner,
    attribute), a module's function or a class's method), counting the
    outermost call only. The parts may nest in one another."""

    def __init__(self, parts):
        self.parts = parts
        self.ms = dict.fromkeys(parts, 0.0)

    def _wrap(self, name, fn):
        depth = [0]

        def wrapper(*args, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    self.ms[name] += (time.perf_counter() - t) * 1e3
        return wrapper

    def __enter__(self):
        self._orig = {n: getattr(o, a) for n, (o, a) in self.parts.items()}
        for n, (o, a) in self.parts.items():
            setattr(o, a, self._wrap(n, self._orig[n]))
        return self

    def __exit__(self, *exc):
        for n, (o, a) in self.parts.items():
            setattr(o, a, self._orig[n])


def _sites(recs) -> str:
    """Where the launches ran: thread names and stream handles, per kernel."""
    out = {}
    for r in recs:
        d = out.setdefault(r["kernel"], {"n": 0, "threads": set(),
                                         "streams": set(), "devices": set()})
        d["n"] += 1
        d["threads"].add(r["thread"])
        d["streams"].add(hex(r["stream"]))
        d["devices"].add(f"{r['device']} (current {r['current_device']})")
    return "; ".join(
        f"{k}: {v['n']} on threads {sorted(v['threads'])}, "
        f"{len(v['streams'])} streams {sorted(v['streams'])[:4]}, devices "
        f"{sorted(v['devices'])}" for k, v in sorted(out.items()))


def run_light(dev, smi: str, signer, keys) -> dict:
    """Phase light: the light client and its serving plane through the
    port's entry points over a header chain of LIGHT_VALIDATORS validators
    of equal power. ``keys`` are (pubkey, seed) of the first validators of
    the big commit. Returns the kernels' launches on this path and a
    summary. Raises on any failed check."""
    import asyncio
    import copy

    import numpy as np

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.crypto import Ed25519PubKey
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.libs.faults import faults
    from tendermint_tpu_torch.light import client as LC
    from tendermint_tpu_torch.light import serve as LS
    from tendermint_tpu_torch.light import verifier as LV
    from tendermint_tpu_torch.light.provider import MockProvider
    from tendermint_tpu_torch.light.store import LightStore
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import ValidatorSet, new_validator
    from tendermint_tpu_torch.types.light_block import LightBlock

    tdevice.set_default_device(dev)
    want_dev = str(tdevice.default_device())
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    os.environ["TMTPU_BLS_BACKEND"] = "cuda"
    rng = np.random.default_rng(SEED + 9)
    t0_ns = commits.BASE_TIME_S * 10**9
    now_ns = t0_ns + 100 * 10**9  # fixed: never the wall clock

    # -- the chains: A signs the sequential chain; the bisection chain
    # shares its heights below 16, and from LIGHT_ROTATE_AT the set B
    # (LIGHT_KEEP of A and new keys) signs
    t = time.perf_counter()
    set_a = ValidatorSet([new_validator(pk, 10) for pk, _ in keys])
    seed_a = {pk.address(): sd for pk, sd in keys}
    new_seeds = commits.seeds(rng, LIGHT_VALIDATORS - LIGHT_KEEP)
    new_pubs = [Ed25519PubKey(p) for p in signer.pubkeys(new_seeds)]
    kept = set_a.validators[:LIGHT_KEEP]
    set_b = ValidatorSet([new_validator(v.pub_key, 10) for v in kept]
                         + [new_validator(p, 10) for p in new_pubs])
    seed_b = {v.address: seed_a[v.address] for v in kept}
    seed_b.update({p.address(): sd for p, sd in zip(new_pubs, new_seeds)})
    ks_a, ks_b = (set_a, seed_a), (set_b, seed_b)
    heights = range(1, LIGHT_HEIGHTS + 1)
    chain = commits.light_chain(signer, LIGHT_CHAIN_ID, lambda h: ks_a,
                                heights, t0_ns)

    def sets2(h):
        return ks_a if h < LIGHT_ROTATE_AT else ks_b

    chain2 = commits.light_chain(
        signer, LIGHT_CHAIN_ID, sets2,
        range(LIGHT_ROTATE_AT - 1, LIGHT_HEIGHTS + 1), t0_ns,
        base={h: chain[h] for h in range(1, LIGHT_ROTATE_AT - 1)})
    # the forgery: a re-signed fork of the top header, which verifies on
    # its own (only a witness cross-check can catch it)
    forged = commits.light_chain(
        signer, LIGHT_CHAIN_ID, sets2, [LIGHT_HEIGHTS], t0_ns,
        base={LIGHT_HEIGHTS - 1: chain2[LIGHT_HEIGHTS - 1]},
        app_hash=b"\xee" * 32)[LIGHT_HEIGHTS]
    n_sigs = LIGHT_VALIDATORS * (2 * LIGHT_HEIGHTS - LIGHT_ROTATE_AT + 3)
    rotated = LIGHT_VALIDATORS - LIGHT_KEEP
    say(f"phase light: {LIGHT_VALIDATORS}-validator chains of "
        f"{LIGHT_HEIGHTS} headers (the second rotates {rotated} validators "
        f"at {LIGHT_ROTATE_AT}) and a forged header: "
        f"{n_sigs} signatures with {signer.workers} workers in "
        f"{time.perf_counter() - t:.1f} s")

    launches = dict.fromkeys(("ed25519_verify_dense", "ed25519_verify_sparse",
                              "probe_sum_u8", "bls_g2_tree_sum"), 0)
    summary = {}

    def count():
        got = {k: (G.launches if k == "bls_g2_tree_sum" else V.launches)[k]
               for k in launches}
        for k, n in got.items():
            launches[k] += n
        return got

    def zero():
        V.reset_launches()
        G.reset_launches()

    def check_sites(label, recs, off_main=False):
        bad = [r for r in recs if r["device"] != want_dev
               or f"cuda:{r['current_device']}" != want_dev]
        if bad:
            raise AssertionError(f"{label}: launches off {want_dev}: "
                                 f"{bad[:3]}")
        if off_main and any(r["thread"] == "MainThread" for r in recs):
            raise AssertionError(f"{label}: a flush launched from the "
                                 "event loop's thread")
        say(f"phase light {label}: launches ran on {_sites(recs)}")

    with _LaunchLog() as log:
        # -- 1. the sequential client: the trust height's own check, then
        # the range in ONE device batch; the replay hits 31 times
        B._calibrated_threshold = None  # the first call calibrates (K11)
        stats0 = dict(B.stats)
        primary = MockProvider(LIGHT_CHAIN_ID, chain)
        witness = MockProvider(LIGHT_CHAIN_ID, chain)
        client = LC.LightClient(
            LIGHT_CHAIN_ID,
            LC.TrustOptions(LIGHT_PERIOD_S, 1,
                            chain[1].signed_header.header.hash()),
            primary, [witness], skipping=False)
        zero()
        log.take()
        parts = _PartClock({
            "store save": (LightStore, "save"),
            "validate_basic": (LightBlock, "validate_basic"),
            "verify_chain_batched": (LV, "verify_chain_batched"),
            "replay": (LV, "verify"),
            "BatchVerifier.verify": (B.BatchVerifier, "verify")})
        with parts:
            t = time.perf_counter()
            asyncio.run(client._initialize())
            t_init = time.perf_counter() - t
            got_init = count()
            zero()
            t = time.perf_counter()
            lb = asyncio.run(client.verify_light_block_at_height(
                LIGHT_HEIGHTS, now_ns=now_ns))
            t_range = time.perf_counter() - t
        got_range = count()
        got = {k: got_init[k] + got_range[k] for k in launches}
        recs = log.take()
        delta = {k: B.stats[k] - stats0[k] for k in B.stats}
        if lb.signed_header.header.hash() != \
                chain[LIGHT_HEIGHTS].signed_header.header.hash():
            raise AssertionError("sequential: wrong header verified")
        if client.store.heights() != list(heights):
            raise AssertionError(f"sequential: stored {client.store.heights()}")
        range_sigs = LIGHT_VALIDATORS * (LIGHT_HEIGHTS - 1)
        if (delta["device_batches"], delta["device_sigs"],
                delta["precomputed_batches"], delta["host_batches"],
                delta["device_errors"]) != (
                2, LIGHT_VALIDATORS + range_sigs, LIGHT_HEIGHTS - 1, 0, 0):
            raise AssertionError(f"sequential: batch stats {delta}, expected "
                                 f"2 device batches of {LIGHT_VALIDATORS} + "
                                 f"{range_sigs} and {LIGHT_HEIGHTS - 1} hits")
        # the trust height's 1,000 fit one chunk: one dense launch after
        # the calibration's three probes. The range's 31,000 go out as
        # whole chunks, one launch a pipeline segment, each segment dense
        # or sparse by the route's own rule
        chunk = 2048
        segs = (len(V._segment_sizes(-(-range_sigs // chunk)))
                if range_sigs >= V.SEG_MIN_SIGS else 1)
        want_init = {"ed25519_verify_dense": 1, "ed25519_verify_sparse": 0,
                     "probe_sum_u8": 3, "bls_g2_tree_sum": 0}
        if got_init != want_init:
            raise AssertionError(f"sequential: the trust height launched "
                                 f"{got_init}, expected {want_init}")
        kinds = (got_range["ed25519_verify_dense"],
                 got_range["ed25519_verify_sparse"])
        if kinds not in ((segs, 0), (0, segs)) or \
                got_range["probe_sum_u8"] or got_range["bls_g2_tree_sum"]:
            raise AssertionError(f"sequential: the range launched "
                                 f"{got_range}, expected {segs} verify "
                                 "launches of one kind")
        route = (f"sparse (K7), {segs} segments" if kinds[1] else
                 f"dense (K5/K6), {segs} segments")
        k_ms = sum(r["ms"] for r in recs if r["kernel"] != "probe_sum_u8")
        wall = t_init + t_range
        split = ", ".join(f"{k} {v:.2f} ms" for k, v in parts.ms.items())
        summary["sequential"] = {
            "init_ms": t_init * 1e3, "range_ms": t_range * 1e3,
            "wall_ms": wall * 1e3,
            "sigs_per_s": (LIGHT_VALIDATORS + range_sigs) / wall,
            "range_sigs_per_s": range_sigs / t_range,
            "kernel_ms": k_ms, "busy": k_ms / (wall * 1e3),
            "launches": got, "launches_trust_height": got_init,
            "launches_range": got_range, "route": route,
            "parts_ms": dict(parts.ms), "threshold": B.device_threshold()}
        say(f"phase light sequential: LightClient(skipping=False) 1 -> "
            f"{LIGHT_HEIGHTS}: trust height {t_init * 1e3:.2f} ms + range of "
            f"{range_sigs} signatures {t_range * 1e3:.2f} ms = "
            f"{wall * 1e3:.2f} ms, "
            f"{summary['sequential']['sigs_per_s']:.0f} sigs/s (range alone "
            f"{summary['sequential']['range_sigs_per_s']:.0f}); kernels "
            f"{k_ms:.4f} ms ({100 * k_ms / (wall * 1e3):.1f}% of the wall); "
            f"device batches 2, precomputed hits {delta['precomputed_batches']}"
            f"; the trust height launched {got_init}, the range {got_range} "
            f"(the {route} route) ({smi})")
        say(f"phase light sequential: host time inside (parts nest: the "
            f"replay runs inside verify_chain_batched, its precomputed hits "
            f"inside BatchVerifier.verify): {split}")
        check_sites("sequential", recs)

        # -- 2. bisection through the rotation, with a lying witness
        def bisect(armed):
            calls = {"verify_adjacent": 0, "verify_non_adjacent": 0}
            orig = {k: getattr(LC, k) for k in calls}

            def counted(k):
                def fn(*a, **kw):
                    calls[k] += 1
                    try:
                        return orig[k](*a, **kw)
                    except Exception as e:
                        fails.append(type(e).__name__)
                        raise
                return fn

            fails = []

            witness = LS.ServeProvider(LIGHT_CHAIN_ID, chain2,
                                       forged={LIGHT_HEIGHTS: forged},
                                       name="lying-witness")
            client = LC.LightClient(
                LIGHT_CHAIN_ID,
                LC.TrustOptions(LIGHT_PERIOD_S, 1,
                                chain2[1].signed_header.header.hash()),
                MockProvider(LIGHT_CHAIN_ID, chain2), [witness],
                skipping=True)
            for k in calls:
                setattr(LC, k, counted(k))
            if armed:
                faults.configure("lightserve.lying_server@1", seed=3)
            t = time.perf_counter()
            try:
                asyncio.run(client.verify_light_block_at_height(
                    LIGHT_HEIGHTS, now_ns=now_ns))
                err = None
            except LC.DivergenceError as e:
                err = e
            finally:
                faults.reset()
                for k, fn in orig.items():
                    setattr(LC, k, fn)
            return (err, time.perf_counter() - t, calls,
                    client.store.heights(), witness, fails)

        def check_batches(label, calls, fails, delta, got):
            """One device batch (one dense launch: at most 1,000 signatures)
            for the trust height, one per adjacent step, two per
            non-adjacent step that passes the trusting check, one per step
            that fails it; nothing on the host."""
            if set(fails) - {"ErrNewValSetCantBeTrusted"}:
                raise AssertionError(f"{label}: steps failed with {fails}")
            want = (1 + calls["verify_adjacent"]
                    + 2 * (calls["verify_non_adjacent"] - len(fails))
                    + len(fails))
            have = (delta["device_batches"], got["ed25519_verify_dense"],
                    got["ed25519_verify_sparse"], delta["host_batches"],
                    delta["precomputed_batches"])
            if have != (want, want, 0, 0, 0):
                raise AssertionError(
                    f"{label}: (device batches, K5, K7, host batches, "
                    f"precomputed hits) = {have}, expected ({want}, {want}, "
                    "0, 0, 0)")
            return want

        zero()
        stats0 = dict(B.stats)
        err, dt, calls, pivots, _w, fails = bisect(armed=False)
        got = count()
        delta = {k: B.stats[k] - stats0[k] for k in B.stats}
        if err is not None or pivots[-1] != LIGHT_HEIGHTS:
            raise AssertionError(f"bisection: {err!r}, trusted {pivots}")
        if LIGHT_ROTATE_AT not in pivots:
            raise AssertionError(f"bisection skipped the rotation: {pivots}")
        batches = check_batches("bisection", calls, fails, delta, got)
        summary["bisection"] = {"wall_ms": dt * 1e3, "verifies": calls,
                                "cant_be_trusted": len(fails),
                                "pivots": pivots, "launches": got}
        say(f"phase light bisection: LightClient(skipping=True) 1 -> "
            f"{LIGHT_HEIGHTS} through the rotation at {LIGHT_ROTATE_AT}: "
            f"verified in {dt * 1e3:.2f} ms; verifies {calls}, of which "
            f"{len(fails)} could not be trusted; trusted pivots {pivots}; "
            f"{batches} device batches; launches {got} ({smi})")
        zero()
        stats0 = dict(B.stats)
        err, dt, calls, pivots, w, fails = bisect(armed=True)
        got = count()
        delta = {k: B.stats[k] - stats0[k] for k in B.stats}
        if not isinstance(err, LC.DivergenceError) or \
                err.height != LIGHT_HEIGHTS or not w.evidence:
            raise AssertionError(f"armed witness: {err!r}, evidence "
                                 f"{w.evidence}")
        check_batches("armed bisection", calls, fails, delta, got)
        summary["bisection_armed"] = {"wall_ms": dt * 1e3,
                                      "verifies": calls, "launches": got}
        say(f"phase light bisection: the armed witness is caught: "
            f"{type(err).__name__}: {err} ({dt * 1e3:.2f} ms, verifies "
            f"{calls}, evidence {len(w.evidence)}; launches {got})")
        check_sites("bisection", log.take())

        # -- 3. coalesced serving: 256 concurrent requests, flush_max 64
        bad = copy.deepcopy(chain[LIGHT_BAD_HEIGHT])
        bad.signed_header.commit.signatures[LIGHT_BAD_IDX].signature = \
            b"\x00" * 64
        bad_chain = dict(chain)
        bad_chain[LIGHT_BAD_HEIGHT] = bad
        w1, w2 = LIGHT_HEIGHTS // 3, 2 * LIGHT_HEIGHTS // 3
        wrong = {h: LightBlock(chain[h].signed_header, set_b)
                 for h in (w1, w2)}
        draws = [tuple(sorted(rng.choice(np.arange(1, LIGHT_HEIGHTS + 1), 2,
                                         replace=False).tolist()))
                 for _ in range(4 * LIGHT_SPANS)]
        pool = list(dict.fromkeys(draws))[:LIGHT_SPANS]
        rows = [("honest", chain, int(a), int(b), LIGHT_PERIOD_S)
                for a, b in (pool[i] for i in rng.integers(
                    0, len(pool), LIGHT_REQUESTS - 64))]
        classes = [
            ("bad-sig adjacent", bad_chain, LIGHT_BAD_HEIGHT - 1,
             LIGHT_BAD_HEIGHT, LIGHT_PERIOD_S),
            ("bad-sig skip", bad_chain, 2, LIGHT_BAD_HEIGHT, LIGHT_PERIOD_S),
            ("wrong set adjacent", wrong, w1 - 1, w1, LIGHT_PERIOD_S),
            ("wrong set skip", wrong, 1, w2, LIGHT_PERIOD_S),
            # headers at t0 + h s, now at t0 + 100 s: a 50 s period has
            # expired every trusted header
            ("expired adjacent", chain, LIGHT_HEIGHTS - 2, LIGHT_HEIGHTS - 1,
             50.0),
            ("expired skip", chain, 2, LIGHT_HEIGHTS - 2, 50.0),
            ("rotated", chain2, 1, LIGHT_HEIGHTS, LIGHT_PERIOD_S),
            ("rotated half", chain2, 1, LIGHT_ROTATE_AT - 1, LIGHT_PERIOD_S),
        ]
        rows += [c for c in classes for _ in range(8)]
        order = rng.permutation(len(rows))
        rows = [rows[i] for i in order]

        def request(row):
            label, blocks, th, h, period = row
            tb = chain2 if blocks is chain2 else chain  # the trusted side
            return LS.VerifyRequest(
                tb[th].signed_header, tb[th].validator_set,
                blocks[h].signed_header, blocks[h].validator_set, period,
                now_ns, LIGHT_DRIFT_S, (1, 3),
                cache_key=(label, th, h, period))

        reqs = [request(r) for r in rows]

        async def serve():
            co = LS.VerifyCoalescer(flush_deadline_s=0.05,
                                    flush_max=LIGHT_FLUSH_MAX)
            tasks = []
            try:
                for r in reqs:
                    tasks.append(asyncio.ensure_future(co.submit(r)))
                    await asyncio.sleep(0)
                return await asyncio.gather(*tasks,
                                            return_exceptions=True), co
            finally:
                co.stop()

        B._calibrated_threshold = None  # concurrent flushes calibrate once
        zero()
        stats0 = dict(B.stats)
        t = time.perf_counter()
        results, co = asyncio.run(serve())
        dt = time.perf_counter() - t
        got = count()
        recs = log.take()
        if got["probe_sum_u8"] != 3:
            raise AssertionError(f"coalesced: {got['probe_sum_u8']} probe "
                                 "launches: the calibration ran more than "
                                 "once (3 round trips)")
        st = co.stats
        if st["device_errors"] or B.stats["device_errors"] != \
                stats0["device_errors"]:
            raise AssertionError(f"coalesced: device errors {st}")
        if B.stats["host_batches"] != stats0["host_batches"]:
            raise AssertionError("coalesced: a batch ran on the host")
        k_ms = sum(r["ms"] for r in recs if r["kernel"] != "probe_sum_u8")
        classes_seen = {}
        # the port's own verify, one request at a time on the same card
        t1 = time.perf_counter()
        scalar = {}
        zero()
        for req, res in zip(reqs, results):
            if req.cache_key not in scalar:
                try:
                    LV.verify(req.trusted_sh, req.trusted_vals,
                              req.untrusted_sh, req.untrusted_vals,
                              req.trusting_period_s, req.now_ns,
                              req.max_clock_drift_s, req.trust_level)
                    scalar[req.cache_key] = None
                except Exception as e:  # the verdict is the exception
                    scalar[req.cache_key] = (type(e).__name__, str(e))
            want = scalar[req.cache_key]
            have = None if res is None else (type(res).__name__, str(res))
            if have != want:
                raise AssertionError(f"coalesced {req.cache_key}: {have} != "
                                     f"one at a time {want}")
            classes_seen.setdefault(req.cache_key[0], set()).add(
                None if want is None else want[0])
        t_scalar = time.perf_counter() - t1
        log.take()  # the comparison's launches
        wants = {"honest": {None}, "bad-sig adjacent": {"ErrInvalidHeader"},
                 "bad-sig skip": {"ErrWrongSignature"},
                 "wrong set adjacent": {"ErrInvalidHeader"},
                 "wrong set skip": {"ErrInvalidHeader"},
                 "expired adjacent": {"ErrOldHeaderExpired"},
                 "expired skip": {"ErrOldHeaderExpired"},
                 "rotated": {"ErrNewValSetCantBeTrusted"},
                 "rotated half": {None}}
        if classes_seen != wants:
            raise AssertionError(f"coalesced verdict classes {classes_seen}")
        summary["coalesced"] = {
            "requests": LIGHT_REQUESTS, "wall_ms": dt * 1e3,
            "verifies_per_s": LIGHT_REQUESTS / dt, "kernel_ms": k_ms,
            "stats": dict(st), "launches": got,
            "one_at_a_time_ms": t_scalar * 1e3,
            "distinct": len(scalar)}
        say(f"phase light coalesced: {LIGHT_REQUESTS} concurrent requests "
            f"({len(scalar)} distinct, every rejection class) in "
            f"{dt * 1e3:.2f} ms = {LIGHT_REQUESTS / dt:.1f} verifies/s; "
            f"flushes {st['flushes']}, largest {st['largest_flush']}, "
            f"batched sigs {st['batched_sigs']}, coalesced_dupes "
            f"{st['coalesced_dupes']}, verdict cache hits "
            f"{st['verdict_cache_hits']}; kernel event pairs {k_ms:.4f} ms "
            f"(they overlap across concurrent flushes); launches {got}; "
            f"every verdict == the port's verify one request at a time on "
            f"the card ({t_scalar * 1e3:.0f} ms for {len(scalar)}) ({smi})")
        check_sites("coalesced", recs, off_main=True)

        # -- the BLS spans: aggregated commits pair inline, one tree launch
        # per aggregate check, nothing in the Ed25519 batch
        t = time.perf_counter()
        fx = commits.BlsCommitFixture(signer, rng, LIGHT_BLS_VALIDATORS,
                                      LIGHT_CHAIN_ID + "-bls", 1)
        bls_chain = commits.bls_light_chain(
            fx, range(1, LIGHT_BLS_HEIGHTS + 1), t0_ns)
        say(f"phase light bls: a {LIGHT_BLS_VALIDATORS}-validator bls12381 "
            f"chain of {LIGHT_BLS_HEIGHTS} aggregated commits in "
            f"{time.perf_counter() - t:.1f} s")
        breqs = [LS.VerifyRequest(
            bls_chain[a].signed_header, bls_chain[a].validator_set,
            bls_chain[b].signed_header, bls_chain[b].validator_set,
            LIGHT_PERIOD_S, now_ns, LIGHT_DRIFT_S, (1, 3))
            for a, b in LIGHT_BLS_SPANS]

        async def serve_bls():
            co = LS.VerifyCoalescer(flush_deadline_s=0.05,
                                    flush_max=len(breqs))
            try:
                return await asyncio.gather(
                    *[co.submit(r) for r in breqs]), co
            finally:
                co.stop()

        zero()
        t = time.perf_counter()
        bres, bco = asyncio.run(serve_bls())
        dt = time.perf_counter() - t
        got = count()
        checks = sum(1 if b == a + 1 else 2 for a, b in LIGHT_BLS_SPANS)
        if bres != [None] * len(breqs):
            raise AssertionError(f"bls spans rejected: {bres}")
        if got["bls_g2_tree_sum"] != checks or G.launches[
                "bls_g2_add_round"] or bco.stats["batched_sigs"]:
            raise AssertionError(
                f"bls spans: {got} tree launches for {checks} aggregate "
                f"checks, batched sigs {bco.stats['batched_sigs']}")
        recs = log.take()
        summary["bls"] = {"spans": LIGHT_BLS_SPANS, "wall_ms": dt * 1e3,
                          "tree_launches": got["bls_g2_tree_sum"]}
        say(f"phase light bls: {len(breqs)} trusting verifies "
            f"{list(LIGHT_BLS_SPANS)} accepted in {dt * 1e3:.2f} ms, one "
            f"flush, batched sigs 0; bls_g2_tree_sum launches "
            f"{got['bls_g2_tree_sum']} = one per aggregate check ({checks})")
        check_sites("bls", recs, off_main=True)
    say(f"phase light: launches on the main path {launches}")
    return {"launches": launches, "summary": summary}


# --- 4d. the evidence pool, the event bus, the live-vote micro-batcher and
# the mempool ingest plane on K5/K7 -------------------------------------------

EVIDENCE_CHAIN_ID = "chip-smoke-evidence"
EVIDENCE_VALIDATORS = 1000   # BASELINE.json config #3's set (LIGHT_VALIDATORS)
EVIDENCE_HEIGHTS = 8
EVIDENCE_TXS = 16            # kvstore txs a height
LCA_LUNATIC = (4, 6)         # (common, conflicting) heights
LCA_LUNATIC_SIGNERS = 500    # the lunatic header's set: the first 500
LCA_EQUIVOCATION = 6         # common = conflicting
LCA_FORGED = 7               # an equivocation whose commit is forged ...
LCA_BAD_IDX = 400            # ... by a zeroed signature inside 2/3 of power
DUPLICATE_VOTES = 16
VOTE_CHAIN_ID = "chip-smoke-votes"
VOTE_HEIGHT = 5
VOTE_PEERS = 64
VOTE_INVALID_EVERY = 97
VOTE_FAULT_VOTES = 64
# the mempool at Tendermint v0.34's config.toml defaults ([mempool] size,
# cache_size); the pipeline at the JAX package's (batch_max 256, 5 ms)
INGEST_SIZE = 5000
INGEST_CACHE = 10000
INGEST_SENDERS = 500
INGEST_VALID = 4500
INGEST_UNSIGNED = 500
INGEST_BAD_SIG = 400
INGEST_MALFORMED = 100
INGEST_DUPS = 200
INGEST_COMMIT = 1000
INGEST_FAULT_TXS = 256
# ROADMAP §3 item 2: the side stream spins this long before K7 reads the
# cached keys (~0.5 s at 1,980 MHz)
RS_SLEEP_CYCLES = 1_000_000_000


def _outcome(fn):
    """None, or (exception class name, str): a verdict under comparison."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the verdict IS the exception
        return type(e).__name__, str(e)
    return None


def _evidence_outcome(job):
    """Spawn-pool worker: ``validate_basic`` then the port's
    ``verify_evidence`` on the host route (``TMTPU_BATCH_BACKEND=host``)
    over one encoded evidence item, against the chain's headers and
    validator sets (encoded, by height). None or (class, text)."""
    from types import SimpleNamespace

    os.environ["TMTPU_BATCH_BACKEND"] = "host"
    from tendermint_tpu_torch.evidence import verify_evidence
    from tendermint_tpu_torch.types.block import Header
    from tendermint_tpu_torch.types.evidence import decode_evidence
    from tendermint_tpu_torch.types.params import EvidenceParams
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    ev_bytes, chain_id, height, time_ns, params, vals, headers = job
    ev = decode_evidence(ev_bytes)
    vsets = {h: ValidatorSet.decode(b) for h, b in vals.items()}
    metas = {h: SimpleNamespace(header=Header.decode(b))
             for h, b in headers.items()}
    state = SimpleNamespace(
        chain_id=chain_id, last_block_height=height,
        last_block_time_ns=time_ns,
        consensus_params=SimpleNamespace(evidence=EvidenceParams(*params)))
    store = SimpleNamespace(load_validators=vsets.get,
                            load_block_meta=metas.get, height=lambda: height)

    def check():
        ev.validate_basic()
        verify_evidence(ev, state, store, store)
    return _outcome(check)


def run_evidence(dev, smi: str, signer, keys) -> dict:
    """Phase evidence: a chain of EVIDENCE_VALIDATORS validators of equal
    power (``keys``: (pubkey, seed) of the big commit's first validators)
    applied for EVIDENCE_HEIGHTS heights through ``BlockExecutor`` with the
    kvstore app, an ``EvidencePool`` and an ``EventBus`` with one
    subscriber; then two light-client attacks, DUPLICATE_VOTES duplicate
    votes and three forgeries through ``EvidencePool.add_evidence``, each
    verdict held against the port's ``verify_evidence`` on the host route
    (in the spawn pool); then the next height carries the pending
    evidence. Returns the kernels' launches and a summary. Raises on any
    failed check."""
    import dataclasses

    import numpy as np

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.abci.example.kvstore import KVStoreApplication
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                            state_from_genesis)
    from tendermint_tpu_torch.state.execution import NoOpMempool
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                            GenesisValidator, ValidatorSet,
                                            new_validator)
    from tendermint_tpu_torch.types import events as tme
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.event_bus import EventBus

    tdevice.set_default_device(dev)
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    rng = np.random.default_rng(SEED + 10)
    t0_ns = commits.BASE_TIME_S * 10**9
    seed_of = {pk.address(): sd for pk, sd in keys}
    conns = AppConns(local_client_creator(KVStoreApplication()))
    conns.start()
    state_store, block_store = StateStore(MemDB()), BlockStore(MemDB())
    pool = EvidencePool(MemDB(), state_store, block_store)
    bus = EventBus()
    sub = bus.subscribe("chip-smoke", "tm.event EXISTS", out_capacity=1 << 16)
    executor = BlockExecutor(state_store, conns.consensus, NoOpMempool(),
                             pool, block_store, event_bus=bus)
    state = state_from_genesis(GenesisDoc(
        chain_id=EVIDENCE_CHAIN_ID, genesis_time_ns=t0_ns,
        validators=[GenesisValidator(pk, 10) for pk, _ in keys]))
    state_store.save(state)
    pool.set_state(state)
    chain = {"state": state, "last": Commit(0, 0, BlockID(), [])}
    steps = {}

    def apply(h, block=None, parts=None):
        st = chain["state"]
        if block is None:
            txs = [b"e%d-%02d=%s" % (h, i, rng.bytes(8).hex().encode())
                   for i in range(EVIDENCE_TXS)]
            block, parts = st.make_block(
                h, txs, chain["last"], [],
                st.validators.get_proposer().address)
        bid = BlockID(block.hash(), parts.header())
        t = time.perf_counter()
        chain["state"], _ = executor.apply_block(st, bid, block)
        steps[f"apply {h}"] = (time.perf_counter() - t) * 1e3
        stamps = [block.header.time_ns + 1_000_000 * (i + 1)
                  for i in range(st.validators.size())]
        chain["last"] = commits.sign_commit(
            signer, seed_of, st.validators, EVIDENCE_CHAIN_ID, h, bid,
            stamps)
        block_store.save_block(block, parts, chain["last"])
        return block

    # the first batch of the phase calibrates (K11), as a node's first
    # batch does
    B._calibrated_threshold = None
    V.reset_launches()
    errors0 = B.stats["device_errors"]
    t = time.perf_counter()
    for h in range(1, EVIDENCE_HEIGHTS + 1):
        apply(h)
    chain_launches = dict(V.launches)
    say(f"phase evidence: {EVIDENCE_HEIGHTS} heights of {EVIDENCE_TXS} txs "
        f"over {EVIDENCE_VALIDATORS} validators applied in "
        f"{time.perf_counter() - t:.1f} s with signing (apply_block ms "
        f"{[round(steps[f'apply {h}'], 2) for h in range(1, 9)]}); launches "
        f"{chain_launches} ({smi})")

    # -- the evidence -------------------------------------------------------
    t = time.perf_counter()
    vals = {h: state_store.load_validators(h)
            for h in range(1, EVIDENCE_HEIGHTS + 1)}
    metas = {h: block_store.load_block_meta(h)
             for h in range(1, EVIDENCE_HEIGHTS + 1)}
    common, conflicting = LCA_LUNATIC
    lunatic_set = ValidatorSet([new_validator(v.pub_key, 10) for v in
                                vals[common].validators[:LCA_LUNATIC_SIGNERS]])

    def attack(keyset, height, common_h, app_hash):
        return commits.light_client_attack(
            signer, EVIDENCE_CHAIN_ID, (keyset, seed_of), height, common_h,
            t0_ns, vals[common_h].total_voting_power(),
            metas[common_h].header.time_ns, app_hash)

    lunatic = attack(lunatic_set, conflicting, common, b"\xee" * 32)
    equivocation = attack(vals[LCA_EQUIVOCATION], LCA_EQUIVOCATION,
                          LCA_EQUIVOCATION, b"\xdd" * 32)
    forged = attack(vals[LCA_FORGED], LCA_FORGED, LCA_FORGED, b"\xcc" * 32)
    fc = forged.conflicting_block.signed_header.commit
    fc.signatures[LCA_BAD_IDX] = dataclasses.replace(
        fc.signatures[LCA_BAD_IDX], signature=bytes(64))
    # 18 distinct validators (53 is prime to the set's size)
    items = [(2 + k % 6, (11 + 53 * k) % len(keys),
              metas[2 + k % 6].header.time_ns)
             for k in range(DUPLICATE_VOTES + 2)]
    dves = commits.duplicate_vote_evidence(signer, seed_of, vals[1],
                                           EVIDENCE_CHAIN_ID, items, rng)
    bad_sig, bad_power = dves[DUPLICATE_VOTES:]
    s = bad_sig.vote_b.signature
    bad_sig.vote_b.signature = s[:5] + bytes([s[5] ^ 1]) + s[6:]
    bad_power.validator_power = 11
    cases = ([("lunatic", lunatic), ("equivocation", equivocation)]
             + [(f"duplicate_vote {k}", e)
                for k, e in enumerate(dves[:DUPLICATE_VOTES])]
             + [("forged commit", forged), ("forged signature", bad_sig),
                ("forged power", bad_power)])
    say(f"phase evidence: {len(cases)} pieces of evidence signed in "
        f"{time.perf_counter() - t:.1f} s")

    got, per_step = [], {}
    for name, ev in cases:
        before = dict(V.launches)
        t = time.perf_counter()
        got.append(_outcome(lambda: pool.add_evidence(ev)))
        per_step[name] = ((time.perf_counter() - t) * 1e3,
                          {k: V.launches[k] - before[k] for k in before
                           if V.launches[k] != before[k]})
    # the reference: the port's own verify_evidence on the host route, in
    # the pool (a 1,000-signature commit is seconds of pure-Python verify)
    t = time.perf_counter()
    st = chain["state"]
    ev_params = st.consensus_params.evidence
    jobs = [(ev.wrapped(), EVIDENCE_CHAIN_ID, st.last_block_height,
             st.last_block_time_ns,
             (ev_params.max_age_num_blocks, ev_params.max_age_duration_ns,
              ev_params.max_bytes),
             {h: v.encode() for h, v in vals.items()},
             {h: m.header.encode() for h, m in metas.items()})
            for _, ev in cases]
    want = signer.run(_evidence_outcome, jobs)
    ref_s = time.perf_counter() - t
    for (name, _), g, w in zip(cases, got, want):
        if g != w:
            raise AssertionError(f"evidence {name}: the card's verdict {g} "
                                 f"!= the host route's {w}")
    n_valid = len(cases) - 3
    if any(g is not None for g in got[:n_valid]) or \
            any(g is None for g in got[n_valid:]):
        raise AssertionError(f"evidence verdicts: {got}")
    for name, (ms, launched) in per_step.items():
        if not name.startswith("duplicate_vote"):
            say(f"phase evidence {name}: {ms:.2f} ms, launches {launched}; "
                f"verdict {dict(zip([c[0] for c in cases], got))[name]}")
    dv_ms = [per_step[f"duplicate_vote {k}"][0]
             for k in range(DUPLICATE_VOTES)]
    dv_launched = [per_step[f"duplicate_vote {k}"][1]
                   for k in range(DUPLICATE_VOTES)]
    if any(dv_launched):
        raise AssertionError(f"a duplicate vote's two signatures went to "
                             f"the device: {dv_launched}")
    say(f"phase evidence: {DUPLICATE_VOTES} duplicate votes accepted, "
        f"median {statistics.median(dv_ms):.2f} ms each on the host route "
        f"(2 signatures, under the break-even threshold "
        f"{B.device_threshold()}); every verdict equal to the host route's "
        f"verify_evidence (the spawn pool, {ref_s:.1f} s)")

    # -- the next height carries the pending evidence -----------------------
    pending, _ = pool.pending_evidence(-1)
    if len(pending) != n_valid:
        raise AssertionError(f"pending evidence {len(pending)} != {n_valid}")
    h = EVIDENCE_HEIGHTS + 1
    st = chain["state"]
    t = time.perf_counter()
    block, parts = executor.create_proposal_block(
        h, st, chain["last"], st.validators.get_proposer().address)
    steps["propose"] = (time.perf_counter() - t) * 1e3
    if sorted(e.hash() for e in block.evidence) != \
            sorted(e.hash() for _, e in cases[:n_valid]):
        raise AssertionError("the proposal does not carry the pending "
                             "evidence")
    before = dict(V.launches)
    apply(h, block, parts)
    committed = [pool.is_committed(e) and not pool.is_pending(e)
                 for _, e in cases[:n_valid]]
    if not all(committed) or pool.pending_evidence(-1)[0]:
        raise AssertionError(f"evidence not committed: {committed}")
    events = []
    while not sub.queue.empty():
        events.append(sub.queue.get_nowait())
    kinds = [m.events[tme.EVENT_TYPE_KEY][-1] for m in events]
    # height h's proposal reaps no txs (the executor's mempool is empty)
    want_kinds = (["NewBlock", "NewBlockHeader"] + ["Tx"] * EVIDENCE_TXS) \
        * EVIDENCE_HEIGHTS + ["NewBlock", "NewBlockHeader"] \
        + ["NewEvidence"] * n_valid
    if kinds != want_kinds or [m.data.evidence.hash() for m in events
                               if m.events["tm.event"][-1] == "NewEvidence"
                               ] != [e.hash() for e in block.evidence]:
        raise AssertionError(f"events: {kinds}")
    launches = dict(V.launches)
    if B.stats["device_errors"] != errors0:
        raise AssertionError(f"device errors: {B.stats}")
    if launches["ed25519_verify_dense"] == 0 or launches["probe_sum_u8"] == 0:
        raise AssertionError(f"phase evidence never launched K5/K11: "
                             f"{launches}")
    block_kb = len(parts.get_reader()) / 1e3
    say(f"phase evidence: height {h} carries {n_valid} pieces of evidence "
        f"({block_kb:.1f} kB block): propose {steps['propose']:.2f} ms, "
        f"apply_block {steps[f'apply {h}']:.2f} ms (check_evidence finds "
        f"them pending: launches {({k: launches[k] - before[k] for k in launches})}); "
        f"all committed; the subscriber got {len(events)} events "
        f"({kinds.count('NewEvidence')} NewEvidence, {kinds.count('Tx')} "
        f"Tx, {kinds.count('NewBlock')} NewBlock) ({smi})")
    say(f"phase evidence: launches on the main path {launches}")
    per_lca = {n: per_step[n][1] for n in ("lunatic", "equivocation",
                                           "forged commit")}
    return {"launches": launches, "summary": {
        "validators": EVIDENCE_VALIDATORS, "pieces": len(cases),
        "lca_launches": per_lca,
        "lca_ms": {n: per_step[n][0] for n in per_lca},
        "duplicate_vote_median_ms": statistics.median(dv_ms),
        "apply_ms": {k: v for k, v in steps.items()}, "card": smi}}


def record_stream_check(dev) -> dict:
    """ROADMAP §3 item 2 on the card: K7 reads a key buffer from
    ``_device_cached`` on a side stream (busy first, so the read comes
    late) while the default stream evicts it (32 new keys fill the cache)
    and allocates and overwrites tensors of its size. Run twice, with
    ``Tensor.record_stream`` and with it made a no-op. The default
    stream's pool is first filled up to a fresh segment, so the freed
    block is the only free block of its size there and the next
    allocation of that size takes it unless ``record_stream`` holds it
    back. With it: the block is not reused and the verdicts equal the
    plain version's. Without it: the block is reused by the next key and
    the verdicts differ. Raises unless both hold and the side stream was
    busy at the overwrite in both runs."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.ed25519_cuda import curve
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V

    rng = np.random.default_rng(SEED + 13)
    base = bytes(rng.integers(0, 256, 110, dtype=np.uint8))
    pks, msgs, sigs = [], [], []
    for i in range(24):
        priv, pub = ed.keygen(bytes([i + 1]) * 32)
        m = bytearray(base)
        m[50], m[77] = i, (3 * i) % 256
        sig = ed.sign(priv, bytes(m))
        if i % 5 == 2:
            sig = sig[:9] + bytes([sig[9] ^ 1]) + sig[10:]
        pks.append(pub)
        msgs.append(bytes(m))
        sigs.append(sig)
    packed = V.pack_sparse(pks, msgs, sigs, 8)
    pk_arr = packed[5]
    table = curve.base_table(dev)
    fresh = [torch.from_numpy(np.array(x)).to(dev) for x in packed[:7]]
    want = V.verify_sparse_plain(*fresh, 8, table).cpu().tolist()
    spec = [ed.verify(*c) for c in zip(pks, msgs, sigs)]
    if [a and b for a, b in zip(want[:24], packed[7])] != spec:
        raise AssertionError("record_stream check: plain != spec")
    del fresh

    def fill_default_pool() -> list:
        # allocations of the key buffer's size on the default stream until
        # the allocator takes a new segment: no free block of that size is
        # left in the default stream's pool before the buffer is made
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # also settles every pending stream event
        held, reserved = [], torch.cuda.memory_reserved(dev)
        while torch.cuda.memory_reserved(dev) == reserved:
            held.append(torch.empty(pk_arr.nbytes, dtype=torch.uint8,
                                    device=dev))
            if len(held) > 4_000_000:
                raise AssertionError("record_stream check: the default "
                                     "pool never took a new segment")
        return held

    def once(keep_record: bool):
        orig = torch.Tensor.record_stream
        if not keep_record:
            torch.Tensor.record_stream = lambda self, stream: None
        try:
            V._PK_DEVICE_CACHE.clear()
            side = torch.cuda.Stream(dev)
            # warm the side stream's pool and the pinned host blocks of
            # these sizes: a cudaMalloc or cudaHostAlloc in the raced part
            # would synchronize the device and close the race window
            with torch.cuda.stream(side):
                warm, _ = V.prepare_sparse_stream(pks, msgs, sigs, 8,
                                                  device=dev)
                warm_out = V.verify_sparse(*warm, 8, table)
            side.synchronize()
            del warm, warm_out
            V._PK_DEVICE_CACHE.clear()
            held = fill_default_pool()
            # the key buffer, allocated on the default stream
            ptr = V._device_cached(pk_arr, dev).data_ptr()
            with torch.cuda.stream(side):
                torch.cuda._sleep(RS_SLEEP_CYCLES)
                args, _ = V.prepare_sparse_stream(pks, msgs, sigs, 8,
                                                  device=dev)  # a hit
                out = V.verify_sparse(*args, 8, table)
            del args
            for i in range(V._PK_CACHE_MAX):  # evicts the key buffer
                V._device_cached(np.full_like(pk_arr, i + 1), dev)
            junk = [torch.full((pk_arr.nbytes,), 0xA5, dtype=torch.uint8,
                               device=dev) for _ in range(64)]
            busy = not side.query()
            after = [t.data_ptr() for t in V._PK_DEVICE_CACHE.values()]
            after += [t.data_ptr() for t in junk]
            side.synchronize()
        finally:
            torch.Tensor.record_stream = orig
        reused = any(p < ptr + pk_arr.nbytes and ptr < p + pk_arr.nbytes
                     for p in after)
        del junk, held
        V._PK_DEVICE_CACHE.clear()
        return out.cpu().tolist() == want, busy, reused

    equal, busy, reused = once(True)
    equal_without, busy_without, reused_without = once(False)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    out = {"equal": equal, "side_busy": busy, "reused": reused,
           "equal_without_record_stream": equal_without,
           "side_busy_without": busy_without,
           "reused_without_record_stream": reused_without}
    say(f"record_stream check: K7 on a side stream over a cached key buffer "
        f"evicted from the default stream: with record_stream the block "
        f"was {'REUSED' if reused else 'not reused'} while the side stream "
        f"ran (busy {busy}) and the verdicts "
        f"{'equal' if equal else 'DIFFER FROM'} the plain version's; with "
        f"record_stream a no-op the block was "
        f"{'reused' if reused_without else 'NOT REUSED'} (busy "
        f"{busy_without}) and the verdicts "
        f"{'STILL EQUAL' if equal_without else 'differ'}")
    if not (busy and busy_without):
        raise AssertionError(f"record_stream check: the side stream was "
                             f"idle before the overwrite: {out}")
    if reused or not equal:
        raise AssertionError(f"record_stream check: K7 read an evicted, "
                             f"reused key buffer: {out}")
    if not reused_without or equal_without:
        raise AssertionError(f"record_stream check: without record_stream "
                             f"the race did not show: {out}")
    return out


def run_votes(dev, smi: str, signer, keys) -> dict:
    """Phase votes: a prevote and a precommit round of all ``keys``
    (10,240 validators, every VOTE_INVALID_EVERY-th signature invalid)
    through a ``BatchVoteVerifier`` at the JAX package's defaults,
    preverified by VOTE_PEERS peer tasks in a seeded order, then a
    ``VoteSet`` whose verifier is the batcher adds every vote; then an
    armed ``device.vote_flush`` and the record_stream check. Returns the
    kernels' launches and a summary. Raises on any failed check."""
    import asyncio

    import numpy as np
    import torch

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto import vote_batcher as VB
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.libs.faults import InjectedFault, faults
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import (BlockID, PartSetHeader,
                                            SignedMsgType, ValidatorSet,
                                            VoteSet, new_validator)
    from tendermint_tpu_torch.types.errors import ErrVoteInvalidSignature
    from tendermint_tpu_torch.types.vote import Vote

    tdevice.set_default_device(dev)
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    rng = np.random.default_rng(SEED + 11)
    t = time.perf_counter()
    seed_of = {pk.address(): sd for pk, sd in keys}
    valset = ValidatorSet([new_validator(pk, 10) for pk, _ in keys])
    n = valset.size()
    bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    base_ns = commits.BASE_TIME_S * 10**9 + VOTE_HEIGHT * 10**9
    kinds = (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT)
    votes = {k: [Vote(k, VOTE_HEIGHT, 0, bid,
                      base_ns + 1_000 * i + 500 * int(k == kinds[1]),
                      v.address, i)
                 for i, v in enumerate(valset.validators)] for k in kinds}
    # validator-major: a worker derives each key once for both votes
    jobs = [(seed_of[valset.validators[i].address],
             votes[k][i].sign_bytes(VOTE_CHAIN_ID))
            for i in range(n) for k in kinds]
    sigs = iter(signer.sign(jobs))
    for i in range(n):
        for k in kinds:
            sig = next(sigs)
            if i % VOTE_INVALID_EVERY == 0:
                sig = sig[:32] + bytes(32)
            votes[k][i].signature = sig
    rows = {k: [(valset.validators[i].pub_key,
                 votes[k][i].sign_bytes(VOTE_CHAIN_ID), votes[k][i].signature)
                for i in range(n)] for k in kinds}
    say(f"phase votes: {2 * n} votes of {n} validators signed in "
        f"{time.perf_counter() - t:.1f} s")

    bv = VB.BatchVoteVerifier()
    flushes = []
    run_flush = bv._run_flush

    async def counted(batch):
        flushes.append(len(batch))
        return await run_flush(batch)

    bv._run_flush = counted

    async def peer(items):
        # the reactor's receive: one detached preverify task a vote
        tasks = []
        for i, (pub, msg, sig) in items:
            tasks.append((i, asyncio.ensure_future(
                bv.preverify(pub, msg, sig))))
            await asyncio.sleep(0)
        return [(i, await f) for i, f in tasks]

    async def round_(items):
        order = rng.permutation(n)
        per_peer = [[(int(i), items[int(i)]) for i in order[p::VOTE_PEERS]]
                    for p in range(VOTE_PEERS)]
        out = [None] * n
        for part in await asyncio.gather(*(peer(x) for x in per_peer)):
            for i, ok in part:
                out[i] = ok
        return out

    V.reset_launches()
    errors0 = B.stats["device_errors"]
    verdicts, summary = {}, {"rounds": {}}
    with _LaunchLog() as log:
        for k in kinds:
            label = k.name.lower()
            f0, st0 = len(flushes), dict(bv.stats)
            launches0 = dict(V.launches)
            # the precommit round runs under torch.profiler (device
            # activity only): the card's busy time over the round's wall
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) \
                if k == kinds[1] else None
            if prof is not None:
                prof.start()
            t = time.perf_counter()
            verdicts[k] = asyncio.run(round_(rows[k]))
            wall = time.perf_counter() - t
            busy_ms = None
            if prof is not None:
                prof.stop()
                busy_ms = _device_busy_ms(prof)
            sizes = flushes[f0:]
            dev_sizes = [x for x in sizes if x >= bv.min_device_batch]
            d = {s: bv.stats[s] - st0.get(s, 0) for s in bv.stats}
            k5 = V.launches["ed25519_verify_dense"] - \
                launches0["ed25519_verify_dense"]
            if (sum(sizes) != n or d.get("device_batches", 0) != len(dev_sizes)
                    or d.get("device_sigs", 0) != sum(dev_sizes)
                    or d.get("host_sigs", 0) != n - sum(dev_sizes)
                    or d.get("device_errors", 0) or k5 != len(dev_sizes)
                    or V.launches["ed25519_verify_sparse"]):
                raise AssertionError(
                    f"votes {label}: flushes {sizes}, stats {d}, K5 {k5}, "
                    f"launches {V.launches}")
            rate = n / wall
            busy = "" if prof is None else (
                "; under torch.profiler: the card busy not measured (the "
                "trace shows no device time)" if busy_ms is None else
                f"; under torch.profiler: the card busy {busy_ms:.4f} ms "
                f"= {100 * busy_ms / (wall * 1e3):.2f}% of the wall")
            say(f"phase votes {label}: {n} votes preverified by "
                f"{VOTE_PEERS} peers in {wall * 1e3:.2f} ms = {rate:.0f} "
                f"votes/s; {len(sizes)} flushes ({len(dev_sizes)} on the "
                f"device, one K5 launch each; sizes min {min(sizes)}, "
                f"median {statistics.median(sizes)}, max {max(sizes)})"
                f"{busy} ({smi})")
            # the state machine's VoteSet next, as consensus does: every
            # vote a cache hit (the cache keeps the newest 16,384 verdicts)
            vset = VoteSet(VOTE_CHAIN_ID, VOTE_HEIGHT, 0, k, valset,
                           verifier=bv)
            st0 = dict(bv.stats)
            refused = 0
            t = time.perf_counter()
            for v in votes[k]:
                try:
                    vset.add_vote(v)
                except ErrVoteInvalidSignature:
                    refused += 1
            add_s = time.perf_counter() - t
            hits = bv.stats["cache_hits"] - st0.get("cache_hits", 0)
            host = bv.stats["sync_host_sigs"] - st0.get("sync_host_sigs", 0)
            want_refused = verdicts[k].count(False)
            if hits != n or host != 0 or refused != want_refused or \
                    not vset.has_two_thirds_majority():
                raise AssertionError(
                    f"VoteSet {label}: hits {hits}, host {host}, refused "
                    f"{refused} (want {want_refused})")
            summary["rounds"][label] = {
                "wall_ms": wall * 1e3, "votes_per_s": rate,
                "flushes": len(sizes), "device_flushes": len(dev_sizes),
                "flush_sizes": [min(sizes), statistics.median(sizes),
                                max(sizes)], "add_vote_ms": add_s * 1e3,
                "profiled": prof is not None, "device_busy_ms": busy_ms}
            say(f"phase votes {label}: VoteSet.add_vote over {n} votes in "
                f"{add_s * 1e3:.2f} ms, all cache hits (sync_host_sigs 0), "
                f"{refused} refused as invalid, +2/3 reached")
        recs = log.take()
    bad = [r for r in recs if r["thread"] == "MainThread"]
    if bad:
        raise AssertionError(f"a flush launched from the event loop's "
                             f"thread: {bad[:2]}")
    say(f"phase votes: launches ran on {_sites(recs)}")

    # -- the verdicts against the host spec ----------------------------------
    t = time.perf_counter()
    spec = signer.verify([(p.bytes(), m, s) for k in kinds
                          for p, m, s in rows[k]])
    spec_s = time.perf_counter() - t
    if verdicts[kinds[0]] + verdicts[kinds[1]] != spec:
        bad_i = [i for i, (a, b) in enumerate(zip(
            verdicts[kinds[0]] + verdicts[kinds[1]], spec)) if a != b]
        raise AssertionError(f"votes: verdicts differ from the spec at "
                             f"{bad_i[:10]}")
    say(f"phase votes: all {2 * n} verdicts equal Ed25519PubKey."
        f"verify_signature ({spec.count(False)} invalid; the spec in the "
        f"pool, {spec_s:.1f} s)")

    # -- an armed device.vote_flush: every future of the flush raises -------
    extra = [Vote(kinds[0], VOTE_HEIGHT, 1, bid, base_ns + 7 * i,
                  v.address, i)
             for i, v in enumerate(valset.validators[:VOTE_FAULT_VOTES])]
    for v, sig in zip(extra, signer.sign(
            [(seed_of[v.validator_address], v.sign_bytes(VOTE_CHAIN_ID))
             for v in extra])):
        v.signature = sig
    items = [(valset.validators[v.validator_index].pub_key,
              v.sign_bytes(VOTE_CHAIN_ID), v.signature) for v in extra]

    async def preverify_all():
        return await asyncio.gather(*(bv.preverify(*x) for x in items),
                                    return_exceptions=True)

    errs0 = bv.stats["device_errors"]
    faults.configure("device.vote_flush*1")
    try:
        faulted = asyncio.run(preverify_all())
    finally:
        faults.reset()
    keys_cached = [bv._key(p.bytes(), m, s) in bv._cache for p, m, s in items]
    if not all(isinstance(r, InjectedFault) for r in faulted) or \
            bv.stats["device_errors"] - errs0 != 1 or any(keys_cached):
        raise AssertionError(f"armed vote flush: {faulted[:3]}, errors "
                             f"{bv.stats['device_errors'] - errs0}, cached "
                             f"{sum(keys_cached)}")
    again = asyncio.run(preverify_all())
    if again != [True] * len(items):
        raise AssertionError(f"votes after the fault: {again}")
    say(f"phase votes: armed device.vote_flush: all {len(items)} futures of "
        f"the flush raised InjectedFault, device_errors 1, none cached; "
        f"resubmitted, all verified on the card")
    launches = dict(V.launches)
    if B.stats["device_errors"] != errors0:
        raise AssertionError(f"device errors: {B.stats}")
    say(f"phase votes: launches on the main path {launches}")
    summary["record_stream"] = record_stream_check(dev)
    summary["card"] = smi
    return {"launches": launches, "summary": summary}


def run_ingest(dev, smi: str, signer, registry) -> dict:
    """Phase ingest: INGEST_VALID signed txs from INGEST_SENDERS senders,
    unsigned, bad-signature and malformed txs and resubmitted duplicates,
    all broadcast at once through an ``IngestPipeline`` in front of a
    ``ShardedMempool`` of INGEST_SIZE over the kvstore app; every response
    held against the scalar path; the reap order; a commit of
    INGEST_COMMIT txs and its recheck; an armed ``device.batch_verify``.
    ``registry`` holds the CryptoMetrics wired through
    ``set_crypto_metrics``. Returns the kernels' launches and a summary.
    Raises on any failed check."""
    import asyncio
    import collections
    import hashlib

    import numpy as np

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.example.kvstore import KVStoreApplication
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.libs.faults import InjectedFault, faults
    from tendermint_tpu_torch.libs.metrics import MempoolMetrics
    from tendermint_tpu_torch.mempool.clist_mempool import (ErrTxInCache,
                                                            MempoolError)
    from tendermint_tpu_torch.mempool.ingest import (SIGNED, IngestPipeline,
                                                     ShardedMempool,
                                                     parse_signed_tx)
    from tendermint_tpu_torch.tools import commits

    tdevice.set_default_device(dev)
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    rng = np.random.default_rng(SEED + 12)
    t = time.perf_counter()
    seeds = commits.seeds(rng, INGEST_SENDERS)
    pubs = signer.pubkeys(seeds)

    def specs(n, tag, nonce0):
        return [(i % INGEST_SENDERS, b"%s%05d=v%08d" % (tag, i, int(
            rng.integers(0, 10**8))), nonce0 + i, int(rng.integers(0, 100)))
            for i in range(n)]

    signed = commits.signed_txs(
        signer, seeds, pubs, specs(INGEST_VALID, b"k", 0)
        + specs(INGEST_BAD_SIG, b"b", 10**6)
        + specs(INGEST_FAULT_TXS, b"f", 2 * 10**6))
    valid = signed[:INGEST_VALID]
    bad = [tx[:-1] + bytes([tx[-1] ^ 1]) for tx in
           signed[INGEST_VALID:INGEST_VALID + INGEST_BAD_SIG]]
    fault_txs = signed[INGEST_VALID + INGEST_BAD_SIG:]
    unsigned = [b"u%05d=%s" % (i, rng.bytes(6).hex().encode())
                for i in range(INGEST_UNSIGNED)]
    malformed = [b"stx1" + rng.bytes(int(rng.integers(0, 108)))
                 for _ in range(INGEST_MALFORMED)]
    dups = [valid[int(j)] for j in
            rng.choice(INGEST_VALID, INGEST_DUPS, replace=False)]
    pool_txs = valid + unsigned + bad + malformed + dups
    arrivals = [pool_txs[int(i)] for i in rng.permutation(len(pool_txs))]
    say(f"phase ingest: {len(arrivals)} broadcasts ({INGEST_VALID} signed by "
        f"{INGEST_SENDERS} senders, {INGEST_UNSIGNED} unsigned, "
        f"{INGEST_BAD_SIG} bad signatures, {INGEST_MALFORMED} malformed, "
        f"{INGEST_DUPS} resubmitted) built in {time.perf_counter() - t:.1f} s")

    def mempool():
        return ShardedMempool(LocalClient(KVStoreApplication()),
                              max_txs=INGEST_SIZE, cache_size=INGEST_CACHE)

    # -- the scalar path, one tx at a time: verify_signed_tx_scalar's check
    # (Ed25519PubKey.verify_signature, run in the pool), then check_tx
    t = time.perf_counter()
    distinct = sorted(set(arrivals))
    stx = {tx: parse_signed_tx(tx) for tx in distinct}
    signed_rows = [tx for tx in distinct if stx[tx][0] == SIGNED]
    ok = signer.verify([(stx[tx][1].pubkey, stx[tx][1].sign_bytes,
                         stx[tx][1].sig) for tx in signed_rows])
    scalar = mempool()
    for tx, v in zip(signed_rows, ok):
        scalar.store_sig_verdict(hashlib.sha256(tx).digest(), bool(v))

    def scalar_response(tx):
        try:
            r = scalar.check_tx(tx)
            return r.code, r.log
        except ErrTxInCache:
            return 1, "tx already exists in cache"
        except MempoolError as e:
            return 1, str(e)

    want = collections.defaultdict(collections.Counter)
    for tx in arrivals:
        want[tx][scalar_response(tx)] += 1
    scalar_s = time.perf_counter() - t

    # -- the pipeline ----------------------------------------------------------
    mp = mempool()
    m = MempoolMetrics(registry)
    mp.metrics = m
    batch_sizes = []

    class _Sized(B.BatchVerifier):
        def verify(self):
            batch_sizes.append(len(self))
            return super().verify()

    pipe = IngestPipeline(mp, queue_limit=len(arrivals) + INGEST_FAULT_TXS,
                          verifier_factory=lambda: _Sized(plane="ingest"))
    pipe.metrics = m

    async def broadcast(txs):
        return await asyncio.gather(*(pipe.submit(tx) for tx in txs),
                                    return_exceptions=True)

    V.reset_launches()
    stats0 = dict(B.stats)
    with _LaunchLog() as log:
        t = time.perf_counter()
        res = asyncio.run(broadcast(arrivals))
        wall = time.perf_counter() - t
        recs = log.take()
    raised = [r for r in res if isinstance(r, BaseException)]
    if raised:
        raise AssertionError(f"ingest: {len(raised)} broadcasts raised: "
                             f"{raised[:3]}")
    got = collections.defaultdict(collections.Counter)
    for tx, r in zip(arrivals, res):
        got[tx][(r.code, r.log)] += 1
    if got != want:
        diff = [tx for tx in want if got[tx] != want[tx]]
        raise AssertionError(f"ingest: {len(diff)} txs answered unlike the "
                             f"scalar path, e.g. {got[diff[0]]} != "
                             f"{want[diff[0]]}")
    entries = mp.entries_after(0)[0]
    if mp.size() != INGEST_SIZE or {e.tx for e in entries} != \
            {e.tx for e in scalar.entries_after(0)[0]}:
        raise AssertionError(f"ingest: the mempool holds {mp.size()} txs")
    reap = mp.reap_max_txs(-1)
    if reap != [e.tx for e in sorted(entries,
                                     key=lambda e: (-e.priority, e.seq))]:
        raise AssertionError("ingest: reap is not (priority desc, arrival "
                             "asc)")
    launched = {k: v for k, v in V.launches.items() if v}
    dev_batches = B.stats["device_batches"] - stats0["device_batches"]
    host_batches = B.stats["host_batches"] - stats0["host_batches"]
    codes = collections.Counter(r.code for r in res)
    route = ("K5 (ed25519_verify_dense, one launch a batch)"
             if set(launched) == {"ed25519_verify_dense"} else str(launched))
    say(f"phase ingest: {len(arrivals)} broadcasts settled in "
        f"{wall * 1e3:.2f} ms = {len(arrivals) / wall:.0f} txs/s; "
        f"{pipe.stats['batches']} batches of {sorted(batch_sizes)[0]}-"
        f"{sorted(batch_sizes)[-1]} signatures (median "
        f"{statistics.median(batch_sizes)}) on {route}: {dev_batches} on the "
        f"card, {host_batches} on the host; codes {dict(codes)}; every "
        f"response equal to the scalar path's ({scalar_s:.1f} s, the spec "
        f"in the pool); {mp.size()} resident, reap (priority desc, arrival "
        f"asc) ({smi})")
    say(f"phase ingest: launches ran on {_sites(recs)}")
    if dev_batches == 0 or V.launches["ed25519_verify_dense"] + \
            V.launches["ed25519_verify_sparse"] < dev_batches:
        raise AssertionError(f"ingest: device batches {dev_batches}, "
                             f"launches {V.launches}")

    # -- a commit of INGEST_COMMIT: recheck rides the verdict cache ----------
    block = reap[:INGEST_COMMIT]
    sigs0 = (B.stats["device_sigs"], B.stats["host_sigs"])
    scalar0 = m.preverified_txs_total.value("scalar")
    hits0 = m.preverify_cache_hits_total.value("recheck")
    t = time.perf_counter()
    mp.lock()
    try:
        mp.update(2, block, [abci.ResponseDeliverTx(code=0)] * len(block))
    finally:
        mp.unlock()
    update_ms = (time.perf_counter() - t) * 1e3
    signed_left = sum(1 for e in mp.entries_after(0)[0]
                      if parse_signed_tx(e.tx)[0] == SIGNED)
    hits = m.preverify_cache_hits_total.value("recheck") - hits0
    if mp.size() != INGEST_SIZE - INGEST_COMMIT or hits != signed_left or \
            (B.stats["device_sigs"], B.stats["host_sigs"]) != sigs0 or \
            m.preverified_txs_total.value("scalar") != scalar0:
        raise AssertionError(f"ingest update: size {mp.size()}, recheck "
                             f"hits {hits} of {signed_left} signed")
    say(f"phase ingest: update after a commit of {len(block)} txs in "
        f"{update_ms:.2f} ms: {mp.size()} rechecked by the app, {hits} "
        f"signatures served from the verdict cache, none verified again")

    # -- an armed device.batch_verify: each broadcast of the flush raises ----
    errs0 = pipe.stats["device_errors"]
    size0 = mp.size()
    faults.configure("device.batch_verify*1")
    try:
        faulted = asyncio.run(broadcast(fault_txs))
    finally:
        faults.reset()
    keys = [hashlib.sha256(tx).digest() for tx in fault_txs]
    if not all(isinstance(r, InjectedFault) for r in faulted) or \
            pipe.stats["device_errors"] - errs0 != 1 or mp.size() != size0 \
            or any(k in mp.sig_verdicts for k in keys) or \
            pipe.queue_depth() != 0:
        raise AssertionError(f"armed ingest flush: {faulted[:3]}, size "
                             f"{mp.size()}, queue {pipe.queue_depth()}")
    again = asyncio.run(broadcast(fault_txs))
    if [r.code for r in again] != [0] * len(fault_txs) or \
            mp.size() != size0 + len(fault_txs):
        raise AssertionError(f"ingest resubmission: {again[:3]}")
    say(f"phase ingest: armed device.batch_verify: all {len(fault_txs)} "
        f"broadcasts of the flush raised InjectedFault, device_errors 1, "
        f"nothing stored or admitted; resubmitted, all admitted "
        f"({mp.size()} resident)")
    routes = [line for line in registry.render().splitlines()
              if line.startswith("tendermint_crypto_routing_decisions_total")]
    say("phase evidence + votes + ingest, crypto_routing_decisions_total by "
        "route and plane: " + "; ".join(r.split("_total", 1)[1]
                                         for r in routes))
    launches = dict(V.launches)
    say(f"phase ingest: launches on the main path {launches}")
    return {"launches": launches, "summary": {
        "broadcasts": len(arrivals), "wall_ms": wall * 1e3,
        "txs_per_s": len(arrivals) / wall, "batches": len(batch_sizes),
        "batch_sizes": [min(batch_sizes), statistics.median(batch_sizes),
                        max(batch_sizes)],
        "device_batches": dev_batches, "host_batches": host_batches,
        "update_ms": update_ms, "routes": routes, "card": smi}}


def run_planes(dev, smi: str, signer, keys) -> dict:
    """Phases evidence, votes and ingest with one CryptoMetrics registry
    wired through ``set_crypto_metrics``; their launches summed."""
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry

    registry = Registry()
    B.set_crypto_metrics(CryptoMetrics(registry))
    out = {"launches": {}, "summary": {}}
    try:
        for name, fn, args in (
                ("evidence", run_evidence, (keys[:EVIDENCE_VALIDATORS],)),
                ("votes", run_votes, (keys,)),
                ("ingest", run_ingest, (registry,))):
            t = time.perf_counter()
            res = fn(dev, smi, signer, *args)
            s = time.perf_counter() - t
            say(f"phase {name}: {s:.1f} s in all ({smi})")
            res["summary"]["phase_s"] = s
            out["summary"][name] = res["summary"]
            for k, n in res["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + n
    finally:
        B.set_crypto_metrics(None)
    return out


# --- 4e. fast sync: the block pool, the blocksync reactor's two-plane
# window precompute, and parallel block execution -------------------------

FASTSYNC_CHAIN_ID = "chip-smoke-fastsync"
FASTSYNC_VALIDATORS = 1000   # BASELINE.json config #5's set
FASTSYNC_BLOCKS = 64         # synced (config #5: 10,000); +1 carries a commit
FASTSYNC_TXS = 256           # kvstore txs a block
FASTSYNC_CONFLICT_EVERY = 8  # one tx in eight rewrites a key of the block
FASTSYNC_BAD_IDX = 400       # the zeroed / flipped signature: inside 2/3
FASTSYNC_BAD_HEIGHT = 20     # the verification plane's forged commit
FASTSYNC_TAMPER_AT = 8       # the block peer `evil` serves tampered


def _fastsync_txs(rng, h):
    """FASTSYNC_TXS kvstore txs; every FASTSYNC_CONFLICT_EVERY-th puts a
    value that is not UTF-8 (a barrier-group tx under parallel execution)
    on the key of an earlier plain tx of the block, so that v1 speculates
    two groups onto one key and re-executes them."""
    txs = []
    for i in range(FASTSYNC_TXS):
        if i % FASTSYNC_CONFLICT_EVERY == FASTSYNC_CONFLICT_EVERY - 1:
            j = i - FASTSYNC_CONFLICT_EVERY + 1 + int(rng.integers(0, 6))
            txs.append(b"f%d-%03d=\xff%s" % (h, j, rng.bytes(4)))
        else:
            txs.append(b"f%d-%03d=%s" % (h, i, rng.bytes(8).hex().encode()))
    return txs


def run_fastsync(dev, smi: str, signer, keys) -> dict:
    """Phase fastsync: a chain of FASTSYNC_BLOCKS + 1 blocks of ``keys``
    (the first FASTSYNC_VALIDATORS of the big commit, equal power), each
    block FASTSYNC_TXS kvstore txs, built by a source node that records
    every height's app, results and validators hash. Then the verification
    plane (``verify_commit_light_batched`` over windows of VERIFY_WINDOW),
    a replay from a fresh node through the blocksync reactor under
    ``execution.version`` v0 and v1 (driven as ``bench.py``
    ``bench_fast_sync_pipeline`` drives it), and two faults: an armed
    ``device.batch_verify`` strikes nobody, a tampered block strikes its
    peer. Returns the kernels' launches and a summary. Raises on any
    failed check."""
    import asyncio
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    import numpy as np
    import torch

    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.abci.example.kvstore import KVStoreApplication
    from tendermint_tpu_torch.blockchain import reactor as R
    from tendermint_tpu_torch.config import ExecutionConfig
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.libs.faults import faults
    from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
    from tendermint_tpu_torch.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                            state_from_genesis)
    from tendermint_tpu_torch.state.execution import (EmptyEvidencePool,
                                                      NoOpMempool)
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                            GenesisValidator)
    from tendermint_tpu_torch.types.block import Block, Commit
    from tendermint_tpu_torch.types.errors import ErrWrongSignature
    from tendermint_tpu_torch.types.validator_set import \
        verify_commit_light_batched

    tdevice.set_default_device(dev)
    want_dev = str(tdevice.default_device())
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    rng = np.random.default_rng(SEED + 12)
    t0_ns = commits.BASE_TIME_S * 10**9
    # 64-byte private keys: 64 heights of signing derive no key
    seed_of = {pk.address(): sd + pk.bytes() for pk, sd in keys}
    genesis = GenesisDoc(
        chain_id=FASTSYNC_CHAIN_ID, genesis_time_ns=t0_ns,
        validators=[GenesisValidator(pk, 10) for pk, _ in keys])
    n_top = FASTSYNC_BLOCKS + 1

    def fresh_node(version="v0"):
        conns = AppConns(local_client_creator(KVStoreApplication()))
        conns.start()
        state = state_from_genesis(genesis)
        state_store = StateStore(MemDB())
        state_store.save(state)
        block_store = BlockStore(MemDB())
        execu = BlockExecutor(state_store, conns.consensus, NoOpMempool(),
                              EmptyEvidencePool(), block_store,
                              exec_config=ExecutionConfig(version=version))
        return state, execu, block_store, conns

    def hashes_of(state):
        return (state.app_hash, state.last_results_hash,
                state.validators.hash())

    # -- the source chain: our own signatures are known-valid, so the
    # source's apply_block checks each LastCommit against precomputed
    # verdicts (setup only, as bench.py's source does). A height's commit
    # is signed in the pool while the block applies.
    t = time.perf_counter()
    state, execu, _bs, conns = fresh_node()
    blocks, source_hashes, known = {}, {}, {}
    last = Commit(0, 0, BlockID(), [])
    token = B.precomputed_verdicts.set(known)
    with ThreadPoolExecutor(1) as side:
        try:
            for h in range(1, n_top + 1):
                block, parts = state.make_block(
                    h, _fastsync_txs(rng, h), last, [],
                    state.validators.get_proposer().address)
                bid = BlockID(block.hash(), parts.header())
                vals = state.validators
                stamps = [block.header.time_ns + 1_000_000 * (i + 1)
                          for i in range(vals.size())]
                signing = (side.submit(commits.sign_commit, signer,
                                       seed_of, vals, FASTSYNC_CHAIN_ID, h,
                                       bid, stamps) if h < n_top else None)
                state, _ = execu.apply_block(state, bid, block)
                source_hashes[h] = hashes_of(state)
                blocks[h] = block
                if signing is None:
                    break
                last = signing.result()
                sbs = last.vote_sign_bytes_all(FASTSYNC_CHAIN_ID)
                for v, sb, cs in zip(vals.validators, sbs, last.signatures):
                    known[(v.pub_key.bytes(), sb, cs.signature)] = True
        finally:
            B.precomputed_verdicts.reset(token)
            conns.stop()
    wire = {h: b.encode() for h, b in blocks.items()}
    n_sigs = FASTSYNC_VALIDATORS * FASTSYNC_BLOCKS
    say(f"phase fastsync: a chain of {n_top} blocks of {FASTSYNC_TXS} txs "
        f"over {FASTSYNC_VALIDATORS} validators ({n_sigs} signatures) "
        f"built in {time.perf_counter() - t:.1f} s with signing")

    def fresh_blocks():
        # fresh objects: no memo of an earlier pass (sign bytes, part
        # sets, header hashes) may leak into the next
        return {h: Block.decode(w) for h, w in wire.items()}

    launches = dict.fromkeys(MAIN_KERNELS, 0)
    summary = {}

    def take_launches():
        got = {k: V.launches[k] for k in launches}
        for k, n in got.items():
            launches[k] += n
        V.reset_launches()
        return got

    def check_sites(label, recs):
        bad = [r for r in recs if r["device"] != want_dev
               or f"cuda:{r['current_device']}" != want_dev]
        if bad:
            raise AssertionError(f"{label}: launches off {want_dev}: "
                                 f"{bad[:3]}")
        if any(r["thread"] == "MainThread" for r in recs):
            raise AssertionError(f"{label}: a launch on the event loop's "
                                 "thread (apply_block or an inline window)")
        say(f"phase fastsync {label}: launches ran on {_sites(recs)}")

    W = R.VERIFY_WINDOW
    with _LaunchLog() as log:
        # -- 1. the verification plane: one batched call a window; the
        # first auto call of the phase calibrates (K11)
        vblocks = fresh_blocks()
        vals = state_from_genesis(genesis).validators
        entries = []
        for h in range(1, FASTSYNC_BLOCKS + 1):
            blk = vblocks[h]
            bid = BlockID(blk.hash(), blk.make_part_set().header())
            entries.append((vals, FASTSYNC_CHAIN_ID, bid, h,
                            vblocks[h + 1].last_commit))
        B._calibrated_threshold = None
        V.reset_launches()
        log.take()
        per_window, t_windows = [], []
        for i in range(0, FASTSYNC_BLOCKS, W):
            t = time.perf_counter()
            res = verify_commit_light_batched(entries[i:i + W])
            t_windows.append(time.perf_counter() - t)
            if any(r is not None for r in res):
                raise AssertionError(f"verification plane: window at "
                                     f"{i + 1}: {res}")
            per_window.append(take_launches())
        recs = log.take()
        plane_s = sum(t_windows)
        say(f"phase fastsync verify plane: {FASTSYNC_BLOCKS} blocks in "
            f"{len(per_window)} windows in {plane_s * 1e3:.2f} ms, "
            f"{FASTSYNC_BLOCKS / plane_s:.1f} blocks/s, "
            f"{n_sigs / plane_s:.0f} sigs/s (window ms "
            f"{[round(x * 1e3, 2) for x in t_windows]}); launches a window "
            f"{per_window}; kernel ms {sum(r['ms'] for r in recs):.4f}")
        summary["verify_plane"] = {
            "blocks_per_s": FASTSYNC_BLOCKS / plane_s,
            "window_ms": [x * 1e3 for x in t_windows],
            "launches": per_window}
        # the forged commit: signature #FASTSYNC_BAD_IDX zeroed, against
        # the host route on the same window alone
        bad_pos = FASTSYNC_BAD_HEIGHT - 1
        w0 = bad_pos - bad_pos % W
        forged = list(entries[w0:w0 + W])
        e = forged[bad_pos - w0]
        commit = Commit.decode(e[4].encode())
        commit.signatures[FASTSYNC_BAD_IDX] = dataclasses.replace(
            commit.signatures[FASTSYNC_BAD_IDX], signature=bytes(64))
        forged[bad_pos - w0] = e[:4] + (commit,)
        got = verify_commit_light_batched(forged)
        take_launches()
        log.take()
        os.environ["TMTPU_BATCH_BACKEND"] = "host"
        try:
            want = verify_commit_light_batched(forged)
        finally:
            os.environ.pop("TMTPU_BATCH_BACKEND", None)

        def names(rs):
            return [None if r is None else (type(r).__name__, str(r))
                    for r in rs]

        err = got[bad_pos - w0]
        if (names(got) != names(want) or not isinstance(err, ErrWrongSignature)
                or f"#{FASTSYNC_BAD_IDX}" not in str(err)
                or sum(r is not None for r in got) != 1):
            raise AssertionError(f"verification plane forged commit: "
                                 f"{names(got)} against the host route's "
                                 f"{names(want)}")
        say(f"phase fastsync verify plane: the forged commit at height "
            f"{FASTSYNC_BAD_HEIGHT} gives {type(err).__name__} ({err}) at "
            f"entry {bad_pos - w0} of its window, as the host route does")

        # -- 2. the reactor pipeline from a fresh node, v0 then v1
        def replay(version, served=None, setup=None, on_fault=None,
                   on_stall=None, profile_window=None,
                   until=FASTSYNC_BLOCKS):
            state, execu, block_store, conns = fresh_node(version)
            reactor = R.BlockchainReactor(state, execu, block_store,
                                          fast_sync=True)
            reactor.pool = R.BlockPool(1)
            served = served or {"src": fresh_blocks()}
            got_hashes, redos, window_launches = {}, [], []
            apply_block = execu.apply_block

            def recorded_apply(st, bid, block):
                out = apply_block(st, bid, block)
                got_hashes[block.header.height] = hashes_of(out[0])
                return out

            execu.apply_block = recorded_apply
            redo = reactor.pool.redo

            def recorded_redo(height):
                bad = redo(height)
                redos.append((height, sorted(bad)))
                return bad

            reactor.pool.redo = recorded_redo

            def feed():
                while True:
                    reqs = reactor.pool.schedule_requests()
                    if not reqs:
                        return
                    for pid, h in reqs:
                        reactor.pool.add_block(pid, served[pid][h])

            if setup is not None:
                setup(reactor, feed)
            else:
                reactor.pool.set_peer_range("src", 1, n_top)
            prof = {}

            async def drive():
                n = 0
                while reactor.blocks_synced < until:
                    feed()
                    before = reactor.blocks_synced
                    n += 1
                    try:
                        if n == profile_window and dev.type == "cuda":
                            with torch.profiler.profile(activities=[
                                    torch.profiler.ProfilerActivity.CUDA]) \
                                    as p:
                                t = time.perf_counter()
                                await reactor._process_window()
                                torch.cuda.synchronize(dev)
                                prof["wall_ms"] = \
                                    (time.perf_counter() - t) * 1e3
                            prof["busy_ms"] = _device_busy_ms(p)
                        else:
                            await reactor._process_window()
                    except Exception as e:
                        if on_fault is None:
                            raise
                        on_fault(reactor, e)
                        continue
                    window_launches.append(take_launches())
                    if reactor.blocks_synced == before and (
                            on_stall is None or not on_stall(reactor)):
                        return

            hits0 = B.stats["precomputed_batches"]
            t = time.perf_counter()
            try:
                asyncio.run(drive())
            finally:
                conns.stop()
            t_end = time.perf_counter()
            hits = B.stats["precomputed_batches"] - hits0
            # apply_block's own split: validate / execute / commit+persist
            split = R.BlockchainReactor.exec_phase_breakdown(t, t_end)
            return SimpleNamespace(reactor=reactor, hashes=got_hashes,
                                   redos=redos, wall=t_end - t, prof=prof,
                                   hits=hits,
                                   window_launches=window_launches,
                                   split={"validate_ms": split["pack_s"] * 1e3,
                                          "execute_ms":
                                          split["dispatch_s"] * 1e3,
                                          "commit_persist_ms":
                                          split["fetch_s"] * 1e3,
                                          "blocks": split["segments"]})

        def check_hashes(label, rep, heights):
            bad = [h for h in heights
                   if rep.hashes.get(h) != source_hashes[h]]
            if bad:
                raise AssertionError(f"{label}: hashes differ from the "
                                     f"source at heights {bad[:5]}")

        runs = {}
        for version in ("v0", "v1"):
            log.take()
            rep = replay(version)
            recs = log.take()
            check_hashes(f"replay {version}", rep,
                         range(1, FASTSYNC_BLOCKS + 1))
            sb = rep.reactor.stage_breakdown()
            if sb["pipelined_windows"] < 2:
                raise AssertionError(f"replay {version}: {sb}")
            check_sites(f"replay {version}", recs)
            if dev.type == "cuda":
                stage_a = [r for r in recs
                           if r["kernel"] == "ed25519_verify_sparse"]
                if len(stage_a) < len(rep.window_launches):
                    raise AssertionError(
                        f"replay {version}: K7 launched {len(stage_a)} "
                        f"times over {len(rep.window_launches)} windows")
            par = rep.reactor.block_exec._parallel
            runs[version] = rep
            say(f"phase fastsync replay {version}: {FASTSYNC_BLOCKS} "
                f"blocks in {rep.wall * 1e3:.2f} ms, "
                f"{FASTSYNC_BLOCKS / rep.wall:.2f} blocks/s; stages "
                f"{ {k: (round(v, 4) if isinstance(v, float) else v) for k, v in sb.items()} }"
                f"; apply_block split "
                f"{ {k: round(v, 2) for k, v in rep.split.items()} }"
                f"; launches a _process_window call (its own window if "
                f"inline, the next window's stage A) {rep.window_launches}"
                f"; kernel ms {sum(r['ms'] for r in recs):.4f}; none on the "
                f"event loop's thread (apply_block's verify_commit: "
                f"{rep.hits} batches served by precomputed verdicts)"
                + (f"; last block: {par.last_groups} groups, "
                   f"{par.last_conflicted} txs re-executed"
                   if par is not None else ""))
            summary[f"replay_{version}"] = {
                "blocks_per_s": FASTSYNC_BLOCKS / rep.wall,
                "stages": sb, "apply_split": rep.split,
                "window_launches": rep.window_launches}
        v1_par = runs["v1"].reactor.block_exec._parallel
        if v1_par is None or v1_par.last_conflicted == 0:
            raise AssertionError("replay v1: no conflict was re-executed")
        say(f"phase fastsync exec stage: v1 "
            f"{runs['v1'].reactor.stage_breakdown()['abci_s'] * 1e3:.2f} ms "
            f"beside v0 "
            f"{runs['v0'].reactor.stage_breakdown()['abci_s'] * 1e3:.2f} ms "
            f"over {FASTSYNC_BLOCKS} blocks")

        # -- 3. faults on the card. An armed device.batch_verify before the
        # first window: the pool routine's rule, nobody struck
        registry = Registry()
        B.set_crypto_metrics(CryptoMetrics(registry))
        faults_seen = []

        def on_fault(reactor, e):
            faults_seen.append(e)
            reactor._on_window_device_fault(e)  # the pool routine's rule

        try:
            faults.configure("device.batch_verify*1")
            # its third _process_window call (the fault, window 1 retried,
            # then window 2 applied as window 3 is prepared) is profiled
            rep = replay("v0", on_fault=on_fault, profile_window=3)
            faults.reset()
            errs = B.metrics.device_errors_total.value("injected", "light")
        finally:
            faults.reset()
            B.set_crypto_metrics(None)
        take_launches()
        log.take()
        struck = [p for p, s in rep.reactor.scoreboard.snapshot().items()
                  if s["total_failures"]]
        if (len(faults_seen) != 1 or errs != 1 or struck or rep.redos
                or rep.reactor.metrics.sync_retries_total.value()):
            raise AssertionError(f"armed fault: {faults_seen} counted {errs}"
                                 f", struck {struck}, redos {rep.redos}")
        check_hashes("armed fault", rep, range(1, FASTSYNC_BLOCKS + 1))
        busy = rep.prof.get("busy_ms")
        share = (f"{busy:.4f} of {rep.prof['wall_ms']:.2f} ms, "
                 f"{100 * busy / rep.prof['wall_ms']:.2f}%"
                 if busy is not None else "not measured")
        summary["busy_ms"] = busy
        summary["profiled_window_ms"] = rep.prof.get("wall_ms")
        say(f"phase fastsync armed device.batch_verify: {faults_seen[0]!r} "
            f"before the first window; device_errors_total{{reason="
            f"\"injected\", plane=\"light\"}} {errs:.0f}; nobody struck, "
            f"nothing redone; the sync completed with the source's hashes "
            f"in {rep.wall * 1e3:.2f} ms; the card busy in one window "
            f"under torch.profiler: {share}")

        # a block with a flipped LastCommit signature from peer `evil`
        def tamper_setup(reactor, feed):
            reactor.pool.set_peer_range("evil", FASTSYNC_TAMPER_AT,
                                        FASTSYNC_TAMPER_AT)
            feed()  # the tampered height goes to evil alone
            reactor.pool.set_peer_range("src", 1, n_top)

        evil = fresh_blocks()
        cs = evil[FASTSYNC_TAMPER_AT].last_commit.signatures[FASTSYNC_BAD_IDX]
        cs.signature = cs.signature[:7] + bytes([cs.signature[7] ^ 1]) + \
            cs.signature[8:]
        served = {"src": fresh_blocks(), "evil": evil,
                  "src2": fresh_blocks()}

        stalls = []

        def another_source(reactor):
            # the redo dropped every provider of the window: once, another
            # honest peer reports in and the sync finishes from it
            if stalls:
                return False
            stalls.append(reactor.blocks_synced)
            reactor.pool.set_peer_range("src2", 1, n_top)
            return True

        # until the redone window has applied
        rep = replay("v0", served=served, setup=tamper_setup,
                     on_stall=another_source, until=2 * FASTSYNC_TAMPER_AT)
        struck = sorted(p for p, s in
                        rep.reactor.scoreboard.snapshot().items()
                        if s["total_failures"])
        redo_h = [h for h, _ in rep.redos]
        if "evil" not in struck or redo_h != [FASTSYNC_TAMPER_AT - 1]:
            raise AssertionError(f"tampered block: struck {struck}, redos "
                                 f"{rep.redos}")
        check_hashes("tampered block", rep,
                     range(1, rep.reactor.blocks_synced + 1))
        take_launches()
        log.take()
        say(f"phase fastsync tampered block from evil at height "
            f"{FASTSYNC_TAMPER_AT}: redo at {redo_h[0]} after "
            f"{stalls[0]} blocks, struck {struck}; src2 served the redone "
            f"heights: {rep.reactor.blocks_synced} applied with the "
            f"source's hashes")
    summary["tamper"] = {"redo": redo_h, "struck": struck}
    return {"launches": launches, "summary": summary}


# --- 4f. consensus: the state machine, its reactors and the in-process
# switch; a 4-node net, then one node against signing stub validators ----

CONSENSUS_CHAIN_ID = "chip-smoke-consensus"
CONSENSUS_NET_NODES = 4      # BASELINE.json config #4's net
CONSENSUS_NET_HEIGHTS = 6
CONSENSUS_NET_TXS = 64
#: (validators, heights): BASELINE.json config 2's set, then configs 3/5's
CONSENSUS_SIZES = ((150, 8), (1000, 4))
CONSENSUS_TXS = 256          # kvstore txs a height (genesis max_gas)
CONSENSUS_TIMEOUT_PROPOSE_S = 3.0   # the reference's default
CONSENSUS_ARMED = (150, 3, 2)       # validators, heights, the armed height
CONSENSUS_PROFILED = 3       # the height profiled under torch.profiler
CONSENSUS_HEIGHT_LIMIT_S = 60.0


def _series_total(metric) -> float:
    """The sum of a counter over all of its label sets."""
    with metric._lock:
        return sum(metric._values.values())


class _NodeClock:
    """Wraps a port node's ``BlockExecutor`` (``apply_block`` and
    ``validate_block``): the time, round and hashes of each committed
    height, the ``validate_block`` calls a height that verified a
    LastCommit, and an optional hook run at each commit (on the node's
    loop)."""

    def __init__(self, node, on_commit=None):
        self.node = node
        self.on_commit = on_commit
        self.commits = {}         # height -> (perf time, round, app hash)
        self.validations = {}     # height -> validate_block calls
        self.last_commit_checks = {}  # height -> those with a LastCommit
        self.seconds = {"validate": 0.0, "apply": 0.0}  # apply's includes
        # its own validate_block
        execu = node.block_exec
        apply_block, validate_block = execu.apply_block, execu.validate_block

        def applied(state, block_id, block):
            t = time.perf_counter()
            out = apply_block(state, block_id, block)
            self.seconds["apply"] += time.perf_counter() - t
            h = block.header.height
            self.commits[h] = (time.perf_counter(), node.cs.rs.round,
                               out[0].app_hash)
            if self.on_commit is not None:
                self.on_commit(h)
            return out

        def validated(state, block):
            h = block.header.height
            self.validations[h] = self.validations.get(h, 0) + 1
            if block.last_commit is not None and block.last_commit.size():
                self.last_commit_checks[h] = \
                    self.last_commit_checks.get(h, 0) + 1
            t = time.perf_counter()
            try:
                return validate_block(state, block)
            finally:
                self.seconds["validate"] += time.perf_counter() - t

        execu.apply_block, execu.validate_block = applied, validated


def _consensus_txs(rng, tag: str, n: int):
    return [b"%s-%04d=%s" % (tag.encode(), i, rng.bytes(6).hex().encode())
            for i in range(n)]


def _kvstore_spec(txs):
    """The kvstore app's state and app hash (a big-endian tx count) after
    ``txs``, from their bytes alone."""
    state = {}
    for tx in txs:
        raw = tx.decode("utf-8", errors="replace")
        k, v = raw.split("=", 1) if "=" in raw else (raw, raw)
        state[k] = v
    return state, len(txs).to_bytes(8, "big")


def run_consensus(dev, smi: str, signer, keys) -> dict:
    """Phase consensus. Part A: CONSENSUS_NET_NODES port nodes (kvstore,
    MockPV, a full mesh of the in-process switch) run
    CONSENSUS_NET_HEIGHTS heights while CONSENSUS_NET_TXS txs go into
    node 0's mempool. Part B: one port node against
    ``tools/validator_stubs.py`` at each of CONSENSUS_SIZES (the node holds
    one key of ``keys``, the stubs the others), CONSENSUS_TXS txs a
    height; then the armed run. Returns the kernels' launches and a
    summary. Raises on any failed check."""
    import asyncio
    from types import SimpleNamespace

    import numpy as np
    import torch

    from tendermint_tpu_torch import crypto as tcrypto
    from tendermint_tpu_torch import device as tdevice
    from tendermint_tpu_torch.consensus.config import test_consensus_config
    from tendermint_tpu_torch.consensus.round_state import RoundStep
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.libs.faults import faults
    from tendermint_tpu_torch.libs.metrics import CryptoMetrics, Registry
    from tendermint_tpu_torch.p2p import InProcNetwork
    from tendermint_tpu_torch.state import state_from_genesis
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.tools.validator_stubs import (LocalNode,
                                                            ValidatorStubs)
    from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                            GenesisValidator, MockPV)
    from tendermint_tpu_torch.types.params import default_consensus_params

    tdevice.set_default_device(dev)
    os.environ.pop("TMTPU_BATCH_BACKEND", None)
    os.environ.pop("TMTPU_DEVICE_THRESHOLD", None)
    rng = np.random.default_rng(SEED + 13)
    launches = dict.fromkeys(MAIN_KERNELS, 0)
    summary = {"card": smi}
    t0_ns = commits.BASE_TIME_S * 10**9

    def take_launches(main_path=True):
        got = {k: V.launches[k] for k in launches}
        if main_path:
            for k, n in got.items():
                launches[k] += n
        V.reset_launches()
        return got

    def config():
        cfg = test_consensus_config()
        cfg.timeout_propose = CONSENSUS_TIMEOUT_PROPOSE_S
        return cfg

    def genesis_of(chain_id, pubs, max_gas=-1):
        params = default_consensus_params()
        params.block.max_gas = max_gas
        return GenesisDoc(chain_id=chain_id, genesis_time_ns=t0_ns,
                          validators=[GenesisValidator(p, 10) for p in pubs],
                          consensus_params=params)

    def priv(i):
        pk, seed = keys[i]
        return seed + pk.bytes()

    async def wait_heights(clocks, height, limit_s):
        t = time.perf_counter()
        while min(max(c.commits, default=0) for c in clocks) < height:
            if time.perf_counter() - t > limit_s:
                raise AssertionError(
                    f"consensus: heights {[max(c.commits, default=0) for c in clocks]}"
                    f" after {limit_s} s, want {height}")
            await asyncio.sleep(0.005)

    def host_verdicts(chain_id, vals, commit):
        rows = [(v.pub_key.bytes(), sb, cs.signature)
                for v, cs, sb in zip(vals.validators, commit.signatures,
                                     commit.vote_sign_bytes_all(chain_id))
                if not cs.absent()]
        return rows, signer.verify(rows)

    # -- A. the 4-node net ----------------------------------------------------
    t_a = time.perf_counter()
    chain_a = CONSENSUS_CHAIN_ID + "-net"
    pvs = [MockPV(tcrypto.Ed25519PrivKey(priv(i)))
           for i in range(CONSENSUS_NET_NODES)]
    genesis = genesis_of(chain_a, [pv.get_pub_key() for pv in pvs])
    nodes = [LocalNode(f"node{i}", genesis, pv, config=config())
             for i, pv in enumerate(pvs)]
    clocks = [_NodeClock(nd) for nd in nodes]
    txs_a = _consensus_txs(rng, "net", CONSENSUS_NET_TXS)
    take_launches()

    async def run_net():
        net = InProcNetwork()
        for nd in nodes:
            net.add_switch(nd.switch)
        for nd in nodes:
            await nd.start()
        await net.connect_topology("full_mesh")
        for tx in txs_a:
            nodes[0].mempool.check_tx(tx)
        try:
            await wait_heights(clocks, CONSENSUS_NET_HEIGHTS,
                               CONSENSUS_HEIGHT_LIMIT_S)
        finally:
            for nd in nodes:
                await nd.stop()

    asyncio.run(run_net())
    net_launches = take_launches()
    wall_a = time.perf_counter() - t_a
    vals_a = state_from_genesis(genesis).validators
    seen_txs = [[] for _ in nodes]
    for h in range(1, CONSENSUS_NET_HEIGHTS + 1):
        metas = [nd.block_store.load_block_meta(h) for nd in nodes]
        apps = {c.commits[h][2] for c in clocks}
        hashes = {m.header.hash() for m in metas}
        if len(hashes) != 1 or len(apps) != 1:
            raise AssertionError(f"net height {h}: block hashes {hashes}, "
                                 f"app hashes {apps}")
        for i, nd in enumerate(nodes):
            seen_txs[i] += nd.block_store.load_block(h).data.txs
            seen = nd.block_store.load_seen_commit(h)
            rows, spec = host_verdicts(chain_a, vals_a, seen)
            bv = B.BatchVerifier(backend="host")
            for pk, sb, sig in rows:
                bv.add(tcrypto.Ed25519PubKey(pk), sb, sig)
            _, host = bv.verify()
            if list(map(bool, host)) != spec or not all(spec) or \
                    len(rows) * 3 <= 2 * vals_a.size():
                raise AssertionError(f"net height {h} node {i}: seen commit "
                                     f"verdicts {list(host)} / {spec}")
            vals_a.verify_commit(chain_a, seen.block_id, h, seen)
    for i, got in enumerate(seen_txs):
        committed = [tx for tx in got if tx in set(txs_a)]
        if sorted(committed) != sorted(txs_a):
            raise AssertionError(f"net node {i}: {len(committed)} of the "
                                 f"{len(txs_a)} txs committed, "
                                 f"{len(committed) - len(set(committed))} "
                                 "twice")
    rate_a = CONSENSUS_NET_HEIGHTS / (
        clocks[0].commits[CONSENSUS_NET_HEIGHTS][0] - t_a)
    say(f"phase consensus net: {CONSENSUS_NET_NODES} nodes agree on the "
        f"block and app hash of heights 1-{CONSENSUS_NET_HEIGHTS}; all "
        f"{len(txs_a)} txs committed once at every node; every seen commit "
        f"verifies on the host spec route; {rate_a:.2f} heights/s, "
        f"{wall_a:.1f} s with set-up; launches {net_launches} (votes and "
        f"4-signature commits stay under the thresholds)")
    summary["net"] = {"heights_per_s": rate_a, "launches": net_launches}

    # -- B. one node against the signing stubs -------------------------------
    def stub_run(n_vals, heights, chain_id, armed_at=None, profile_at=None,
                 min_device_batch=None):
        V.reset_launches()  # the previous run's comparisons do not count
        pubs = [keys[i][0] for i in range(n_vals)]
        genesis = genesis_of(chain_id, pubs, max_gas=CONSENSUS_TXS)
        vals = state_from_genesis(genesis).validators
        # the node holds the key that proposes height 2; the stubs propose
        # the others (the proposer priority of equal powers)
        p2 = vals.copy_increment_proposer_priority(1).get_proposer().address
        node_i = next(i for i, p in enumerate(pubs) if p.address() == p2)
        node = LocalNode("node", genesis,
                         MockPV(tcrypto.Ed25519PrivKey(priv(node_i))),
                         config=config(), broadcast_txs=False)
        stubs = ValidatorStubs(genesis, {pubs[i].address(): priv(i)
                                         for i in range(n_vals)
                                         if i != node_i}, signer)
        txs = _consensus_txs(rng, chain_id, CONSENSUS_TXS * heights)
        bv = node.cs.vote_verifier
        if min_device_batch is not None:
            bv.min_device_batch = min_device_batch
        flushes, failed_keys, host_keys = [], [], []
        run_flush, fail, verify = bv._run_flush, bv._fail, bv.verify

        async def counted(batch):
            flushes.append(len(batch))
            return await run_flush(batch)

        def failing(batch, exc):
            failed_keys.extend(b[0] for b in batch)
            return fail(batch, exc)

        def verifying(pub, msg, sig):
            key = bv._key(pub.bytes(), msg, sig)
            if key not in bv._cache:
                host_keys.append(key)
            return verify(pub, msg, sig)

        bv._run_flush, bv._fail, bv.verify = counted, failing, verifying
        prof, prof_out = [None], {}

        def arm(rs):
            # once the node has prevoted at the armed height: the flushes
            # that follow carry that height's votes
            if rs.height == armed_at and rs.step == RoundStep.PREVOTE \
                    and not armed:
                armed.append(rs.round)
                faults.configure("device.vote_flush*1")

        armed = []
        if armed_at is not None:
            node.cs.new_round_step_listeners.append(arm)

        def on_commit(h):
            if profile_at is not None and dev.type == "cuda":
                if h == profile_at - 1:
                    torch.cuda.synchronize(dev)
                    prof[0] = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA])
                    prof[0].start()
                    prof_out["t"] = time.perf_counter()
                elif h == profile_at and prof[0] is not None:
                    torch.cuda.synchronize(dev)
                    prof_out["wall_ms"] = \
                        (time.perf_counter() - prof_out["t"]) * 1e3
                    prof[0].stop()
                    prof_out["busy_ms"] = _device_busy_ms(prof[0])

        clock = _NodeClock(node, on_commit)
        cm = CryptoMetrics(Registry())
        B.set_crypto_metrics(cm)
        out = {}

        async def drive():
            net = InProcNetwork()
            net.add_switch(node.switch)
            await node.switch.start()
            await stubs.connect(net, "node")
            for tx in txs:
                node.mempool.check_tx(tx)
                stubs.mempool.check_tx(tx)
            out["t0"] = time.perf_counter()
            await node.cs.start()
            stubs.drive()
            try:
                await wait_heights([clock], heights,
                                   CONSENSUS_HEIGHT_LIMIT_S)
            finally:
                await stubs.stop()
                await node.stop()

        with _LaunchLog() as log:
            try:
                asyncio.run(drive())
            finally:
                faults.reset()
                B.set_crypto_metrics(None)
            recs = log.take()
        errs = _series_total(cm.device_errors_total)
        return SimpleNamespace(node=node, stubs=stubs, clock=clock,
                               flushes=flushes, failed_keys=failed_keys,
                               host_keys=host_keys, recs=recs, errs=errs,
                               txs=txs, vals=vals, t0=out["t0"],
                               prof=prof_out,
                               launches=take_launches(armed_at is None),
                               chain_id=chain_id, bv=bv,
                               reactor=node.cs_reactor)

    def check_chain(label, r, heights):
        node = r.node
        committed = []
        for h in range(1, heights + 1):
            blk = node.block_store.load_block(h)
            committed += blk.data.txs
            if len(blk.data.txs) != CONSENSUS_TXS:
                raise AssertionError(f"{label} height {h}: "
                                     f"{len(blk.data.txs)} txs")
            if r.stubs.commits.get(h, (None,))[0] != blk.hash():
                raise AssertionError(f"{label} height {h}: the stubs "
                                     "committed another block")
            if h > 1:
                rows, spec = host_verdicts(r.chain_id, r.vals, blk.last_commit)
                bv = B.BatchVerifier(backend="cuda")
                for pk, sb, sig in rows:
                    bv.add(tcrypto.Ed25519PubKey(pk), sb, sig)
                _, dev_v = bv.verify()
                if list(map(bool, dev_v)) != spec or not all(spec):
                    raise AssertionError(f"{label} height {h}: LastCommit "
                                         f"verdicts differ from the host "
                                         f"spec")
        state, app_hash = _kvstore_spec(committed)
        if (sorted(committed) != sorted(r.txs[:len(committed)]) or
                len(committed) != CONSENSUS_TXS * heights or
                node.app.state != state or
                r.clock.commits[heights][2] != app_hash):
            raise AssertionError(f"{label}: {len(committed)} txs committed, "
                                 f"app hash {r.clock.commits[heights][2]} "
                                 f"against the spec's {app_hash}")

    B._calibrated_threshold = None  # one calibration for part B (K11)
    if dev.type == "cuda":
        # the profiler's first start in a process initializes CUPTI
        # (seconds): not inside a measured height
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    summary["stubs"] = {}
    for n_vals, heights in CONSENSUS_SIZES:
        label = f"consensus {n_vals}"
        t = time.perf_counter()
        r = stub_run(n_vals, heights, f"{CONSENSUS_CHAIN_ID}-{n_vals}",
                     profile_at=CONSENSUS_PROFILED)
        wall = time.perf_counter() - t
        rounds = {h: r.clock.commits[h][1] for h in range(1, heights + 1)}
        seen_rounds = {h: r.node.block_store.load_seen_commit(h).round
                       for h in range(1, heights + 1)}
        t_end = r.clock.commits[heights][0]
        rate = heights / (t_end - r.t0)
        bvs = r.bv.stats
        votes = bvs["device_sigs"] + bvs["host_sigs"]
        dev_flushes = [x for x in r.flushes if x >= r.bv.min_device_batch]
        k5 = [x for x in r.recs if x["kernel"] == "ed25519_verify_dense"]
        k5_main = [x for x in k5 if x["thread"] == "MainThread"]
        k5_exec = [x for x in k5 if x["thread"] != "MainThread"]
        k5_n = r.launches["ed25519_verify_dense"]
        probes = r.launches["probe_sum_u8"]
        checks = r.clock.last_commit_checks
        problems = []
        if any(rounds.values()) or any(seen_rounds.values()):
            problems.append(f"rounds {rounds} / {seen_rounds}")
        if r.launches["ed25519_verify_sparse"]:
            problems.append("K7 ran")
        # vote flushes reached the device, each of min_device_batch votes
        # or more launched K5 once from an executor thread, and every
        # LastCommit verify launched once on the loop
        if not dev_flushes:
            problems.append("no vote flush reached the device")
        if (dev.type == "cuda" and (len(k5_main) != sum(checks.values())
                                    or len(k5) != k5_n
                                    or len(k5_exec) != len(dev_flushes))) \
                or k5_n != len(dev_flushes) + sum(checks.values()) \
                or bvs["device_batches"] != len(dev_flushes):
            problems.append(f"K5 {len(k5_main)} on the loop, {len(k5_exec)}"
                            f" on executors, {len(dev_flushes)} device "
                            f"flushes, stats {dict(bvs)}")
        if probes != (3 if n_vals == CONSENSUS_SIZES[0][0] else 0):
            problems.append(f"K11 {probes}")
        if r.errs or r.reactor.stats["preverify_device_errors"]:
            problems.append(f"device errors {r.errs}, "
                            f"{dict(r.reactor.stats)}")
        if problems:
            raise AssertionError(f"{label}: {'; '.join(problems)}")
        check_chain(label, r, heights)
        ms = [(r.clock.commits[h][0] - (r.clock.commits[h - 1][0] if h > 1
                                         else r.t0)) * 1e3
              for h in range(1, heights + 1)]
        split = {"node_validate_ms": r.clock.seconds["validate"] * 1e3,
                 "node_apply_ms": r.clock.seconds["apply"] * 1e3,
                 **{f"stubs_{k}_ms": v * 1e3
                    for k, v in r.stubs.seconds.items()}}
        say(f"phase consensus stubs {n_vals} ({len(r.stubs.switches)} "
            f"links): ms a height "
            f"{[round(x, 1) for x in ms]}; time inside (ms, all heights; "
            f"the stubs' overlaps the node's) "
            f"{ {k: round(v, 1) for k, v in split.items()} }; the stubs "
            f"resent {r.stubs.stats['resent']} votes")
        busy = r.prof.get("busy_ms")
        share = ("not measured (no device time in the trace)"
                 if busy is None else
                 f"{busy:.4f} of {r.prof['wall_ms']:.2f} ms, "
                 f"{100 * busy / r.prof['wall_ms']:.2f}%")
        n_checks = [checks.get(h, 0) for h in range(2, heights + 1)]
        say(f"phase consensus stubs {n_vals}: {heights} heights in "
            f"{(t_end - r.t0) * 1e3:.2f} ms = {rate:.3f} heights/s, every "
            f"one in round 0; {votes} votes preverified = "
            f"{votes / (t_end - r.t0):.0f} votes/s; {len(r.flushes)} "
            f"flushes ({len(dev_flushes)} on the device, median size "
            f"{statistics.median(r.flushes)}, max {max(r.flushes)}); K5 "
            f"launches a height "
            f"{k5_n / heights:.2f}: "
            f"{len(k5_exec)} vote flushes on threads "
            f"{sorted({x['thread'] for x in k5_exec})}, {len(k5_main)} "
            f"validate_block LastCommit verifies on the loop (MainThread); "
            f"validate_block verified the same LastCommit {n_checks} times "
            f"a height (2-{heights}); K11 {probes}, K7 0; "
            f"crypto_device_errors_total 0; the stubs proposed "
            f"{r.stubs.stats['proposals']} blocks; the card busy in height "
            f"{CONSENSUS_PROFILED} under torch.profiler: {share}; LastCommit "
            f"verdicts equal the host spec's, app hash the kvstore spec's; "
            f"{wall:.1f} s with set-up ({smi})")
        summary["stubs"][n_vals] = {
            "heights_per_s": rate, "votes_per_s": votes / (t_end - r.t0),
            "flushes": len(r.flushes), "device_flushes": len(dev_flushes),
            "median_flush": statistics.median(r.flushes),
            "k5_per_height": k5_n / heights,
            "k5_flush": len(k5_exec), "k5_validate": len(k5_main),
            "validate_last_commit_per_height": n_checks,
            "k11": probes, "busy_ms": busy,
            "profiled_height_ms": r.prof.get("wall_ms"),
            "height_ms": ms, "split_ms": split,
            "resent": r.stubs.stats["resent"],
            "links": len(r.stubs.switches)}

    # -- the armed run: device.vote_flush once, at height CONSENSUS_ARMED[2]
    n_vals, heights, armed_at = CONSENSUS_ARMED
    label = "consensus armed"
    # every vote flush takes the device route here, so that a flush of
    # the armed height meets the armed site whatever its size
    r = stub_run(n_vals, heights, f"{CONSENSUS_CHAIN_ID}-armed",
                 armed_at=armed_at, min_device_batch=1)
    failed, host = set(r.failed_keys), set(r.host_keys)
    rstats = dict(r.reactor.stats)
    commit_round = r.node.block_store.load_seen_commit(armed_at).round
    node_round = r.clock.commits[armed_at][1]
    if (rstats.get("preverify_device_errors") != 1 or r.errs != 1
            or not failed or failed & host):
        raise AssertionError(f"{label}: reactor {rstats}, "
                             f"crypto_device_errors_total {r.errs}, "
                             f"{len(failed)} votes in the failed flush, "
                             f"{len(failed & host)} of them verified on "
                             "the host")
    check_chain(label, r, heights)
    say(f"phase consensus armed device.vote_flush at height {armed_at} of "
        f"{n_vals} validators: preverify_device_errors 1, "
        f"crypto_device_errors_total 1 (every flush on the device route, "
        f"min_device_batch 1), {len(failed)} votes of the flush "
        f"dropped ({rstats.get('preverify_dropped_votes')} deliveries), "
        f"none verified on the host miss path; the stubs resent "
        f"{r.stubs.stats['resent']} votes; height {armed_at} committed "
        f"the round-{commit_round} precommits with the node in round "
        f"{node_round}; {heights} heights in all; launches {r.launches}, "
        f"not counted on the main path")
    summary["armed"] = {"commit_round": commit_round,
                        "node_round": node_round,
                        "dropped": rstats.get("preverify_dropped_votes"),
                        "resent": r.stubs.stats["resent"],
                        "launches": r.launches}
    V.reset_launches()  # the checks' launches do not count
    return {"launches": launches, "summary": summary}


# --- 4b. sharded verify-and-tally (K8), the multi-device stream, the
# device-profile stub kernels (P1-P3) and P4 -------------------------------

SHARDS = 4
TALLY_INVALID_EVERY = 97
TALLY_POWER = 1 << 40
MD_LANES = 2
STUB_SIGS = 2 * N_BIG
STUB_WORK = 20_000
# the stubs are held against their plain versions at these round counts
# (around 16 rounds and a block of STUB_BLOCK unrolled rounds, and the
# scale cell's), on the whole pack and on slices from these rows (odd: the
# diff columns of a slice start off a 16-byte boundary)
STUB_CHECK_WORK = (0, 1, 15, 16, 17, 63, 64, 65, STUB_WORK)
STUB_SLICE_ROWS = (0, 1, 33)
# one warp's chain timed at two round counts (whole blocks of
# STUB_CHAIN_BLOCK; 2 and 6 ms of chain, so that back-to-back launches
# stay device-bound on a slow host), differenced: the latency of one
# dependent round
CHAIN_ROUNDS = (1_024_000, 3_072_000)
# a stub at STUB_WORK rounds must take at most this many chain floors
STUB_FLOOR_LIMIT = 2.0
# rounds in one unrolled block of a stub's chain (csrc/stub.cuh) and of
# stub_chain's (csrc/stub.cu)
STUB_BLOCK = 64
STUB_CHAIN_BLOCK = 256
P4_BYTES = 4 << 20


def _ops_bound(ops, nbytes, int32_peak):
    ops_s, bytes_s = ops / int32_peak, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _streams_time_ms(fns, dev, reps=5):
    """Mean ms of launching each of ``fns`` on a stream of its own, all
    after and before the current stream (CUDA events)."""
    import torch

    streams = [torch.cuda.Stream(device=dev) for _ in fns]

    def run_all():
        cur = torch.cuda.current_stream(dev)
        for st, fn in zip(streams, fns):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                fn()
        for st in streams:
            cur.wait_stream(st)
    return _time_ms(run_all, dev, reps)


def _kernel_alone_ms(fn, dev, kernel: str, reps: int = 20):
    """The device time (ms) of ``kernel`` per call of ``fn``, from a
    torch.profiler trace of ``reps`` calls; None when the trace shows no
    device time for it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages() if kernel in ev.key)
    return us / 1e3 / reps if us > 0 else None


def _device_busy_ms(prof):
    """The device time (ms) of every kernel and copy in a stopped
    torch.profiler trace; None when the trace shows no device time."""
    import torch

    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages()
             if getattr(ev, "device_type", None)
             == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us > 0 else None


def _sass_chain(lib_path) -> dict:
    """Per kernel of a built library (cuobjdump -sass): its IMAD count and
    its longest chain of dependent IMADs (each reads the register the one
    before wrote, with the same multiplier and addend: a chain of LCG
    rounds), with the chain's lines, for the kernels whose names hold
    "stub". Raises when cuobjdump is not found or lists no such kernel."""
    import re
    import shutil

    tool = next((str(p) for p in (Path("/usr/local/cuda/bin/cuobjdump"),)
                 if p.exists()), None) or shutil.which("cuobjdump")
    if tool is None:
        raise AssertionError("cuobjdump not found: the stubs' SASS cannot "
                             "be checked")
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    imad = re.compile(r"IMAD (R\d+), (R\d+), (.+)")
    dest = re.compile(r"[A-Z0-9.]+ (R\d+)")
    chains = {}  # the register a chain's last IMAD wrote -> its lines
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, chains = m.group(1), {}
            out[name] = {"imad": 0, "chain": 0, "lines": []}
            continue
        m = ins.search(line)
        if not (m and name):
            continue
        rec, op = out[name], m.group(2).replace(".reuse", "")
        c = imad.match(op)
        if c:
            rec["imad"] += 1
            prev = chains.pop(c.group(2), [])
            if prev and imad.match(prev[-1].split(" ", 1)[1]).group(3) \
                    != c.group(3):
                prev = []
            chains[c.group(1)] = prev + [f"/*{m.group(1)}*/ {op}"]
            if len(chains[c.group(1)]) > rec["chain"]:
                rec["chain"] = len(chains[c.group(1)])
                rec["lines"] = chains[c.group(1)]
            continue
        d = dest.match(op)
        if d:  # another instruction overwrites a chain's register
            chains.pop(d.group(1), None)
    out = {fn: rec for fn, rec in out.items() if "stub" in fn}
    for kernel in ("stub_verify_dense_kernel", "stub_verify_sparse_kernel",
                   "stub_chain_kernel"):
        if not any(kernel in fn for fn in out):
            raise AssertionError(f"cuobjdump -sass lists no {kernel} in "
                                 f"{lib_path}")
    return out


def stub_chain_latency(dev, smi: str) -> dict:
    """One warp's chain of LCG rounds (``stub_chain``) at the two counts of
    CHAIN_ROUNDS, CUDA events around back-to-back launches and the
    kernel's clock64 counts, differenced: cycles and ns of one dependent
    round; nvidia-smi's SM clock read just after. Raises if the chain's
    words differ from the closed form."""
    import torch

    from tendermint_tpu_torch.crypto.ed25519_cuda import stub as ST

    ms, cyc = {}, {}
    for rounds in CHAIN_ROUNDS:
        out, cycles = ST.stub_chain(rounds, dev)
        if not torch.equal(out.cpu(), ST.stub_chain_plain(rounds)):
            raise AssertionError(f"stub_chain at {rounds} rounds != the "
                                 "closed form")
        cyc[rounds] = int(cycles.max().item())
        ms[rounds] = _time_ms(lambda: ST.stub_chain(rounds, dev), dev, 10)
    lo, hi = CHAIN_ROUNDS
    sm_mhz = _nvidia_smi("clocks.sm")
    rec = {"cycles_per_round": (cyc[hi] - cyc[lo]) / (hi - lo),
           "ns_per_round": (ms[hi] - ms[lo]) * 1e6 / (hi - lo),
           "rounds": list(CHAIN_ROUNDS), "ms": [ms[lo], ms[hi]],
           "clock64": [cyc[lo], cyc[hi]], "clocks_sm": sm_mhz}
    rec["implied_mhz"] = rec["cycles_per_round"] / rec["ns_per_round"] * 1e3
    max_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    if rec["implied_mhz"] > 1.02 * max_mhz:
        # fewer ns than the cycles take at the card's top clock: the
        # launches were host-bound, and the floor would be too low
        raise AssertionError(f"stub_chain: {rec['cycles_per_round']:.3f} "
                             f"cycles in {rec['ns_per_round']:.4f} ns is "
                             f"{rec['implied_mhz']:.0f} MHz, over the "
                             f"card's {max_mhz:.0f}")
    say(f"times: stub_chain (one warp): {rec['cycles_per_round']:.3f} "
        f"cycles and {rec['ns_per_round']:.4f} ns a dependent round "
        f"(clock64 {cyc[lo]} and {cyc[hi]}, events {ms[lo]:.4f} and "
        f"{ms[hi]:.4f} ms at {lo} and {hi} rounds, differenced; implied "
        f"clock {rec['implied_mhz']:.0f} MHz; nvidia-smi clocks.sm just "
        f"after: {sm_mhz}) ({smi})")
    return rec


def _larger(row) -> str:
    """Which floor of a stub's row is the larger: "chain" or "bound"."""
    return "chain" if row["chain_floor_ms"] > row["bound_ms"] else "bound"


def _same(what, k, p):
    """The largest difference of two result tensors; raises unless they
    are equal."""
    import torch

    err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max().item()) \
        if k.numel() else 0
    if not torch.equal(k, p):
        raise AssertionError(f"{what}: kernel != plain (max diff {err})")
    return err


def run_sharded(dev, smi: str, int32_peak: float, signer, big_items) -> dict:
    """Phase sharded: K8, P1-P3 and P4 against their plain versions on the
    card; the paths that run them, each with the launch counts zeroed just
    before and read just after (batch_verify_sharded over one shard and
    over SHARDS shards of the card plus entry.dryrun_multichip(1) for K8;
    MultiDeviceStream over MD_LANES lanes of the card against the
    single-device stream; device_profile cost-model for P4; a synthetic
    scale cell for P1-P3); then their times. Returns the kernels' JSON
    records and the phase's summary. Raises on any failed check."""
    import numpy as np
    import torch

    from tendermint_tpu_torch import entry
    from tendermint_tpu_torch.crypto import phases
    from tendermint_tpu_torch.crypto.ed25519_cuda import curve
    from tendermint_tpu_torch.crypto.ed25519_cuda import multidevice as MD
    from tendermint_tpu_torch.crypto.ed25519_cuda import sharded as S
    from tendermint_tpu_torch.crypto.ed25519_cuda import build as ed_build
    from tendermint_tpu_torch.crypto.ed25519_cuda import stub as ST
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.tools import device_profile as DP

    t_phase = time.perf_counter()
    table = curve.base_table(dev)
    products = PRODUCTS_PER_VERIFY
    # the big commit's signatures, every 97th with its s half zeroed (host
    # valid, rejected by the kernel), each of power 2^40
    pks, msgs, sigs0 = big_items
    n = len(pks)
    sigs = [sg[:32] + bytes(32) if i % TALLY_INVALID_EVERY == 0 else sg
            for i, sg in enumerate(sigs0)]
    expect = np.arange(n) % TALLY_INVALID_EVERY != 0
    powers = [TALLY_POWER] * n

    # -- checks: each kernel against its plain version, every item ----------
    bw, nb, sw, ok = V.prepare_batch(pks, msgs, sigs)
    limbs = S._power_limbs(np.full(n, TALLY_POWER, np.int64) * ok)
    full = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
            (V._as_i32(bw), nb, V._as_i32(sw), limbs)]
    tally_err = 0
    for d in (1, SHARDS):
        for a, b in S._shard_bounds(n, d):
            args = [x[a:b] for x in full]
            kv, ks = V.verify_tally(*args, table)
            pv, ps = V.verify_tally_plain(*args, table)
            tally_err = max(tally_err, _same("ed25519_verify_tally verdicts",
                                             kv, pv),
                            _same("ed25519_verify_tally limb sums", ks, ps))
            if (kv.cpu().numpy() & ok[a:b]).tolist() != expect[a:b].tolist():
                raise AssertionError("ed25519_verify_tally: wrong verdicts "
                                     f"in rows {a}..{b}")
    say(f"phase kernels: ed25519_verify_tally == plain on every item and "
        f"limb sum, {n} signatures (every {TALLY_INVALID_EVERY}th invalid, "
        f"powers 2^40) as 1 shard and as {SHARDS} shards")

    spks, smsgs, ssigs = DP.build_workload(STUB_SIGS)
    (dbw, dnb, dsw), _ = V._pack_stream_dense(spks, smsgs, ssigs, CHUNK)
    dense = V._dense_args(dbw, dnb, dsw, dev)
    slimbs = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, 256, (dbw.shape[0], 8), dtype=np.int32)).to(dev)
    seg = STUB_SIGS // 2   # one segment of the synthetic multidev row
    sp = V.pack_sparse(spks[:seg], smsgs[:seg], ssigs[:seg], CHUNK)
    _, scols, sdv, smlen, sr, sa, ss = [torch.from_numpy(np.array(x)).to(dev)
                                        for x in sp[:7]]
    sparse = (sdv, smlen, sr, sa, ss)
    stub_err = sparse_err = 0
    for work in STUB_CHECK_WORK:
        for row in STUB_SLICE_ROWS:
            for lb in (None, slimbs):
                args = [x[row:] for x in dense]
                lbs = None if lb is None else lb[row:]
                kv, kb, ks = ST.stub_verify_dense(*args, work, limbs=lbs)
                pv, pb, ps = ST.stub_verify_dense_plain(*args, work,
                                                        limbs=lbs)
                stub_err = max(
                    stub_err, _same("stub_verify_dense verdicts", kv, pv),
                    _same("stub_verify_dense burned words", kb, pb),
                    0 if lb is None else _same("stub_verify_dense limb sums",
                                               ks, ps))
            args = [x[row:] for x in sparse]
            kv, kb = ST.stub_verify_sparse(*args, work)
            pv, pb = ST.stub_verify_sparse_plain(*args, work)
            sparse_err = max(sparse_err,
                             _same("stub_verify_sparse verdicts", kv, pv),
                             _same("stub_verify_sparse burned words", kb, pb))
    say(f"phase kernels: stub_verify_dense == plain on {dbw.shape[0]} items "
        f"x NBLK {dbw.shape[1]} (verdicts, burned words, limb sums; with "
        f"and without limbs) and stub_verify_sparse == plain on {seg} items "
        f"x {sdv.shape[1]} diff columns, each at device_work "
        f"{', '.join(map(str, STUB_CHECK_WORK))}, on the whole pack and on "
        f"the slices from rows {', '.join(map(str, STUB_SLICE_ROWS[1:]))}")
    chain = stub_chain_latency(dev, smi)
    # the stubs' ptxas lines are printed with every library's at the build
    sass = _sass_chain(ed_build.PACKAGE.lib_paths()["stub"]) \
        if dev.type == "cuda" else {}
    for fn, rec in sass.items():
        say(f"sass stub: {fn}: {rec['imad']} IMAD, the longest chain of "
            f"dependent IMADs {rec['chain']}")
        # a block of rounds (the remainder loop's round may extend it in
        # the listing): a compiler that folded rounds into a multiply-add
        # by a^k would leave fewer
        want = STUB_CHAIN_BLOCK if "stub_chain" in fn else STUB_BLOCK
        if rec["chain"] < want:
            raise AssertionError(f"{fn}: a chain of {rec['chain']} "
                                 f"dependent IMADs, not {want}")
        for line in rec["lines"][:3] + ["..."] + rec["lines"][-2:]:
            say(f"sass stub: {fn}:   {line}")

    x4 = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, 256, P4_BYTES, dtype=np.uint8)).to(dev)
    k4, p4 = V.probe_sum(x4).item(), V.probe_sum_plain(x4).item()
    if not k4 == p4 == _i32(int(x4.to(torch.int64).sum().item())):
        raise AssertionError(f"probe_sum_u8 at 4 MB: {k4} != plain {p4}")
    say(f"phase kernels: probe_sum_u8 (P4) == plain at {P4_BYTES} bytes "
        f"({k4}) in {V.probe_blocks(P4_BYTES)} blocks")

    # -- the paths, counts zeroed just before and read just after ------------
    V.reset_launches()
    t = time.perf_counter()
    verdicts, totals = {}, {}
    for d in (1, SHARDS):
        verdicts[d], totals[d] = S.batch_verify_sharded(
            pks, msgs, sigs, powers=powers, mesh=[dev] * d)
        if verdicts[d].tolist() != expect.tolist():
            raise AssertionError(f"batch_verify_sharded over {d} shards: "
                                 "wrong verdicts")
        if totals[d] != int(expect.sum()) << 40:
            raise AssertionError(f"batch_verify_sharded over {d} shards: "
                                 f"tally {totals[d]}")
    sharded_s = time.perf_counter() - t
    entry.dryrun_multichip(1, signer=signer)
    tally_launches = V.launches["ed25519_verify_tally"]
    if tally_launches != 1 + SHARDS + 2:
        raise AssertionError(f"{tally_launches} K8 launches, expected "
                             f"{1 + SHARDS + 2}")
    say(f"phase sharded: {n} signatures over 1 and {SHARDS} shards of the "
        f"card: verdicts == expected, exact tally {totals[1]} (~2^"
        f"{totals[1].bit_length() - 1}) both ways, in {sharded_s:.2f} s; "
        f"entry.dryrun_multichip(1) ok; K8 launches {tally_launches}")

    md_pks, md_msgs = pks * 2, msgs * 2
    md_sigs = sigs0 + [_flip(sg, 45, 4) if i % 13 == 0 else sg
                       for i, sg in enumerate(sigs0)]
    md_expect = [True] * n + [i % 13 != 0 for i in range(n)]
    with MD.disabled():
        single = V.batch_verify_stream(md_pks, md_msgs, md_sigs, chunk=CHUNK)
    pool = MD.MultiDeviceStream(devices=[dev] * MD_LANES, min_sigs=0)
    try:
        phases.reset()
        V.reset_launches()
        got = pool.verify(md_pks, md_msgs, md_sigs, CHUNK)
        md_launches = dict(V.launches)
        lanes = sorted({r["device"] for r in phases.recent_segments()})
        if got.tolist() != single.tolist() or got.tolist() != md_expect:
            raise AssertionError("MultiDeviceStream verdicts != the "
                                 "single-device stream's")
        if lanes != [l.label for l in pool.lanes]:
            raise AssertionError(f"segments ran on lanes {lanes}")
        if pool.stats["lane_errors"] or not md_launches[
                "ed25519_verify_sparse"]:
            raise AssertionError(f"MultiDeviceStream: {pool.stats}, "
                                 f"launches {md_launches}")
        walls = {"single": [], "multidev": []}
        for _ in range(3):
            for key, fn in (("single", lambda: V._verify_segmented(
                    md_pks, md_msgs, md_sigs, CHUNK)),
                    ("multidev", lambda: pool.verify(
                        md_pks, md_msgs, md_sigs, CHUNK))):
                t = time.perf_counter()
                fn()
                walls[key].append((time.perf_counter() - t) * 1e3)
    finally:
        pool.shutdown()
    md_ms = {k: statistics.median(v) for k, v in walls.items()}
    say(f"phase sharded: MultiDeviceStream over {MD_LANES} lanes of the card "
        f"({', '.join(lanes)}), {2 * n} signatures: verdicts == the "
        f"single-device stream's; launches {md_launches}; wall "
        f"{md_ms['multidev']:.2f} ms against {md_ms['single']:.2f} ms "
        f"single-device (median of 3, alternated) ({smi})")

    V.reset_launches()
    cost = DP.make_doc("cost-model", {"payload_mb": 4.0, "runs": 4},
                       DP.run_cost_model(dev, 4.0, 4), dev.type)
    p4_launches = V.launches["probe_sum_u8"]
    errs = DP.validate_profile(cost)
    if errs or not p4_launches:
        raise AssertionError(f"cost-model: {errs}, P4 launches "
                             f"{p4_launches}")
    for line in DP.to_markdown(cost).splitlines():
        say(f"  {line}")
    seg_chunks = MD._seg_chunks_from_cost_model(cost, CHUNK)
    say(f"phase sharded: device_profile cost-model (4 MB, 4 runs) ok; "
        f"probe_sum_u8 launches {p4_launches}; fixed dispatch "
        f"{cost['results']['fixed_dispatch_ms']['min']:.4f} ms (min) -> "
        f"segments of {seg_chunks} chunks of {CHUNK} "
        f"(multidevice._seg_chunks_from_cost_model)")

    V.reset_launches()
    ST.reset_launches()
    cell = DP.run_scale_cell(dev.type, 1, [CHUNK], STUB_SIGS, "synthetic",
                             runs=1, device_work=STUB_WORK)
    stub_launches = dict(ST.launches)
    verify_launched = {k: n_ for k, n_ in V.launches.items()
                       if k != "probe_sum_u8" and n_}
    if not all(stub_launches.values()) or verify_launched:
        raise AssertionError(f"synthetic scale cell: stub launches "
                             f"{stub_launches}, verify launches "
                             f"{verify_launched}")
    say(f"phase sharded: device_profile scale cell (synthetic, device_work "
        f"{STUB_WORK}, {STUB_SIGS} signatures): "
        + "; ".join(f"{r['mode']} {r['sigs_per_sec']:.0f} sigs/s"
                    for r in cell["rows"])
        + f"; stub launches {stub_launches}")

    # -- times ---------------------------------------------------------------
    k8_ms = _time_ms(lambda: V.verify_tally(*full, table), dev)
    k8_4_ms = _streams_time_ms(
        [lambda a=a, b=b: V.verify_tally(*[x[a:b] for x in full], table)
         for a, b in S._shard_bounds(n, SHARDS)], dev)
    k8_plain = _time_ms(lambda: V.verify_tally_plain(*full, table), dev, 1, 0)
    k8_bytes = sum(x.numel() * x.element_size() for x in full) \
        + table.numel() * 4 + n + 64
    k8_bound, k8_by = _ops_bound(n * products, k8_bytes, int32_peak)
    say(f"times: ed25519_verify_tally {n} x NBLK {bw.shape[1]}: one launch "
        f"{k8_ms:.4f} ms; {SHARDS} shards on {SHARDS} streams {k8_4_ms:.4f} "
        f"ms (plain {k8_plain:.1f} ms, bound {k8_bound:.4f} ms by {k8_by}) "
        f"({smi})")

    # each stub's time (CUDA events around back-to-back calls), the plain
    # version's, the bound, the chain floor (its rounds x the latency of
    # one dependent round, measured above) and the kernel alone (the
    # profiler's device time)
    nd, words = dbw.shape[0], dbw.shape[1] * 32
    d_bytes = nd * (words * 4 + 4 + 32) + nd * 5
    c = sdv.shape[1]
    s_bytes = seg * (c + 4 + 96) + seg * 5
    stubs = {
        "stub_verify_dense": (
            f"{nd} items x NBLK {dbw.shape[1]}",
            lambda work: ST.stub_verify_dense(*dense, work),
            lambda work: ST.stub_verify_dense_plain(*dense, work),
            # a word read is one add; a round is one multiply-add
            lambda work: _ops_bound(nd * (words + 9 + work), d_bytes,
                                    int32_peak)),
        "stub_verify_sparse": (
            f"{seg} items x {c} columns",
            lambda work: ST.stub_verify_sparse(*sparse, work),
            lambda work: ST.stub_verify_sparse_plain(*sparse, work),
            lambda work: _ops_bound(seg * (c + 97 + work), s_bytes,
                                    int32_peak))}
    stub_t = {}
    for name, (shape, fn, plain_fn, bound_fn) in stubs.items():
        rows = stub_t[name] = {}
        for work in (0, STUB_WORK):
            ms = _time_ms(lambda: fn(work), dev, 20)
            plain = _time_ms(lambda: plain_fn(work), dev, 3)
            bound, by = bound_fn(work)
            alone = _kernel_alone_ms(lambda: fn(work), dev, name + "_kernel")
            floor = work * chain["ns_per_round"] / 1e6
            rows[work] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                          "bound_by": by, "kernel_ms": alone,
                          "chain_floor_ms": floor}
        say(f"times: {name} {shape}: " + "; ".join(
            f"device_work {w}: {r['ms']:.4f} ms, the kernel alone "
            + ("not measured" if r["kernel_ms"] is None
               else f"{r['kernel_ms']:.4f} ms")
            + f" (plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} "
            f"ms by {r['bound_by']}, chain floor {r['chain_floor_ms']:.6f} "
            f"ms: the {_larger(r)} is larger)" for w, r in rows.items())
            + f" ({smi})")
        top = rows[STUB_WORK]
        if top["kernel_ms"] is None:
            raise AssertionError(f"{name}: the profiler shows no device "
                                 "time, so the chain-floor gate cannot run")
        say(f"times: {name} at {STUB_WORK} rounds: the kernel alone "
            f"{top['kernel_ms'] / top['chain_floor_ms']:.3f}x its chain "
            f"floor; a window of 20 calls from the host "
            f"{top['ms'] / top['chain_floor_ms']:.3f}x")
        # the chain sets this kernel's time: at most STUB_FLOOR_LIMIT
        # floors, read on the kernel alone (a host-timed window of a
        # ~0.05 ms launch also times the host)
        if top["kernel_ms"] > STUB_FLOOR_LIMIT * top["chain_floor_ms"]:
            raise AssertionError(
                f"{name} at {STUB_WORK} rounds: the kernel alone "
                f"{top['kernel_ms']:.4f} ms, over {STUB_FLOOR_LIMIT}x its "
                f"chain floor {top['chain_floor_ms']:.4f} ms")

    p4_ms = _time_ms(lambda: V.probe_sum(x4), dev, 20)
    p4_plain = _time_ms(lambda: V.probe_sum_plain(x4), dev, 20)
    p4_lib = _time_ms(lambda: torch.sum(x4, dtype=torch.int32), dev, 20)
    p4_bound, p4_by = _ops_bound(P4_BYTES, P4_BYTES + 4, int32_peak)
    say(f"times: probe_sum_u8 (P4) {P4_BYTES} bytes: {p4_ms:.4f} ms (plain "
        f"{p4_plain:.4f} ms, torch.sum {p4_lib:.4f} ms, bound "
        f"{p4_bound:.6f} ms by {p4_by}) ({smi})")
    # the cost model times this kernel as the fixed cost of a dispatch: it
    # must cost no more than the library's sum of the same bytes (2x leaves
    # room for the card's noise)
    if p4_ms > 2 * p4_lib:
        raise AssertionError(f"probe_sum_u8 at {P4_BYTES} bytes: {p4_ms:.4f}"
                             f" ms, over 2x torch.sum's {p4_lib:.4f} ms")

    def record(name, shape, launches, err, ms, plain, bound, by, lib=None,
               **extra):
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": TPU_KERNELS[name], "shape": shape,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": lib, **extra}

    kernels = [
        record("ed25519_verify_tally", f"{n} items x NBLK {bw.shape[1]}, "
               "one launch", tally_launches, tally_err, k8_ms, k8_plain,
               k8_bound, k8_by, ms_4_shards_4_streams=k8_4_ms),
        *(record(name, f"{stubs[name][0]}, device_work {STUB_WORK}",
                 stub_launches[name], err,
                 *(stub_t[name][STUB_WORK][k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by")),
                 kernel_ms=stub_t[name][STUB_WORK]["kernel_ms"],
                 chain_floor_ms=stub_t[name][STUB_WORK]["chain_floor_ms"],
                 ns_per_round=chain["ns_per_round"],
                 cycles_per_round=chain["cycles_per_round"],
                 **{f"{k}_work_0": v for k, v in stub_t[name][0].items()
                    if k != "chain_floor_ms"})
          for name, err in (("stub_verify_dense", stub_err),
                            ("stub_verify_sparse", sparse_err))),
        record("probe_sum_u8 (P4)", f"{P4_BYTES} bytes", p4_launches,
               abs(k4 - p4), p4_ms, p4_plain, p4_bound, p4_by, p4_lib),
    ]
    phase_s = time.perf_counter() - t_phase
    say(f"phase sharded: {phase_s:.1f} s in all")
    return {"kernels": kernels, "summary": {
        "tally": totals[1], "multidev_ms": md_ms,
        "multidev_launches": md_launches, "cost_model": cost["results"],
        "cost_model_seg_chunks": seg_chunks, "stub_chain": chain,
        "scale_cell": cell["rows"], "phase_s": phase_s}}


# --- SHA-256 (K9) -------------------------------------------------------------

def _sha_bound(shapes, int32_peak):
    """Least time for the SHA-256 of the (n, L) batches in ``shapes``: the
    compressions' integer operations over the INT32 rate, or each input
    byte read once and each digest written once over the memory rate."""
    from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as S

    ops = sum(n * S.n_blocks(length) for n, length in shapes) \
        * SHA256_OPS_PER_COMPRESSION
    nbytes = sum(n * (length + 32) for n, length in shapes)
    ops_s, bytes_s = ops / int32_peak, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def sha256_check(dev, n=SHA_CHECK_N) -> int:
    """Phase kernels for K9: the kernel equals its plain version on ``n``
    messages at each main-path length, and hashlib on a sample of lengths
    around the block boundaries. Returns the largest byte difference."""
    import hashlib

    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as S

    rng = np.random.default_rng(SEED + 1)
    err = 0
    for length in SHA_CHECK_LENGTHS:
        x = torch.from_numpy(rng.integers(0, 256, (n, length),
                                          dtype=np.uint8)).to(dev)
        k, p = S.sha256_many(x), S.sha256_many_plain(x)
        err = max(err, int((k.to(torch.int16) - p.to(torch.int16))
                           .abs().max().item()))
        if not torch.equal(k, p):
            bad = torch.nonzero((k != p).any(dim=1)).flatten()[:20]
            raise AssertionError(f"sha256_many != plain at L={length}, rows "
                                 f"{bad.tolist()}")
    for length in SHA_SPEC_LENGTHS:
        raw = rng.integers(0, 256, (64, length), dtype=np.uint8)
        got = S.sha256_many(torch.from_numpy(raw).to(dev)).cpu().numpy()
        want = b"".join(hashlib.sha256(raw[i].tobytes()).digest()
                        for i in range(64))
        if got.tobytes() != want:
            raise AssertionError(f"sha256_many != hashlib at L={length}")
    say(f"phase kernels: sha256_many == plain on {n} messages at L "
        f"{list(SHA_CHECK_LENGTHS)}, == hashlib at L "
        f"{list(SHA_SPEC_LENGTHS)}")
    return err


def sha256_times(dev, smi: str, int32_peak: float, launches: int,
                 err: int) -> dict:
    """K9 at the full rebuild's shapes: the 2^20 leaf launch, the 2^14
    inner launch, and the 7 launches of one rebuild of a 2^20-key tree.
    The leaf launch is also held against the plain version, digest by
    digest."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as S

    rng = np.random.default_rng(SEED + 3)
    levels = [(STATE_KEYS, 51)] + [(STATE_KEYS >> i, 65)
                                   for i in range(1, 7)]
    xs = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
          .to(dev) for shape in levels]
    leaf_ms = _time_ms(lambda: S.sha256_many(xs[0]), dev, 20)
    small_ms = _time_ms(lambda: S.sha256_many(xs[-1]), dev, 50)
    full_ms = _time_ms(lambda: [S.sha256_many(x) for x in xs], dev, 10)
    # the plain version's first run is its timing's warm-up
    k, p = S.sha256_many(xs[0]), S.sha256_many_plain(xs[0])
    err = max(err, int((k.to(torch.int16) - p.to(torch.int16))
                       .abs().max().item()))
    if not torch.equal(k, p):
        bad = torch.nonzero((k != p).any(dim=1)).flatten()[:20]
        raise AssertionError(f"sha256_many != plain at {levels[0]}, rows "
                             f"{bad.tolist()}")
    plain_ms = _time_ms(lambda: S.sha256_many_plain(xs[0]), dev, 1, 0)
    bound, by = _sha_bound(levels[:1], int32_peak)
    small_bound, small_by = _sha_bound(levels[-1:], int32_peak)
    full_bound, _ = _sha_bound(levels, int32_peak)
    crossover = sha256_route_times(dev, smi)
    say(f"times: sha256_many {levels[0][0]} x {levels[0][1]} B: "
        f"{leaf_ms:.4f} ms, == plain (plain {plain_ms:.2f} ms, bound "
        f"{bound:.4f} ms by {by}); {levels[-1][0]} x 65 B: {small_ms:.4f} ms "
        f"(bound {small_bound:.6f} ms by {small_by}); a full "
        f"rebuild's {len(levels)} launches: {full_ms:.4f} ms (bound "
        f"{full_bound:.4f} ms) ({smi})")
    return {"name": "sha256_many",
            "shape": f"{levels[0][0]} messages x {levels[0][1]} bytes",
            "launches": launches, "max_abs_err": err, "ms": leaf_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "route": "cuda",
            "source": SOURCES["sha256_many"],
            "replaces": TPU_KERNELS["sha256_many"], "ms_2e14_x_65": small_ms,
            "bound_ms_2e14_x_65": small_bound,
            "bound_by_2e14_x_65": small_by,
            "ms_full_rebuild": full_ms, "bound_ms_full_rebuild": full_bound,
            "launches_per_full_rebuild": len(levels),
            "route_ms_65B": crossover}


def sha256_route_times(dev, smi: str) -> dict:
    """Host-clock ms of one tree level of n inner nodes (65 bytes) through
    each route of crypto/merkle.py: the hashlib loop and the device (join,
    pinned upload, kernel, fetch, split), for the crossover against
    TMTPU_MERKLE_DEVICE_MIN."""
    import os

    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.crypto import merkle_fast as mf

    out = {}
    for n in (256, 1024, 4096, 16384, 65536):
        msgs = [os.urandom(65) for _ in range(n)]
        reps = max(3, 65536 // n)
        hashlib_ms = _wall_s(lambda: [merkle.inner_hash(m[1:33], m[33:])
                                      for m in msgs], reps) * 1e3
        dev_ms = _wall_s(lambda: mf.sha256_many_device(msgs, dev),
                         reps) * 1e3
        out[str(n)] = {"hashlib": hashlib_ms, "device": dev_ms}
        say(f"times: a level of {n} inner nodes: hashlib {hashlib_ms:.3f} "
            f"ms, device {dev_ms:.3f} ms ({smi})")
    return out


# --- 5. block execution -------------------------------------------------------

def run_apply(dev, smi: str, signer, state_keys=STATE_KEYS,
              measured_txs=MEASURED_TXS) -> dict:
    """Phase apply: a 150-validator chain with the Merkle kvstore app, seeded
    to ``state_keys`` keys, then the measured heights. Returns the
    per-height records and the main path's launches. Raises on any failed
    check."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.abci.example.kvstore import \
        MerkleKVStoreApplication
    from tendermint_tpu_torch.crypto import Ed25519PubKey
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto import merkle, phases
    from tendermint_tpu_torch.crypto.breaker import device_breaker
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.crypto.merkle_cuda import sha256 as S
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                            state_from_genesis)
    from tendermint_tpu_torch.state.execution import (EmptyEvidencePool,
                                                      NoOpMempool)
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                            GenesisValidator)
    from tendermint_tpu_torch.types.block import Commit

    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    seeds = commits.seeds(rng, APPLY_VALIDATORS)
    pubs = signer.pubkeys(seeds)
    seed_of = {Ed25519PubKey(p).address(): s for s, p in zip(seeds, pubs)}
    genesis = GenesisDoc(
        chain_id=CHAIN_ID, genesis_time_ns=commits.BASE_TIME_S * 10**9,
        validators=[GenesisValidator(Ed25519PubKey(p), 10) for p in pubs])
    app = MerkleKVStoreApplication(interval=4)
    conns = AppConns(local_client_creator(app))
    conns.start()
    state_store, block_store = StateStore(MemDB()), BlockStore(MemDB())
    executor = BlockExecutor(state_store, conns.consensus, NoOpMempool(),
                             EmptyEvidencePool(), block_store)
    chain = {"state": state_from_genesis(genesis),
             "last": Commit(0, 0, BlockID(), []), "keys": []}
    state_store.save(chain["state"])

    def new_txs(n):
        kh, vh = rng.bytes(8 * n).hex(), rng.bytes(16 * n).hex()
        keys = [kh[16 * i:16 * i + 16] for i in range(n)]
        chain["keys"].extend(keys)
        return [f"{k}={vh[32 * i:32 * i + 32]}".encode()
                for i, k in enumerate(keys)]

    def update_txs(n):
        keys = chain["keys"]
        vh = rng.bytes(16 * n).hex()
        return [f"{keys[j]}={vh[32 * i:32 * i + 32]}".encode() for i, j in
                enumerate(rng.choice(len(keys), n, replace=False))]

    def apply(h, txs):
        state = chain["state"]
        proposer = state.validators.get_proposer().address
        block, parts = state.make_block(h, txs, chain["last"], [], proposer)
        bid = BlockID(block.hash(), parts.header())
        t = time.perf_counter()
        chain["state"], _ = executor.apply_block(state, bid, block)
        wall = time.perf_counter() - t
        stamps = [block.header.time_ns + 1_000_000 * (i + 1)
                  for i in range(state.validators.size())]
        chain["last"] = commits.sign_commit(signer, seed_of,
                                            state.validators, CHAIN_ID, h,
                                            bid, stamps)
        block_store.save_block(block, parts, chain["last"])
        seg = [r for r in phases.recent_segments()
               if r["plane"] == "exec"][-1]
        return wall, len(parts.get_reader()), seg

    per_block = state_keys // SEED_BLOCKS
    for h in range(1, SEED_BLOCKS + 1):
        t = time.perf_counter()
        txs = new_txs(per_block)
        wall, size, seg = apply(h, txs)
        say(f"phase apply: seed height {h}: {per_block} txs, block "
            f"{size / 1e6:.1f} MB, apply_block {wall:.2f} s = validate "
            f"{seg['pack_s']:.2f} + execute {seg['dispatch_s']:.2f} + "
            f"commit+persist {seg['fetch_s']:.2f} (height "
            f"{time.perf_counter() - t:.2f} s with tx generation, block "
            f"making, signing and storing)")
    say(f"phase apply: {len(app.state)} keys seeded in "
        f"{time.perf_counter() - t0:.1f} s")

    root_s = []
    imt_root = app._imt.root

    def timed_root(*args, **kw):
        t = time.perf_counter()
        out = imt_root(*args, **kw)
        root_s.append(time.perf_counter() - t)
        return out

    app._imt.root = timed_root
    # device time of every SHA-256 launch: CUDA events around the wrapper
    # (merkle_fast calls it through the module, so it finds this one)
    kernel_events = []
    sha256_many = S.sha256_many

    def timed_sha256_many(x):
        if x.device.type != "cuda":
            return sha256_many(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sha256_many(x)
        end.record()
        kernel_events.append((start, end))
        return out

    S.sha256_many = timed_sha256_many
    V.reset_launches()
    S.reset_launches()
    errors0 = B.stats["device_errors"]
    heights = []
    h = SEED_BLOCKS
    for kind, count in MEASURED:
        for _ in range(count):
            h += 1
            txs = (new_txs if kind == "insert" else update_txs)(measured_txs)
            phases.reset()
            kernel_events.clear()
            tiers0 = dict(merkle.stats)
            launches0 = S.launches["sha256_many"]
            root_s.clear()
            wall, _, seg = apply(h, txs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            kernel_ms = sum(a.elapsed_time(b) for a, b in kernel_events)
            rec = {"height": h, "kind": kind, "txs": len(txs),
                   "apply_ms": wall * 1e3,
                   "validate_ms": seg["pack_s"] * 1e3,
                   "execute_ms": seg["dispatch_s"] * 1e3,
                   "commit_persist_ms": seg["fetch_s"] * 1e3,
                   "merkle_root_ms": sum(root_s) * 1e3,
                   "kernel_ms": kernel_ms,
                   "launches": S.launches["sha256_many"] - launches0,
                   "tiers": {k: merkle.stats[k] - tiers0[k]
                             for k in ("device", "hashlib")}}
            heights.append(rec)
            say(f"phase apply: height {h} ({kind}, {len(txs)} txs, "
                f"{len(app.state)} keys): apply_block {rec['apply_ms']:.1f} "
                f"ms = validate {rec['validate_ms']:.1f} + execute "
                f"{rec['execute_ms']:.1f} + commit+persist "
                f"{rec['commit_persist_ms']:.1f}; merkle root "
                f"{rec['merkle_root_ms']:.1f} ms, sha256_many "
                f"{rec['kernel_ms']:.3f} ms in {rec['launches']} launches; "
                f"messages by tier {rec['tiers']} ({smi})")
            if kind == "insert" and rec["launches"] == 0:
                raise AssertionError(f"height {h}: sha256_many never "
                                     "launched on a full rebuild")
    app._imt.root = imt_root
    S.sha256_many = sha256_many
    launches = {"sha256_many": S.launches["sha256_many"],
                **{k: n for k, n in V.launches.items()}}
    say(f"phase apply: launches {launches}")
    if launches["sha256_many"] == 0 or launches["ed25519_verify_dense"] == 0:
        raise AssertionError(f"the apply path never launched a kernel: "
                             f"{launches}")
    if B.stats["device_errors"] != errors0 or device_breaker.state != "closed":
        raise AssertionError(f"device errors: verify {B.stats}, breaker "
                             f"{device_breaker.state}")
    t = time.perf_counter()
    spec = merkle.hash_from_byte_slices(
        MerkleKVStoreApplication._leaf_items(app.state))
    if chain["state"].app_hash != spec:
        raise AssertionError(f"app hash {chain['state'].app_hash.hex()} != "
                             f"the recursive spec {spec.hex()}")
    say(f"phase apply: app hash {spec.hex()} == the recursive hashlib spec "
        f"over {len(app.state)} keys ({time.perf_counter() - t:.1f} s)")
    return {"heights": heights, "launches": launches,
            "state_keys": len(app.state)}


# --- 6. aggregated BLS commits (K10) -------------------------------------------

def _g2_bound(launches, int32_peak):
    """Least time for G2-add launches given as (lanes, adding lanes,
    doubling lanes): the Fq products those lanes do over the INT32 rate,
    or 3 x 288 bytes a lane over the memory rate."""
    ops = sum(a * FQ_MULS_ADD + d * FQ_MULS_DBL for _, a, d in launches) \
        * PRODUCTS_PER_FQ_MUL
    nbytes = sum(3 * n * G2_LANE_BYTES for n, _, _ in launches)
    ops_s, bytes_s = ops / int32_peak, nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _g2_tree_bound(n, int32_peak):
    """Least time for one launch of the n-key tree: the Fq products of its
    additions of two finite points over the INT32 rate, or its padded
    lanes read once and the root written once over the memory rate."""
    ops = sum(a for _, a, _ in _tree_launches(n)) * FQ_MULS_ADD \
        * PRODUCTS_PER_FQ_MUL
    width = 2 * _tree_launches(n)[0][0]
    ops_s = ops / int32_peak
    bytes_s = (width + 1) * G2_LANE_BYTES / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def _tree_launches(n):
    """(lanes, adding lanes, 0) of each launch of an n-key tree: the
    padded width halves each round and a lane adds two finite points
    while both halves still hold keys."""
    width, live, out = 2, n, []
    while width < n:
        width *= 2
    while width > 1:
        half = width // 2
        out.append((half, max(0, live - half), 0))
        live, width = min(live, half), half
    return out


class _BlsTimers:
    """Patches the routed verify's steps with timers: the K10 launches, the
    tree and the one-key round (CUDA events), hash_to_g1 and the pairing
    (host clock)."""

    def __init__(self):
        from tendermint_tpu_torch.crypto.bls12381 import vec as BV
        from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G

        self.BV, self.G = BV, G
        self.events, self.h2c_s, self.pairing_s = [], [], []

    def _timed(self, fn, acc):
        def wrapper(*args):
            t = time.perf_counter()
            out = fn(*args)
            acc.append(time.perf_counter() - t)
            return out
        return wrapper

    def _evented(self, fn):
        import torch

        def wrapper(*lanes):
            if lanes[0].device.type != "cuda":
                return fn(*lanes)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*lanes)
            end.record()
            self.events.append((start, end))
            return out
        return wrapper

    def __enter__(self):
        self._orig = (self.G.tree_sum, self.G.g2_add_round,
                      self.BV.hash_to_g1, self.BV.multi_pairing_check)
        self.G.tree_sum = self._evented(self._orig[0])
        self.G.g2_add_round = self._evented(self._orig[1])
        self.BV.hash_to_g1 = self._timed(self._orig[2], self.h2c_s)
        self.BV.multi_pairing_check = self._timed(self._orig[3],
                                                  self.pairing_s)
        return self

    def __exit__(self, *exc):
        (self.G.tree_sum, self.G.g2_add_round, self.BV.hash_to_g1,
         self.BV.multi_pairing_check) = self._orig

    def clear(self):
        self.events.clear()
        self.h2c_s.clear()
        self.pairing_s.clear()

    def read(self):
        import torch

        if self.events:
            torch.cuda.synchronize()
        return {"apk_device_ms": sum(a.elapsed_time(b)
                                     for a, b in self.events),
                "hash_to_g1_ms": sum(self.h2c_s) * 1e3,
                "pairing_ms": sum(self.pairing_s) * 1e3}


def _limb_diff(k, p):
    """The largest difference of two uint32 tensors, limb by limb."""
    import torch

    ki = k.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    pi = p.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return int((ki - pi).abs().max().item())


def bls_check(dev, int32_peak) -> dict:
    """Phase kernels for K10: the round equals its plain version on
    BLS_CHECK_LANES lanes of every class and a sample of its sums the
    curve spec's; the Fq product equals its plain version on edge limbs;
    the tree equals the plain tree on every limb of the root at
    BLS_TREE_CHECK_SIZES keys. Returns the largest limb difference of each
    and the check launch's numbers."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.bls12381 import vec as BV
    from tendermint_tpu_torch.crypto.bls12381.curve import g2_to_affine
    from tendermint_tpu_torch.crypto.bls12381.field import P
    from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
    from tendermint_tpu_torch.tools import g2_lanes

    t0 = time.perf_counter()
    ps, qs, kinds = g2_lanes.lane_pairs(np.random.default_rng(SEED + 4),
                                        BLS_CHECK_LANES)
    p, q = G.to_lanes(ps, dev), G.to_lanes(qs, dev)
    pl = G.g2_add_round_plain(p, q)
    k = G.g2_add_round(p, q)
    if not torch.equal(k.view(torch.int32), pl.view(torch.int32)):
        bad = torch.nonzero((k.view(torch.int32) != pl.view(
            torch.int32)).flatten(1).any(1)).flatten()[:20]
        raise AssertionError(
            f"bls_g2_add_round != plain at lanes {bad.tolist()} "
            f"({[kinds[i] for i in bad]})")
    err = _limb_diff(k, pl)
    sample = [i for i in range(0, BLS_CHECK_LANES, 7)
              if kinds[i] != "junk"]
    out = G.from_lanes(k[:max(sample) + 1])
    for i in sample:
        got = None if out[i][2] == (0, 0) else g2_to_affine(out[i])
        if got != g2_lanes.spec_sum(ps[i], qs[i]):
            raise AssertionError(f"bls_g2_add_round lane {i} ({kinds[i]}) "
                                 "!= the curve spec")
    n_add = sum(kd in ("generic", "generic-z", "cancel", "junk")
                for kd in kinds)
    n_dbl = sum(kd in ("double", "double-z") for kd in kinds)
    say(f"phase kernels: bls_g2_add_round == plain on {BLS_CHECK_LANES} lanes"
        f" ({', '.join(f'{c} {kinds.count(c)}' for c in g2_lanes.CLASSES)}),"
        f" == the curve spec on {len(sample)} "
        f"({time.perf_counter() - t0:.1f} s)")

    rng = np.random.default_rng(SEED + 9)
    vals = [0, 1, 2, P - 1, P - 2, pow(2, 384, P)] + [
        (2**384 - d) % P for d in (1, 2, 2**32, 2**64 + 1)] + [
        int.from_bytes(rng.bytes(48), "little") % P for _ in range(22)]
    a = torch.from_numpy(G.fq_to_limbs([x for x in vals for _ in vals]))
    b = torch.from_numpy(G.fq_to_limbs([y for _ in vals for y in vals]))
    a, b = a.to(dev), b.to(dev)
    for reps in (1, 3):
        want = a
        for _ in range(reps):
            want = G.fq_mul_plain(want, b)
        err = max(err, _limb_diff(G.fq_mul(a, b, reps), want))
    if err:
        raise AssertionError(f"bls_fq_mul != plain (max limb diff {err})")
    say(f"phase kernels: bls_fq_mul == plain on {a.shape[0]} pairs of edge "
        f"and random limbs, once and 3 times in a row")

    t0 = time.perf_counter()
    for n in BLS_TREE_CHECK_SIZES:
        affs = g2_lanes.tree_points(np.random.default_rng(SEED + n), n)
        lanes = BV._points_to_lanes(affs, dev)
        want = G.tree_sum_plain(lanes)
        got = G.tree_sum(lanes)
        d = _limb_diff(got, want)
        if d or not torch.equal(got.view(torch.int32),
                                want.view(torch.int32)):
            raise AssertionError(f"bls_g2_tree_sum of {n} keys != the plain "
                                 "tree")
        err = max(err, d)
    say(f"phase kernels: bls_g2_tree_sum == the plain tree on every limb of "
        f"the root's X, Y, Z at {', '.join(map(str, BLS_TREE_CHECK_SIZES))} "
        f"keys (a doubling and a cancel in each tree of 3 keys up) "
        f"({time.perf_counter() - t0:.1f} s)")
    ms = _time_ms(lambda: G.g2_add_round(p, q), dev, 20)
    plain_ms = _time_ms(lambda: G.g2_add_round_plain(p, q), dev, 1, 0)
    bound, by = _g2_bound([(BLS_CHECK_LANES, n_add, n_dbl)], int32_peak)
    return {"err": err, "ms_4096_lanes": ms, "plain_ms_4096_lanes": plain_ms,
            "bound_ms_4096_lanes": bound, "bound_by_4096_lanes": by}


def run_bls(dev, smi: str, int32_peak: float, max_sm_mhz: float,
            signer) -> dict:
    """Phase bls, the verify half: aggregated commits of BLS_SIZES
    validators through the three verify_commit entry points, the three
    rejections, the kernels' times and the verify rates. Returns the
    kernels' JSON records (their launches on this main path so far) and
    the rates. Raises on any failed check."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import bls12381 as bls
    from tendermint_tpu_torch.crypto.bls12381 import vec as BV
    from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types.errors import (
        ErrNotEnoughVotingPowerSigned, ErrWrongSignature)

    os.environ["TMTPU_BLS_BACKEND"] = "cuda"
    rng = np.random.default_rng(SEED + 5)
    t0 = time.perf_counter()
    fixtures = {n: commits.BlsCommitFixture(signer, rng, n, BLS_CHAIN_ID,
                                            100 + n) for n in BLS_SIZES}
    say(f"phase bls: {sum(BLS_SIZES)} BLS keys with proofs of possession "
        f"and {len(BLS_SIZES)} aggregated commits in "
        f"{time.perf_counter() - t0:.1f} s ({signer.workers} workers)")
    main_launches = {"bls_g2_tree_sum": 0, "bls_g2_add_round": 0}

    def drive(label, fn, kernel, want_err=None):
        """fn with the counts zeroed just before and read just after: one
        launch of ``kernel`` (the tree, or the round for one key), no other
        K10 launch."""
        G.reset_launches()
        calls0 = BV.stats["device_calls"]
        t = time.perf_counter()
        err = None
        try:
            fn()
        except (ErrWrongSignature, ErrNotEnoughVotingPowerSigned) as e:
            err = e
        dt = time.perf_counter() - t
        got = {k: G.launches[k] for k in main_launches}
        for k in main_launches:
            main_launches[k] += got[k]
        if got != {k: int(k == kernel) for k in main_launches}:
            raise AssertionError(f"{label}: K10 launches {got}, expected one "
                                 f"of {kernel}")
        if BV.stats["device_calls"] <= calls0:
            raise AssertionError(f"{label}: no device call")
        if BV.stats["device_errors"]:
            raise AssertionError(f"{label}: device errors {BV.stats}")
        if want_err is None and err is not None:
            raise AssertionError(f"{label}: rejected: {err}")
        if want_err is not None and str(err) != str(want_err):
            raise AssertionError(f"{label}: {err!r}, expected {want_err!r}")
        say(f"phase bls: {label}: {'rejected: ' + str(err) if err else 'ok'}"
            f" in {dt * 1e3:.2f} ms; K10 launches {got}")
        return dt

    first_ms = {}
    tree = "bls_g2_tree_sum"
    for n, fx in fixtures.items():
        first_ms[str(n)] = drive(f"verify_commit-{n} (first sight of its "
                                 f"keys)", fx.verify, tree) * 1e3
        drive(f"verify_commit-{n}", fx.verify, tree)
        drive(f"verify_commit_light-{n}", fx.verify_light, tree)
        drive(f"verify_commit_light_trusting-{n}", fx.verify_light_trusting,
              tree)
        total = fx.valset.total_voting_power()
        needed = total * 2 // 3
        wrong = fx.make_commit(range(n), msg=fx.message(fx.height + 1))
        drive(f"wrong-aggregate-{n}", lambda: fx.verify(wrong), tree,
              ErrWrongSignature(-1, wrong.agg_sig))
        k = needed // 10
        sub = fx.make_commit(range(k))
        drive(f"sub-quorum-{n} ({k} signers)", lambda: fx.verify(sub), tree,
              ErrNotEnoughVotingPowerSigned(10 * k, needed))
        one = fx.make_commit([0])
        drive(f"single-signer-{n} (the one-key probe)", lambda: fx.verify(one),
              "bls_g2_add_round", ErrNotEnoughVotingPowerSigned(10, needed))

    # -- times ----------------------------------------------------------------
    lanes = {}
    for n, fx in fixtures.items():
        affs = [bls.decompress_pubkey(v.pub_key.bytes())
                for v in fx.valset.validators]
        lanes[n] = BV._points_to_lanes(affs, dev)
    first = lanes[BLS_SIZES[0]]
    half = first.shape[0] // 2
    p128, q128 = first[:half].contiguous(), first[half:].contiguous()
    one_ms = _time_ms(lambda: G.g2_add_round(p128, q128), dev, 50)
    one_plain = _time_ms(lambda: G.g2_add_round_plain(p128, q128), dev, 1, 0)
    one_bound, _ = _g2_bound(_tree_launches(BLS_SIZES[0])[:1], int32_peak)
    # one Fq product alone: a chain of dependent products on one thread,
    # less an empty launch (no product)
    a1 = torch.from_numpy(G.fq_to_limbs([SEED])).to(dev)
    b1 = torch.from_numpy(G.fq_to_limbs([SEED + 1])).to(dev)
    launch_ms = _time_ms(lambda: G.fq_mul(a1, b1, 0), dev, 50)
    chain_ms = _time_ms(lambda: G.fq_mul(a1, b1, FQ_CHAIN_REPS), dev, 5)
    fq_ns = (chain_ms - launch_ms) * 1e6 / FQ_CHAIN_REPS
    fq_cycles = fq_ns * max_sm_mhz / 1e3
    say(f"times: bls_fq_mul alone: {fq_ns:.1f} ns a dependent product "
        f"({fq_cycles:.0f} cycles at the max SM clock of {max_sm_mhz} MHz; "
        f"a chain of {FQ_CHAIN_REPS} on one thread less an empty launch of "
        f"{launch_ms:.4f} ms) ({smi})")
    trees = {}
    for n, ln in lanes.items():
        ms = _time_ms(lambda: G.tree_sum(ln), dev, 20)
        want = {}
        plain = _time_ms(lambda: want.update(sum=G.tree_sum_plain(ln)), dev,
                         1, 0)
        got = G.tree_sum(ln)
        if not torch.equal(got.view(torch.int32),
                           want["sum"].view(torch.int32)):
            raise AssertionError(f"the {n}-key tree != its plain version")
        bound, by = _g2_tree_bound(n, int32_peak)
        levels = len(_tree_launches(n))
        critical = levels * G2_PRODUCT_LEVELS * fq_ns / 1e6 + launch_ms
        trees[n] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                    "bound_by": by, "levels": levels,
                    "critical_path_ms": critical}
        say(f"times: bls_g2_tree_sum of {n} keys ({ln.shape[0]} lanes, "
            f"{levels} levels, one launch): {ms:.4f} ms (plain "
            f"{plain:.1f} ms, bound {bound:.6f} ms by {by}; critical path "
            f"{levels} levels x "
            f"{G2_PRODUCT_LEVELS} products + one launch = {critical:.4f} ms, "
            f"the tree at {ms / critical:.2f}x it) ({smi})")
    say(f"times: bls_g2_add_round one launch of {half} lanes: "
        f"{one_ms:.4f} ms (plain {one_plain:.1f} ms, bound {one_bound:.6f} "
        f"ms); "
        f"library: none, no PyTorch call adds G2 points ({smi})")

    # where an aggregated verify spends its time, and verifies per second
    rates, breakdown = {}, {}
    for n, fx in fixtures.items():
        os.environ["TMTPU_BLS_BACKEND"] = "cuda"
        pks = [v.pub_key.bytes() for v in fx.valset.validators]
        bls._g2_cache.clear()
        t = time.perf_counter()
        for pk in pks:
            bls.decompress_pubkey(pk)
        decompress_ms = (time.perf_counter() - t) * 1e3
        bls._c.reset_h2c_cache()
        with _BlsTimers() as tm:
            t = time.perf_counter()
            fx.verify()
            wall = (time.perf_counter() - t) * 1e3
            cold = tm.read()
            tm.clear()
            fx.verify()
            warm = tm.read()
        apk_host_ms = _wall_s(lambda: BV.aggregate_pubkeys_vec(pks), 5) * 1e3
        breakdown[str(n)] = {"decompress_first_sight_ms": decompress_ms,
                             "verify_ms": wall, "apk_host_ms": apk_host_ms,
                             "apk_device_ms": cold["apk_device_ms"],
                             "hash_to_g1_cold_ms": cold["hash_to_g1_ms"],
                             "hash_to_g1_warm_ms": warm["hash_to_g1_ms"],
                             "pairing_ms": cold["pairing_ms"]}
        say(f"times: aggregated verify_commit at {n}: first sight of the keys"
            f" {first_ms[str(n)]:.1f} ms (decompress and subgroup checks "
            f"alone {decompress_ms:.1f} ms); warm keys, cold hash: "
            f"{wall:.2f} ms = apk {apk_host_ms:.2f} ms on the host clock "
            f"({cold['apk_device_ms']:.4f} ms on the card) + hash_to_g1 "
            f"{cold['hash_to_g1_ms']:.2f} ms + pairing "
            f"{cold['pairing_ms']:.2f} ms ({smi})")
        for route in ("cuda", "scalar"):
            os.environ["TMTPU_BLS_BACKEND"] = route

            def cold_apk():
                bls._apk_cache.clear()
                fx.verify()

            def apk_only():
                if route == "cuda":
                    return BV.aggregate_pubkeys_vec(pks)
                bls._apk_cache.clear()
                return bls.aggregate_pubkeys(pks)

            r = {"apk_ms": _wall_s(apk_only, 5) * 1e3,
                 "verify_apk_cold_ms": _wall_s(cold_apk, 5) * 1e3,
                 "verify_warm_ms": _wall_s(fx.verify, 5) * 1e3}
            r["verifies_per_s_apk_cold"] = 1e3 / r["verify_apk_cold_ms"]
            r["verifies_per_s_warm"] = 1e3 / r["verify_warm_ms"]
            rates[f"{route}-{n}"] = r
            say(f"times: verify_commit {n} on the {route} route: apk "
                f"{r['apk_ms']:.3f} ms; verify with the apk cache cleared "
                f"{r['verify_apk_cold_ms']:.2f} ms = "
                f"{r['verifies_per_s_apk_cold']:.2f}/s, warm "
                f"{r['verify_warm_ms']:.2f} ms = "
                f"{r['verifies_per_s_warm']:.2f}/s ({smi})")
    os.environ["TMTPU_BLS_BACKEND"] = "cuda"
    t150 = trees[BLS_SIZES[0]]
    tree_record = {
        "name": "bls_g2_tree_sum", "route": "cuda",
        "source": SOURCES["bls_g2_tree_sum"],
        "replaces": TPU_KERNELS["bls_g2_tree_sum"],
        "shape": f"a {BLS_SIZES[0]}-key tree: {first.shape[0]} lanes, "
                 f"{t150['levels']} levels, one launch",
        "launches": main_launches["bls_g2_tree_sum"], "ms": t150["ms"],
        "plain_ms": t150["plain_ms"], "bound_ms": t150["bound_ms"],
        "bound_by": t150["bound_by"], "library_ms": None,
        "critical_path_ms": t150["critical_path_ms"],
        "fq_mul_ns": fq_ns, "fq_mul_cycles": fq_cycles,
        "empty_launch_ms": launch_ms}
    for n in BLS_SIZES[1:]:
        for key in ("ms", "plain_ms", "bound_ms", "critical_path_ms"):
            tree_record[f"{key}_tree_{n}"] = trees[n][key]
    round_record = {
        "name": "bls_g2_add_round", "route": "cuda",
        "source": SOURCES["bls_g2_add_round"],
        "replaces": TPU_KERNELS["bls_g2_add_round"],
        "shape": f"one round of {half} lanes (the {BLS_SIZES[0]}-key tree's "
                 f"first level); on the main path the one-key probe",
        "launches": main_launches["bls_g2_add_round"], "ms": one_ms,
        "plain_ms": one_plain, "bound_ms": one_bound,
        "bound_by": "operations", "library_ms": None}
    return {"kernels": [tree_record, round_record], "rates": rates,
            "breakdown": breakdown}


def run_bls_apply(dev, smi: str, signer) -> dict:
    """Phase bls, the apply half: a BLS_APPLY_VALIDATORS-validator bls12381
    chain with the Merkle kvstore app; BLS_APPLY_HEIGHTS heights whose
    LastCommit is the VoteSet's aggregated commit of every validator's
    precommit. Returns the per-height records and the tree's launches."""
    import numpy as np

    from tendermint_tpu_torch.abci.example.kvstore import \
        MerkleKVStoreApplication
    from tendermint_tpu_torch.crypto import (Bls12381PrivKey,
                                             Bls12381PubKey)
    from tendermint_tpu_torch.crypto import bls12381 as bls
    from tendermint_tpu_torch.crypto import merkle, phases
    from tendermint_tpu_torch.crypto.bls12381 import vec as BV
    from tendermint_tpu_torch.crypto.bls12381_cuda import g2 as G
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.proxy import AppConns, local_client_creator
    from tendermint_tpu_torch.state import (BlockExecutor, StateStore,
                                            state_from_genesis)
    from tendermint_tpu_torch.state.execution import (EmptyEvidencePool,
                                                      NoOpMempool)
    from tendermint_tpu_torch.store import BlockStore
    from tendermint_tpu_torch.tools import commits
    from tendermint_tpu_torch.types import (BlockID, GenesisDoc,
                                            GenesisValidator, MockPV,
                                            SignedMsgType, Vote, VoteSet)
    from tendermint_tpu_torch.types.block import AggregatedCommit, Commit
    from tendermint_tpu_torch.types.params import (ConsensusParams,
                                                   SignatureParams,
                                                   ValidatorParams)

    chain_id = BLS_CHAIN_ID + "-apply"
    rng = np.random.default_rng(SEED + 6)
    t0 = time.perf_counter()
    key_seeds = commits.seeds(rng, BLS_APPLY_VALIDATORS)
    keys = signer.bls_keys(key_seeds)
    pvs = [MockPV(Bls12381PrivKey(bls.sk_to_bytes(bls.sk_from_seed(s))))
           for s in key_seeds]
    genesis = GenesisDoc(
        chain_id=chain_id, genesis_time_ns=commits.BASE_TIME_S * 10**9,
        consensus_params=ConsensusParams(
            validator=ValidatorParams(["bls12381"]),
            signature=SignatureParams("bls12381", True)),
        validators=[GenesisValidator(Bls12381PubKey(pk), 10, pop=pop)
                    for pk, pop in keys])
    t1 = time.perf_counter()
    state = state_from_genesis(genesis)
    say(f"phase bls apply: {BLS_APPLY_VALIDATORS} keys in "
        f"{t1 - t0:.1f} s; genesis with {BLS_APPLY_VALIDATORS} proofs of "
        f"possession checked in {time.perf_counter() - t1:.1f} s")
    app = MerkleKVStoreApplication(interval=4)
    conns = AppConns(local_client_creator(app))
    conns.start()
    state_store, block_store = StateStore(MemDB()), BlockStore(MemDB())
    executor = BlockExecutor(state_store, conns.consensus, NoOpMempool(),
                             EmptyEvidencePool(), block_store)
    state_store.save(state)
    last = Commit(0, 0, BlockID(), [])
    heights, launches = [], 0
    with _BlsTimers() as tm:
        for h in range(1, BLS_APPLY_HEIGHTS + 2):
            txs = [f"{rng.bytes(8).hex()}={rng.bytes(16).hex()}".encode()
                   for _ in range(BLS_APPLY_TXS)]
            block, parts = state.make_block(
                h, txs, last, [], state.validators.get_proposer().address)
            bid = BlockID(block.hash(), parts.header())
            vals = state.validators
            phases.reset()
            tm.clear()
            G.reset_launches()
            errors0 = BV.stats["device_errors"]
            t = time.perf_counter()
            state, _ = executor.apply_block(state, bid, block)
            wall = time.perf_counter() - t
            n = G.launches["bls_g2_tree_sum"]
            launches += n
            seg = [r for r in phases.recent_segments()
                   if r["plane"] == "exec"][-1]
            rec = {"height": h, "txs": len(txs),
                   "last_commit": type(block.last_commit).__name__,
                   "apply_ms": wall * 1e3,
                   "validate_ms": seg["pack_s"] * 1e3,
                   "execute_ms": seg["dispatch_s"] * 1e3,
                   "commit_persist_ms": seg["fetch_s"] * 1e3,
                   "launches": n, **tm.read()}
            heights.append(rec)
            if G.launches["bls_g2_add_round"] or h > 1 and (
                    n != 1 or not isinstance(block.last_commit,
                                             AggregatedCommit)):
                raise AssertionError(f"height {h}: {n} K10 launches for a "
                                     f"{type(block.last_commit).__name__}")
            if BV.stats["device_errors"] != errors0:
                raise AssertionError(f"height {h}: device errors "
                                     f"{BV.stats}")
            t, made = time.perf_counter(), ""
            if h <= BLS_APPLY_HEIGHTS:
                vs = VoteSet(chain_id, h, 0, SignedMsgType.PRECOMMIT, vals)
                for pv in pvs:
                    addr = pv.get_pub_key().address()
                    i, _ = vals.get_by_address(addr)
                    v = Vote(SignedMsgType.PRECOMMIT, h, 0, bid,
                             block.header.time_ns + 1_000_000 * (i + 1),
                             addr, i, b"")
                    pv.sign_vote(chain_id, v)
                    if not vs.add_vote(v):
                        raise AssertionError(f"height {h}: vote {i} refused")
                last = vs.make_commit()
                block_store.save_block(block, parts, last)
                made = (f"; {BLS_APPLY_VALIDATORS} precommits signed, added "
                        f"and aggregated in {time.perf_counter() - t:.1f} s")
            say(f"phase bls apply: height {h} ({len(txs)} txs, LastCommit "
                f"{rec['last_commit']}): apply_block {rec['apply_ms']:.1f} ms"
                f" = validate {rec['validate_ms']:.1f} (apk "
                f"{rec['apk_device_ms']:.4f} ms on the card in {n} launches, "
                f"hash_to_g1 {rec['hash_to_g1_ms']:.2f} ms, pairing "
                f"{rec['pairing_ms']:.2f} ms) + execute "
                f"{rec['execute_ms']:.1f} + commit+persist "
                f"{rec['commit_persist_ms']:.1f}{made} ({smi})")
    spec = merkle.hash_from_byte_slices(
        MerkleKVStoreApplication._leaf_items(app.state))
    if state.app_hash != spec:
        raise AssertionError(f"bls chain: app hash {state.app_hash.hex()} "
                             f"!= the recursive spec {spec.hex()}")
    say(f"phase bls apply: app hash {spec.hex()} == the recursive hashlib "
        f"spec over {len(app.state)} keys; bls_g2_tree_sum launches "
        f"{launches}")
    return {"heights": heights, "launches": launches}


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
    from tendermint_tpu_torch.crypto import cuda_build
    from tendermint_tpu_torch.crypto.ed25519_cuda import build as ed_build
    from tendermint_tpu_torch.crypto.bls12381_cuda import build as bls_build
    from tendermint_tpu_torch.crypto.merkle_cuda import build as sha_build
    from tendermint_tpu_torch.tools import commits

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
    pkgs = (ed_build.PACKAGE, sha_build.PACKAGE, bls_build.PACKAGE)
    cuda_build.build_all(*pkgs)  # one nvcc per source
    for pkg in pkgs:
        for lib in pkg.sources:
            pkg.library(lib)
        for lib, log in pkg.build_logs.items():
            for line in _ptxas_lines(log):
                say(f"ptxas {lib}: {line}")
    say(f"phase card: kernels built in {time.perf_counter() - t0:.1f} s")
    int32_peak = (props.multi_processor_count * INT32_LANES_PER_SM
                  * max_sm_mhz * 1e6)

    with commits.Signer() as signer:
        result = run(dev, smi, int32_peak, signer)
        sharded = run_sharded(dev, smi, int32_peak, signer,
                              result.pop("big_items"))
        keys = result.pop("keys")
        t_light = time.perf_counter()
        light = run_light(dev, smi, signer, keys[:LIGHT_VALIDATORS])
        say(f"phase light: {time.perf_counter() - t_light:.1f} s in all")
        planes = run_planes(dev, smi, signer, keys)
        t_fs = time.perf_counter()
        fastsync = run_fastsync(dev, smi, signer, keys[:FASTSYNC_VALIDATORS])
        fastsync["summary"]["phase_s"] = time.perf_counter() - t_fs
        say(f"phase fastsync: {fastsync['summary']['phase_s']:.1f} s in all "
            f"({smi})")
        t_cs = time.perf_counter()
        consensus = run_consensus(dev, smi, signer,
                                  keys[:CONSENSUS_SIZES[-1][0]])
        consensus["summary"]["phase_s"] = time.perf_counter() - t_cs
        say(f"phase consensus: {consensus['summary']['phase_s']:.1f} s in "
            f"all; launches {consensus['launches']} ({smi})")
        sha_err = sha256_check(dev)
        apply = run_apply(dev, smi, signer)
        t_bls = time.perf_counter()
        bls_kernel = bls_check(dev, int32_peak)
        bls = run_bls(dev, smi, int32_peak, max_sm_mhz, signer)
        bls_apply = run_bls_apply(dev, smi, signer)
        bls_s = time.perf_counter() - t_bls
    for k in result["kernels"]:  # K5/K6, K7 and K11 on the light path,
        # the evidence pool, the vote batcher, the ingest plane, fast sync
        # and consensus
        k["launches"] += light["launches"].get(k["name"], 0) + \
            planes["launches"].get(k["name"], 0) + \
            fastsync["launches"].get(k["name"], 0) + \
            consensus["launches"].get(k["name"], 0)
    result["kernels"] += sharded["kernels"]
    result["kernels"].append(sha256_times(
        dev, smi, int32_peak, apply["launches"]["sha256_many"], sha_err))
    tree, rnd = bls["kernels"]
    tree["launches"] += bls_apply["launches"] + \
        light["launches"]["bls_g2_tree_sum"]
    tree["max_abs_err"] = rnd["max_abs_err"] = bls_kernel.pop("err")
    rnd.update(bls_kernel)
    result["kernels"] += [tree, rnd]
    say(f"phase bls: {bls_s:.1f} s in all; K10 launches on the main path: "
        f"bls_g2_tree_sum {tree['launches']}, bls_g2_add_round "
        f"{rnd['launches']}")
    say(f"card and power limit: {smi}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"verify_commit_sigs_per_s":
                    result["verify_commit_sigs_per_s"],
                    "apply_block": apply["heights"],
                    "bls_verify": bls["rates"],
                    "bls_verify_breakdown": bls["breakdown"],
                    "bls_apply_block": bls_apply["heights"],
                    "sharded": sharded["summary"],
                    "light": light["summary"], **planes["summary"],
                    "fastsync": fastsync["summary"],
                    "consensus": consensus["summary"],
                    "card": smi}))
    say(json.dumps({"kernels": result["kernels"]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
