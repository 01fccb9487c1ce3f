"""Device-plane profiler of the port: the counterpart of the JAX package's
``tools/device_profile.py``, on the card.

Three subcommands, each emitting a schema-versioned JSON document
(``tmtpu-device-profile/v1``, the JAX tool's schema) and a markdown table:

* ``cost-model`` — the dispatch cost model: fixed dispatch cost (input
  resident on the card, one int32 out), upload bandwidth from a payload-size
  ladder, the near-copy check (a payload that differs in two bytes from the
  last one pays full price), the same-thread check (two dispatches from one
  thread against one) and the worker-overlap check (two threads, each on
  its own stream, against two dispatches from one). The dispatched kernel
  is ``probe_sum_u8`` (K11, ``csrc/probe.cu``), which computes exactly what
  the JAX tool's ``touch`` (P4) does: the int32 sum of a uint8 payload.
  Timed with CUDA events on the card.
* ``sweep`` — chunk size x SEG_CHUNKS grid through the port's
  ``batch_verify_stream``: signatures per second, pack share and pipeline
  overlap from crypto/phases.py.
* ``scale`` — device counts, in this process, over the cards present (a
  count above them raises): the ``sharded`` verify-and-tally path
  (sharded.py, K8), ``threads`` (one thread per device packs and launches
  a dense stream shard) and ``multidev`` (the pool's MultiDeviceStream).
  CPU shards run only with ``--device cpu``.

Workloads: ``--workload ed25519`` (and ``auto``, the default) runs the real
verify kernels; ``--workload synthetic`` swaps in the stub kernels
(``csrc/stub.cu``: P1-P3), which take the same wire formats and burn
``--device-work`` LCG rounds per item on the card in place of a verify.
Signature bytes are random: the verify kernels do the same work for an
invalid signature, so no keys are needed.

    python -m tendermint_tpu_torch.tools.device_profile cost-model --out p.json
    python -m tendermint_tpu_torch.tools.device_profile sweep --chunks 1024,2048
    python -m tendermint_tpu_torch.tools.device_profile scale --devices 1
    python -m tendermint_tpu_torch.tools.device_profile --self-test   # CPU
"""

from __future__ import annotations

import argparse
import contextlib
import json
import platform
import statistics
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

SCHEMA = "tmtpu-device-profile/v1"
#: synthetic scale cells burn this many LCG rounds per item on the device,
#: so that the dispatch topology, not host packing, is what scales
DEFAULT_SCALE_DEVICE_WORK = 20000
KINDS = ("cost-model", "sweep", "scale")
MB = 1 << 20

#: per-kind required result keys (the schema's load-bearing part)
REQUIRED_RESULTS = {
    "cost-model": ("fixed_dispatch_ms", "transfer", "no_cross_run_dedup",
                   "same_thread_pipelining", "worker_overlap"),
    "sweep": ("workload", "table"),
    "scale": ("workload", "table"),
}
_ROW_KEYS = {
    "sweep": ("chunk", "seg_chunks", "sigs_per_sec"),
    "scale": ("devices", "mode", "sigs_per_sec"),
}


# -- schema -------------------------------------------------------------------

def _card() -> Optional[str]:
    """nvidia-smi's name and power limit of the cards, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def platform_info(device: str) -> Dict:
    info: Dict = {"python": sys.version.split()[0],
                  "machine": platform.machine(), "torch": torch.__version__,
                  "backend": device}
    if device == "cuda":
        n = torch.cuda.device_count()
        info["n_devices"] = n
        info["devices"] = [f"cuda:{i}" for i in range(n)]
        info["kind"] = [torch.cuda.get_device_name(i) for i in range(n)]
        info["card"] = _card()
    else:
        info["n_devices"] = 1
        info["devices"] = ["cpu:0"]
    return info


def make_doc(kind: str, config: Dict, results: Dict,
             device: str = "cpu") -> Dict:
    return {
        "schema": SCHEMA,
        "kind": kind,
        "generated_by": "tendermint_tpu_torch/tools/device_profile.py",
        "generated_unix": time.time(),
        "platform": platform_info(device),
        "config": config,
        "results": results,
    }


def validate_profile(doc) -> List[str]:
    """Schema check of a profile document; the list of problems (empty =
    valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, want object"]
    if doc.get("schema") != SCHEMA:
        errs.append(f"schema: want {SCHEMA!r}, got {doc.get('schema')!r}")
    kind = doc.get("kind")
    if kind not in KINDS:
        errs.append(f"kind: want one of {KINDS}, got {kind!r}")
    if not isinstance(doc.get("generated_unix"), (int, float)):
        errs.append("generated_unix: missing or not a number")
    plat = doc.get("platform")
    if not isinstance(plat, dict):
        errs.append("platform: missing or not an object")
    else:
        if not isinstance(plat.get("backend"), str):
            errs.append("platform.backend: missing or not a string")
        if not isinstance(plat.get("n_devices"), int):
            errs.append("platform.n_devices: missing or not an int")
        if not isinstance(plat.get("devices"), list):
            errs.append("platform.devices: missing or not a list")
    if not isinstance(doc.get("config"), dict):
        errs.append("config: missing or not an object")
    res = doc.get("results")
    if not isinstance(res, dict):
        errs.append("results: missing or not an object")
        return errs
    for key in REQUIRED_RESULTS.get(kind, ()):
        if key not in res:
            errs.append(f"results.{key}: missing")
    if kind == "cost-model" and isinstance(res.get("transfer"), dict):
        bw = res["transfer"].get("bandwidth_mbps")
        # None = ladder delta below the noise floor; a non-finite number
        # would serialize as invalid JSON (Infinity/NaN tokens)
        if bw is not None and not (isinstance(bw, (int, float))
                                   and -1e18 < bw < 1e18):
            errs.append(f"results.transfer.bandwidth_mbps: bad value {bw!r}")
    row_keys = _ROW_KEYS.get(kind)
    if row_keys is not None:
        table = res.get("table")
        if not isinstance(table, list) or not table:
            errs.append("results.table: missing or empty")
            return errs
        for i, row in enumerate(table):
            if not isinstance(row, dict):
                errs.append(f"results.table[{i}]: not an object")
                continue
            for k in row_keys:
                if k not in row:
                    errs.append(f"results.table[{i}].{k}: missing")
            sps = row.get("sigs_per_sec")
            if not (isinstance(sps, (int, float)) and sps >= 0):
                errs.append(f"results.table[{i}].sigs_per_sec: bad value "
                            f"{sps!r}")
    return errs


def to_markdown(doc: Dict) -> str:
    """A compact markdown rendering of the profile."""
    kind = doc.get("kind")
    plat = doc.get("platform", {})
    head = (f"### device_profile {kind} — backend {plat.get('backend')}"
            f" ({plat.get('n_devices')} devices"
            + (f", {plat['card']}" if plat.get("card") else "") + ")")
    res = doc.get("results", {})
    lines = [head, ""]
    if kind == "cost-model":
        fd = res["fixed_dispatch_ms"]
        bw = res["transfer"].get("bandwidth_mbps")
        pipe, ov = res["same_thread_pipelining"], res["worker_overlap"]
        lines += ["| probe | result |", "|---|---|",
                  f"| fixed dispatch (resident input) | "
                  f"{fd['min']:.4f}/{fd['med']:.4f} ms min/med |",
                  "| upload bandwidth (per thread) | "
                  + (f"{bw:.1f} MB/s |" if bw is not None
                     else "n/a (ladder delta below noise floor) |"),
                  "| near-copy payload | "
                  + ("full price |" if res["no_cross_run_dedup"]["holds"]
                     else "CHEAPER |"),
                  f"| same-thread pipelining | "
                  f"{'DETECTED' if pipe['pipelined'] else 'none (2x cost)'}"
                  f" (ratio {pipe['ratio']:.2f}) |",
                  f"| worker-thread overlap | "
                  f"{'works' if ov['overlaps'] else 'NO OVERLAP'} "
                  f"(ratio {ov['ratio']:.2f}) |"]
    elif kind == "sweep":
        lines += ["| chunk | SEG_CHUNKS | sigs/s | pack share | overlap |",
                  "|---|---|---|---|---|"]
        for r in res["table"]:
            ov = r.get("overlap_ratio")
            lines.append(
                f"| {r['chunk']} | {r['seg_chunks']} | "
                f"{r['sigs_per_sec']:.0f} | {r.get('pack_share', 0):.3f} | "
                f"{'-' if ov is None else f'{ov:.2f}'} |")
    elif kind == "scale":
        lines += ["| devices | mode | chunk | threads | sigs/s |",
                  "|---|---|---|---|---|"]
        for r in res["table"]:
            lines.append(
                f"| {r['devices']} | {r['mode']} | "
                f"{r.get('chunk') or '-'} | {r.get('threads') or '-'} | "
                f"{r['sigs_per_sec']:.0f} |")
    return "\n".join(lines)


# -- workload -----------------------------------------------------------------

def build_workload(n: int, msg_len: int = 110, seed: int = 7):
    """Commit-shaped batch: a shared message template with 8 varying
    'timestamp' bytes per item (the sparse wire format the real path uses),
    random 32-byte pks, random 64-byte sigs with the s half's top byte
    zeroed (s < L, so the host mask passes every row). The verdicts are
    meaningless; the kernels do the same work either way."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 256, msg_len, dtype=np.uint8)
    arr = np.broadcast_to(tpl, (n, msg_len)).copy()
    ts = (1_700_000_000_000_000_000 + np.arange(n, dtype=np.uint64))
    for k in range(8):  # 8 varying bytes, big-endian, vote-timestamp-like
        arr[:, 40 + k] = ((ts >> (8 * (7 - k))) & 0xFF).astype(np.uint8)
    msgs = [row.tobytes() for row in arr]
    pks = [b.tobytes() for b in rng.integers(0, 256, (n, 32), dtype=np.uint8)]
    sig_arr = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    sig_arr[:, 63] = 0  # s < L
    sigs = [b.tobytes() for b in sig_arr]
    return pks, msgs, sigs


def resolve_workload(choice: str) -> str:
    """``auto`` means the real kernels; the stubs only when asked for."""
    return "ed25519" if choice == "auto" else choice


def install_stub_kernels(V, sharded=None, device_work: int = 0):
    """Swap the verify kernels of ``V`` (crypto/ed25519_cuda/verify.py) —
    and ``sharded``'s K8 when given — for the stub kernels (the same wire
    formats in, the same verdict shapes out, ``device_work`` LCG rounds per
    item between) and return a restore() callable. Packing, upload and
    dispatch stay real."""
    from ..crypto.ed25519_cuda import stub as ST

    orig = (V.verify_dense, V.verify_sparse, V.verify_tally,
            sharded.verify_tally if sharded is not None else None)

    def dense(blocks, nblk, s_words, table):
        return ST.stub_verify_dense(blocks, nblk, s_words, device_work)[0]

    def sparse(templates, cols, diff_vals, mlen, r, a, s, chunk, table):
        return ST.stub_verify_sparse(diff_vals, mlen, r, a, s,
                                     device_work)[0]

    def tally(blocks, nblk, s_words, limbs, table):
        verdict, _, sums = ST.stub_verify_dense(blocks, nblk, s_words,
                                                device_work, limbs=limbs)
        return verdict, sums

    V.verify_dense, V.verify_sparse, V.verify_tally = dense, sparse, tally
    if sharded is not None:
        sharded.verify_tally = tally

    def restore():
        V.verify_dense, V.verify_sparse, V.verify_tally = orig[:3]
        if sharded is not None:
            sharded.verify_tally = orig[3]

    return restore


def _set_device(device: str) -> torch.device:
    from ..device import default_device, set_default_device

    if device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {device!r}")
    set_default_device(device)
    return default_device()  # raises without CUDA unless the CPU is asked


# -- cost-model ---------------------------------------------------------------

def _timed_ms(fn: Callable[[int], None], runs: int,
              dev: torch.device) -> Dict[str, float]:
    """Per-run ms of ``fn(i)``, which ends with its results on the host:
    CUDA events on the card's current stream (idle between runs, so the
    events bracket the whole run), the host clock on the CPU."""
    ts = []
    for i in range(runs):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(i)
            ts.append((time.perf_counter() - t0) * 1e3)
    return {"min": min(ts), "med": statistics.median(ts),
            "runs_ms": [round(t, 4) for t in ts]}


def run_cost_model(dev: torch.device, payload_mb: float = 4.0,
                   runs: int = 4) -> Dict:
    """The dispatch cost model, with the P4 probe (``probe_sum_u8``) as
    the dispatched kernel; fresh or perturbed payloads and fetched outputs
    throughout. Payloads are made before each timed run, so a run times
    the upload, the launch and the fetch, not the host's random numbers."""
    from ..crypto.ed25519_cuda import verify as V

    rng = np.random.default_rng(0)
    nbytes = max(int(payload_mb * MB), 1 << 12)

    def fresh_payloads(size: int, count: int = 1) -> List[List[np.ndarray]]:
        return [[rng.integers(0, 255, size, dtype=np.uint8)
                 for _ in range(count)] for _ in range(runs)]

    def launch(a) -> torch.Tensor:
        """Upload a host payload (or take a resident one) and sum it on
        the device."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        return V.probe_sum(t.to(dev))

    base = rng.integers(0, 255, nbytes, dtype=np.uint8)
    launch(base).item()  # builds and loads the kernel

    # 1. fixed dispatch cost: input resident on the device, scalar output
    resident = torch.from_numpy(base).to(dev)
    fixed = _timed_ms(lambda i: launch(resident).item(), runs, dev)

    # 2. per-thread upload bandwidth from a payload ladder (fresh bytes)
    per_size = []
    for frac in (0.125, 0.5, 1.0):
        sz = max(int(nbytes * frac), 1 << 12)
        pays = fresh_payloads(sz)
        t = _timed_ms(lambda i: launch(pays[i][0]).item(), runs, dev)
        per_size.append({"mb": sz / MB, "min_ms": round(t["min"], 4),
                         "med_ms": round(t["med"], 4)})
    d_ms = per_size[-1]["min_ms"] - per_size[0]["min_ms"]
    d_mb = per_size[-1]["mb"] - per_size[0]["mb"]
    # below the noise floor the ladder measures jitter, not transfer:
    # report null rather than a garbage (or Infinity) number
    bandwidth = round(d_mb / (d_ms / 1e3), 2) if d_ms > 0.05 else None

    # 3. a near-copy of the previous payload must pay what fresh bytes do
    pays = fresh_payloads(nbytes)
    t_fresh = _timed_ms(lambda i: launch(pays[i][0]).item(), runs, dev)
    nears = []
    near = base.copy()
    for i in range(runs):
        near[i] ^= 1
        near[nbytes // 2 + i] ^= 1
        nears.append(near.copy())
    t_near = _timed_ms(lambda i: launch(nears[i]).item(), runs, dev)
    dedup_ratio = t_near["min"] / max(t_fresh["min"], 1e-6)

    # 4. two dispatches from ONE thread, both fetched at the end
    pairs = fresh_payloads(nbytes, 2)

    def two(i):
        ra, rb = launch(pairs[i][0]), launch(pairs[i][1])
        ra.item(), rb.item()

    t_two = _timed_ms(two, runs, dev)
    pipe_ratio = t_two["min"] / max(t_fresh["min"], 1e-6)

    # 5. the same two dispatches from two threads, each on its own stream
    streams = ([torch.cuda.Stream(device=dev) for _ in range(2)]
               if dev.type == "cuda" else [None, None])
    pairs = fresh_payloads(nbytes, 2)

    def job(i, j):
        with (torch.cuda.stream(streams[j]) if streams[j] is not None
              else contextlib.nullcontext()):
            launch(pairs[i][j]).item()

    def overlapped(i):
        ths = [threading.Thread(target=job, args=(i, j)) for j in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

    t_overlap = _timed_ms(overlapped, runs, dev)
    overlap_ratio = t_overlap["min"] / max(t_two["min"], 1e-6)

    return {
        "kernel": "probe_sum_u8",
        "fixed_dispatch_ms": {"min": round(fixed["min"], 4),
                              "med": round(fixed["med"], 4)},
        "transfer": {"bandwidth_mbps": bandwidth, "per_size": per_size},
        "no_cross_run_dedup": {
            "fresh_min_ms": round(t_fresh["min"], 4),
            "near_copy_min_ms": round(t_near["min"], 4),
            "ratio": round(dedup_ratio, 3),
            # a near-copy at >=70% of fresh cost means no dedup is helping
            "holds": bool(dedup_ratio >= 0.7)},
        "same_thread_pipelining": {
            "one_min_ms": round(t_fresh["min"], 4),
            "two_min_ms": round(t_two["min"], 4),
            "ratio": round(pipe_ratio, 3),
            "pipelined": bool(pipe_ratio < 1.5)},
        "worker_overlap": {
            "serial_two_min_ms": round(t_two["min"], 4),
            "overlapped_two_min_ms": round(t_overlap["min"], 4),
            "ratio": round(overlap_ratio, 3),
            "overlaps": bool(overlap_ratio < 0.8)},
    }


# -- sweep --------------------------------------------------------------------

def run_sweep(sigs: int, chunks: List[int], seg_chunks: List[int],
              workload: str, runs: int = 3,
              seg_min_sigs: Optional[int] = None,
              device_work: int = 0) -> Dict:
    """chunk x SEG_CHUNKS grid through the port's batch_verify_stream on
    the default device; sigs/s, pack share and pipeline overlap per cell."""
    from ..crypto import phases
    from ..crypto.ed25519_cuda import verify as V

    restore = (install_stub_kernels(V, device_work=device_work)
               if workload == "synthetic" else lambda: None)
    pks, msgs, sigs_b = build_workload(sigs)
    rows = []
    old_sc, old_min = V.SEG_CHUNKS, V.SEG_MIN_SIGS
    try:
        if seg_min_sigs is not None:
            V.SEG_MIN_SIGS = seg_min_sigs
        for chunk in chunks:
            for sc in seg_chunks:
                V.SEG_CHUNKS = sc
                V.batch_verify_stream(pks, msgs, sigs_b, chunk=chunk)  # warm
                phases.reset()
                times = []
                for _ in range(runs):
                    t0 = time.perf_counter()
                    V.batch_verify_stream(pks, msgs, sigs_b, chunk=chunk)
                    times.append(time.perf_counter() - t0)
                tot = phases.phase_totals()
                wall = sum(times)
                fly_sum = tot["inflight_sum_s"]
                rows.append({
                    "chunk": chunk, "seg_chunks": sc, "sigs": sigs,
                    "best_s": round(min(times), 5),
                    "sigs_per_sec": round(sigs / min(times), 1),
                    "pack_share": round(tot["pack_s"] / max(wall, 1e-9), 4),
                    "segments": int(tot["segments"]),
                    "overlap_ratio": (
                        round(tot["inflight_union_s"] / fly_sum, 3)
                        if fly_sum > 0 else None),
                })
    finally:
        V.SEG_CHUNKS, V.SEG_MIN_SIGS = old_sc, old_min
        restore()
    return {"workload": workload, "table": rows}


# -- scale --------------------------------------------------------------------

def scale_devices(device: str, count: int) -> List[torch.device]:
    """``count`` devices of the scale cell: the first cards (more than the
    cards present raises), or CPU shards when ``device`` is ``cpu``."""
    if device == "cpu":
        return [torch.device("cpu")] * count
    have = torch.cuda.device_count()
    if count > have:
        raise RuntimeError(f"need {count} devices, have {have}")
    return [torch.device("cuda", i) for i in range(count)]


def _best_s(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def run_scale_cell(device: str, devices: int, chunks: List[int], sigs: int,
                   workload: str, runs: int = 3,
                   threads: Optional[int] = None,
                   device_work: int = DEFAULT_SCALE_DEVICE_WORK) -> Dict:
    """One device count: (a) the sharded verify-and-tally path over the
    mesh, (b) per-chunk rows where each of ``threads`` threads packs a
    dense stream shard and launches it on its own device and stream, (c)
    the pool's MultiDeviceStream over the devices."""
    from ..crypto.ed25519_cuda import multidevice as MD
    from ..crypto.ed25519_cuda import curve
    from ..crypto.ed25519_cuda import sharded as S
    from ..crypto.ed25519_cuda import verify as V

    devs = scale_devices(device, devices)
    restore = (install_stub_kernels(V, sharded=S, device_work=device_work)
               if workload == "synthetic" else lambda: None)
    n_threads = threads or devices
    pks, msgs, sigs_b = build_workload(sigs)
    rows = []
    try:
        # (a) one sharded call over the mesh, with the exact tally
        S.batch_verify_sharded(pks, msgs, sigs_b, mesh=devs)  # warm
        best = _best_s(lambda: S.batch_verify_sharded(pks, msgs, sigs_b,
                                                      mesh=devs), runs)
        rows.append({"devices": devices, "mode": "sharded", "chunk": None,
                     "threads": None, "sigs": sigs,
                     "sigs_per_sec": round(sigs / best, 1)})

        # (b) thread j packs its shard and launches it on device j
        per = max(-(-sigs // n_threads), 1)
        shards = [(pks[a:a + per], msgs[a:a + per], sigs_b[a:a + per])
                  for a in range(0, sigs, per)]
        streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                   for d in devs]
        for chunk in chunks:
            shard_chunk = min(chunk, per)

            def job(j):
                p, m, s = shards[j % len(shards)]
                dev = devs[j % devices]
                (bw, nb, sw), _ok = V._pack_stream_dense(p, m, s, shard_chunk)
                ctx = (torch.cuda.stream(streams[j % devices])
                       if dev.type == "cuda" else contextlib.nullcontext())
                with ctx:
                    args = V._dense_args(bw, nb, sw, dev)
                    V._Fetch(V.verify_dense(*args, curve.base_table(dev))) \
                        .result()

            used = min(n_threads, len(shards))
            for j in range(used):
                job(j)  # warm every device

            def all_jobs():
                ths = [threading.Thread(target=job, args=(j,))
                       for j in range(used)]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join()

            best = _best_s(all_jobs, runs)
            done = sum(len(shards[j % len(shards)][0]) for j in range(used))
            rows.append({"devices": devices, "mode": "threads",
                         "chunk": chunk, "threads": used, "sigs": done,
                         "sigs_per_sec": round(done / best, 1)})

        # (c) the pool's dispatcher over the same devices
        pool = MD.MultiDeviceStream(devices=devs, min_sigs=0)
        try:
            for chunk in chunks:
                c = min(chunk, max(sigs // 2, 1))
                pool.verify(pks, msgs, sigs_b, chunk=c)  # warm every lane
                best = _best_s(lambda: pool.verify(pks, msgs, sigs_b,
                                                   chunk=c), runs)
                rows.append({"devices": devices, "mode": "multidev",
                             "chunk": c, "threads": devices, "sigs": sigs,
                             "sigs_per_sec": round(sigs / best, 1)})
        finally:
            pool.shutdown()
    finally:
        restore()
    return {"devices": devices, "rows": rows}


def run_scale(device: str, devices_list: List[int], chunks: List[int],
              sigs: int, workload: str, runs: int,
              threads: Optional[int],
              device_work: int = DEFAULT_SCALE_DEVICE_WORK) -> Dict:
    rows = []
    for d in devices_list:
        rows.extend(run_scale_cell(device, d, chunks, sigs, workload,
                                   runs=runs, threads=threads,
                                   device_work=device_work)["rows"])
    return {"workload": workload, "table": rows}


# -- CLI ----------------------------------------------------------------------

def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x]


def emit(doc: Dict, out: Optional[str], md: Optional[str]) -> None:
    errs = validate_profile(doc)
    if errs:  # the tool never writes a document its own schema rejects
        raise SystemExit("device_profile: generated profile fails its "
                         "schema: " + "; ".join(errs))
    print(to_markdown(doc))
    if out:
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, allow_nan=False)
        print(f"\nwrote {out}")
    else:
        print()
        print(json.dumps(doc, allow_nan=False))
    if md:
        with open(md, "w") as f:
            f.write(to_markdown(doc) + "\n")


SELF_TEST_SAMPLES = {
    "cost-model": {
        "fixed_dispatch_ms": {"min": 1.0, "med": 2.0},
        "transfer": {"bandwidth_mbps": 10.0, "per_size": []},
        "no_cross_run_dedup": {"holds": True},
        "same_thread_pipelining": {"ratio": 2.0, "pipelined": False},
        "worker_overlap": {"ratio": 0.6, "overlaps": True},
    },
    "sweep": {"workload": "synthetic", "table": [
        {"chunk": 2048, "seg_chunks": 10, "sigs_per_sec": 1000.0,
         "pack_share": 0.1, "overlap_ratio": 0.8}]},
    "scale": {"workload": "synthetic", "table": [
        {"devices": 2, "mode": "sharded", "chunk": None,
         "threads": None, "sigs_per_sec": 500.0}]},
}


def self_test() -> int:
    """Schema samples and mutations, the workload, and a micro cost-model,
    sweep and scale cell on CPU shards with the stub kernels."""
    for kind, res in SELF_TEST_SAMPLES.items():
        doc = make_doc(kind, {"sample": True}, res)
        assert validate_profile(doc) == [], (kind, validate_profile(doc))
        assert to_markdown(doc).startswith("### device_profile")
        broken = json.loads(json.dumps(doc))
        del broken["results"][REQUIRED_RESULTS[kind][0]]
        errs = validate_profile(broken)
        assert errs and REQUIRED_RESULTS[kind][0] in errs[0], errs
    pks, msgs, sigs = build_workload(256)
    assert len({len(m) for m in msgs}) == 1 and len(pks) == 256
    dev = _set_device("cpu")
    doc = make_doc("cost-model", {"payload_mb": 0.0625, "runs": 2},
                   run_cost_model(dev, payload_mb=0.0625, runs=2))
    assert validate_profile(doc) == [], validate_profile(doc)
    doc = make_doc("sweep", {"sigs": 512}, run_sweep(
        sigs=512, chunks=[128], seg_chunks=[2], workload="synthetic",
        runs=1, seg_min_sigs=0))
    assert validate_profile(doc) == [], validate_profile(doc)
    doc = make_doc("scale", {"devices": [2]}, run_scale(
        "cpu", [2], chunks=[128], sigs=256, workload="synthetic", runs=1,
        threads=None, device_work=16))
    assert validate_profile(doc) == [], validate_profile(doc)
    assert {r["mode"] for r in doc["results"]["table"]} == \
        {"sharded", "threads", "multidev"}
    print("device_profile self-test OK (schema, workload, cost-model, "
          "sweep, scale cell incl. multidev stream)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", nargs="?", choices=list(KINDS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the card; cpu only when "
                         "asked for)")
    ap.add_argument("--out", help="write the profile JSON here "
                                  "(default: print to stdout)")
    ap.add_argument("--md", help="also write the markdown table here")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--payload-mb", type=float, default=4.0,
                    help="cost-model probe payload size")
    ap.add_argument("--sigs", type=int, default=20480,
                    help="sweep/scale workload size")
    ap.add_argument("--chunks", type=_ints, default=[1024, 2048, 4096],
                    help="comma-separated chunk sizes")
    ap.add_argument("--seg-chunks", type=_ints, default=[5, 10, 20],
                    help="comma-separated SEG_CHUNKS values (sweep)")
    ap.add_argument("--seg-min-sigs", type=int, default=None,
                    help="override SEG_MIN_SIGS for the sweep (0 forces "
                         "the segmented pipeline on)")
    ap.add_argument("--devices", type=_ints, default=[1],
                    help="comma-separated device counts (scale)")
    ap.add_argument("--threads", type=int, default=None,
                    help="scale: dispatch threads per cell "
                         "(default: one per device)")
    ap.add_argument("--device-work", type=int,
                    default=DEFAULT_SCALE_DEVICE_WORK,
                    help="synthetic workload: LCG rounds per item burned "
                         "on the device (0 = trivial stubs)")
    ap.add_argument("--workload", choices=("auto", "ed25519", "synthetic"),
                    default="auto",
                    help="real verify kernels (auto), or the stub kernels")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    if not args.command:
        ap.error("need a subcommand (cost-model | sweep | scale) "
                 "or --self-test")
    dev = _set_device(args.device)
    workload = resolve_workload(args.workload)
    if args.command == "cost-model":
        doc = make_doc("cost-model",
                       {"payload_mb": args.payload_mb, "runs": args.runs},
                       run_cost_model(dev, args.payload_mb, args.runs),
                       args.device)
    elif args.command == "sweep":
        doc = make_doc("sweep",
                       {"sigs": args.sigs, "chunks": args.chunks,
                        "seg_chunks": args.seg_chunks, "runs": args.runs,
                        "workload": workload,
                        "device_work": args.device_work},
                       run_sweep(args.sigs, args.chunks, args.seg_chunks,
                                 workload, runs=args.runs,
                                 seg_min_sigs=args.seg_min_sigs,
                                 device_work=args.device_work),
                       args.device)
    else:  # scale
        doc = make_doc("scale",
                       {"devices": args.devices, "chunks": args.chunks,
                        "sigs": args.sigs, "runs": args.runs,
                        "threads": args.threads,
                        "device_work": args.device_work,
                        "workload": workload},
                       run_scale(args.device, args.devices, args.chunks,
                                 args.sigs, workload, args.runs,
                                 args.threads,
                                 device_work=args.device_work),
                       args.device)
    emit(doc, args.out, args.md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
