"""Where a verify_commit call spends its time on the card.

Counterpart of the JAX package's tools/profile_verify.py. For seeded
commits of ``--sizes`` validators (default 150, 1,000 and 10,240) it prints, per
size, one JSON line:

* ``wall_ms``: median host time of ``ValidatorSet.verify_commit`` (ends
  with verdicts on the host);
* ``phases``: the segment records' pack / dispatch / fetch split
  (``crypto/phases.phase_breakdown`` over the same calls);
* ``device_ms`` and ``device_busy_share``: device time per call by
  activity (kernels and copies) from a ``torch.profiler`` trace, and its
  share of the traced wall time (1 - share is the card's idle share);
* ``host_other_ms``: wall time outside every segment (sign-bytes, the
  ``BatchVerifier.add`` loop, the precedence replay).

Then, for the K11/P4 probe at 32 KB and 4 MB, one JSON line each: the
device time of one ``probe_sum`` and of one ``torch.sum(x,
dtype=torch.int32)`` by activity (``torch.profiler``), and the host time a
call takes to return (its enqueue, the wrappers included).

Run on the card: ``python -m tendermint_tpu_torch.tools.profile_verify``.
``--trace-dir`` keeps the Chrome traces.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..crypto import phases
from ..crypto.ed25519_cuda import build
from ..crypto.ed25519_cuda import verify as V
from ..device import set_default_device
from . import commits

CHAIN_ID = "profile-chain"


def _device_ms(prof, calls: int) -> dict:
    """Device time per call (ms) by activity name: kernels and copies."""
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0)
        if t > 0:
            out[ev.key[:80]] = t / 1e3 / calls
    return out


def profile_commit(fx: commits.CommitFixture, reps: int, trace_dir: str):
    fx.verify()  # warm: routing probe, pk cache, sign-bytes memo
    walls = []
    phases.reset()
    t_first = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        fx.verify()
        walls.append(time.perf_counter() - t0)
    t_last = time.perf_counter()
    brk = phases.phase_breakdown(phases.recent_segments(), t_first, t_last)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fx.verify()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"verify_commit_{len(fx.valset)}.json"))
    kms = _device_ms(prof, reps)
    wall = statistics.median(walls)
    per_call = (t_last - t_first) / reps
    return {
        "validators": len(fx.valset), "reps": reps,
        "wall_ms": wall * 1e3,
        "sigs_per_s": len(fx.valset) / wall,
        "phases": {k: brk[k] for k in (
            "pack_s", "dispatch_s", "fetch_s", "wait_s", "device_share",
            "pack_share_exposed", "dispatch_share_exposed",
            "accounted_share", "overlap_ratio", "segments")},
        "host_other_ms": per_call * (1 - brk["accounted_share"]) * 1e3,
        "device_ms": kms,
        "device_busy_share": sum(kms.values()) * reps / 1e3 / traced_s,
    }


def profile_probe(dev: torch.device, nbytes: int, reps: int) -> dict:
    """Device and host time of one K11 probe and one ``torch.sum`` over the
    same ``nbytes`` bytes on ``dev``."""
    x = torch.from_numpy(np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8)).to(dev)
    rec = {"probe_bytes": nbytes, "reps": reps,
           "probe_blocks": V.probe_blocks(nbytes, dev)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, fn in (("probe_sum", lambda: V.probe_sum(x)),
                     ("torch_sum", lambda: torch.sum(x, dtype=torch.int32))):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
        rec[name] = {"device_ms": _device_ms(prof, reps),
                     "host_ms_per_call": host_s * 1e3 / reps}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="150,1000,10240")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_verify: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    set_default_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for lib in build.PACKAGE.sources:
        build.PACKAGE.library(lib)
    rng = np.random.default_rng(args.seed)
    with commits.Signer() as signer:
        fixtures = [commits.CommitFixture(signer, rng, int(n), CHAIN_ID, 5)
                    for n in args.sizes.split(",")]
    for fx in fixtures:
        rec = profile_commit(fx, args.reps, args.trace_dir)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    for nbytes in (32 << 10, 4 << 20):
        rec = profile_probe(dev, nbytes, 200)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
