"""The device-profile stub kernels' times on the card, the kernel alone.

For P1 (``stub_verify_dense``, without the tally) and P3
(``stub_verify_sparse``) at the shapes ``chip_smoke.py``'s phase sharded
gives them (the dense pack of 20,480 signatures of the device-profile
workload in chunks of 2,048, and the sparse pack of its first half), at 0
and 20,000 rounds, one JSON line: the kernel's device time per call
(``torch.profiler``), the call's time (CUDA events around back-to-back
calls) and the file of the package that ran.

It imports ``tendermint_tpu_torch`` from ``--root`` (by default the
checkout that holds this file), so that the same script times another
tree, a parent commit unpacked beside the checkout say. Run it as a file::

    python tendermint_tpu_torch/tools/profile_stubs.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SIGS = 20_480
CHUNK = 2048
ROUNDS = (0, 20_000)
REPS = 100


def _kernel_ms(torch, fn, kernel: str, reps: int):
    """The device time (ms) of ``kernel`` per call of ``fn``; None when the
    trace shows none."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages() if kernel in ev.key)
    return us / 1e3 / reps if us > 0 else None


def _event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto.ed25519_cuda import stub as ST
    from tendermint_tpu_torch.crypto.ed25519_cuda import verify as V
    from tendermint_tpu_torch.tools import device_profile as DP

    if not torch.cuda.is_available():
        print("profile_stubs: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    pks, msgs, sigs = DP.build_workload(SIGS)
    (bw, nb, sw), _ = V._pack_stream_dense(pks, msgs, sigs, CHUNK)
    dense = V._dense_args(bw, nb, sw, dev)
    seg = SIGS // 2
    sp = V.pack_sparse(pks[:seg], msgs[:seg], sigs[:seg], CHUNK)
    sparse = [torch.from_numpy(np.array(x)).to(dev) for x in sp[2:7]]
    stubs = {
        "stub_verify_dense": (f"{bw.shape[0]} items x NBLK {bw.shape[1]}",
                              lambda w: ST.stub_verify_dense(*dense, w)),
        "stub_verify_sparse": (f"{seg} items x {sp[2].shape[1]} columns",
                               lambda w: ST.stub_verify_sparse(*sparse, w))}
    for name, (shape, call) in stubs.items():
        for rounds in ROUNDS:
            print(json.dumps({
                "kernel": name, "shape": shape, "rounds": rounds,
                "kernel_ms": _kernel_ms(torch, lambda: call(rounds),
                                        name + "_kernel", REPS),
                "ms": _event_ms(torch, lambda: call(rounds), REPS),
                "source": ST.__file__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
