"""Sharded Ed25519 verification with an exact voting-power tally.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/sharded.py``. The
packed batch is split into ``d`` contiguous, near-equal shards of rows (the
order of the JAX package's B-axis sharding, so the verdicts come back in
input order), one per device of the mesh. Each shard runs K8
(``ed25519_verify_tally``, ``csrc/tally.cu``) on its own device's stream:
the dense verify plus the sum of the 8-bit power limbs of the signatures
it accepts. The ``d`` partial sums, eight int64 each, are then combined on
the first shard's device (a device-to-device copy and an add: the psum of a
single-process program) and fetched.

The tally is EXACT for int64 voting powers, as in the JAX package: each
power is split on the host into eight 8-bit limbs (int64 -> uint64, so a
negative power counts as its uint64 pattern; host-invalid rows carry no
power), the kernel sums limbs, and the host recombines
``sum_j limb_sum_j * 2^(8j)`` in Python ints, so a total above 2^63 is
exact too. ``MAX_EXACT_SIGS`` = 2^22 is the JAX package's bound (its limb
sums are int32) and the port keeps it.

A mesh is a list of ``torch.device``: the first ``n`` cards, or ``n`` CPU
shards when the default device is the CPU (the tests). A mesh may name one
card more than once (``[cuda:0] * 4``): each shard then gets its own stream
on that card. The combine across distinct cards has not run on more than
one card.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import phases
from ...device import default_device, device_label
from . import curve
from .verify import (_Fetch, _as_i32, _on_device, _upload, prepare_batch,
                     verify_tally)

POWER_LIMB_BITS = 8
POWER_LIMBS = 8                          # 8 x 8-bit limbs cover int64 powers
MAX_EXACT_SIGS = 1 << 22                 # the JAX package's int32-safe bound


def make_mesh(n_devices: int) -> List[torch.device]:
    """``n_devices`` devices: the first cards, or CPU shards when the
    default device is the CPU. Raises RuntimeError when there are too few
    cards (KernelUnavailable when CUDA is absent and the CPU was not asked
    for)."""
    dev = default_device()
    if dev.type == "cpu":
        return [dev] * n_devices
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _power_limbs(powers: np.ndarray) -> np.ndarray:
    """(n,) int64 -> (n, 8) int32 8-bit limbs of each power's uint64
    pattern."""
    p = powers.astype(np.uint64)
    shifts = np.arange(POWER_LIMBS, dtype=np.uint64) * POWER_LIMB_BITS
    return ((p[:, None] >> shifts) & ((1 << POWER_LIMB_BITS) - 1)) \
        .astype(np.int32)


def _shard_bounds(n: int, d: int) -> List[Tuple[int, int]]:
    base, extra = divmod(n, d)
    out, lo = [], 0
    for i in range(d):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def batch_verify_sharded(
    pks: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    powers: Optional[Sequence[int]] = None,
    mesh: Optional[Sequence[torch.device]] = None,
    n_devices: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Verify a batch over a mesh; -> ((N,) bool verdicts, exact tally).

    The tally is the exact sum of ``powers`` (1 each when None) over the
    accepted signatures (see the module docstring)."""
    if mesh is None:
        if n_devices is None:
            dev = default_device()
            n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
        mesh = make_mesh(n_devices)
    mesh = [torch.device(m) for m in mesh]
    d = len(mesh)
    n = len(pks)
    if n > MAX_EXACT_SIGS:
        raise ValueError(
            f"batch of {n} exceeds the exact-tally bound {MAX_EXACT_SIGS}; "
            "split into multiple calls"
        )
    # phase record: one segment spread over the whole mesh; per-device
    # dispatch/in-flight series get every shard's label
    rec = phases.Segment(sigs=n, chunk=n, device=f"mesh[{d}]",
                         devices=[device_label(m) for m in mesh]).begin()
    blocks_w, nblk, s_words, ok = prepare_batch(pks, msgs, sigs)
    pw = np.ones(n, dtype=np.int64)
    if powers is not None:
        pw[:] = np.asarray(list(powers), dtype=np.int64)
    pw *= ok  # host-invalid entries contribute no power
    limbs = _power_limbs(pw)
    blocks_i, s_i = _as_i32(blocks_w), _as_i32(s_words)
    bounds = _shard_bounds(n, d)
    streams = [torch.cuda.Stream(device=m) if m.type == "cuda" else None
               for m in mesh]
    rec.pack_done()
    # every shard launched before any fetch
    verdicts, sums = [], []
    for (a, b), dev, st in zip(bounds, mesh, streams):
        with _on_device(dev, st):
            args = (_upload(blocks_i[a:b], dev),
                    _upload(np.ascontiguousarray(nblk[a:b]), dev),
                    _upload(s_i[a:b], dev), _upload(limbs[a:b], dev))
            v, sm = verify_tally(*args, curve.base_table(dev))
            verdicts.append(_Fetch(v))
        sums.append(sm)
    # the combine: every partial sum onto the first shard's device, added
    # there on its stream
    with _on_device(mesh[0], streams[0]):
        total_d = sums[0]
        for sm, st in zip(sums[1:], streams[1:]):
            if st is not None:
                streams[0].wait_stream(st)
            total_d = total_d + sm.to(mesh[0], non_blocking=True)
        total_f = _Fetch(total_d)
    rec.dispatched()
    try:
        t_w = time.perf_counter()
        verdict = np.concatenate([f.result() for f in verdicts]) & ok
        tl = total_f.result()
        rec.fetched(wait_s=time.perf_counter() - t_w)
    finally:
        rec.abandon()  # failed fetch must not wedge the in-flight gauges
    total = sum(int(tl[j]) << (POWER_LIMB_BITS * j)
                for j in range(POWER_LIMBS))
    return verdict, total
