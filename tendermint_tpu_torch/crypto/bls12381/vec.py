"""The aggregate-pubkey tree on the card, and the routed
fast-aggregate-verify that the consensus plane calls.

The one data-parallel step of an aggregated-commit verify is the
aggregate-pubkey sum (many G2 points, one result). Here it is a
pad-to-power-of-two Jacobian tree with the JAX tree's order (at every
level lane i adds lane i + half), summed in one launch of the CUDA kernel
``bls_g2_tree_sum`` (``crypto/bls12381_cuda``; K10 of the JAX package's
``crypto/bls12381/vec.py`` runs one ``_g2_add_round`` a level). A single
key is one round, ``bls_g2_add_round``, the key plus infinity. Points
cross to the card as Montgomery limbs (``bls12381_cuda/g2.py``). On a CPU
default device the kernel's plain PyTorch version runs the rounds.

Routing. ``TMTPU_BLS_BACKEND`` = ``cuda`` (the default: the port's entry
points run on the card) | ``scalar`` (the pure-Python spec,
``bls12381.fast_aggregate_verify``); any other value, ``jax`` and
``numpy`` included, means the default, as unknown values do in the JAX
package. The scalar spec runs only when the caller asks for it: on the
``cuda`` route nothing moves to the host. A card that cannot be used at
all (no CUDA while the default device is ``cuda``, a kernel that does not
build or load) raises ``device.KernelUnavailable``; the armed
``crypto.bls_verify`` fault site and every fault of a running kernel (at
launch, surfacing at the fetch, or a one-key probe that does not come
back unchanged) are counted in ``device_errors`` and reach the caller.
The shared ``device_breaker`` is neither read nor struck here.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import torch

from ...libs.faults import faults
from .. import phases as _phases
from ..breaker import count_device_error
from ..bls12381_cuda import g2 as _g2
from . import DST_SIG, decompress_pubkey
from .curve import g2_to_affine, hash_to_g1
from .pairing import NEG_G2_AFF, multi_pairing_check

FAULT_SITE = "crypto.bls_verify"
BACKENDS = ("cuda", "scalar")
DEFAULT_BACKEND = "cuda"

stats = {"device_calls": 0, "scalar_calls": 0, "device_errors": 0}

_INF = ((0, 0), (0, 0), (0, 0))


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _points_to_lanes(affs, device) -> torch.Tensor:
    """Affine int points -> Montgomery limb lanes, padded with infinity
    lanes to a power of 2 (at least 2)."""
    lanes = 2
    while lanes < len(affs):
        lanes *= 2
    pts = [(a[0], a[1], (1, 0)) for a in affs]
    return _g2.to_lanes(pts + [_INF] * (lanes - len(affs)), device)


def aggregate_pubkeys_vec(pks, device=None,
                          rec: Optional[_phases.Segment] = None):
    """Sum the (decompressed, subgroup-checked) pubkeys with one launch of
    the tree kernel (of the round kernel for one key). Returns the affine
    aggregate, or None on any invalid key or an infinite sum. ``rec`` gets
    its pack stamp after the host conversion, its dispatch stamp after the
    launch and its fetch stamp when the sum is back on the host.

    A single key is summed with the point at infinity by one round and
    must come back unchanged, so a one-signer commit is checked on the
    card too; a key that does not come back raises RuntimeError. More than
    ``g2.TREE_MAX_LANES`` (2^14) keys raise ValueError: a commit has at
    most MAX_VOTES_COUNT (10,000) signers."""
    affs = []
    for pk in pks:
        q = decompress_pubkey(pk)
        if q is None:
            return None
        affs.append(q)
    if not affs:
        return None
    dev = _g2.kernel_device() if device is None else torch.device(device)
    pt = _points_to_lanes(affs, dev)
    if rec is not None:
        rec.pack_done()
    if len(affs) == 1:
        pt = _g2.g2_add_round(pt[:1], pt[1:])  # the key + infinity
    else:
        pt = _g2.tree_sum(pt)
    if rec is not None:
        rec.dispatched()
    X, Y, Z = _g2.from_lanes(pt)[0]
    if rec is not None:
        rec.fetched()
    if len(affs) == 1:
        if (X, Y, Z) != (affs[0][0], affs[0][1], (1, 0)):
            raise RuntimeError("bls_g2_add_round: key + infinity != key")
        return affs[0]
    if Z == (0, 0):
        return None
    return g2_to_affine((X, Y, Z))


# --- routed fast-aggregate-verify (the consensus-plane entry point) --------

def backend_from_env() -> str:
    b = os.environ.get("TMTPU_BLS_BACKEND", DEFAULT_BACKEND).strip().lower()
    return b if b in BACKENDS else DEFAULT_BACKEND


def _pairing_verdict(apk, msg: bytes, sig: bytes, dst: bytes) -> bool:
    from . import _decompress_sig

    s = _decompress_sig(sig)
    if apk is None or s is None:
        return False
    return multi_pairing_check([(s, NEG_G2_AFF), (hash_to_g1(msg, dst), apk)])


def fast_aggregate_verify_routed(pks, msg: bytes, sig: bytes,
                                 dst: bytes = DST_SIG,
                                 backend: Optional[str] = None,
                                 mode: str = "full") -> bool:
    """fast_aggregate_verify with backend routing (see the module doc).

    ``mode`` labels which verify_commit* entry point asked (full / light /
    trusting) — it never changes the verdict, only the telemetry: the call
    is timed into ``crypto_pairing_seconds{plane}``, counted into
    ``crypto_aggregate_verify_total{scheme,mode}``, and wrapped in a
    height-tagged ``agg_verify`` tracer span so trace breakdowns can split
    ed25519 from bls12381 commits."""
    from ...libs.trace import tracer

    plane, height = _phases.context()
    span_args = {"scheme": "bls12381", "mode": mode, "n_signers": len(pks)}
    if height is not None:
        span_args["height"] = height
    t0 = time.perf_counter()
    try:
        with tracer.span("agg_verify", **span_args):
            return _routed(pks, msg, sig, dst, backend)
    finally:
        m = _phases.metrics
        if m is not None:
            try:
                m.pairing_seconds.labels(plane or "aggsig").observe(
                    time.perf_counter() - t0)
                m.aggregate_verify_total.labels("bls12381", mode).inc()
            except Exception:
                pass


def _routed(pks: List[bytes], msg: bytes, sig: bytes, dst: bytes,
            backend: Optional[str]) -> bool:
    from . import fast_aggregate_verify  # the scalar spec

    if backend is None:
        backend = backend_from_env()
    if backend not in BACKENDS:
        raise ValueError(f"unknown bls backend {backend!r}")
    if not pks:
        return False
    if backend == "scalar":
        stats["scalar_calls"] += 1
        return fast_aggregate_verify(pks, msg, sig, dst=dst)
    try:
        dev = _g2.kernel_device()
    except Exception as e:  # KernelUnavailable: not in stats
        count_device_error(e, "aggsig")
        raise
    n = len(pks)
    rec = _phases.Segment(sigs=n, chunk=n, device="bls-apk", plane="aggsig")
    try:
        faults.inject(FAULT_SITE)
        rec.begin()
        apk = aggregate_pubkeys_vec(pks, dev, rec)
        rec.fetched()
    except Exception as e:
        rec.abandon()
        stats["device_errors"] += 1
        count_device_error(e, "aggsig")
        raise
    stats["device_calls"] += 1
    return _pairing_verdict(apk, msg, sig, dst)
