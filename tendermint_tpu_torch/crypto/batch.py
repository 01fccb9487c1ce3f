"""BatchVerifier — the batched verification seam the reference lacks.

The reference verifies one signature at a time (crypto/crypto.go:22-28 has
only PubKey.VerifySignature; SURVEY.md north star). Here, callers collect
(pubkey, msg, sig) tuples and verify them in one device call:

    bv = BatchVerifier()
    bv.add(pub, msg, sig)          # any number of times
    ok_all, per_item = bv.verify() # one batched device call

Backends:
* "cuda" — the batched CUDA kernels (ed25519_cuda.batch_verify_stream) on
  the default device (tendermint_tpu_torch.device; the CPU tests pin it to
  the CPU, where the kernels' plain PyTorch versions run);
* "host" — scalar loop over PubKey.verify_signature (OpenSSL or pure-Python).

Decisions are byte-identical across backends (enforced by differential
tests). Default backend: "cuda" when a device batch is worthwhile, "host" for
tiny batches where kernel-launch latency would dominate — the threshold is
overridable for benchmarking. Set env TMTPU_BATCH_BACKEND to pin one.
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import Ed25519PubKey, PubKey
from . import phases as _phases
from .breaker import count_device_error
from ..device import KernelUnavailable
from ..libs.faults import faults
from ..libs.trace import tracer

logger = logging.getLogger("tmtpu.batch")

# below this many signatures the host scalar loop beats a device round-trip.
# The break-even point depends on the round trip's fixed cost, so "auto"
# calibrates once.
DEFAULT_DEVICE_THRESHOLD = 16
_HOST_SIGS_PER_SEC_ESTIMATE = 7000.0  # OpenSSL verify ~140 us/op
_calibrated_threshold: Optional[int] = None
# flushes of the light-serving coalescer run in executor threads: the
# first two may ask at once, and only one of them calibrates
_calibration_lock = threading.Lock()


# routed batches must never lose to the scalar loop: bias the calibrated
# break-even up so near-threshold commits stay on host (the device win at
# the margin is ~0)
_CALIBRATION_SAFETY = 1.25


def device_threshold() -> int:
    """Break-even batch size for the device path, measured once: the round
    trip of a fresh 32 KB payload (a ~150-sig commit's wire weight) through
    the K11 probe kernel, timed with CUDA events, x host verify rate.
    Override: TMTPU_DEVICE_THRESHOLD. Raises KernelUnavailable when the
    card or the probe kernel cannot be used."""
    global _calibrated_threshold
    env = os.environ.get("TMTPU_DEVICE_THRESHOLD")
    if env:
        return int(env)
    if _calibrated_threshold is not None:
        return _calibrated_threshold
    with _calibration_lock:
        if _calibrated_threshold is None:
            try:
                from .ed25519_cuda.verify import probe_dispatch_seconds

                # the first use builds and loads the kernel
                probe_dispatch_seconds()
                overhead = min(probe_dispatch_seconds(),
                               probe_dispatch_seconds())
                _calibrated_threshold = max(
                    DEFAULT_DEVICE_THRESHOLD,
                    int(overhead * _HOST_SIGS_PER_SEC_ESTIMATE
                        * _CALIBRATION_SAFETY))
            except KernelUnavailable:
                raise
            except Exception as e:
                # calibration failure is routing advice, not correctness:
                # fall back to the static default — but say so
                logger.warning("device-threshold calibration failed (%s); "
                               "using default %d", e, DEFAULT_DEVICE_THRESHOLD)
                _calibrated_threshold = DEFAULT_DEVICE_THRESHOLD
    return _calibrated_threshold


# verdicts precomputed by a wider batching scope (e.g. the light client's
# chain-batched verifier): (pk_bytes, msg, sig) -> bool. Consulted before any
# dispatch so an enclosing batch costs ONE device call total.
precomputed_verdicts: "contextvars.ContextVar[Optional[Dict]]" = \
    contextvars.ContextVar("tmtpu_precomputed_verdicts", default=None)


def precompute(items: Sequence[Tuple[PubKey, bytes, bytes]],
               plane: str = "light", backend: Optional[str] = None,
               device_threshold: Optional[int] = None
               ) -> Dict[Tuple[bytes, bytes, bytes], bool]:
    """Verify ``(pub, msg, sig)`` tuples in ONE batched call and return the
    verdict map shaped for :data:`precomputed_verdicts` — the entry point a
    wider batching scope (the light-serving coalescer, the chain-batched
    verifier) uses to fold many independent verifications into a single
    device dispatch, then replay exact scalar semantics against the map."""
    bv = BatchVerifier(backend=backend, device_threshold=device_threshold,
                       plane=plane)
    for pub, msg, sig in items:
        bv.add(pub, msg, sig)
    _, verdicts = bv.verify()
    return {(items[i][0].bytes(), items[i][1], items[i][2]):
            bool(verdicts[i]) for i in range(len(items))}

# routing observability (VERDICT r3: batch sizes / routing decisions were
# invisible): cumulative counters, cheap ints only
stats = {
    "host_batches": 0, "host_sigs": 0,
    "device_batches": 0, "device_sigs": 0,
    "precomputed_batches": 0, "precomputed_sigs": 0,
    "largest_batch": 0,
    # device attempts that raised to the caller
    "device_errors": 0,
}

# CryptoMetrics hook, wired by the node (same idiom as p2p's
# set_p2p_metrics): None outside a node process, so library callers
# (tests, bench, light client as a library) pay one None-check per batch
metrics = None


def set_crypto_metrics(m) -> None:
    global metrics
    metrics = m


def _padded_slots(n: int, chunk: int = 2048) -> int:
    """Device slots a batch of n occupies after padding: the stream path
    rounds up to whole chunks; the one-call path launches exactly n. Used
    for the pad-waste gauge only."""
    if n <= 0:
        return 0
    if n > chunk:
        return -(-n // chunk) * chunk
    return n


class BatchVerifier:
    def __init__(self, backend: Optional[str] = None,
                 device_threshold: Optional[int] = None,
                 plane: str = "votes"):
        self._backend = backend or os.environ.get("TMTPU_BATCH_BACKEND") or "auto"
        if self._backend not in ("auto", "cuda", "host"):
            raise ValueError(f"unknown batch backend {self._backend!r}")
        self._threshold = device_threshold
        # metric label only: which verification plane this batch serves
        # ("votes" live commits, "light" light/fast-sync, "evidence")
        self.plane = plane
        self._pks: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []
        self._non_ed25519: List[Tuple[int, PubKey]] = []
        self._columns = None

    def __len__(self) -> int:
        return len(self._pks)

    def set_columns(self, columns) -> None:
        """Columnar sign-bytes (crypto/signcols.SignColumns) aligned 1:1
        with the rows added so far — a packing HINT for the device path
        (skips per-segment structure re-discovery). Rows must reconstruct
        byte-identically to the added msgs; verdicts cannot change either
        way. Cleared by verify() with the rest of the batch."""
        self._columns = columns

    def add(self, pub: PubKey, msg: bytes, sig: bytes) -> None:
        if not isinstance(pub, Ed25519PubKey):
            # rare key types verify on host; remember position for the verdict
            self._non_ed25519.append((len(self._pks), pub))
        self._pks.append(pub.bytes())
        self._msgs.append(msg)
        self._sigs.append(sig)

    def verify(self) -> Tuple[bool, np.ndarray]:
        """-> (all_valid, per-item bool array). Resets the collected batch."""
        pks, msgs, sigs = self._pks, self._msgs, self._sigs
        non_ed = self._non_ed25519
        columns = self._columns
        self._pks, self._msgs, self._sigs, self._non_ed25519 = [], [], [], []
        self._columns = None
        n = len(pks)
        if n == 0:
            return True, np.zeros(0, dtype=bool)

        stats["largest_batch"] = max(stats["largest_batch"], n)
        pre = precomputed_verdicts.get()
        if pre is not None:
            hits = [pre.get((pks[i], msgs[i], sigs[i])) for i in range(n)]
            if all(h is not None for h in hits):
                out = np.array(hits, dtype=bool)
                stats["precomputed_batches"] += 1
                stats["precomputed_sigs"] += n
                if metrics is not None:
                    metrics.precomputed_hits_total.labels(self.plane).inc()
                return bool(out.all()), out

        backend = self._backend
        if backend == "auto":
            thr = (self._threshold if self._threshold is not None
                   else device_threshold())
            backend = "cuda" if n >= thr else "host"
        if backend == "cuda":
            from .ed25519_cuda.verify import kernel_device

            # a card or kernel that cannot be used at all reaches the
            # caller (KernelUnavailable): on device_errors_total, not in
            # stats, which count running kernels' faults
            try:
                kernel_device()
            except KernelUnavailable as e:
                count_device_error(e, self.plane)
                raise

        non_ed_idx = {i: pk for i, pk in non_ed}

        def _host_verify() -> np.ndarray:
            res = np.zeros(n, dtype=bool)
            for i in range(n):
                pub = non_ed_idx.get(i) or Ed25519PubKey(pks[i])
                res[i] = pub.verify_signature(msgs[i], sigs[i])
            return res

        route = "device" if backend == "cuda" else "scalar"
        t0 = time.perf_counter()
        # tracer.span is a shared no-op when disabled (one attribute check
        # inside span() plus the kwargs dict — noise next to any verify)
        with tracer.span("batch_verify", n=n, route=route,
                         plane=self.plane):
            if backend == "cuda":
                try:
                    # chaos seam: an armed `device.batch_verify` site raises
                    # here, as a fault of a running kernel would
                    faults.inject("device.batch_verify")
                    from .ed25519_cuda import batch_verify_stream

                    ed_pos = [i for i in range(n) if i not in non_ed_idx]
                    out = np.zeros(n, dtype=bool)
                    if ed_pos:
                        # batch_verify_stream == batch_verify below one
                        # chunk; above, it launches whole chunks per
                        # segment (or shards them across the multi-device
                        # pool). The columnar hint only survives when it
                        # still aligns 1:1 with the rows the kernel sees
                        # (no non-ed25519 holes)
                        cols = (columns if columns is not None
                                and len(ed_pos) == n
                                and len(columns) == n else None)
                        ed_out = batch_verify_stream(
                            [pks[i] for i in ed_pos],
                            [msgs[i] for i in ed_pos],
                            [sigs[i] for i in ed_pos],
                            columns=cols)
                        out[ed_pos] = ed_out
                    # rare non-ed25519 keys verify on host, verdicts merged
                    # by index
                    for i, pub in non_ed_idx.items():
                        out[i] = pub.verify_signature(msgs[i], sigs[i])
                except KernelUnavailable as e:
                    count_device_error(e, self.plane)
                    raise
                except Exception as e:
                    # a fault of a running kernel (at launch, or surfacing
                    # at the fetch), the armed fault site, or every lane of
                    # the multi-device pool failing: counted, and raised to
                    # the caller; nothing is re-verified on the host
                    stats["device_errors"] += 1
                    count_device_error(e, self.plane)
                    raise
            else:
                out = _host_verify()
        stats["device_batches" if route == "device" else "host_batches"] += 1
        stats["device_sigs" if route == "device" else "host_sigs"] += n
        if route != "device":
            # scalar-routed batches record zero device phases but still
            # count on the device plane's ledger
            _phases.count_host(self.plane, n)
        if metrics is not None:
            elapsed = time.perf_counter() - t0
            metrics.routing_decisions_total.labels(route, self.plane).inc()
            metrics.batch_size.labels(route, self.plane).observe(n)
            metrics.verify_latency_seconds.labels(route,
                                                  self.plane).observe(elapsed)
            if route == "device":
                n_ed = n - len(non_ed_idx)  # only ed25519 rows ride the kernel
                slots = _padded_slots(n_ed)
                if slots:
                    metrics.pad_waste_ratio.labels(self.plane).set(
                        (slots - n_ed) / slots)
        return bool(out.all()), out
