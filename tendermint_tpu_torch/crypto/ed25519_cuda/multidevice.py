"""Multi-device streaming verifier: one batch_verify_stream call sharded
across a pool of device lanes.

Counterpart of ``tendermint_tpu/crypto/ed25519_jax/multidevice.py``. The
batch's segments go round-robin to the lanes, with:

* **one worker thread per lane**, which packs, uploads and launches its
  segments on its own device and its own CUDA stream, so one lane's host
  packing overlaps another's kernel;
* **a circuit breaker per lane** (crypto/breaker.lane_breaker): a sick
  lane's segment is re-sharded onto the next healthy lane with no
  signature dropped. That is device-to-device work. When no healthy lane is
  left the call raises :class:`AllLanesFailed` to the caller: nothing is
  re-verified on the host;
* **segment sizing from a cost model** (the port's
  ``tools/device_profile.py cost-model`` output, named by
  ``TMTPU_DEVICE_PROFILE``); ``TMTPU_SEG_CHUNKS`` overrides it;
* **a fault site per lane**, ``device.lane.<label>`` (libs/faults).

A lane's label is its device's (``cuda:0``, ``cuda:1``) when each device
backs one lane, and ``cuda:0/1``, ``cpu:0/2`` and so on (the device, then
the lane's place among that device's lanes) when one device backs several:
one breaker and one fault site per lane either way. The CPU tests run CPU
lanes, and a single card can back two lanes.

Verdicts equal the single-device path's: segments are exact slices of the
same batch, fetched and reassembled in order. Every segment records its
pack/dispatch/fetch phases with its lane's label.

Knobs: ``TMTPU_VERIFY_DEVICES`` (lane count; 0/1 disables the pool, unset =
every card; with the default device pinned to the CPU, the pool exists only
when it names two or more CPU lanes), ``TMTPU_MULTIDEV_MIN_SIGS`` (engage
threshold, default 2x SEG_MIN_SIGS), ``TMTPU_DEVICE_BREAKER_THRESHOLD`` /
``TMTPU_DEVICE_BREAKER_COOLDOWN_S`` (the lane breakers).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import default_device, device_label
from ...libs.faults import faults
from .. import phases
from ..breaker import lane_breaker
from . import verify as V

logger = logging.getLogger("tmtpu.multidevice")

ENV_DEVICES = "TMTPU_VERIFY_DEVICES"
ENV_MIN_SIGS = "TMTPU_MULTIDEV_MIN_SIGS"
ENV_PROFILE = "TMTPU_DEVICE_PROFILE"

#: fault-site family: one site per lane, e.g. ``device.lane.cuda:1``
LANE_SITE_PREFIX = "device.lane."

#: keep per-dispatch fixed cost under ~1/OVERHEAD_TARGET of a segment's
#: transfer time when sizing segments from a cost model
OVERHEAD_TARGET = 9.0
#: ~wire bytes per signature on the dense path (R+A+s + padded preimage)
APPROX_BYTES_PER_SIG = 300.0


class AllLanesFailed(RuntimeError):
    """Every pool lane is sick or failed this batch; the error reaches the
    caller."""


def _seg_chunks_from_cost_model(doc: dict, chunk: int = 2048) -> Optional[int]:
    """Segment size (in chunks) from a device_profile cost-model doc: big
    enough that the fixed dispatch cost is <= ~1/OVERHEAD_TARGET of the
    segment's per-thread transfer time. None when the doc lacks the
    numbers (e.g. bandwidth below the ladder's noise floor)."""
    try:
        res = doc["results"]
        fixed_s = float(res["fixed_dispatch_ms"]["min"]) / 1e3
        bw = res["transfer"]["bandwidth_mbps"]
        if bw is None or bw <= 0 or fixed_s <= 0:
            return None
        chunk_transfer_s = chunk * APPROX_BYTES_PER_SIG / (bw * (1 << 20))
        if chunk_transfer_s <= 0:
            return None
        need = OVERHEAD_TARGET * fixed_s / chunk_transfer_s
        return max(2, min(64, -(-int(need * 1000) // 1000)))
    except (KeyError, TypeError, ValueError):
        return None


def default_seg_chunks() -> int:
    """Per-lane segment size: TMTPU_SEG_CHUNKS wins; else a cost model
    named by TMTPU_DEVICE_PROFILE; else verify.SEG_CHUNKS."""
    if os.environ.get("TMTPU_SEG_CHUNKS"):
        return V.SEG_CHUNKS  # verify.py already parsed the env knob
    path = os.environ.get(ENV_PROFILE)
    if path:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("kind") == "cost-model":
                derived = _seg_chunks_from_cost_model(doc)
                if derived is not None:
                    return derived
        except (OSError, ValueError) as e:
            logger.warning("%s=%r unusable (%s); using SEG_CHUNKS=%d",
                           ENV_PROFILE, path, e, V.SEG_CHUNKS)
    return V.SEG_CHUNKS


def plan_segments(k_total: int, n_lanes: int,
                  seg_chunks: int) -> List[Tuple[int, int]]:
    """Deterministic shard plan: ``[(size_chunks, lane_index), ...]``.

    Near-equal segments of at most ``seg_chunks`` chunks, at least two per
    lane when the batch is big enough (each lane's worker then packs
    segment i+1 while its segment i runs), assigned round-robin so the plan
    is a pure function of (k_total, n_lanes, seg_chunks)."""
    if k_total <= 0:
        return []
    n_segs = min(k_total, max(-(-k_total // seg_chunks),
                              min(k_total, 2 * n_lanes)))
    base, extra = divmod(k_total, n_segs)
    sizes = [base + (1 if i < extra else 0) for i in range(n_segs)]
    return [(s, i % n_lanes) for i, s in enumerate(sizes)]


def lane_labels(devices: Sequence[torch.device]) -> List[str]:
    """One label per lane: the device's label, or ``<device>/<k>`` for the
    k-th of several lanes on one device."""
    names = [device_label(d) for d in devices]
    counts = collections.Counter(names)
    seen: collections.Counter = collections.Counter()
    out = []
    for name in names:
        if counts[name] > 1:
            out.append(f"{name}/{seen[name]}")
            seen[name] += 1
        else:
            out.append(name)
    return out


class DeviceLane:
    """One lane: a device, its worker thread, its stream and its
    breaker."""

    __slots__ = ("index", "device", "label", "breaker", "stream", "pool")

    def __init__(self, index: int, device: torch.device, label: str):
        self.index = index
        self.device = device
        self.label = label
        self.breaker = lane_breaker(label)
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        self.pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"ed25519-lane{index}")

    def shutdown(self) -> None:
        self.pool.shutdown(wait=False)


class MultiDeviceStream:
    """Shards one batch_verify_stream call across a pool of device lanes."""

    def __init__(self, devices: Optional[Sequence] = None,
                 min_sigs: Optional[int] = None,
                 seg_chunks: Optional[int] = None):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        self.lanes = [DeviceLane(i, d, label) for i, (d, label) in
                      enumerate(zip(devices, lane_labels(devices)))]
        env_min = os.environ.get(ENV_MIN_SIGS)
        self.min_sigs = (min_sigs if min_sigs is not None
                         else int(env_min) if env_min
                         else 2 * V.SEG_MIN_SIGS)
        self.seg_chunks = (seg_chunks if seg_chunks is not None
                           else default_seg_chunks())
        self.stats = collections.Counter()

    # -- health -------------------------------------------------------------

    def eligible_lanes(self) -> List[DeviceLane]:
        """Lanes whose breakers would admit a dispatch (read-only check)."""
        return [l for l in self.lanes if l.breaker.peek()]

    def engaged(self, n: int) -> bool:
        """Should a batch of n shard across the pool? Needs enough
        signatures to amortize per-lane dispatch and at least two healthy
        lanes (with one, the single-device path is strictly better)."""
        return n >= self.min_sigs and len(self.eligible_lanes()) >= 2

    # -- the dispatcher -----------------------------------------------------

    def verify(self, pks, msgs, sigs, chunk: int, columns=None,
               t_entry: Optional[float] = None) -> np.ndarray:
        """(N,) bool — the batch as round-robin segments across healthy
        lanes, fetched and reassembled in order. A lane failure re-shards
        that segment onto the next healthy lane (no signature dropped) and
        feeds the lane's breaker; :class:`AllLanesFailed` reaches the
        caller when no healthy lane remains."""
        n = len(pks)
        lanes = self.eligible_lanes()
        if not lanes:
            raise AllLanesFailed(
                f"0/{len(self.lanes)} device lanes healthy")
        plan = plan_segments(-(-n // chunk), len(lanes), self.seg_chunks)
        bounds, lo = [], 0
        for size, lane_i in plan:
            hi = min(lo + size * chunk, n)
            bounds.append((lo, hi, lane_i))
            lo = hi
        plane, height = phases.context()
        all_recs: List[phases.Segment] = []

        def submit(seg_i, a, b, lane):
            rec = phases.Segment(
                sigs=b - a, chunk=chunk, seg=seg_i, n_segs=len(bounds),
                device=lane.label, plane=plane, height=height)
            all_recs.append(rec)
            col = columns.slice(a, b) if columns is not None else None
            fut = lane.pool.submit(
                self._run_lane, lane, rec, pks[a:b], msgs[a:b], sigs[a:b],
                chunk, col)
            return rec, fut

        # admit only lanes the plan actually dispatches to (allow() is the
        # MUTATING breaker check: it latches a half-open probe slot, and a
        # probe on a lane that never gets a segment would stay phantom-
        # in-flight for a whole cooldown, starving the lane's rejoin)
        admitted = []
        for lane in lanes[:min(len(bounds), len(lanes))]:
            if lane.breaker.allow():
                admitted.append(lane)
        if not admitted:
            raise AllLanesFailed(
                f"0/{len(self.lanes)} device lanes admitted a dispatch")
        lane_of = lambda i: admitted[i % len(admitted)]

        # windowed submission: at most ~2 queued segments per lane, so the
        # packed host arrays and device buffers alive at once are bounded
        # by the lane count, not by the batch size
        window = 2 * len(admitted)
        recs: List[Optional[phases.Segment]] = [None] * len(bounds)
        futs: List = [None] * len(bounds)
        for seg_i in range(min(window, len(bounds))):
            a, b, lane_i = bounds[seg_i]
            recs[seg_i], futs[seg_i] = submit(seg_i, a, b, lane_of(lane_i))
        if t_entry is not None:
            # stream-entry host work (bucket grouping) is critical-path
            # pack cost; charge it to segment 0 like the single-device path
            recs[0].t0 = t_entry

        out = np.zeros(n, dtype=bool)
        failed_lanes: set = set()
        try:
            for seg_i, (a, b, lane_i) in enumerate(bounds):
                lane = lane_of(lane_i)
                nxt = seg_i + window
                if nxt < len(bounds):
                    a2, b2, lane_i2 = bounds[nxt]
                    recs[nxt], futs[nxt] = submit(nxt, a2, b2,
                                                  lane_of(lane_i2))
                tried = set()
                while True:
                    t_wait0 = time.perf_counter()
                    try:
                        fetch, ok = futs[seg_i].result()
                        arr = fetch.result()
                    except Exception as e:
                        recs[seg_i].abandon()
                        tried.add(lane.label)
                        failed_lanes.add(lane.label)
                        lane.breaker.record_failure()
                        self.stats["lane_errors"] += 1
                        logger.warning(
                            "device lane %s failed segment %d/%d (n=%d): "
                            "%s — re-sharding to a healthy peer",
                            lane.label, seg_i, len(bounds), b - a, e)
                        lane = self._next_lane(tried)
                        if lane is None:
                            raise AllLanesFailed(
                                f"segment {seg_i} failed on every healthy "
                                f"lane ({sorted(tried)})") from e
                        self.stats["resharded_segments"] += 1
                        recs[seg_i], futs[seg_i] = submit(seg_i, a, b, lane)
                        continue
                    recs[seg_i].fetched(
                        wait_s=time.perf_counter() - t_wait0)
                    if lane.label not in failed_lanes:
                        lane.breaker.record_success()
                    out[a:b] = arr.reshape(-1)[:b - a] & ok
                    break
        finally:
            for r in all_recs:
                r.abandon()  # no-op for fetched records
        phases.observe_overlap(recs)
        self.stats["calls"] += 1
        self.stats["sigs"] += n
        return out

    def _next_lane(self, tried: set) -> Optional[DeviceLane]:
        """The next healthy lane not already tried for this segment."""
        for lane in self.lanes:
            if lane.label in tried:
                continue
            if lane.breaker.allow():
                return lane
        return None

    @staticmethod
    def _run_lane(lane: DeviceLane, rec, pks, msgs, sigs, chunk, columns):
        """One segment on its lane's worker: the lane's fault site, then
        pack, upload and launch on the lane's device and stream. The
        coordinating thread fetches."""
        faults.inject(LANE_SITE_PREFIX + lane.label)
        return V._run_dispatch(rec, pks, msgs, sigs, chunk, columns=columns,
                               stream=lane.stream, device=lane.device)

    def shutdown(self) -> None:
        for lane in self.lanes:
            lane.shutdown()


# -- the process pool ---------------------------------------------------------

_POOL: Optional[MultiDeviceStream] = None
_POOL_RESOLVED = False
_POOL_LOCK = threading.Lock()


def _pool_devices() -> List[torch.device]:
    """The devices the pool would use: every card, as many as
    TMTPU_VERIFY_DEVICES allows; with the default device pinned to the CPU,
    as many CPU lanes as it names. A value that is not an integer raises."""
    env = os.environ.get(ENV_DEVICES)
    want = int(env) if env else None
    if want is not None and want <= 1:
        return []
    dev = default_device()
    if dev.type == "cpu":
        return [dev] * (want or 1)
    count = torch.cuda.device_count()
    count = count if want is None else min(want, count)
    return [torch.device("cuda", i) for i in range(count)]


def pool() -> Optional[MultiDeviceStream]:
    """The process-wide MultiDeviceStream, built at first use. None when
    fewer than two devices are in play (or TMTPU_VERIFY_DEVICES <= 1). A
    pool that cannot be built raises."""
    global _POOL, _POOL_RESOLVED
    if _POOL_RESOLVED:
        return _POOL
    with _POOL_LOCK:
        if _POOL_RESOLVED:
            return _POOL
        devs = _pool_devices()
        built = None
        if len(devs) > 1:
            built = MultiDeviceStream(devices=devs)
            logger.info("multi-device verify pool: %d lanes (%s)", len(devs),
                        ", ".join(l.label for l in built.lanes))
        _POOL = built
        _POOL_RESOLVED = True
        return _POOL


def reset_pool() -> None:
    """Tear down the pool (tests / env-knob changes re-resolve lazily)."""
    global _POOL, _POOL_RESOLVED
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown()
        _POOL = None
        _POOL_RESOLVED = False


@contextlib.contextmanager
def disabled():
    """Force the single-device path inside the block (A/B runs and parity
    tests measure 'what would this cost without the pool')."""
    global _POOL, _POOL_RESOLVED
    with _POOL_LOCK:
        prev = (_POOL, _POOL_RESOLVED)
        _POOL, _POOL_RESOLVED = None, True
    try:
        yield
    finally:
        with _POOL_LOCK:
            _POOL, _POOL_RESOLVED = prev
