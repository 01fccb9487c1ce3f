"""Per-segment dispatch-phase telemetry for the device verification plane.

Every device dispatch has three phases — host packing, the async kernel
dispatch, and the fetch wait for verdicts. This module makes their stamps
a permanent, always-on part of the dispatch path so the cost model is
*measured by the system itself*:

* :class:`Segment` — one dispatched segment's monotonic phase stamps.
  ``begin()`` opens the pack phase, ``pack_done()`` closes it (stamped from
  inside the dispatcher via the thread-local active segment),
  ``dispatched()`` marks the async kernel call returning, and ``fetched()``
  closes the record when the verdict array is on the host. By construction
  ``pack_s + dispatch_s + fetch_s == t_end - t0`` for every record.
* a bounded ring of the last :data:`RING_CAPACITY` records plus cumulative
  :func:`phase_totals` — the inputs ``tools/device_profile.py`` and the
  debugdump ``device.json`` snapshot read;
* a ``DeviceMetrics`` hook (:func:`set_device_metrics`, wired by the node
  like ``crypto.batch.set_crypto_metrics``): phase histograms
  ``crypto_segment_phase_seconds{phase,plane}``, the per-segment size
  histogram, per-device dispatch counter / in-flight gauge, and the
  pipeline-overlap gauge;
* height-tagged ``seg_pack`` / ``seg_dispatch`` / ``seg_fetch`` tracer
  spans (emitted retroactively via ``tracer.complete`` when a segment
  closes) so ``trace_summary --by-height`` and ``trace_merge`` render
  device-pipeline occupancy next to the consensus stage timeline;
* :func:`phase_breakdown` — interval-union decomposition of a wall-clock
  window into exposed pack / exposed dispatch / device-in-flight shares
  (the shares sum to the accounted fraction of wall time — bench.py's
  flagship asserts they cover >=90%).

Deliberately kernel-free: the host-fallback planes (crypto/batch.py scalar
route, the vote micro-batcher) count their batches here via
:func:`count_host` without dragging the CUDA kernels into the hot path.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..libs.trace import tracer

#: the phase catalog (README "Device profiling"): pack = host-side wire
#: packing, dispatch = the async kernel call returning, fetch = dispatch
#: return -> verdict bytes on host (in-flight transfer+compute+wait)
PHASE_NAMES = ("pack", "dispatch", "fetch")

#: last-N segment records kept for debugdump / the profiler
RING_CAPACITY = 256

#: synthetic tracer tid base for per-segment span tracks; each Segment
#: draws a distinct track (mod 256) so two calls in flight at once (a
#: live-plane flush under a sync-plane window) never share one — sharing
#: would render wall-time-overlapping slices as mis-nested in Perfetto
_SEG_TRACK_BASE = 0x5E60000
_TRACK_SEQ = itertools.count()

#: DeviceMetrics hook (libs/metrics.py), wired by node.py; None outside a
#: node process so library callers pay one None-check per segment
metrics = None


def set_device_metrics(m) -> None:
    global metrics
    metrics = m


# -- plane/height tagging context --------------------------------------------

# (plane, height): "sync" for block-sync/commit segments (default), "live"
# for the vote micro-batcher's flush dispatches. Height is tagged by the
# block-sync reactor around its window verify.
_ctx: "contextvars.ContextVar[Tuple[str, Optional[int]]]" = \
    contextvars.ContextVar("tmtpu_phase_ctx", default=("sync", None))


@contextlib.contextmanager
def telemetry(plane: Optional[str] = None, height: Optional[int] = None):
    """Tag segments recorded in this context with a plane and/or height.
    Thread-scoped like any contextvar: set it on the thread that calls the
    verifier (executor thunks must set it inside the thunk)."""
    cur_plane, cur_height = _ctx.get()
    token = _ctx.set((plane if plane is not None else cur_plane,
                      height if height is not None else cur_height))
    try:
        yield
    finally:
        _ctx.reset(token)


def context() -> Tuple[str, Optional[int]]:
    return _ctx.get()


# -- recording ----------------------------------------------------------------

_lock = threading.Lock()
_records: "collections.deque" = collections.deque(maxlen=RING_CAPACITY)
_ZERO_TOTALS = {
    "segments": 0, "sigs": 0,
    "pack_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0, "wait_s": 0.0,
    # per segmented call: union of in-flight intervals vs their sum
    "pipelined_calls": 0, "inflight_union_s": 0.0, "inflight_sum_s": 0.0,
    # scalar-routed batches: zero device phases, still counted
    "host_batches": 0, "host_sigs": 0,
}
_totals: Dict[str, float] = dict(_ZERO_TOTALS)

# thread-local active segment: the dispatcher stamps pack_done() from deep
# inside _dispatch_stream without threading a record through its signature
_active = threading.local()


def set_active(rec: "Segment"):
    prev = getattr(_active, "rec", None)
    _active.rec = rec
    return prev


def clear_active(prev) -> None:
    _active.rec = prev


def mark_pack_done() -> None:
    rec = getattr(_active, "rec", None)
    if rec is not None:
        rec.pack_done()


class Segment:
    """One device dispatch's phase stamps. Construct on the coordinating
    thread (captures plane/height from :func:`context` unless passed), then
    ``begin()`` on whichever thread packs, ``fetched()`` when the verdicts
    are host-resident."""

    __slots__ = ("plane", "height", "seg", "n_segs", "sigs", "chunk",
                 "device", "devices", "t0", "t_pack", "t_dispatch", "t_end",
                 "wait_s", "track")

    def __init__(self, sigs: int, chunk: int, seg: int = 0, n_segs: int = 1,
                 device: str = "device", plane: Optional[str] = None,
                 height: Optional[int] = None,
                 devices: Optional[Sequence[str]] = None):
        if plane is None or height is None:
            c_plane, c_height = _ctx.get()
            plane = plane if plane is not None else c_plane
            height = height if height is not None else c_height
        self.plane = plane
        self.height = height
        self.seg = seg
        self.n_segs = n_segs
        self.sigs = sigs
        self.chunk = chunk
        self.device = device
        self.devices = tuple(devices) if devices else (device,)
        self.t0 = None
        self.t_pack = None
        self.t_dispatch = None
        self.t_end = None
        self.wait_s = 0.0
        self.track = _SEG_TRACK_BASE + (next(_TRACK_SEQ) & 0xFF)

    def begin(self) -> "Segment":
        if self.t0 is None:
            self.t0 = time.perf_counter()
        return self

    def pack_done(self) -> "Segment":
        if self.t_pack is None:
            self.t_pack = time.perf_counter()
        return self

    def dispatched(self) -> "Segment":
        # state transition under the module lock: an abandon() racing from
        # the consuming thread (a sibling's fetch raised while this worker
        # was still packing) must never interleave with the gauge
        # increment — a late dispatch on a closed record would increment
        # in-flight with nobody left to drain it
        with _lock:
            if self.t_dispatch is not None or self.t_end is not None:
                return self
            self.t_dispatch = time.perf_counter()
            if self.t_pack is None:
                # no inner pack stamp (stubbed dispatch): attribute it all
                # to pack so the phases still tile the segment span exactly
                self.t_pack = self.t_dispatch
        m = metrics
        if m is not None:
            try:
                for d in self.devices:
                    m.device_dispatch_total.labels(d).inc()
                    m.device_inflight.labels(d).inc()
            except Exception:
                pass
        return self

    def abandon(self) -> "Segment":
        """Close a never-fetched segment (a relay fetch or a sibling
        segment raised): drains the in-flight gauge if it dispatched, and
        marks the record closed either way — so a pipeline worker still
        mid-pack when its call aborts cannot increment the gauge later
        with nobody left to drain it. No phase observation — the segment
        has no honest fetch time. No-op for already-fetched records."""
        with _lock:
            if self.t_end is not None:
                return self
            self.t_end = time.perf_counter()
            was_dispatched = self.t_dispatch is not None
        if not was_dispatched:
            return self  # closed pre-dispatch: gauge was never touched
        m = metrics
        if m is not None:
            try:
                for d in self.devices:
                    m.device_inflight.labels(d).inc(-1)
            except Exception:
                pass
        return self

    def fetched(self, wait_s: float = 0.0) -> "Segment":
        """Close the record: verdicts are on the host. ``wait_s`` is the
        portion of the fetch phase the *consuming* thread spent blocked
        (future wait + device-to-host copy) — the critical-path cost."""
        self.dispatched()  # defensive: a record may close without stamps
        t_end = time.perf_counter()
        with _lock:
            if self.t_end is not None:
                return self
            self.t_end = t_end
        self.wait_s = float(wait_s)
        pack_s = self.t_pack - self.t0
        dispatch_s = self.t_dispatch - self.t_pack
        fetch_s = t_end - self.t_dispatch
        rec = {
            "plane": self.plane, "height": self.height,
            "seg": self.seg, "n_segs": self.n_segs,
            "sigs": self.sigs, "chunk": self.chunk, "device": self.device,
            "t0": self.t0, "t_end": t_end,
            "pack_s": pack_s, "dispatch_s": dispatch_s, "fetch_s": fetch_s,
            "wait_s": self.wait_s,
        }
        if len(self.devices) > 1:
            rec["devices"] = list(self.devices)
        with _lock:
            _records.append(rec)
            _totals["segments"] += 1
            _totals["sigs"] += self.sigs
            _totals["pack_s"] += pack_s
            _totals["dispatch_s"] += dispatch_s
            _totals["fetch_s"] += fetch_s
            _totals["wait_s"] += self.wait_s
        m = metrics
        if m is not None:
            try:
                m.segment_phase_seconds.labels("pack", self.plane).observe(pack_s)
                m.segment_phase_seconds.labels("dispatch",
                                               self.plane).observe(dispatch_s)
                m.segment_phase_seconds.labels("fetch", self.plane).observe(fetch_s)
                m.segment_sigs.labels(self.plane).observe(self.sigs)
                for d in self.devices:
                    m.device_inflight.labels(d).inc(-1)
            except Exception:
                pass
        if tracer.enabled:
            args = {"plane": self.plane, "seg": self.seg,
                    "n_segs": self.n_segs, "sigs": self.sigs,
                    "device": self.device}
            if self.height is not None:
                args["height"] = self.height
            # synthetic per-segment track: pipelined (and cross-plane
            # concurrent) segments overlap in wall time, and all three
            # spans are emitted from the fetching thread — sharing a real
            # tid would render overlapping slices on one track as
            # mis-nested garbage in Perfetto. One track per segment shows
            # the occupancy honestly.
            tid = self.track
            tracer.complete("seg_pack", self.t0 * 1e6, pack_s * 1e6,
                            tid=tid, **args)
            tracer.complete("seg_dispatch", self.t_pack * 1e6,
                            dispatch_s * 1e6, tid=tid, **args)
            tracer.complete("seg_fetch", self.t_dispatch * 1e6,
                            fetch_s * 1e6, tid=tid, **args)
        return self


def count_host(plane: str, sigs: int) -> None:
    """A batch that never touched the device (scalar route / host
    fallback): zero device phases, but it must still COUNT — otherwise
    host-routed work silently vanishes from the device plane's accounting.
    Shows up as ``crypto_device_dispatch_total{device="host"}`` plus
    per-plane ``host_batches_<plane>`` / ``host_sigs_<plane>`` totals (the
    profiler / device.json answer to "which plane fell back how often")."""
    with _lock:
        _totals["host_batches"] += 1
        _totals["host_sigs"] += sigs
        for key, amt in ((f"host_batches_{plane}", 1),
                         (f"host_sigs_{plane}", sigs)):
            _totals[key] = _totals.get(key, 0) + amt
    m = metrics
    if m is not None:
        try:
            m.device_dispatch_total.labels("host").inc()
        except Exception:
            pass


def observe_overlap(recs: Sequence["Segment"]) -> Optional[float]:
    """Pipeline-overlap ratio for one segmented call: wall time with >=1
    segment in flight (union of [dispatched, fetched] intervals) over the
    SUM of in-flight durations. 1.0 = fully serial dispatches; 0.5 = a
    2-deep pipeline whose in-flight windows fully overlap."""
    iv = [(r.t_dispatch, r.t_end) for r in recs
          if r.t_dispatch is not None and r.t_end is not None]
    if not iv:
        return None
    total = sum(b - a for a, b in iv)
    if total <= 0:
        return None
    ratio = _union_len(iv) / total
    with _lock:
        _totals["pipelined_calls"] += 1
        _totals["inflight_union_s"] += _union_len(iv)
        _totals["inflight_sum_s"] += total
    m = metrics
    if m is not None:
        try:
            m.pipeline_overlap_ratio.set(ratio)
        except Exception:
            pass
    return ratio


# -- read side ----------------------------------------------------------------

def recent_segments(n: Optional[int] = None) -> List[dict]:
    """Copies of the last ``n`` (default: all retained) segment records."""
    with _lock:
        out = [dict(r) for r in _records]
    return out if n is None else out[-n:]


def phase_totals() -> Dict[str, float]:
    with _lock:
        return dict(_totals)


def reset() -> None:
    with _lock:
        _records.clear()
        _totals.clear()
        _totals.update(_ZERO_TOTALS)


# -- wall-clock decomposition -------------------------------------------------

def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [a, b) intervals."""
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def phase_breakdown(records: Sequence[dict], wall_t0: float,
                    wall_t1: float) -> Dict[str, float]:
    """Decompose a wall-clock window into device-plane phase shares from
    the segment records inside it.

    Interval-union accounting keeps the shares physical under pipelining:
    ``device_share`` is the union of in-flight intervals; ``pack`` /
    ``dispatch`` exposed shares count only host time NOT hidden behind an
    in-flight segment. The three exposed shares sum to ``accounted_share``
    (<= 1), while ``*_s`` totals sum raw per-thread seconds (which CAN
    exceed wall — that is the overlap working)."""
    wall = max(wall_t1 - wall_t0, 1e-9)
    pack_iv, disp_iv, fly_iv = [], [], []
    pack_s = dispatch_s = fetch_s = wait_s = 0.0
    sigs = 0
    for r in records:
        t0 = r["t0"]
        t_pack = t0 + r["pack_s"]
        t_disp = t_pack + r["dispatch_s"]
        pack_iv.append((t0, t_pack))
        disp_iv.append((t_pack, t_disp))
        fly_iv.append((t_disp, r["t_end"]))
        pack_s += r["pack_s"]
        dispatch_s += r["dispatch_s"]
        fetch_s += r["fetch_s"]
        wait_s += r["wait_s"]
        sigs += r["sigs"]
    fly_u = _union_len(fly_iv)
    pack_exposed = _union_len(fly_iv + pack_iv) - fly_u
    disp_exposed = _union_len(fly_iv + pack_iv + disp_iv) \
        - _union_len(fly_iv + pack_iv)
    busy = fly_u + pack_exposed + disp_exposed
    fly_sum = sum(b - a for a, b in fly_iv)
    return {
        "wall_s": wall, "busy_s": busy,
        "accounted_share": busy / wall,
        "segments": len(records), "sigs": sigs,
        "pack_s": pack_s, "dispatch_s": dispatch_s,
        "fetch_s": fetch_s, "wait_s": wait_s,
        "pack_share_total": pack_s / wall,
        "pack_share_exposed": pack_exposed / wall,
        "dispatch_share_exposed": disp_exposed / wall,
        "device_share": fly_u / wall,
        "overlap_ratio": (fly_u / fly_sum) if fly_sum > 0 else 1.0,
    }
