"""Dependency-free span tracer with Chrome trace-event export.

The reference leans on Go's pprof/runtime-trace for hot-path attribution;
Python has no equivalent that survives a wedged loop AND is cheap enough to
leave compiled into consensus-critical code. This is the minimal analog:

    from tendermint_tpu_torch.libs.trace import tracer
    with tracer.span("verify_window", height=h, n_sigs=n):
        ...

records one complete ("X"-phase) Chrome trace event per span onto a bounded,
thread-safe ring buffer. ``tracer.chrome_trace()`` / ``tracer.write(path)``
export the standard trace-event JSON that https://ui.perfetto.dev and
chrome://tracing load directly.

Disabled (the default) the hot path pays one attribute check: call sites
guard with ``if tracer.enabled`` or rely on :meth:`Tracer.span` returning a
shared no-op context manager — no event dict, no span object, no timestamp
read is allocated. ``bench.py --trace-out`` and tests enable it explicitly.

The ring is a ``collections.deque(maxlen=...)``: appends are atomic under
the GIL and old events fall off the front, so a long-running node can keep
the tracer on and still bound memory — the dump (libs/debugdump.py) snapshots
the tail of whatever survived.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 65536


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def set(self, **args) -> "_Span":
        """Amend the span's args mid-body (e.g. the route actually taken
        when a device attempt fell back to host)."""
        if self._args is None:
            self._args = {}
        self._args.update(args)
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        ev = {
            "name": self._name,
            "ph": "X",
            "ts": self._t0 * 1e6,  # trace-event timestamps are microseconds
            "dur": (t1 - self._t0) * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if self._args:
            ev["args"] = self._args
        self._tracer._record(ev)


_PID = os.getpid()


class Tracer:
    """Bounded ring of Chrome trace events; safe to share across threads."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        self.capacity = capacity
        self.enabled = enabled
        self._buf: "collections.deque" = collections.deque(maxlen=capacity)
        #: events pushed off the full ring (saturation visibility: a trace
        #: whose front was eaten should SAY so, not just look short)
        self.dropped = 0
        #: optional Counter (NodeMetrics.trace_dropped_events_total) so the
        #: saturation shows up on /metrics, not only in the export header
        self.drop_counter = None
        #: cross-node correlation identity (set_identity): who produced this
        #: trace, and how its perf_counter timeline maps onto wall clock
        self.node_id: Optional[str] = None
        self.epoch_unix_s: Optional[float] = None
        self.epoch_perf_us: Optional[float] = None

    # -- control -------------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def set_identity(self, node_id: str) -> None:
        """Stamp this process's trace with a node id and a wall↔perf epoch
        pair. ``ts`` fields stay in the process-local perf_counter domain;
        the export header carries (epoch_unix_s, epoch_perf_us) sampled at
        the same instant, so tools/trace_merge.py can re-base N nodes'
        events onto the shared wall clock and align their tracks."""
        self.node_id = str(node_id)
        self.epoch_unix_s = time.time()
        self.epoch_perf_us = time.perf_counter() * 1e6

    # -- recording -----------------------------------------------------------

    def _record(self, ev: dict) -> None:
        buf = self._buf
        if len(buf) == buf.maxlen:
            self.dropped += 1
            c = self.drop_counter
            if c is not None:
                try:
                    c.inc()
                except Exception:
                    pass
        buf.append(ev)

    def span(self, name: str, **args) -> object:
        """Context manager timing its body as one complete trace event.
        When disabled, returns a shared no-op — nothing is allocated."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker ("i"-phase instant event)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.perf_counter() * 1e6, "pid": _PID,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        self._record(ev)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 tid: Optional[int] = None, **args) -> None:
        """Record a complete event with an EXPLICIT start/duration (both in
        perf_counter microseconds) — for retroactive spans whose endpoints
        were sampled outside a context manager (the consensus stage
        timeline seals a height and emits one span per stage interval).
        ``tid`` overrides the emitting thread's id: retroactive spans for
        work that ran elsewhere (a pipeline slot's pack on a worker) would
        otherwise render overlapping slices on the emitter's track."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
              "pid": _PID,
              "tid": (tid if tid is not None
                      else threading.get_ident() & 0x7FFFFFFF)}
        if args:
            ev["args"] = args
        self._record(ev)

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        return list(self._buf)

    def tail(self, n: int) -> List[dict]:
        buf = self._buf
        if n >= len(buf):
            return list(buf)
        return list(buf)[-n:]

    def chrome_trace(self, events: Optional[list] = None) -> dict:
        """The standard trace-event container Perfetto/chrome://tracing
        load: {"traceEvents": [...], "displayTimeUnit": "ms"} — plus the
        correlation header (node_id + wall↔perf epoch, set_identity) and a
        ``dropped`` count so a saturated ring is visible instead of a
        silently truncated trace. Viewers ignore the extra keys. Pass
        ``events`` to wrap a subset (debugdump's tail) in the same
        header instead of the full ring."""
        if events is None:
            events = self.events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "dropped": self.dropped}
        if self.node_id is not None:
            # Perfetto names the pid track from this metadata event
            doc["traceEvents"] = [{
                "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
                "args": {"name": self.node_id}}] + events
            doc["node_id"] = self.node_id
            doc["epoch_unix_s"] = self.epoch_unix_s
            doc["epoch_perf_us"] = self.epoch_perf_us
        return doc

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


#: process-global tracer, disabled by default; instrumented hot paths check
#: ``tracer.enabled`` (one attribute load) before doing any tracing work
tracer = Tracer()
