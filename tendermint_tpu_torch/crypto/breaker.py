"""Device circuit breaker for the verification plane.

The device backend (the CUDA kernels) can fail persistently: a card that
is lost or wedged, a kernel build that never lands. Before this breaker, every batch re-discovered the failure — paying
the dispatch timeout or exception each time — because the fallback had no
memory. Classic breaker state machine (Nygard, "Release It!"):

* CLOSED     — device route allowed; N consecutive failures trip it OPEN.
* OPEN       — zero device attempts until ``cooldown_s`` elapses.
* HALF_OPEN  — after the cooldown, exactly ONE in-flight probe batch is
               allowed onto the device; success closes the breaker, failure
               re-opens it for another cooldown.

The module singleton ``device_breaker`` stays, with its tests, but no
route of the port reads it (see below). The lane
breakers serve ``crypto/ed25519_cuda/multidevice.py``. Thread-safe: the
lanes run on executor threads.

Tuning: ``TMTPU_BREAKER_THRESHOLD`` (consecutive failures to trip,
default 3), ``TMTPU_BREAKER_COOLDOWN_S`` (seconds OPEN before a probe,
default 30). State + transitions export via CryptoMetrics when the node
wires ``set_breaker_metrics``.

Per-device lanes: the multi-device dispatcher
(``crypto/ed25519_cuda/multidevice.py``) keeps one breaker PER DEVICE via
:func:`lane_breaker` (names ``device:<platform>:<id>``) so one sick card
degrades the pool to N-1 healthy lanes. Lane knobs:
``TMTPU_DEVICE_BREAKER_THRESHOLD`` / ``TMTPU_DEVICE_BREAKER_COOLDOWN_S``
(falling back to the shared knobs above). When EVERY lane is sick the
dispatcher raises ``AllLanesFailed`` to the caller. No route of the port
reads the shared ``device_breaker``: a device fault reaches the caller,
counted by :func:`count_device_error`, and nothing moves to the host.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
import weakref
from typing import Callable, Optional

logger = logging.getLogger("tmtpu.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: gauge encoding (README metric catalog): 0 closed, 1 open, 2 half-open
STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

DEFAULT_FAILURE_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 30.0

# CryptoMetrics hook (breaker_state / breaker_transitions_total), wired by
# the node alongside crypto.batch.set_crypto_metrics
metrics = None

# weak: tests construct many short-lived breakers; only live ones should
# re-export gauge state when metrics are wired
_BREAKERS: "weakref.WeakSet" = weakref.WeakSet()


def set_breaker_metrics(m) -> None:
    global metrics
    metrics = m
    if m is not None:
        for b in _BREAKERS:
            b._export_state(m)


class CircuitBreaker:
    def __init__(self, name: str = "device",
                 failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        env_thr = os.environ.get("TMTPU_BREAKER_THRESHOLD")
        env_cd = os.environ.get("TMTPU_BREAKER_COOLDOWN_S")
        self.name = name
        self.failure_threshold = (failure_threshold if failure_threshold
                                  is not None else
                                  int(env_thr) if env_thr
                                  else DEFAULT_FAILURE_THRESHOLD)
        self.cooldown_s = (cooldown_s if cooldown_s is not None else
                           float(env_cd) if env_cd else DEFAULT_COOLDOWN_S)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started_at = 0.0
        self.stats = collections.Counter()
        _BREAKERS.add(self)

    # -- the routing seam ---------------------------------------------------

    def allow(self) -> bool:
        """May the caller attempt the device route right now? OPEN answers
        False (host path, no device attempt); an elapsed cooldown admits
        exactly one probe (HALF_OPEN) until its verdict arrives."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    self.stats["rejections"] += 1
                    return False
                self._transition(HALF_OPEN)
                self._probe_in_flight = True
                self._probe_started_at = self._clock()
                self.stats["probes"] += 1
                return True
            # HALF_OPEN: one probe at a time — but a probe whose verdict
            # never arrives (task cancelled mid-await, relay wedged) must
            # not latch the breaker shut forever; after a cooldown's worth
            # of silence the probe is presumed abandoned and a new one is
            # admitted
            if (self._probe_in_flight
                    and self._clock() - self._probe_started_at
                    < self.cooldown_s):
                self.stats["rejections"] += 1
                return False
            self._probe_in_flight = True
            self._probe_started_at = self._clock()
            self.stats["probes"] += 1
            return True

    def peek(self) -> bool:
        """Read-only: would :meth:`allow` admit a call right now? Unlike
        ``allow`` this neither admits a half-open probe nor counts a
        rejection — the multi-device planner uses it to pick healthy lanes
        without consuming probe slots on lanes it may not dispatch to."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return self._clock() - self._opened_at >= self.cooldown_s
            return not (self._probe_in_flight
                        and self._clock() - self._probe_started_at
                        < self.cooldown_s)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            self.stats["failures"] += 1
            if self._state == HALF_OPEN:
                # failed probe: straight back to OPEN for another cooldown
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._consecutive_failures += 1
            if (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(OPEN)

    # -- internals ----------------------------------------------------------

    def _transition(self, new: str) -> None:
        # caller holds the lock
        old, self._state = self._state, new
        self.stats[f"to_{new}"] += 1
        if new == OPEN:
            logger.warning(
                "circuit breaker %r OPEN after %d consecutive device "
                "failures; host path only for %.1fs", self.name,
                self._consecutive_failures, self.cooldown_s)
        else:
            logger.info("circuit breaker %r: %s -> %s", self.name, old, new)
        m = metrics
        if m is not None:
            m.breaker_transitions_total.labels(self.name, old, new).inc()
            m.breaker_state.labels(self.name).set(STATE_CODE[new])

    def _export_state(self, m) -> None:
        m.breaker_state.labels(self.name).set(STATE_CODE[self._state])

    # -- introspection / tests ---------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def reset(self) -> None:
        with self._lock:
            changed = self._state != CLOSED
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self.stats.clear()
        m = metrics
        if m is not None and changed:
            m.breaker_state.labels(self.name).set(STATE_CODE[CLOSED])


#: the shared device-route breaker (BatchVerifier + vote micro-batcher)
device_breaker = CircuitBreaker("device")


# -- per-device lane breakers -------------------------------------------------

#: device label ("tpu:3", "cpu:0") -> lane CircuitBreaker. Keyed by label,
#: not device object: a rebuilt pool after reset_pool() reuses the same
#: breaker state for the same physical chip.
_LANE_BREAKERS: dict = {}
_LANE_LOCK = threading.Lock()


def lane_breaker(label: str) -> CircuitBreaker:
    """The per-device breaker for one dispatch lane, created on first use.
    Lane knobs (``TMTPU_DEVICE_BREAKER_THRESHOLD`` /
    ``TMTPU_DEVICE_BREAKER_COOLDOWN_S``) are read at creation and fall back
    to the shared breaker defaults."""
    with _LANE_LOCK:
        b = _LANE_BREAKERS.get(label)
        if b is None:
            thr = os.environ.get("TMTPU_DEVICE_BREAKER_THRESHOLD")
            cd = os.environ.get("TMTPU_DEVICE_BREAKER_COOLDOWN_S")
            b = CircuitBreaker(
                f"device:{label}",
                failure_threshold=int(thr) if thr else None,
                cooldown_s=float(cd) if cd else None)
            _LANE_BREAKERS[label] = b
        return b


def lane_breakers() -> dict:
    """Snapshot of the live lane breakers (label -> CircuitBreaker)."""
    with _LANE_LOCK:
        return dict(_LANE_BREAKERS)


def reset_lane_breakers() -> None:
    """Reset every lane breaker and drop the registry (test fixtures; a
    later lane_breaker() re-reads the env knobs)."""
    with _LANE_LOCK:
        for b in _LANE_BREAKERS.values():
            b.reset()
        _LANE_BREAKERS.clear()


def classify_device_error(e: BaseException) -> str:
    """reason label of device_errors_total: unavailable / injected /
    compile_error / runtime_error (the cardinality-bounded taxonomy, not
    str(e))."""
    from ..device import KernelUnavailable
    from ..libs.faults import InjectedFault

    if isinstance(e, KernelUnavailable):
        return "unavailable"
    if isinstance(e, InjectedFault):
        return "injected"
    name = type(e).__name__
    text = f"{name}: {e}".lower()
    if "compil" in text:
        return "compile_error"
    return "runtime_error"


def count_device_error(e: BaseException, plane: str) -> None:
    """Count a device fault that is about to reach the caller, once, on
    ``crypto_device_errors_total{reason, plane}`` of the registry set by
    ``crypto.batch.set_crypto_metrics`` (``plane``: votes, light,
    evidence, ingest, aggsig or merkle), and mark it so that
    ``device.is_device_fault`` knows it up the stack. A fault counted by
    an inner site is not counted again by an outer one."""
    from ..device import mark_device_fault
    from . import batch

    if not mark_device_fault(e):
        return
    m = batch.metrics
    if m is not None:
        m.device_errors_total.labels(classify_device_error(e), plane).inc()
