"""Deterministic, seeded fault injection — the fault plane.

``libs/fail.py`` can only murder the process at a counter; real failure
modes are partial: a device call that raises, an fsync that returns EIO, a
link that eats a packet. This module gives every such failure surface a
NAMED SITE that production code consults in one call:

    from ..libs.faults import faults
    faults.inject("wal.fsync", _EIO)     # raises iff the site is armed

Sites ship disabled: ``faults`` is a singleton whose hot-path check is one
truthiness test on an empty dict, so instrumented code pays nothing in
production. Arming happens from the environment::

    TMTPU_FAULTS="wal.fsync*1+2,device.batch_verify@0.25"
    TMTPU_FAULTS_SEED=7

or programmatically (tests): ``faults.configure("db.write_batch*1")``.

Grammar — comma-separated site specs, each ``site[@prob][*count][+skip]``:

* ``site``        fire on every evaluation (prob 1, unlimited)
* ``site@0.1``    fire with probability 0.1 per evaluation
* ``site*3``      fire at most 3 times, then go quiet
* ``site+5``      skip the first 5 evaluations before arming
* modifiers combine: ``wal.fsync@0.5*2+1``

Determinism: each site draws from its own ``random.Random`` seeded by
(global seed, site name), so a failing chaos run replays EXACTLY by
re-running with the same TMTPU_FAULTS/TMTPU_FAULTS_SEED pair — regardless
of how other sites interleave or what order threads evaluate. All state is
lock-protected; sites are evaluated from reactor tasks, executor threads,
and the consensus loop alike.

Known sites (the catalog; see README "Fault injection & chaos testing"):

* ``device.batch_verify`` — BatchVerifier's device dispatch (crypto/batch.py)
* ``device.lane.<label>`` — ONE multi-device pool lane (site family, e.g.
                            ``device.lane.tpu:3``; multidevice.py)
* ``device.vote_flush``   — vote micro-batcher device flush (vote_batcher.py)
* ``wal.fsync``           — consensus WAL fsync (consensus/wal.py)
* ``db.write_batch``      — KV write batches: BufferedDB window flush and
                            SQLiteDB write_batch (libs/db.py)
* ``net.drop``            — in-proc transport delivery (p2p/inproc.py)
* ``clock.skew``          — per-node deterministic wall-clock offset for
                            vote/proposal timestamping (consensus/state.py;
                            value-returning — consulted via ``skew_ns``,
                            the ``@prob`` modifier scales the ±500ms
                            magnitude window instead of gating firing)

Content-corruption sites (the adversarial plane — ``mutate`` flips a
deterministically-chosen bit instead of raising, so the victim's REAL
verification path runs against the tampered bytes):

* ``net.corrupt``             — payload tampering at in-proc transport
                                delivery (p2p/inproc.py)
* ``statesync.lying_snapshot`` — serving reactor advertises a snapshot
                                with a bogus hash (statesync/reactor.py)
* ``statesync.lying_chunk``   — serving reactor returns corrupted chunk
                                bytes (statesync/reactor.py)
* ``blocksync.bad_block``     — serving reactor returns a tampered block
                                response (blockchain/reactor.py)

All four are injected at the SERVER so the syncing/receiving node — the
victim — exercises its production verification + peer-banning paths.

Torn-write sites (the crash plane — ``tear`` truncates a payload at a
seeded prefix and may append a seeded garbage suffix, modeling a write
the process died in the middle of, so the victim's CRC-bounded replay,
repair-on-open, atomic-rename, and WAL-replay paths run against REAL
partial data instead of clean exceptions):

* ``wal.torn_write``    — consensus WAL record emit, group commits
                          included (consensus/wal.py)
* ``db.torn_write``     — KV write batches: a seeded PREFIX of the batch
                          lands before the failure (libs/db.py — the
                          batch-level analog of a byte tear)
* ``privval.torn_state`` — last-sign-state atomic write
                          (privval/file_pv.py)
* ``mempool.wal_torn``  — MempoolWAL tx-line emit
                          (mempool/clist_mempool.py)
"""

from __future__ import annotations

import logging
import os
import random
import threading
import zlib
from typing import Callable, Dict, List, Optional

ENV_SPEC = "TMTPU_FAULTS"
ENV_SEED = "TMTPU_FAULTS_SEED"

#: every site production code actually consults (the docstring catalog).
#: Site names are intentionally open — tests arm ad-hoc names — but a
#: typo'd name in an operator-facing spec arms nothing and the chaos run
#: passes vacuously, so env/manifest arming validates against this.
KNOWN_SITES = frozenset({
    "device.batch_verify",
    "device.vote_flush",
    "wal.fsync",
    "db.write_batch",
    "net.drop",
    # seeded per-node clock skew (consensus timestamping); value-returning
    # via skew_ns(), not a fire()-gated raise
    "clock.skew",
    # conflict-group mis-assignment (state/parallel.py): a fired trigger
    # tosses a tx into a deliberately wrong speculation lane, forcing the
    # validation + re-execution machinery to earn the byte-parity
    # invariant instead of riding correct hints
    "exec.conflict",
    # BLS aggregate-verify device path (crypto/bls12381/vec.py): a fired
    # site strikes the jax apk aggregation, opening the device breaker and
    # forcing the host scalar fallback — the verdict must not change
    "crypto.bls_verify",
    # content-corruption (adversarial) sites — consulted via mutate()
    "net.corrupt",
    "statesync.lying_snapshot",
    "statesync.lying_chunk",
    "blocksync.bad_block",
    # lying light-block server (light/serve.py): a fired site swaps the
    # served header for a tampered/forged one — witness cross-check must
    # catch it and strike the liar on the peerscore ledger
    "lightserve.lying_server",
    # torn-write (crash) sites — consulted via tear()/tear_index()
    "wal.torn_write",
    "db.torn_write",
    "privval.torn_state",
    "mempool.wal_torn",
})

#: site-name prefixes that are known as a FAMILY: the multi-device
#: dispatcher consults one site per device lane
#: (``device.lane.<platform>:<id>``, e.g. ``device.lane.tpu:3``), so a
#: chaos run can arm exactly one chip and watch the pool degrade to the
#: healthy peers. Exact names can't be enumerated — device topology is a
#: runtime fact.
KNOWN_SITE_PREFIXES = ("device.lane.",)


def is_known_site(name: str) -> bool:
    return name in KNOWN_SITES or name.startswith(KNOWN_SITE_PREFIXES)

logger = logging.getLogger("tmtpu.faults")


class InjectedFault(Exception):
    """Raised by an armed site with no caller-supplied exception factory."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


class _Site:
    __slots__ = ("name", "prob", "count", "skip", "rng", "evals", "fires")

    def __init__(self, name: str, prob: float, count: Optional[int],
                 skip: int, seed: int):
        self.name = name
        self.prob = prob
        self.count = count          # None = unlimited
        self.skip = skip
        # per-site stream: other sites' draws can't perturb this one's
        self.rng = random.Random(zlib.crc32(f"{seed}|{name}".encode()))
        self.evals = 0
        self.fires = 0

    def evaluate(self) -> bool:
        self.evals += 1
        if self.evals <= self.skip:
            return False
        if self.count is not None and self.fires >= self.count:
            return False
        if self.prob < 1.0 and self.rng.random() >= self.prob:
            return False
        self.fires += 1
        return True


def _parse_spec(spec: str, seed: int) -> Dict[str, _Site]:
    sites: Dict[str, _Site] = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        name, prob, count, skip = raw, 1.0, None, 0
        # modifiers may appear in any order; the site name is the prefix up
        # to the first marker, then the modifier tail is walked char-wise
        first = min((i for i in (raw.find(m) for m in "@*+") if i >= 0),
                    default=-1)
        if first >= 0:
            name, tail = raw[:first], raw[first:]
            i = 0
            try:
                while i < len(tail):
                    marker = tail[i]
                    j = i + 1
                    while j < len(tail) and tail[j] not in "@*+":
                        j += 1
                    val = tail[i + 1:j]
                    if marker == "@":
                        prob = float(val)
                    elif marker == "*":
                        count = int(val)
                    elif marker == "+":
                        skip = int(val)
                    i = j
            except ValueError as e:
                raise ValueError(f"bad fault spec {raw!r}: {e}") from e
        if not name:
            raise ValueError(f"bad fault spec {raw!r}: empty site name")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"bad fault spec {raw!r}: prob not in [0,1]")
        if (count is not None and count < 0) or skip < 0:
            raise ValueError(f"bad fault spec {raw!r}: negative count/skip")
        sites[name] = _Site(name, prob, count, skip, seed)
    return sites


# FaultMetrics (faults_injected_total{site}), wired by the node; None for
# library users — one None-check per FIRE, not per evaluation
metrics = None


def set_fault_metrics(m) -> None:
    global metrics
    metrics = m


class FaultPlane:
    """Singleton holding every armed site. Disabled == empty == free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {}
        self._spec = ""
        self._seed = 0

    # -- configuration -----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._sites)

    @property
    def spec(self) -> str:
        return self._spec

    @property
    def seed(self) -> int:
        return self._seed

    def configure(self, spec: str, seed: int = 0) -> "FaultPlane":
        """Arm sites from a spec string (see module grammar). Replaces any
        previous configuration; returns self for chaining."""
        parsed = _parse_spec(spec, seed)
        with self._lock:
            self._sites = parsed
            self._spec = spec
            self._seed = seed
        return self

    def configure_from_env(self, environ=os.environ) -> "FaultPlane":
        spec = environ.get(ENV_SPEC, "")
        if spec:
            self.configure(spec, int(environ.get(ENV_SEED, "0") or "0"))
            unknown = {s for s in self._sites if not is_known_site(s)}
            if unknown:
                logger.warning(
                    "%s arms site(s) no production code consults: %s — "
                    "known sites: %s", ENV_SPEC, sorted(unknown),
                    sorted(KNOWN_SITES))
        return self

    def reset(self) -> None:
        """Disarm every site (test fixtures call this between tests)."""
        with self._lock:
            self._sites = {}
            self._spec = ""
            self._seed = 0

    # -- evaluation (the production seam) ----------------------------------

    def armed(self, site: str) -> bool:
        """Lock-free membership probe for hot paths that want to skip
        ``fire``'s lock when the site isn't configured at all. Safe:
        ``_sites`` is replaced wholesale under configure/reset, and a dict
        membership test is atomic under the GIL."""
        return site in self._sites

    def fire(self, site: str) -> bool:
        """Evaluate one trigger at `site`; True when the fault should
        happen. The disabled fast path is a single dict-truthiness check."""
        if not self._sites:
            return False
        with self._lock:
            st = self._sites.get(site)
            if st is None or not st.evaluate():
                return False
        m = metrics
        if m is not None:
            m.faults_injected_total.labels(site).inc()
        return True

    def inject(self, site: str,
               exc_factory: Optional[Callable[[str], BaseException]] = None
               ) -> None:
        """Raise at `site` when armed; no-op otherwise. ``exc_factory``
        builds the exception (default: InjectedFault) so storage sites can
        surface an OSError exactly like the real failure would."""
        if self.fire(site):
            raise (exc_factory(site) if exc_factory is not None
                   else InjectedFault(site))

    def mutate(self, site: str, data: bytes) -> bytes:
        """Content-corruption seam: return `data` with one
        deterministically-chosen bit flipped when `site` fires, `data`
        unchanged otherwise. The flip position comes from the site's own
        seeded RNG, so a corruption schedule replays exactly — the i-th
        fire of a site always tampers the same way. Empty payloads pass
        through untouched (there is nothing to lie about)."""
        if not self._sites or not data:
            return data
        with self._lock:
            st = self._sites.get(site)
            if st is None or not st.evaluate():
                return data
            # draw under the lock from the site stream: position/bit are
            # part of the deterministic schedule, not scheduling noise
            pos = st.rng.randrange(len(data))
            bit = 1 << st.rng.randrange(8)
        m = metrics
        if m is not None:
            m.faults_injected_total.labels(site).inc()
        out = bytearray(data)
        out[pos] ^= bit
        return bytes(out)

    def tear(self, site: str, data: bytes) -> bytes:
        """Torn-write seam: when `site` fires, return `data` truncated at a
        seeded prefix (0 <= cut < len — always strictly partial) with, on a
        seeded coin flip, a short garbage suffix appended (the disk sector
        half-written at crash time). `data` unchanged otherwise. Both draws
        come from the site's own stream, so the i-th tear of a site is the
        same tear every run — a torn-tail repro replays from its seed.
        Empty payloads pass through (nothing to tear)."""
        if not self._sites or not data:
            return data
        with self._lock:
            st = self._sites.get(site)
            if st is None or not st.evaluate():
                return data
            cut = st.rng.randrange(len(data))
            garbage = b""
            if st.rng.random() < 0.5:
                garbage = st.rng.randbytes(st.rng.randrange(1, 9))
        m = metrics
        if m is not None:
            m.faults_injected_total.labels(site).inc()
        return data[:cut] + garbage

    def tear_index(self, site: str, n: int) -> Optional[int]:
        """Batch-level tear: when `site` fires, a seeded cut index in
        [0, n) — the caller applies only items[:cut] before failing, the
        multi-record analog of a byte-level torn write (used by the KV
        write-batch seam, where the unit of emission is a record, not a
        byte). None when the site is quiet."""
        if not self._sites or n <= 0:
            return None
        with self._lock:
            st = self._sites.get(site)
            if st is None or not st.evaluate():
                return None
            cut = st.rng.randrange(n)
        m = metrics
        if m is not None:
            m.faults_injected_total.labels(site).inc()
        return cut

    def skew_ns(self, site: str, ident: str,
                max_abs_ns: int = 500_000_000) -> int:
        """Value-returning seam for clock-skew sites: a deterministic
        signed offset in [-max_abs_ns, +max_abs_ns] nanoseconds for
        ``ident`` (node name / validator address) when ``site`` is armed,
        0 otherwise. The offset is a pure function of (seed, site, ident)
        — NOT of the site's RNG stream position — so every consultation
        returns the same value and arming order can't perturb it; two
        nodes with different idents get different (but each deterministic)
        offsets from one spec. The ``@prob`` modifier scales the magnitude
        window (``clock.skew@0.5`` draws from ±max/2) rather than gating
        firing — a clock is skewed or it isn't, per process."""
        if not self._sites:
            return 0
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return 0
            st.evals += 1
            span = int(max_abs_ns * st.prob)
            seed = self._seed
            if span <= 0:
                return 0
            st.fires += 1
        m = metrics
        if m is not None:
            m.faults_injected_total.labels(site).inc()
        rng = random.Random(zlib.crc32(f"{seed}|{site}|{ident}".encode()))
        return rng.randint(-span, span)

    # -- introspection (tests / tools) -------------------------------------

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {name: {"evals": s.evals, "fires": s.fires}
                    for name, s in self._sites.items()}

    def fires(self, site: str) -> int:
        with self._lock:
            s = self._sites.get(site)
            return s.fires if s is not None else 0


#: process-wide singleton; armed from the environment at import so
#: subprocess nodes (e2e runner, cmd start) inherit TMTPU_FAULTS for free
faults = FaultPlane().configure_from_env()
