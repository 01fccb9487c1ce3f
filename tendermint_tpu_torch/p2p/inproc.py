"""In-process transport: whole multi-node networks in one asyncio loop
(the reference's p2p test utilities — MakeConnectedSwitches over net.Pipe,
p2p/test_util.go). The production TCP transport shares the Peer surface.

Chaos controls: every DIRECTED link (a's peer object for b carries the
a→b direction) can take a :class:`LinkPolicy` — seeded drop / duplicate /
reorder / delay / jitter plus a partition blackhole — so a 4-node
consensus net can be run under deterministic 10% loss, partitioned, and
healed, all inside one test. Policies are applied at ``try_send`` time;
with no policy the path is byte-identical to the original direct enqueue.

Degraded-network profiles: :data:`LINK_PROFILES` names the knob sets for
the hard regimes the partially-synchronous model actually allows —
``wan`` (latency + jitter + light loss), ``gray`` (heavy loss, NOT a
blackhole: some traffic still leaks through, so peers never see a clean
disconnect), and ``asym`` (one direction degraded while the reverse stays
clean). :func:`plan_link_profiles` is the pure seeded planner that maps
every directed link to its knobs — same (ids, profile, seed) → same plan —
and ``InProcNetwork.apply_link_plan`` attaches it to a live net. One-way
partitions (``partition_oneway``) and cut-scoped healing (``heal`` with
groups) round out the plane: healing never replaces policy objects, so
the surviving direction's RNG stream keeps replaying.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import random
import zlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..libs.faults import faults
from .base import Peer
from .switch import Switch

logger = logging.getLogger("tmtpu.p2p.inproc")


class LinkPolicy:
    """Deterministic chaos policy for one directed link.

    All randomness comes from one ``random.Random`` seeded by
    (seed, src, dst), so a run replays exactly: the i-th send over this
    link sees the same fate every time regardless of scheduling elsewhere.
    ``blocked`` models a network partition: sends are blackholed (the
    sender still sees success — a partitioned wire gives no feedback).

    ``delay_s`` is the base one-way latency; ``jitter_s`` adds a seeded
    uniform draw in [0, jitter_s) per delivered copy, modeling WAN queueing
    variance. With ``jitter_s == 0`` the RNG stream is byte-identical to a
    policy built before jitter existed (no extra draw is consumed), so
    seeded replays of older schedules still hold.
    """

    __slots__ = ("drop_p", "dup_p", "reorder_p", "delay_s", "jitter_s",
                 "blocked", "profile", "rng", "stats")

    def __init__(self, src: str = "", dst: str = "", seed: int = 0,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 reorder_p: float = 0.0, delay_s: float = 0.0,
                 jitter_s: float = 0.0, blocked: bool = False,
                 profile: str = ""):
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.reorder_p = reorder_p
        self.delay_s = delay_s
        self.jitter_s = jitter_s
        self.blocked = blocked
        self.profile = profile
        self.rng = random.Random(zlib.crc32(f"{seed}|{src}|{dst}".encode()))
        self.stats = collections.Counter()

    def plan(self) -> Optional[list]:
        """Decide one message's fate: None = drop/blackhole, else a list of
        per-copy delivery delays (0.0 = immediate). Pure decision — the
        peer does the queueing — so determinism is testable without a
        loop."""
        if self.blocked:
            self.stats["blackholed"] += 1
            return None
        r = self.rng
        if self.drop_p and r.random() < self.drop_p:
            self.stats["dropped"] += 1
            return None
        copies = 1
        if self.dup_p and r.random() < self.dup_p:
            copies = 2
            self.stats["duplicated"] += 1
        delays = []
        for _ in range(copies):
            delay = self.delay_s
            if self.jitter_s:
                delay += r.uniform(0.0, self.jitter_s)
                self.stats["jittered"] += 1
            if self.reorder_p and r.random() < self.reorder_p:
                # hold this copy just long enough for later sends to
                # overtake it (queue pumps drain in well under a ms)
                delay += r.uniform(0.001, 0.005)
                self.stats["reordered"] += 1
            if delay:
                self.stats["delayed"] += 1
            delays.append(delay)
        self.stats["delivered"] += copies
        return delays


#: named knob sets for one DIRECTED link under each degraded-network
#: profile (the e2e manifest validates against these same names):
#:   wan   continental RTT with queueing variance and light loss
#:   gray  heavy loss that still leaks traffic — peers never see a clean
#:         disconnect, the regime that defeats naive failure detectors
#:   asym  knobs for the DEGRADED direction of an asymmetric pair; the
#:         planner leaves the reverse direction clean
LINK_PROFILES: Dict[str, Dict[str, float]] = {
    "wan":  {"delay_s": 0.030, "jitter_s": 0.040, "drop_p": 0.01,
             "reorder_p": 0.05},
    "gray": {"delay_s": 0.010, "jitter_s": 0.020, "drop_p": 0.60},
    "asym": {"delay_s": 0.020, "jitter_s": 0.030, "drop_p": 0.45},
}


def plan_link_profiles(ids: List[str], profile: str,
                       seed: int = 0) -> Dict[Tuple[str, str], Dict]:
    """Pure seeded planner: map every directed link among ``ids`` to the
    knob dict it should run under ``profile``. Same (ids, profile, seed) →
    same plan, independent of any live net. ``wan`` and ``gray`` degrade
    every direction uniformly; ``asym`` picks — per unordered pair, from
    the planner RNG — ONE direction to degrade and leaves the reverse
    clean (absent from the plan). Every knob dict carries ``profile`` so
    live policies are attributable in stats and fingerprints."""
    if profile not in LINK_PROFILES:
        raise ValueError(
            f"unknown link profile {profile!r}; known: "
            f"{sorted(LINK_PROFILES)}")
    knobs = dict(LINK_PROFILES[profile], profile=profile)
    ids = sorted(ids)
    plan: Dict[Tuple[str, str], Dict] = {}
    rng = random.Random(zlib.crc32(f"linkplan|{profile}|{seed}".encode()))
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            if profile == "asym":
                src, dst = (a, b) if rng.random() < 0.5 else (b, a)
                plan[(src, dst)] = dict(knobs)
            else:
                plan[(a, b)] = dict(knobs)
                plan[(b, a)] = dict(knobs)
    return plan


def sparse_edges(ids: List[str], degree: int = 3,
                 seed: int = 0) -> List[Tuple[str, str]]:
    """Deterministic connected sparse graph over ``ids``: a ring (so the
    graph is connected by construction) plus seeded random chords until the
    average degree reaches ``degree``. Pure — same (ids, degree, seed) →
    same edge list — so an e2e runner and an in-proc chaos net derive the
    SAME persistent-peer graph. Returns sorted (a, b) pairs with a < b."""
    ids = sorted(ids)
    n = len(ids)
    if n < 2:
        return []
    edges: Set[Tuple[str, str]] = set()
    for i in range(n):  # the ring
        a, b = ids[i], ids[(i + 1) % n]
        if a != b:
            edges.add((min(a, b), max(a, b)))
    want = min(n * max(2, degree) // 2, n * (n - 1) // 2)
    rng = random.Random(zlib.crc32(f"sparse|{seed}|{n}".encode()))
    attempts = 0
    while len(edges) < want and attempts < 20 * want:
        attempts += 1
        a, b = rng.sample(ids, 2)
        edges.add((min(a, b), max(a, b)))
    return sorted(edges)


class InProcPeer(Peer):
    """One side of a connected pair; sends enqueue into the remote's pump."""

    def __init__(self, peer_id: str, outbound: bool):
        super().__init__(peer_id, outbound)
        self._remote: Optional["InProcPeer"] = None
        self._recv_queue: "asyncio.Queue[Tuple[int, bytes]]" = asyncio.Queue(maxsize=10000)
        self._running = True
        self._pump_task: Optional[asyncio.Task] = None
        #: chaos policy for the direction this peer object sends in
        #: (owner → remote); None = the original zero-overhead path
        self.policy: Optional[LinkPolicy] = None

    def send(self, channel_id: int, msg: bytes) -> bool:
        return self.try_send(channel_id, msg)

    def try_send(self, channel_id: int, msg: bytes) -> bool:
        if not self._running or self._remote is None:
            return False
        pol = self.policy
        if pol is None and not faults.enabled:
            return self._deliver(channel_id, msg)
        # generic env-armed sites (TMTPU_FAULTS=net.drop@p / net.corrupt@p):
        # drops ride the same path as a policy drop; corruption tampers the
        # payload IN FLIGHT (a Byzantine wire) so the receiver's decode /
        # signature / merkle checks run against the flipped bits. The
        # lock-free armed() probes keep chaos runs arming only
        # storage/device sites off fire()'s lock on this per-message path
        if faults.armed("net.drop") and faults.fire("net.drop"):
            return True
        if faults.armed("net.corrupt"):
            msg = faults.mutate("net.corrupt", msg)
        if pol is None:
            return self._deliver(channel_id, msg)
        delays = pol.plan()
        if delays is None:
            return True  # dropped/blackholed: the wire gives no feedback
        ok = True
        for delay in delays:
            if delay <= 0.0:
                ok = self._deliver(channel_id, msg) and ok
            else:
                self._deliver_later(delay, channel_id, msg)
        return ok

    def _deliver(self, channel_id: int, msg: bytes) -> bool:
        try:
            self._remote._recv_queue.put_nowait((channel_id, msg))
            return True
        except asyncio.QueueFull:
            return False

    def _deliver_later(self, delay: float, channel_id: int, msg: bytes) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._deliver(channel_id, msg)  # no loop: deliver inline
            return

        def _fire():
            if self._running and self._remote is not None:
                self._deliver(channel_id, msg)

        loop.call_later(delay, _fire)

    def is_running(self) -> bool:
        return self._running

    async def stop(self) -> None:
        self._running = False
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass

    async def _pump(self, switch: Switch) -> None:
        """Deliver inbound messages into the owning switch."""
        while self._running:
            channel_id, msg = await self._recv_queue.get()
            await switch.dispatch(channel_id, self, msg)
            await asyncio.sleep(0)  # fairness under sustained load


class InProcNetwork:
    """Registry + wiring of in-proc switches (MakeConnectedSwitches analog)."""

    def __init__(self):
        self.switches: Dict[str, Switch] = {}
        #: directed links: (src node, dst node) -> the src-owned peer
        #: object whose try_send covers that direction
        self.links: Dict[Tuple[str, str], InProcPeer] = {}
        #: nodes that left ON PURPOSE (remove_node): excluded from
        #: reconnect_missing()/connect_all() until they re-join via
        #: add_node — a clean leave must not read as a link failure
        self.departed: Set[str] = set()

    def add_switch(self, switch: Switch) -> None:
        self.switches[switch.node_id] = switch
        self.departed.discard(switch.node_id)

    async def connect(self, id_a: str, id_b: str) -> None:
        """Create a bidirectional pair and register with both switches."""
        sw_a, sw_b = self.switches[id_a], self.switches[id_b]
        peer_of_b = InProcPeer(id_b, outbound=True)   # a's view of b
        peer_of_a = InProcPeer(id_a, outbound=False)  # b's view of a
        peer_of_b._remote = peer_of_a
        peer_of_a._remote = peer_of_b
        peer_of_b._pump_task = asyncio.create_task(peer_of_b._pump(sw_a))
        peer_of_a._pump_task = asyncio.create_task(peer_of_a._pump(sw_b))
        self.links[(id_a, id_b)] = peer_of_b
        self.links[(id_b, id_a)] = peer_of_a
        await sw_a.add_peer(peer_of_b)
        await sw_b.add_peer(peer_of_a)

    async def connect_all(self) -> None:
        ids = list(self.switches)
        for i, a in enumerate(ids):
            for b in ids[i + 1:]:
                await self.connect(a, b)

    async def connect_topology(self, topology: str = "full_mesh",
                               degree: int = 3, seed: int = 0) -> int:
        """Wire the registered switches per ``topology``: ``full_mesh``
        (every pair) or ``sparse`` (ring + seeded chords, ~``degree`` links
        per node — the persistent-peer graph shape a 32-node fleet actually
        runs, where gossip must relay multi-hop). Returns pairs wired."""
        if topology == "full_mesh":
            await self.connect_all()
            return len(self.links) // 2
        if topology != "sparse":
            raise ValueError(f"unknown topology {topology!r}")
        edges = sparse_edges(sorted(self.switches), degree=degree, seed=seed)
        for a, b in edges:
            if not self.connected(a, b):
                await self.connect(a, b)
        return len(edges)

    async def disconnect(self, id_a: str, id_b: str) -> None:
        """Sever the pair in both directions (perturbation support)."""
        sw_a, sw_b = self.switches[id_a], self.switches[id_b]
        pa = sw_a.peers.get(id_b)
        pb = sw_b.peers.get(id_a)
        self.links.pop((id_a, id_b), None)
        self.links.pop((id_b, id_a), None)
        if pa is not None:
            await sw_a.stop_peer_gracefully(pa)
        if pb is not None:
            await sw_b.stop_peer_gracefully(pb)

    # -- live membership -----------------------------------------------------

    async def add_node(self, switch: Switch,
                       connect_to: Optional[Iterable[str]] = None) -> None:
        """Register a switch at RUNTIME and wire it into the live net:
        connect to every current member (full-mesh entry) or, for sparse
        topologies / discovery entry, only to ``connect_to``. A previously
        departed id re-joining is un-marked. The switch should already be
        started (its reactors greet peers via add_peer)."""
        self.add_switch(switch)
        targets = (list(connect_to) if connect_to is not None
                   else [i for i in self.switches if i != switch.node_id])
        for other in targets:
            if other == switch.node_id or other not in self.switches:
                continue
            if not self.connected(other, switch.node_id):
                await self.connect(other, switch.node_id)

    async def remove_node(self, node_id: str) -> int:
        """Depart a node cleanly: sever every link it holds (both
        directions drained), drop its switch from the registry, and mark it
        departed so reconnect_missing()/connect_all() stop trying to
        re-wire it. LinkPolicy objects on SURVIVING links are untouched
        (their RNG streams keep replaying). Returns pairs severed. The
        caller still owns stopping the node's own switch/consensus."""
        pairs = sorted({tuple(sorted(k)) for k in self.links
                        if node_id in k})
        for id_a, id_b in pairs:
            if id_a in self.switches and id_b in self.switches:
                await self.disconnect(id_a, id_b)
            else:  # counterpart already gone: just drop the stale entries
                self.links.pop((id_a, id_b), None)
                self.links.pop((id_b, id_a), None)
        self.switches.pop(node_id, None)
        self.departed.add(node_id)
        return len(pairs)

    def connected(self, id_a: str, id_b: str) -> bool:
        """Both switches hold a live peer object for the other side."""
        return (id_b in self.switches[id_a].peers
                and id_a in self.switches[id_b].peers)

    async def reconnect_missing(self) -> int:
        """Re-establish any severed pair — the in-proc analog of persistent-
        peer redial. A corrupted message makes the receiver drop the link
        (stop_peer_for_error); without this, adversarial chaos runs bleed
        connectivity until the net partitions itself. Existing LinkPolicy
        objects (and their RNG streams) carry over to the fresh peers so a
        seeded chaos schedule survives reconnects — PER DIRECTION: an
        asymmetric pair (src→dst blocked, dst→src seeded-lossy) rewires
        with each direction keeping its own policy object, so a one-way
        partition survives a redial exactly as asymmetric. Intentionally-departed
        nodes (remove_node) are skipped — redialing them would make clean
        leave impossible and mask real link failures in chaos stats.
        Returns pairs rewired."""
        count = 0
        pairs = {tuple(sorted(k)) for k in self.links}
        for id_a, id_b in sorted(pairs):
            if id_a in self.departed or id_b in self.departed:
                continue
            if id_a not in self.switches or id_b not in self.switches:
                continue
            if self.connected(id_a, id_b):
                continue
            pol_ab = self.links.get((id_a, id_b))
            pol_ba = self.links.get((id_b, id_a))
            pol_ab = pol_ab.policy if pol_ab is not None else None
            pol_ba = pol_ba.policy if pol_ba is not None else None
            await self.disconnect(id_a, id_b)  # clear any half-open side
            await self.connect(id_a, id_b)
            self.links[(id_a, id_b)].policy = pol_ab
            self.links[(id_b, id_a)].policy = pol_ba
            count += 1
        return count

    # -- chaos controls ------------------------------------------------------

    def set_link_policy(self, src: str, dst: str, seed: int = 0,
                        **kw) -> LinkPolicy:
        """Attach a fresh seeded policy to the directed link src→dst."""
        peer = self.links[(src, dst)]
        peer.policy = LinkPolicy(src, dst, seed=seed, **kw)
        return peer.policy

    def set_loss(self, drop_p: float, seed: int = 0, **kw) -> None:
        """Seeded loss (plus any other policy knobs) on EVERY directed
        link. Per-link RNGs derive from (seed, src, dst), so the whole-net
        schedule replays exactly for a given seed."""
        for (src, dst) in list(self.links):
            self.set_link_policy(src, dst, seed=seed, drop_p=drop_p, **kw)

    def apply_link_plan(self, plan: Dict[Tuple[str, str], Dict],
                        seed: int = 0) -> int:
        """Attach a :func:`plan_link_profiles` plan to the live net: each
        planned directed link gets a fresh seeded policy with the planned
        knobs; directed links absent from the plan are left untouched
        (clean under ``asym``). Returns policies attached."""
        count = 0
        for (src, dst), kw in sorted(plan.items()):
            if (src, dst) in self.links:
                self.set_link_policy(src, dst, seed=seed, **kw)
                count += 1
        return count

    def apply_profile(self, profile: str, seed: int = 0) -> int:
        """Plan + apply a named profile over every current switch."""
        plan = plan_link_profiles(sorted(self.switches), profile, seed=seed)
        return self.apply_link_plan(plan, seed=seed)

    def clear_policies(self) -> None:
        for peer in self.links.values():
            peer.policy = None

    def partition(self, group_a: Iterable[str],
                  group_b: Optional[Iterable[str]] = None) -> None:
        """Blackhole every link crossing the cut (both directions).
        ``group_b`` defaults to all other switches. Existing policies on
        crossing links keep their seed/loss knobs and gain ``blocked``;
        links without a policy get a block-only one."""
        a: Set[str] = set(group_a)
        b: Set[str] = (set(group_b) if group_b is not None
                       else set(self.switches) - a)
        for (src, dst), peer in self.links.items():
            if (src in a and dst in b) or (src in b and dst in a):
                if peer.policy is None:
                    peer.policy = LinkPolicy(src, dst, blocked=True)
                else:
                    peer.policy.blocked = True

    def partition_oneway(self, src_group: Iterable[str],
                         dst_group: Optional[Iterable[str]] = None) -> int:
        """Blackhole ONLY the src→dst direction of links crossing the
        cut — the reverse direction keeps flowing, its policy object (and
        RNG stream) untouched. This is the asymmetric-connectivity regime
        TCP-based failure detectors misread: dst still hears from src but
        src gets no acks back. Returns directed links blocked."""
        a: Set[str] = set(src_group)
        b: Set[str] = (set(dst_group) if dst_group is not None
                       else set(self.switches) - a)
        count = 0
        for (src, dst), peer in self.links.items():
            if src in a and dst in b:
                if peer.policy is None:
                    peer.policy = LinkPolicy(src, dst, blocked=True)
                else:
                    peer.policy.blocked = True
                count += 1
        return count

    def heal(self, group_a: Optional[Iterable[str]] = None,
             group_b: Optional[Iterable[str]] = None) -> int:
        """Unblock partitioned links: every link by default, or — given
        ``group_a`` (and optionally ``group_b``) — only links crossing
        that cut, both directions. Healing only flips ``blocked`` flags;
        policy objects are NEVER replaced, so loss/delay knobs and RNG
        streams survive — a direction that was never blocked (one-way
        partition) is a no-op flip and its seeded schedule continues
        undisturbed. Returns directed links unblocked."""
        if group_a is None:
            sel = None
        else:
            a: Set[str] = set(group_a)
            b: Set[str] = (set(group_b) if group_b is not None
                           else set(self.switches) - a)
            sel = (a, b)
        count = 0
        for (src, dst), peer in self.links.items():
            if sel is not None:
                a, b = sel
                if not ((src in a and dst in b)
                        or (src in b and dst in a)):
                    continue
            if peer.policy is not None and peer.policy.blocked:
                peer.policy.blocked = False
                count += 1
        return count

    def chaos_stats(self) -> collections.Counter:
        """Aggregate per-link policy counters (dropped/duplicated/...)."""
        total: collections.Counter = collections.Counter()
        for peer in self.links.values():
            if peer.policy is not None:
                total.update(peer.policy.stats)
        return total

    async def stop(self) -> None:
        for sw in self.switches.values():
            await sw.stop()
