"""Block-sync ("fast sync") reactor — channel 0x40
(reference blockchain/v0/reactor.go:51; pool routine at :255).

Batch-first difference from the reference: the reference verifies ONE commit per
pool-routine iteration (VerifyCommitLight of block N against N+1's
LastCommit, one scalar ed25519 verify per signature). Here a contiguous
window of downloaded blocks is verified as ONE device batch
(types.validator_set.verify_commit_light_batched) whenever the window shares
a validator set (header.validators_hash equality — the hash commits to the
full set), which is the common case; heights where the set changes fall back
to per-block verification. This is baseline config #5 (10k-block replay at
1000 validators).

The apply plane is a 2-deep stage pipeline:

    stage A (worker thread)   | window N:  hash blocks (part sets, block
                              | IDs), precompute both signature planes,
                              | batched light-verify
    stage B (event loop)      | window N-1: ABCI exec + per-window batched
                              | store writes

While window N-1 is in stage B, window N's stage A runs concurrently on the
executor (device dispatch and OpenSSL release the GIL, so the verify
round-trip hides under ABCI exec). The single ``_prepared`` slot is the
explicit backpressure bound: at most one window of lookahead, prepared
results are consumed in strict height order, and a prepared window is
discarded whenever the pool or validator set moved underneath it (redo,
valset change), so apply order and peer-punish semantics are identical to
the unpipelined loop.

Device faults (``device.is_device_fault``: the card or a kernel unusable,
a running kernel's fault, an armed ``device.*`` site) are never verdicts
about a peer's blocks. This departs from the JAX package's reactor, whose
device route re-verifies on its host:

* the window precompute falls back to the per-block path for malformed
  peer data only; the batch is built inside its ``try`` and verified
  outside it, so a device fault propagates;
* a device fault in stage A, inline or in the lookahead, is counted
  where it was raised (``crypto_device_errors_total``, plane ``light``:
  stage A's ``BatchVerifier``); nothing is redone, no peer is punished or
  struck, and the window's blocks stay in the pool (a lookahead fault
  leaves the window to be verified inline);
* the pool routine, which logs any other error and retries every 0.1 s
  forever, hands ``KernelUnavailable`` to ``on_fatal`` at once, and a
  fault of a running kernel after ``MAX_WINDOW_DEVICE_FAULTS``
  consecutive window faults; a window that applies resets the count;
* a device fault inside ``apply_block`` becomes ``FatalSyncError``, as
  every apply fault does; no peer is blamed.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..p2p import BLOCKCHAIN_CHANNEL
from ..p2p.base import ChannelDescriptor, Peer, Reactor
from ..state import BlockExecutor
from ..state.state import State
from ..store import BlockStore
from ..types.basic import BlockID
from ..types.block import Block
from ..crypto import phases
from ..crypto.batch import BatchVerifier, precomputed_verdicts
from ..device import KernelUnavailable, is_device_fault
from ..libs.faults import faults
from ..libs.metrics import BlocksyncMetrics, Registry
from ..libs.peerscore import PeerScoreboard
from ..libs.trace import tracer
from ..types.validator_set import verify_commit_light_batched
from .msgs import (
    BlockRequest,
    BlockResponse,
    NoBlockResponse,
    StatusRequest,
    StatusResponse,
    decode_msg,
    encode_msg,
)
from .pool import BlockPool

logger = logging.getLogger("tmtpu.blockchain")


class FatalSyncError(Exception):
    """A deterministic local fault during block application: the reference
    panics here (v0/reactor.go ApplyBlock err); we stop the sync loop and
    propagate so the node halts and restart replay reconciles."""


# verify/apply at most this many blocks per batch; bounds device batch size
# (10k validators x 64 blocks = 640k sigs would exceed one comfortable batch)
VERIFY_WINDOW = 16
# window precompute engages at/above this many candidate signatures (both
# planes); below it the per-block path is cheaper and compile-free
PRECOMPUTE_MIN_SIGS = 2048
POLL_INTERVAL = 0.01
STATUS_UPDATE_INTERVAL = 10.0
SWITCH_TO_CONSENSUS_INTERVAL = 1.0
# consecutive windows whose verification failed on the card before the
# pool routine gives up (the breaker's default failure threshold)
MAX_WINDOW_DEVICE_FAULTS = 3


@dataclass
class _PreparedWindow:
    """Stage-A output for one verify window, handed to the apply stage."""

    start_height: int
    vals_hash: bytes          # validator-set hash the window was gated on
    window: list              # [(block, peer_id)] — the pairs + commit carrier
    pairs: list               # [(blk, peer_id, next_blk, next_peer_id)]
    entries: list             # verify_commit_light_batched inputs
    results: list             # per-entry verdicts (None or exception)
    pre: Optional[dict] = field(default=None, repr=False)  # verdict memo


class BlockchainReactor(Reactor):
    def __init__(self, state: State, block_exec: BlockExecutor,
                 block_store: BlockStore, fast_sync: bool,
                 consensus_reactor=None, on_fatal=None):
        super().__init__("BLOCKCHAIN")
        self.initial_state = state
        self.state = state
        self.block_exec = block_exec
        self.store = block_store
        self.fast_sync = fast_sync
        self.consensus_reactor = consensus_reactor
        self.pool = BlockPool(max(self.store.height(), state.last_block_height) + 1)
        self._pool_task: Optional[asyncio.Task] = None
        # called with the exception on a fatal (deterministic) sync fault;
        # the node wires this to shut itself down (the reference panics)
        self.on_fatal = on_fatal
        self.synced = asyncio.Event()  # set on switch-to-consensus
        self.blocks_synced = 0
        # the pipeline's single lookahead slot (backpressure bound = 1)
        self._prepared: Optional[_PreparedWindow] = None
        # consecutive windows that failed on the card (module docstring)
        self.window_device_faults = 0
        # per-stage histograms + pipeline counters (libs/metrics.py
        # BlocksyncMetrics). The node rebinds this to its shared registry so
        # the series land on /metrics; standalone reactors (bench, tests)
        # keep this private set. bench.py derives the old stage_times
        # breakdown from the histogram sums via stage_breakdown().
        self.metrics = BlocksyncMetrics(Registry())
        # untrusted-provider scoring (libs/peerscore.py): a bad block is a
        # strike — exponential backoff keeps the offender out of the pool,
        # ban_threshold strikes disconnect it. Threshold 2 (not 1): over a
        # Byzantine wire a single tampered response may be the LINK lying,
        # not the peer; a repeat offender is disconnected either way.
        self.scoreboard = PeerScoreboard(
            ban_threshold=int(
                os.environ.get("TMTPU_BLOCKSYNC_BAN_THRESHOLD") or 2),
            seed=faults.seed, name="blocksync",
            # every ban path (bad_block, bad_encoding, unsolicited) counts;
            # node.py re-points this when it rebinds self.metrics
            bans_counter=self.metrics.peer_bans_total)

    def stage_breakdown(self) -> dict:
        """The bench-facing view of the stage metrics: cumulative seconds
        per stage + window counters — the same numbers the old stage_times
        dict accumulated, now derived from the metric set."""
        m = self.metrics
        return {
            "hash_s": m.stage_seconds.sum_value("hash"),
            "verify_s": m.stage_seconds.sum_value("verify"),
            "store_s": m.stage_seconds.sum_value("store"),
            "abci_s": m.stage_seconds.sum_value("exec"),
            "pipelined_windows": int(m.pipelined_windows_total.value()),
            "inline_windows": int(m.inline_windows_total.value()),
        }

    @staticmethod
    def exec_phase_breakdown(wall_t0: float, wall_t1: float) -> dict:
        """Phase decomposition of the EXEC plane over a wall-clock window:
        state/execution.py records one ``plane="exec"`` segment per applied
        block (validate=pack, tx execution=in-flight, commit+persist=fetch),
        so the same interval-union accounting that profiles the device
        verify plane decomposes block execution — bench's ``exec`` config
        reports the in-flight (execute) share vs validate/commit overhead.
        Stage A's verify-commit(H+1) runs concurrently with these segments;
        its time lives in ``stage_breakdown()`` verify_s, not here."""
        recs = [r for r in phases.recent_segments()
                if r.get("plane") == "exec"
                and wall_t0 <= r["t0"] and r["t_end"] <= wall_t1]
        return phases.phase_breakdown(recs, wall_t0, wall_t1)

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(BLOCKCHAIN_CHANNEL, priority=5,
                                  send_queue_capacity=1000,
                                  recv_message_capacity=10 * 1024 * 1024)]

    async def start(self) -> None:
        # idempotent: Switch.start() starts every registered reactor, and the
        # node/state-sync paths may call start again — two concurrent pool
        # routines would double-apply blocks
        if self.fast_sync:
            if self._pool_task is None:
                self._pool_task = asyncio.create_task(self._pool_routine())
                self._pool_task.add_done_callback(self._pool_done)
        else:
            self.synced.set()

    async def switch_to_fast_sync(self, state: State) -> None:
        """(reactor.go SwitchToFastSync) enter fast sync from a state-synced
        state: re-seed the pool at the bootstrapped height and start."""
        self.state = state
        self.fast_sync = True
        self.synced.clear()
        self._prepared = None  # any lookahead was for the old pool
        self.pool = BlockPool(state.last_block_height + 1)
        if self._pool_task is None:
            self._pool_task = asyncio.create_task(self._pool_routine())
            self._pool_task.add_done_callback(self._pool_done)

    def _pool_done(self, task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            logger.critical("block sync died: %s", exc)
            if self.on_fatal is not None:
                self.on_fatal(exc)

    async def stop(self) -> None:
        if self._pool_task is not None:
            self._pool_task.cancel()
            self._pool_task = None

    # -- peer lifecycle -----------------------------------------------------

    async def add_peer(self, peer: Peer) -> None:
        # advertise our range so the peer can sync from us (reactor.go AddPeer)
        peer.try_send(BLOCKCHAIN_CHANNEL, encode_msg(
            StatusResponse(self.store.height(), self.store.base())))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self.pool.remove_peer(peer.id)

    # -- inbound ------------------------------------------------------------

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        try:
            msg = decode_msg(msg_bytes)
        except Exception:
            # a garbled payload on the blocksync channel is a strike before
            # the switch drops the link — over a Byzantine wire the
            # scoreboard is how repeat offenders get recognized across
            # reconnects
            self.scoreboard.record_failure(peer.id, "bad_encoding")
            raise
        if isinstance(msg, BlockRequest):
            block = self.store.load_block(msg.height)
            if block is not None:
                # blocksync.bad_block (libs/faults.py): this node serves a
                # tampered block part/commit — the fetching victim's real
                # decode + commit-verification path must catch it and
                # strike/ban us via its scoreboard
                payload = faults.mutate("blocksync.bad_block",
                                        encode_msg(BlockResponse(block)))
                peer.try_send(BLOCKCHAIN_CHANNEL, payload)
            else:
                peer.try_send(BLOCKCHAIN_CHANNEL, encode_msg(NoBlockResponse(msg.height)))
        elif isinstance(msg, StatusRequest):
            peer.try_send(BLOCKCHAIN_CHANNEL, encode_msg(
                StatusResponse(self.store.height(), self.store.base())))
        elif isinstance(msg, StatusResponse):
            # a provider in backoff/ban stays out of the pool — the status
            # broadcast would otherwise re-admit it the moment we struck it
            if not (self.scoreboard.banned(peer.id)
                    or self.scoreboard.in_backoff(peer.id)):
                self.pool.set_peer_range(peer.id, msg.base, msg.height)
        elif isinstance(msg, BlockResponse):
            status = self.pool.add_block(peer.id, msg.block)
            if status == "unsolicited":
                # never requested from anyone: peer error, not a free
                # bandwidth vector (reference reactor treats it as such).
                # "stale" (timed-out/reassigned request arriving late) is an
                # honest slow peer and is silently dropped.
                logger.warning("unsolicited block h=%d from %s",
                               msg.block.header.height, peer.id)
                self.scoreboard.record_failure(peer.id, "unsolicited")
                if self.switch is not None:
                    await self.switch.stop_peer_for_error(
                        peer, f"unsolicited block at {msg.block.header.height}")
        elif isinstance(msg, NoBlockResponse):
            self.pool.no_block(peer.id, msg.height)

    # -- the sync loop (reactor.go:255 poolRoutine) --------------------------

    async def _pool_routine(self) -> None:
        last_status = 0.0
        last_switch_check = 0.0
        self.switch and self._broadcast_status_request()
        while True:
            try:
                now = time.monotonic()
                if now - last_status > STATUS_UPDATE_INTERVAL:
                    self._broadcast_status_request()
                    last_status = now
                for peer_id, height in self.pool.schedule_requests():
                    peer = self.switch.peers.get(peer_id) if self.switch else None
                    if peer is not None:
                        peer.try_send(BLOCKCHAIN_CHANNEL,
                                      encode_msg(BlockRequest(height)))
                await self._process_window()
                if now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL:
                    last_switch_check = now
                    if self.pool.is_caught_up():
                        logger.info("fast sync complete at height %d (%d blocks)",
                                    self.state.last_block_height, self.blocks_synced)
                        self._switch_to_consensus()
                        return
                await asyncio.sleep(POLL_INTERVAL)
            except asyncio.CancelledError:
                raise
            except FatalSyncError:
                logger.critical("fatal block-sync error; halting sync loop")
                raise
            except Exception as e:
                if is_device_fault(e):
                    self._on_window_device_fault(e)
                else:
                    logger.exception("pool routine error")
                await asyncio.sleep(0.1)

    def _on_window_device_fault(self, e: BaseException) -> None:
        """A window's verification failed on the card: retry it, or raise
        (to ``on_fatal``) for ``KernelUnavailable`` and after
        MAX_WINDOW_DEVICE_FAULTS consecutive faults."""
        self.window_device_faults += 1
        if (isinstance(e, KernelUnavailable)
                or self.window_device_faults >= MAX_WINDOW_DEVICE_FAULTS):
            logger.critical("block sync: the card failed %d window(s) in "
                            "a row (%s); halting sync loop",
                            self.window_device_faults, e)
            raise e
        logger.warning("block sync: window verification failed on the "
                       "card (%s); retrying (%d of %d)", e,
                       self.window_device_faults, MAX_WINDOW_DEVICE_FAULTS)

    def _broadcast_status_request(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(BLOCKCHAIN_CHANNEL, encode_msg(StatusRequest()))

    def _switch_to_consensus(self) -> None:
        self.synced.set()
        if self.consensus_reactor is not None:
            self.consensus_reactor.switch_to_consensus(self.state)

    async def _process_window(self) -> None:
        """Verify+apply a contiguous run of downloaded blocks, pipelined.

        Block N's canonical commit is block N+1's LastCommit, so a run of
        k+1 blocks yields k verifiable (block, commit) pairs. All pairs whose
        headers commit to the CURRENT validator set are verified as one
        device batch; the rest of the run waits for the state to advance.

        Steady state: the window was already verified by the previous
        iteration's prepare-ahead (stage A ran while the previous window
        applied); this iteration applies it and concurrently prepares the
        next one.
        """
        loop = asyncio.get_running_loop()
        prep = self._take_prepared()
        if prep is None:
            window = self.pool.peek_window(VERIFY_WINDOW + 1)
            if len(window) < 2:
                return
            cur_vals_hash = self.state.validators.hash()
            pairs = self._select_pairs(window, cur_vals_hash)
            if not pairs:
                # the very next block claims a different valset: its commit
                # can't be checked against our state -> bad block
                # (validate_block would reject it anyway); redo from here.
                first, first_peer = window[0]
                await self._punish(self.pool.redo(first.header.height),
                                   "block valset hash mismatch")
                return
            # off-loop: a cold kernel build or a big host batch inside
            # the loop would stall RPC/p2p liveness for the whole node
            # a device fault propagates: no verdict, the blocks stay in the
            # pool, and the pool routine decides on a retry
            prep = await loop.run_in_executor(
                None, self._stage_a, window, pairs, cur_vals_hash,
                self.state.last_validators, self.state.validators,
                self.state.chain_id)
            self.metrics.inline_windows_total.inc()
        else:
            self.metrics.pipelined_windows_total.inc()

        # 2-deep pipeline: kick off stage A for the NEXT window on a worker
        # thread before this window's apply starts. Snapshot the pre-apply
        # valset NOW — the prepared result is only consumed if the apply
        # leaves the set's membership unchanged (_take_prepared re-checks).
        next_task = None
        next_start = prep.start_height + len(prep.pairs)
        nwindow = self.pool.peek_from(next_start, VERIFY_WINDOW + 1)
        if len(nwindow) >= 2:
            npairs = self._select_pairs(nwindow, prep.vals_hash)
            if npairs:
                # prepared-ahead windows verify every block against the
                # CURRENT set: the run is gated on hash equality, so the
                # first block's signing set (its previous height's valset)
                # has identical membership and powers
                next_task = loop.run_in_executor(
                    None, self._stage_a, nwindow, npairs, prep.vals_hash,
                    self.state.validators, self.state.validators,
                    self.state.chain_id)
        elif next_start + 1 <= self.pool.max_peer_height():
            # download plane starved the lookahead: a peer advertises the
            # next window's pair (next_start and its commit carrier) but the
            # blocks weren't here when stage A wanted to start. Chain
            # exhaustion (end of sync) is NOT a stall.
            self.metrics.lookahead_stalls_total.inc()
        try:
            await self._apply_window(prep)
        except BaseException:
            # a failed window N aborts N+1 cleanly: nothing from the
            # lookahead may outlive the fault
            if next_task is not None:
                next_task.cancel()
            self._prepared = None
            raise
        self.window_device_faults = 0
        if next_task is not None:
            try:
                self._prepared = await next_task
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._prepared = None
                if is_device_fault(e):
                    if isinstance(e, KernelUnavailable):
                        raise
                    logger.warning("prepare-ahead failed on the card (%s); "
                                   "next window will re-verify inline", e)
                else:
                    logger.exception("prepare-ahead failed; next window "
                                     "will re-verify inline")

    def _take_prepared(self) -> Optional[_PreparedWindow]:
        """Consume the lookahead slot — only if the world it was computed
        against still holds: same next height, same validator-set hash, and
        the pool still holds the very same block objects (a redo swaps in
        re-downloads from other peers)."""
        prep, self._prepared = self._prepared, None
        if prep is None:
            return None
        if (prep.start_height != self.pool.height
                or prep.vals_hash != self.state.validators.hash()):
            self.metrics.stale_window_discards_total.inc()
            return None
        window = self.pool.peek_from(prep.start_height, len(prep.window))
        if len(window) < len(prep.window):
            self.metrics.stale_window_discards_total.inc()
            return None
        for (blk, peer_id), (pblk, ppeer_id) in zip(window, prep.window):
            if blk is not pblk or peer_id != ppeer_id:
                self.metrics.stale_window_discards_total.inc()
                return None
        return prep

    @staticmethod
    def _select_pairs(window, cur_vals_hash) -> List[Tuple[Block, str, Block, str]]:
        pairs: List[Tuple[Block, str, Block, str]] = []  # (blk, peer, next, npeer)
        for (blk, peer_id), (nxt, npeer_id) in zip(window, window[1:]):
            if blk.header.validators_hash != cur_vals_hash:
                break  # validator set changes mid-window: verify after advance
            pairs.append((blk, peer_id, nxt, npeer_id))
        return pairs

    # -- stage A: hash + verify (worker thread) -----------------------------

    def _stage_a(self, window, pairs, vals_hash, first_vals, vals,
                 chain_id) -> _PreparedWindow:
        """Everything that can run before the window's first ABCI call:
        part-set construction, block hashing, sign-bytes assembly, the
        dual-plane signature precompute, and the batched light verify. All
        results memoize on the immutable block/commit instances, so the
        apply stage re-derives none of it."""
        with tracer.span("verify_window", height=pairs[0][0].header.height,
                         n_blocks=len(pairs)):
            # height-tag the window's device segments: the seg_pack/
            # seg_dispatch/seg_fetch spans and phase records carry the
            # first height so trace tooling can line device-pipeline
            # occupancy up against the consensus stage timeline
            with phases.telemetry(height=pairs[0][0].header.height):
                return self._stage_a_inner(window, pairs, vals_hash,
                                           first_vals, vals, chain_id)

    def _stage_a_inner(self, window, pairs, vals_hash, first_vals, vals,
                       chain_id) -> _PreparedWindow:
        t0 = time.perf_counter()
        entries = []
        for blk, _p, nxt, _np in pairs:
            parts_header = blk.make_part_set().header()
            block_id = BlockID(blk.hash(), parts_header)
            entries.append((vals, chain_id, block_id, blk.header.height,
                            nxt.last_commit))
        t1 = time.perf_counter()

        # Pre-verify the window's OTHER signature plane in the same scope:
        # apply_block -> validate_block re-checks each block's LastCommit
        # with the full VerifyCommit predicate (state/validation.py:55,
        # reference state/validation.go:72). Verified one commit at a time
        # that is a full-dispatch-latency device call per block; batched
        # here, the apply loop's verify_commit hits precomputed verdicts and
        # the whole window costs one device round-trip for BOTH planes.
        pre = self._precompute_last_commit_verdicts(pairs, first_vals, vals,
                                                    chain_id)
        token = precomputed_verdicts.set(pre) if pre is not None else None
        try:
            results = verify_commit_light_batched(entries)
        finally:
            if token is not None:
                precomputed_verdicts.reset(token)
        t2 = time.perf_counter()
        self.metrics.stage_seconds.labels("hash").observe(t1 - t0)
        self.metrics.stage_seconds.labels("verify").observe(t2 - t1)
        return _PreparedWindow(
            start_height=pairs[0][0].header.height, vals_hash=vals_hash,
            window=window[:len(pairs) + 1], pairs=pairs, entries=entries,
            results=results, pre=pre)

    def _precompute_last_commit_verdicts(self, pairs, first_vals, vals,
                                         chain_id) -> "Optional[dict]":
        """(pk, sign_bytes, sig) -> verdict for every candidate signature the
        window will verify — the light entries above AND each block's
        LastCommit full-commit candidates. Returns None when the window's
        LastCommits span a validator-set change (the per-block fallback is
        correct there; _select_pairs already bounds pairs to one set for
        the light plane)."""
        try:
            batch = self._precompute_inner(pairs, first_vals, vals, chain_id)
        except Exception as e:
            # peer data is untrusted here (nothing has validated these
            # blocks yet): ANY malformed shape — last_commit=None, odd sig
            # sizes — falls back to the per-block path, whose per-entry
            # error handling turns bad blocks into pool.redo + punish
            # instead of wedging the pool routine
            logger.debug("window precompute skipped: %s", e)
            return None
        if batch is None:
            return None
        # outside the try: a device fault is no malformed data, and
        # propagates
        bv, keys = batch
        _, verdicts = bv.verify()
        return {t: bool(v) for t, v in zip(keys, verdicts)}

    def _precompute_inner(self, pairs, first_vals, vals, chain_id):
        """-> (BatchVerifier, keys) of the window's candidate signatures,
        or None where the per-block path is the right one."""
        first_h = pairs[0][0].header.height
        # small-net windows (few validators or a short tail) stay on the
        # per-block path: doubling a tiny batch buys nothing and must not
        # push it over the device-routing threshold (a cold kernel build in
        # a fresh node process would dwarf the verification itself)
        if any(hasattr(blk.last_commit, "agg_sig")
               or hasattr(nxt.last_commit, "agg_sig")
               for blk, _p, nxt, _np in pairs):
            # aggregated commits verify via one pairing in
            # verify_commit_light_batched, not an ed25519 device batch —
            # nothing to precompute here
            return None
        n_sigs = sum(len(blk.last_commit.signatures) if blk.last_commit else 0
                     for blk, _p, _n, _np in pairs) * 2
        if n_sigs < PRECOMPUTE_MIN_SIGS:
            return None
        bv = BatchVerifier(plane="light")
        keys: List[Tuple[bytes, bytes, bytes]] = []

        def _add(pub, msg, sig):
            bv.add(pub, msg, sig)
            keys.append((pub.bytes(), msg, sig))

        for blk, _p, nxt, _np in pairs:
            # block h's LastCommit was signed by the valset of h-1: the first
            # window block checks against the caller's first_vals (the live
            # last_validators when preparing inline; the current set when
            # preparing ahead, where the hash gate makes them equal), later
            # ones against the (stable) current set. A stale guess here can
            # only miss the memo and re-dispatch — never mis-verify.
            fv = first_vals if blk.header.height == first_h else vals
            lc = blk.last_commit
            if lc is not None and len(lc.signatures):
                if len(lc.signatures) != fv.size():
                    return None  # shape mismatch: let validate_block decide
                sb = lc.vote_sign_bytes_all(chain_id)
                for idx, cs in enumerate(lc.signatures):
                    if not cs.absent():
                        _add(fv.validators[idx].pub_key, sb[idx],
                             cs.signature)
            # the light plane of THIS window (nxt.last_commit rows) shares
            # the batch: one device call covers both planes. Candidate rule
            # MUST mirror verify_commit_light_batched (validator_set.py):
            # for_block sigs keyed by (pk, vote_sign_bytes_all row, sig) —
            # any divergence makes BatchVerifier miss the precomputed dict
            # and silently re-dispatch, not mis-verify (all-or-nothing hit)
            sbn = nxt.last_commit.vote_sign_bytes_all(chain_id)
            for idx, cs in enumerate(nxt.last_commit.signatures):
                if cs.for_block() and idx < vals.size():
                    _add(vals.validators[idx].pub_key, sbn[idx], cs.signature)
        if not keys:
            return None
        return bv, keys

    # -- stage B: apply (event loop, strict height order) -------------------

    async def _apply_window(self, prep: _PreparedWindow) -> None:
        with tracer.span("apply_window", height=prep.start_height,
                         n_blocks=len(prep.pairs)):
            await self._apply_window_inner(prep)

    async def _apply_window_inner(self, prep: _PreparedWindow) -> None:
        token = (precomputed_verdicts.set(prep.pre)
                 if prep.pre is not None else None)
        st = self.metrics.stage_seconds
        applied = 0
        t_flush = None
        try:
            # every write the window produces — block parts, commits, seen
            # commits, ABCI responses, per-height validator/param records,
            # the state record — lands in ONE write-batch per store, flushed
            # at scope exit (also on error: staged writes describe blocks
            # whose ABCI commit already happened)
            with self.store.window_batch(), \
                    self.block_exec.state_store.window_batch():
                for (blk, peer_id, nxt, npeer_id), err, entry in zip(
                        prep.pairs, prep.results, prep.entries):
                    if err is not None:
                        logger.warning("invalid block/commit at height %d: %s",
                                       blk.header.height, err)
                        bad = self.pool.redo(blk.header.height)
                        bad.update({peer_id, npeer_id})
                        await self._punish(
                            bad, f"bad block at {blk.header.height}: {err}")
                        return
                    _vs, _chain, block_id, _h, _commit = entry
                    t0 = time.perf_counter()
                    parts = blk.make_part_set()
                    self.store.save_block(blk, parts, nxt.last_commit)
                    t1 = time.perf_counter()
                    # a commit-verified block that fails to apply is a
                    # deterministic local fault (bad app or corrupt state),
                    # not a peer fault
                    try:
                        self.state, _retain = self.block_exec.apply_block(
                            self.state, block_id, blk)
                    except Exception as e:
                        raise FatalSyncError(
                            f"apply_block failed at {blk.header.height}: {e}"
                        ) from e
                    t2 = time.perf_counter()
                    st.labels("store").observe(t1 - t0)
                    st.labels("exec").observe(t2 - t1)
                    self.pool.pop()
                    self.blocks_synced += 1
                    applied += 1
                t_flush = time.perf_counter()
        finally:
            if t_flush is not None:
                # the batched per-window DB flush is store-stage time too
                st.labels("store").observe(time.perf_counter() - t_flush)
            if applied:
                self.metrics.window_blocks.observe(applied)
            if token is not None:
                precomputed_verdicts.reset(token)

    async def _punish(self, peer_ids, reason: str) -> None:
        """Strike every suspected provider on the scoreboard; disconnect
        only those the scoreboard bans (ban_threshold strikes). First
        offenders sit out an exponential backoff instead — pool.redo
        already dropped them, and the backoff check in StatusResponse
        handling keeps them out until it lapses."""
        self.metrics.sync_retries_total.inc()  # the redo behind this punish
        for pid in set(peer_ids):
            if self.scoreboard.banned(pid):
                continue  # already banned (and disconnected) earlier
            if not self.scoreboard.record_failure(pid, "bad_block"):
                logger.info("block provider %s struck (%s); backing off",
                            pid[:8], reason)
                continue
            # (the scoreboard's bans_counter already counted the ban)
            if self.switch is not None:
                peer = self.switch.peers.get(pid)
                if peer is not None:
                    await self.switch.stop_peer_for_error(peer, reason)
        # re-discover remaining providers right away: the redo emptied the
        # pool's view of the offenders and sync should not idle a full
        # STATUS_UPDATE_INTERVAL before asking who else can serve
        self._broadcast_status_request()
