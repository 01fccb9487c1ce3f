"""Consensus write-ahead log (reference consensus/wal.go:58).

Every consensus input is logged before it acts on the state machine; own
(internal) messages are fsynced. Framing mirrors the reference encoder
(wal.go:288): crc32(payload) u32 BE || length u32 BE || payload. Payload is a
JSON envelope {time_ns, type, data} — msg types: "vote", "proposal",
"block_part", "timeout", "end_height", "round_step" (EventDataRoundStep).
Size-rotated like libs/autofile.Group.

Group commit: ``with wal.group():`` defers the flush/fsync of every record
written inside to the context exit — one fsync covers the whole batch when
any record in it requires durability (own messages), so a proposal plus its
N block parts cost one disk sync instead of N+1. Record bytes and ordering
are identical to per-record writes; only the fsync schedule changes, and the
receive loop commits the group BEFORE acting on any message in it, which
preserves the reference rule that our own messages are durable before any
state transition can expose them to gossip (state.go:754,763).
"""

from __future__ import annotations

import contextlib
import errno
import json
import logging
import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..libs.fail import KilledAtFailPoint, fail_point
from ..libs.faults import faults
from ..libs.trace import tracer
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote

logger = logging.getLogger("tmtpu.wal")

MAX_MSG_SIZE_BYTES = 1024 * 1024  # 1MB (wal.go maxMsgSizeBytes)
DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # autofile group head rotation
DEFAULT_GROUP_LIMIT = 60 * 1024 * 1024

#: exit code for the fatal-fsync path (EX_IOERR from sysexits.h)
FSYNC_EXIT_CODE = 74


class FsyncError(BaseException):
    """A WAL fsync failed: durability of already-written records is
    UNKNOWN (fsyncgate: after a failed fsync the kernel may have dropped
    the dirty pages, and a later successful fsync proves nothing about
    them). BaseException on purpose — the consensus loop's defensive
    ``except Exception`` must not be able to swallow it and carry on
    treating the records as durable; like the reference's panic, the only
    safe continuation is a restart that replays the WAL from disk."""


def _injected_eio(site: str) -> OSError:
    return OSError(errno.EIO, f"injected fault at {site}")


@dataclass
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int  # RoundStep value


@dataclass
class EndHeightMessage:
    height: int


@dataclass
class WALMessage:
    time_ns: int
    type: str
    data: dict


def _encode_vote(v: Vote) -> dict:
    return {"vote": v.encode().hex()}


def _encode_msg(msg, peer_id: str) -> Tuple[str, dict]:
    from .state import BlockPartMessage, ProposalMessage, VoteMessage

    if isinstance(msg, VoteMessage):
        return "vote", {"vote": msg.vote.encode().hex(), "peer": peer_id}
    if isinstance(msg, ProposalMessage):
        return "proposal", {"proposal": msg.proposal.encode().hex(), "peer": peer_id}
    if isinstance(msg, BlockPartMessage):
        return "block_part", {"height": msg.height, "round": msg.round,
                              "part": msg.part.encode().hex(), "peer": peer_id}
    raise ValueError(f"unsupported WAL message {type(msg)}")


class WAL:
    # class-level defaults so no-op/partial subclasses (NilWAL) and
    # long-lived instances share the group-commit surface without each
    # __init__ having to know about it
    _group_depth = 0
    _group_records = 0
    _group_sync = False
    _last_sync_t = 0.0
    #: fsync-even-without-a-durable-record deadline for grouped batches of
    #: purely external records (the reference never syncs those at all; the
    #: deadline only bounds how far an async tail can lag)
    sync_deadline_s = 0.05
    #: ConsensusMetrics (wal_fsyncs_total / wal_records_per_fsync /
    #: wal_fsync_seconds), wired by the node
    metrics = None
    #: what to do when os.fsync raises (fsyncgate semantics — continuing
    #: would record messages as durable that may not be): "exit" kills the
    #: process (a node restart replays the WAL, the reference's panic
    #: analog); "raise" surfaces FsyncError for in-process harnesses.
    #: Env override TMTPU_FSYNC_ERROR_POLICY for subprocess nets.
    fsync_error_policy = os.environ.get("TMTPU_FSYNC_ERROR_POLICY", "exit")

    #: repair-on-open accounting (crash-recovery plane): how many torn
    #: tails this instance truncated at open, and how many bytes went
    repairs = 0
    repaired_bytes = 0

    def __init__(self, path: str, head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
                 repair: bool = True):
        self.path = path
        self._head_size_limit = head_size_limit
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # a crash can leave a torn/garbage tail; appending after it would
        # strand every new record behind undecodable bytes (CRC-bounded
        # replay stops at the first bad frame), so repair BEFORE opening
        # for append. repair=False for read-only observers (cmd debug) —
        # truncating a file a LIVE node holds open for append would corrupt
        # it under the owner's feet.
        self.repaired_bytes = self._repair_tail(path) if repair else 0
        self.repairs = 1 if self.repaired_bytes else 0
        self._f = open(path, "ab")
        self._records_since_sync = 0
        # fresh WAL: write #ENDHEIGHT 0 so height-1 catchup replay has its
        # start marker (reference consensus/wal.go BaseWAL.OnStart)
        if self._f.tell() == 0 and not os.path.exists(f"{path}.0"):
            self.write_sync("end_height", {"height": 0})

    @staticmethod
    def _decodable_prefix_len(raw: bytes) -> int:
        """Byte length of the longest valid-record prefix of `raw` (same
        validity rule as iter_messages: framing + CRC + JSON envelope)."""
        pos = 0
        while pos + 8 <= len(raw):
            crc, ln = struct.unpack_from(">II", raw, pos)
            if ln > MAX_MSG_SIZE_BYTES or pos + 8 + ln > len(raw):
                break
            payload = raw[pos + 8:pos + 8 + ln]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break
            try:
                json.loads(payload.decode())
            except (ValueError, UnicodeDecodeError):
                break
            pos += 8 + ln
        return pos

    def _repair_tail(self, path: str) -> int:
        """Truncate any undecodable suffix of the head file so appended
        records stay replayable; returns bytes removed (0 = clean)."""
        if not os.path.exists(path):
            return 0
        with open(path, "rb") as f:
            raw = f.read()
        good = self._decodable_prefix_len(raw)
        if good == len(raw):
            return 0
        torn = len(raw) - good
        logger.warning(
            "WAL %s: torn tail repaired at open — truncated %d undecodable "
            "byte(s) after %d good byte(s) (crash mid-append; records past "
            "the tear were never durable)", path, torn, good)
        os.truncate(path, good)
        return torn

    # -- writing -----------------------------------------------------------

    def _write_record(self, payload: bytes, sync: bool) -> None:
        if len(payload) > MAX_MSG_SIZE_BYTES:
            raise ValueError(f"msg is too big: {len(payload)} bytes, max: {MAX_MSG_SIZE_BYTES}")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        frame = struct.pack(">II", crc, len(payload)) + payload
        # torn-write seam at the byte-emit point: a fired site emits a
        # strictly partial frame (seeded prefix + optional garbage), the
        # on-disk shape a crash mid-append leaves — repair-on-open and
        # CRC-bounded replay are exercised against real partial data
        self._f.write(faults.tear("wal.torn_write", frame))
        self._records_since_sync += 1
        if self._group_depth:
            # group commit: the batch's single flush/fsync happens at the
            # group() exit; record bytes are already in the file buffer in
            # write order, so replay framing is identical either way
            if self._group_records:
                # >=1 record of this batch appended, flush still pending —
                # the mid-group-commit durability boundary
                fail_point("wal.mid_group_commit")
            self._group_records += 1
            self._group_sync = self._group_sync or sync
            return
        self._f.flush()
        if sync:
            self._fsync()
        self._maybe_rotate()

    def _fsync(self) -> None:
        n = self._records_since_sync
        # pre/post-fsync durability boundaries (crashmatrix): before, the
        # records are appended+flushed but their durability is unclaimed;
        # after, they are durable and nothing has acted on them yet
        fail_point("wal.before_fsync")
        with tracer.span("wal_fsync", n_records=n):
            t0 = time.perf_counter()
            try:
                faults.inject("wal.fsync", _injected_eio)
                os.fsync(self._f.fileno())
            except OSError as e:
                self._on_fsync_error(e)
            dt = time.perf_counter() - t0
        fail_point("wal.after_fsync")
        self._last_sync_t = time.monotonic()
        self._records_since_sync = 0
        m = self.metrics
        if m is not None:
            m.wal_fsyncs_total.inc()
            if n:  # flush_and_sync() with an already-durable tail observes
                # no batch — only real record batches feed the histogram
                m.wal_records_per_fsync.observe(n)
            m.wal_fsync_seconds.observe(dt)

    def _on_fsync_error(self, e: OSError) -> None:
        """Fatal by default: a record whose fsync failed must never be
        treated as durable, and fsync retry semantics are untrustworthy
        (fsyncgate) — so crash and let restart replay from disk."""
        m = self.metrics
        if m is not None:
            m.wal_fsync_errors_total.inc()
        logger.critical(
            "WAL fsync failed (%s): %d record(s) of unknown durability; "
            "%s per fsync_error_policy", e, self._records_since_sync,
            "exiting" if self.fsync_error_policy == "exit" else "raising")
        if self.fsync_error_policy == "raise":
            raise FsyncError(f"WAL fsync failed: {e}") from e
        os._exit(FSYNC_EXIT_CODE)

    @contextlib.contextmanager
    def group(self):
        """Group commit: records written inside are appended immediately but
        their flush/fsync is deferred to the context exit — ONE fsync when
        any record in the batch wants durability (own messages), else only
        when ``sync_deadline_s`` has passed since the last sync. Nested
        groups collapse into the outermost. The batch is committed even
        when the body raises: the records are already appended, and a torn
        tail is reconciled by CRC-bounded replay exactly like a torn single
        record. Exception: a simulated process death (KilledAtFailPoint —
        the crashmatrix in-proc kill) commits NOTHING on the way out — a
        dead process flushes no batch, and committing here would make the
        mid-group-commit durability boundary vacuously durable."""
        if self._group_depth:
            yield self
            return
        self._group_depth = 1
        self._group_records = 0
        self._group_sync = False
        try:
            yield self
        except KilledAtFailPoint:
            self._group_depth = 0
            raise
        finally:
            if self._group_depth:
                self._group_depth = 0
                if self._group_records:
                    self._f.flush()
                    if self._group_sync or (time.monotonic() - self._last_sync_t
                                            >= self.sync_deadline_s):
                        self._fsync()
                    self._maybe_rotate()

    def _maybe_rotate(self) -> None:
        if self._f.tell() > self._head_size_limit:
            # flushed-but-unsynced records must not rotate away: after the
            # rename, fsyncs hit the NEW fd only, so the deadline lag bound
            # (and the records_per_fsync accounting) would silently exclude
            # them. Rotation is per ~10MB — one extra fsync is noise.
            if self._records_since_sync:
                self._fsync()
            self._f.close()
            idx = 0
            while os.path.exists(f"{self.path}.{idx}"):
                idx += 1
            os.rename(self.path, f"{self.path}.{idx}")
            self._f = open(self.path, "ab")

    def _envelope(self, type_: str, data: dict, time_ns: int) -> bytes:
        return json.dumps({"time_ns": time_ns, "type": type_, "data": data},
                          separators=(",", ":")).encode()

    def write(self, type_: str, data: dict, time_ns: int = 0) -> None:
        self._write_record(self._envelope(type_, data, time_ns), sync=False)

    def write_sync(self, type_: str, data: dict, time_ns: int = 0) -> None:
        self._write_record(self._envelope(type_, data, time_ns), sync=True)

    def write_msg_info(self, msg, peer_id: str, time_ns: int, internal: bool) -> None:
        """msgInfo records; fsync for our own messages (state.go:754,763)."""
        type_, data = _encode_msg(msg, peer_id)
        if internal:
            self.write_sync(type_, data, time_ns)
        else:
            self.write(type_, data, time_ns)

    def write_timeout(self, ti: TimeoutInfo, time_ns: int) -> None:
        self.write("timeout", {"duration_s": ti.duration_s, "height": ti.height,
                               "round": ti.round, "step": int(ti.step)}, time_ns)

    def write_end_height(self, height: int, time_ns: int) -> None:
        self.write_sync("end_height", {"height": height}, time_ns)

    def write_round_step(self, height: int, round_: int, step: int, time_ns: int) -> None:
        self.write("round_step", {"height": height, "round": round_, "step": step}, time_ns)

    def flush_and_sync(self) -> None:
        self._f.flush()
        self._fsync()

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except ValueError:
            pass

    # -- reading -----------------------------------------------------------

    def _all_paths(self) -> List[str]:
        """Rotated files oldest-first, then the head."""
        idx = 0
        out = []
        while os.path.exists(f"{self.path}.{idx}"):
            out.append(f"{self.path}.{idx}")
            idx += 1
        if os.path.exists(self.path):
            out.append(self.path)
        return out

    def iter_messages(self) -> Iterator[WALMessage]:
        """All decodable messages; stops cleanly at a torn/corrupt tail
        (reference wal decoder DataCorruptionError tolerance)."""
        for path in self._all_paths():
            with open(path, "rb") as f:
                raw = f.read()
            pos = 0
            while pos + 8 <= len(raw):
                crc, ln = struct.unpack_from(">II", raw, pos)
                if ln > MAX_MSG_SIZE_BYTES or pos + 8 + ln > len(raw):
                    return  # torn write at tail
                payload = raw[pos + 8:pos + 8 + ln]
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    return  # corruption: stop replay here
                try:
                    d = json.loads(payload.decode())
                except (ValueError, UnicodeDecodeError):
                    return
                yield WALMessage(d.get("time_ns", 0), d["type"], d.get("data", {}))
                pos += 8 + ln

    def search_for_end_height(self, height: int) -> bool:
        """True if #ENDHEIGHT for `height` exists (wal.go:231) — meaning the
        block at `height` was fully committed and WAL replay should start
        after that record."""
        for m in self.iter_messages():
            if m.type == "end_height" and m.data.get("height") == height:
                return True
        return False

    def messages_after_end_height(self, height: int) -> List[WALMessage]:
        """Messages following the #ENDHEIGHT record for `height`."""
        out: List[WALMessage] = []
        found = False
        for m in self.iter_messages():
            if found:
                out.append(m)
            elif m.type == "end_height" and m.data.get("height") == height:
                found = True
        return out


class NilWAL(WAL):
    """No-op WAL for tests (consensus/wal.go:421 nilWAL)."""

    def __init__(self):  # noqa: super-init-not-called
        pass

    def _write_record(self, payload: bytes, sync: bool) -> None:
        pass

    def write(self, *a, **k) -> None:
        pass

    def write_sync(self, *a, **k) -> None:
        pass

    def write_msg_info(self, *a, **k) -> None:
        pass

    def write_timeout(self, *a, **k) -> None:
        pass

    def write_end_height(self, *a, **k) -> None:
        pass

    def write_round_step(self, *a, **k) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    def iter_messages(self):
        return iter(())
