"""Crash-point injection (reference libs/fail/fail.go): the commit path is
sprinkled with ``fail_point()`` calls; setting ``TMTPU_FAIL_INDEX=N`` kills
the process at the Nth point reached, so crash-consistency tests can murder
a node at every interesting boundary (reference sites:
state/execution.go:149,156,188,196, consensus/state.go:776).

Three trigger forms:

* index — ``TMTPU_FAIL_INDEX=N``: die at the Nth fail point reached,
  whichever it is (the crash-matrix sweep);
* named — ``TMTPU_FAIL_POINT=<site>``: die the first time the point with
  that name is reached (``fail_point("consensus.commit.before_end_height")``),
  so a test can target one boundary without counting its way there;
* in-proc — ``arm_raise(<site>)``: the first reach of that named point
  raises :class:`KilledAtFailPoint` (a BaseException, so defensive
  ``except Exception`` blocks can't swallow it) instead of exiting, and
  the arming is consumed. This is how in-proc fleets (tools/crashmatrix.py)
  SIGKILL one node of a shared-process net: the victim's task dies at the
  boundary while the survivors' tasks keep running; the rig then freezes
  the victim's fds (dup2 → /dev/null, discarding unflushed buffers exactly
  like a real SIGKILL would) and rebuilds it from its home dir.

The counter is lock-protected: fail points sit on the consensus loop AND
on apply-plane worker threads, and a racy double-increment would make the
crash matrix skip boundaries. Test fixtures call :func:`reset` so
counters (and in-proc armings) don't leak between tests (see
tests/conftest.py).

For non-fatal, probabilistic, seeded injection see libs/faults.py — this
module is only the kill switch.
"""

from __future__ import annotations

import contextvars
import os
import sys
import threading
from typing import Optional

#: in-proc kill scoping: a rig sets ``scope.set("victim")`` around the
#: victim's task creation (asyncio tasks inherit the creating context), so
#: an armed boundary in SHARED code (execution, commit) kills only the
#: victim's tasks while survivors sharing the process sail past it.
#: Default None = unscoped; arm_raise(scope_token=None) fires everywhere.
scope: contextvars.ContextVar = contextvars.ContextVar(
    "tmtpu_fail_scope", default=None)

#: every named fail point production code actually reaches — the durability
#: boundary catalog tools/crashmatrix.py enumerates and e2e manifests
#: validate ``fail_point =`` against (a typo'd name never fires and the
#: crash cell passes vacuously, so arming validates against this).
KNOWN_FAIL_POINTS = frozenset({
    "execution.before_exec_block",       # state/execution.py (execution.go:149)
    "execution.after_state_save",        # state/execution.py (execution.go:196)
    "consensus.commit.before_end_height",  # consensus/state.py (state.go:776)
    "wal.before_fsync",                  # consensus/wal.py: record appended+
                                         # flushed, durability not yet claimed
    "wal.after_fsync",                   # consensus/wal.py: records durable,
                                         # nothing has acted on them yet
    "wal.mid_group_commit",              # consensus/wal.py: >=1 record of a
                                         # group appended, batch flush pending
    "db.mid_window_flush",               # libs/db.py SQLiteDB.write_batch:
                                         # batch staged in the txn, not committed
    "privval.between_sign_and_save",     # privval/file_pv.py: signature
                                         # computed, last-sign-state not saved
    "statesync.mid_chunk_apply",         # statesync/syncer.py: >=1 chunk
                                         # applied, restore incomplete
    "prune.mid_blocks",                  # store/block_store.py: prune deletes
                                         # enumerated, batch not applied
})

_counter = 0
_lock = threading.Lock()
_armed_raise: Optional[str] = None
_armed_scope: Optional[str] = None
_killed_at: Optional[str] = None


class KilledAtFailPoint(BaseException):
    """In-proc process death at a fail point. BaseException on purpose: a
    real SIGKILL doesn't ask the victim's ``except Exception`` blocks for
    permission, so the simulated one must not either."""

    def __init__(self, site: str):
        super().__init__(f"killed at fail point {site!r}")
        self.site = site


def fail_index() -> int:
    v = os.environ.get("TMTPU_FAIL_INDEX")
    return int(v) if v else -1


def fail_point(name: Optional[str] = None) -> None:
    """(fail.go Fail) exit(1) when the configured index — or, for named
    points, the configured TMTPU_FAIL_POINT site — is reached; raise
    KilledAtFailPoint when the point was armed in-proc via arm_raise."""
    global _counter, _armed_raise, _killed_at
    if _armed_raise is not None and name is not None:
        fire = False
        with _lock:
            if _armed_raise == name and (
                    _armed_scope is None or scope.get() == _armed_scope):
                _armed_raise = None  # one-shot: the restarted victim, same
                _killed_at = name    # process, must not re-die here
                fire = True
        if fire:
            raise KilledAtFailPoint(name)
    named = os.environ.get("TMTPU_FAIL_POINT")
    if named and name is not None and named == name:
        _die(f"named fail point {name!r} reached")
    idx = fail_index()
    if idx < 0:
        return
    with _lock:
        hit = _counter == idx
        _counter += 1
    if hit:
        _die(f"fail point {idx} reached")


def arm_raise(name: str, scope_token: Optional[str] = None) -> None:
    """Arm ONE named point to raise KilledAtFailPoint at its next reach
    (one-shot; replaces any previous arming). In-proc analog of
    TMTPU_FAIL_POINT for fleets sharing a process. ``scope_token`` limits
    the kill to tasks whose ``fail.scope`` contextvar equals it — how a
    rig kills ONE node of a shared-process fleet at a boundary that sits
    in code every node runs."""
    global _armed_raise, _armed_scope, _killed_at
    with _lock:
        _armed_raise = name
        _armed_scope = scope_token
        _killed_at = None


def killed_at() -> Optional[str]:
    """The site the last arm_raise kill fired at (None = hasn't fired)."""
    with _lock:
        return _killed_at


def armed() -> Optional[str]:
    with _lock:
        return _armed_raise


def _die(why: str) -> None:
    sys.stderr.write(f"*** {why}: exiting ***\n")
    sys.stderr.flush()
    os._exit(1)


def reset() -> None:
    global _counter, _armed_raise, _armed_scope, _killed_at
    with _lock:
        _counter = 0
        _armed_raise = None
        _armed_scope = None
        _killed_at = None


def counter() -> int:
    with _lock:
        return _counter
