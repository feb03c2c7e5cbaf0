"""SIGKILL-safe flock leases: the control plane's single-writer primitives.

The port's copy of ``gol_tpu/fleet/lease.py`` (JAX-free; the port imports
nothing of the JAX package), the lock under the journal compactor
(``serve/compaction.py``).

The journal compactor proved the discipline this module extracts: an advisory
``fcntl.flock`` on a well-known file is the ONE mutual-exclusion primitive
in the tree that a SIGKILL cannot wedge — the kernel drops the lock with
the holder's last fd, no unlock code ever runs, and any survivor acquires
it on its next attempt. No heartbeats, no TTLs, no fencing tokens to
mint: the lock *is* the liveness check. (Contrast the reference's
``mpirun`` world, where the launcher is the lone coordinator and its death
is everyone's death — here coordination is a file on the fleet dir that
any replica can pick up.)

Two shapes, one rule each:

- :func:`acquire` / :func:`release` — a bounded critical *section* (a
  manifest write, a compaction pass). Blocking acquire serializes writers
  that must ALL complete; non-blocking lets the loser skip work that the
  winner's pass already covers.
- :class:`FlockLease` — a long-*held* leadership lease (the single-writer
  ticks: autoscaler, respawn supervision). ``try_acquire`` is idempotent
  and cheap enough to call every tick; holding is just keeping the fd
  open, and death — graceful or SIGKILL — is the release.

The lock file's CONTENT is observability only (holder pid + label for an
operator's ``cat``), never authority: authority is the kernel's lock
table. A reader must never parse the file to decide who leads — the file
outlives every holder, and a stale pid in it is normal, not a bug.

Clocks: none. This module has no timing at all — leases have no expiry
because the kernel's fd lifetime IS the expiry (any timing it ever grows
must be ``time.perf_counter``, never the wall clock).
"""

from __future__ import annotations

import fcntl
import logging
import os
import threading

logger = logging.getLogger(__name__)


def acquire(path: str, *, blocking: bool = False) -> int | None:
    """Open ``path`` (creating it) and take an exclusive flock on it.

    Returns the locked fd — pass it to :func:`release` when the critical
    section ends — or ``None`` when ``blocking=False`` and another process
    (or another fd in THIS process: flock is per-open-file, so two Fleet
    instances in one test conflict like two processes) holds the lock.
    ``blocking=True`` waits: use it only for short sections every writer
    must complete (the manifest write), never for skippable work."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        flags = fcntl.LOCK_EX if blocking else fcntl.LOCK_EX | fcntl.LOCK_NB
        fcntl.flock(fd, flags)
    except OSError:
        os.close(fd)
        return None
    return fd


def release(fd: int) -> None:
    """End the critical section: closing the fd releases the flock."""
    os.close(fd)


class FlockLease:
    """A held leadership lease over ``path``, safe to poll every tick.

    ``try_acquire()`` returns whether THIS object holds the lease after
    the call — True immediately when it already does (re-acquiring an
    flock this process holds would succeed trivially; the early return
    keeps the fd stable so release semantics stay obvious). A False
    answer means some other holder is alive *right now*; ask again next
    tick — when the holder dies, by any signal, the kernel frees the
    lock and the next asker wins.

    On winning, the holder stamps ``pid label`` into the file — the
    operator-facing trail ("which router leads?"), explicitly
    non-authoritative (see module docstring).
    """

    def __init__(self, path: str, label: str = ""):
        self.path = path
        self.label = label
        self._fd: int | None = None
        self._mu = threading.Lock()

    @property
    def held(self) -> bool:
        return self._fd is not None

    def try_acquire(self) -> bool:
        with self._mu:
            if self._fd is not None:
                return True
            fd = acquire(self.path, blocking=False)
            if fd is None:
                return False
            try:
                os.ftruncate(fd, 0)
                os.write(fd, f"{os.getpid()} {self.label}\n".encode("utf-8"))
            except OSError:
                pass  # the stamp is best-effort prose, never authority
            self._fd = fd
            logger.info("lease %s acquired (pid %d%s)", self.path,
                        os.getpid(), f", {self.label}" if self.label else "")
            return True

    def release(self) -> None:
        """Voluntary hand-off (drain/shutdown); crash release is the
        kernel's job and needs no call."""
        with self._mu:
            if self._fd is not None:
                release(self._fd)
                self._fd = None
                logger.info("lease %s released", self.path)
