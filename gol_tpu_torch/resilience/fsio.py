"""The injectable filesystem shim under durable-state writers.

The port's copy of ``gol_tpu/resilience/fsio.py``, so far its reading
half: the writers' helpers (``write_all``, ``write_stream``, which probe
``faults.on_fs_write``) come with the journal and the result cache, their
only callers.

``free_bytes`` is the disk-pressure watchdog's (resilience/diskguard.py)
one reading of the world: the real ``os.statvfs`` free bytes, unless the
plan pins a value (``disk_free_bytes=N`` / ``full_disk=1`` -> 0).

No clocks in this module: exhaustion is about bytes, not time.
"""

from __future__ import annotations

import os

from gol_tpu_torch.resilience import faults


def free_bytes(path: str) -> int:
    """Free bytes available on ``path``'s filesystem (or the fault plan's
    pinned value). ``f_bavail`` — the unprivileged view — because the
    reserved-root blocks are exactly the ones this process cannot use."""
    pinned = faults.fs_free_bytes()
    if pinned is not None:
        return pinned
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


__all__ = ["free_bytes"]
