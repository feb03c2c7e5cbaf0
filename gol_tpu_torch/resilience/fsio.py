"""The injectable filesystem shim under durable-state writers.

The port's copy of ``gol_tpu/resilience/fsio.py``. Every byte the job
journal (serve/jobs.py) and the compaction snapshot (serve/compaction.py)
put on disk routes through ``write_all`` or ``write_stream``, and each
probes ``faults.on_fs_write`` first, so the fault plan's exhaustion knobs
(``enospc_after_bytes``, ``eio_every``, ``full_disk``) drive each writer
into ENOSPC/EIO deterministically. Disarmed, each probe is one ``None``
check.

``free_bytes`` is the disk-pressure watchdog's (resilience/diskguard.py)
one reading of the world: the real ``os.statvfs`` free bytes, unless the
plan pins a value (``disk_free_bytes=N`` / ``full_disk=1`` -> 0).

No clocks in this module: exhaustion is about bytes, not time.
"""

from __future__ import annotations

import os

from gol_tpu_torch.resilience import faults


def write_all(fd: int, data, site: str) -> None:
    """Write ``data`` to ``fd`` completely (``os.write`` may return short —
    large records, ENOSPC mid-way). The fault probe fires ONCE per logical
    record, before the first byte: a journal record either wholly precedes
    the injected exhaustion or wholly fails."""
    faults.on_fs_write(len(data), site)
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def write_stream(f, data, site: str) -> None:
    """``f.write(data)`` behind the probe — the buffered-file counterpart
    of ``write_all`` for the staged-commit writers (the compaction
    snapshot)."""
    faults.on_fs_write(len(data), site)
    f.write(data)


def free_bytes(path: str) -> int:
    """Free bytes available on ``path``'s filesystem (or the fault plan's
    pinned value). ``f_bavail`` — the unprivileged view — because the
    reserved-root blocks are exactly the ones this process cannot use."""
    pinned = faults.fs_free_bytes()
    if pinned is not None:
        return pinned
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


__all__ = ["free_bytes", "write_all", "write_stream"]
