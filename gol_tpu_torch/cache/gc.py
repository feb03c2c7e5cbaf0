"""CAS garbage collection: a byte budget for the disk tier.

The port's copy of ``gol_tpu/cache/gc.py`` (it differs in its imports):
the same scan, eviction order and report, so ``gc`` prints the same lines
over the same directory in either package (test-pinned).

Without it ``DiskCAS`` never deletes a healthy entry — correct for a cache
fed by a bounded workload, unbounded for a long-lived server. This module
closes that: ``scan`` walks the store into per-entry byte
sizes plus the garbage classes (orphaned payload sidecars whose meta never
committed, staging leftovers, foreign files), and ``collect`` brings the
store under a byte budget by deleting orphans first, then whole entries in
least-recently-used order.

**Eviction is always safe** because the CAS is a cache: the journal stays
the source of truth, every entry is reconstructible by re-running the
(pure) simulation, and a concurrent ``get`` of an evicted fingerprint is
just a miss. The only cost of any GC decision is a re-run.

**Recency** comes from the store's in-process access ledger — perf_counter
stamps taken on every get/put (``DiskCAS`` keeps them; the clock is
injectable, and the wall clock steps under NTP).
Entries never touched by THIS process (cold restarts) have no stamp and
evict first, ordered among themselves by file modification time — an
ordering-only fallback, never arithmetic against the process clock.

Deletion order inside one entry is meta FIRST (the commit point: the entry
becomes invisible in one unlink), payloads second — a crash mid-evict
leaves orphan sidecars, which are exactly what the next sweep's orphan
pass collects. The ``on_cas_evict`` fault probe sits in that window so the
SIGKILL matrix can prove it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil

from gol_tpu_torch.cache import store as cas_store
from gol_tpu_torch.resilience import STAGING_SUFFIX, faults

logger = logging.getLogger(__name__)

# Everything a committed entry may own, keyed off its fingerprint stem.
_ENTRY_SUFFIXES = (cas_store._META_SUFFIX, cas_store._PACKED_SUFFIX,
                   cas_store._STORE_SUFFIX)


@dataclasses.dataclass
class GCReport:
    """What one ``collect`` pass found (and, unless dry-run, did)."""

    dry_run: bool
    entries: int  # committed entries found
    bytes_total: int  # store footprint before (entries + garbage)
    bytes_after: int  # footprint after the pass (== bytes_total on dry-run)
    budget: int | None  # the byte budget enforced (None: orphans only)
    evicted: list  # fingerprints (to be) evicted, LRU first
    evicted_bytes: int
    orphans: list  # garbage paths (to be) removed
    orphan_bytes: int
    errors: int  # deletions that failed (logged)


def _path_size(path: str) -> int:
    try:
        if os.path.isdir(path):
            total = 0
            for root, _dirs, names in os.walk(path):
                for name in names:
                    try:
                        total += os.path.getsize(os.path.join(root, name))
                    except OSError:
                        pass
            return total
        return os.path.getsize(path)
    except OSError:
        return 0


def scan(directory: str):
    """Walk the store: ``(entries, mtimes, orphans)`` where ``entries``
    maps fingerprint -> total bytes (meta + payloads), ``mtimes`` maps
    fingerprint -> the meta file's mtime (the cold-entry ordering
    fallback), and ``orphans`` lists (path, bytes) of garbage — payloads
    without a committed meta, staging leftovers, and files that are not
    the CAS's at all (a foreign write into the cache volume is garbage to
    the budget even if this pass only reports it)."""
    entries: dict[str, int] = {}
    mtimes: dict[str, float] = {}
    orphans: list[tuple[str, int]] = []
    try:
        subdirs = sorted(os.listdir(directory))
    except OSError:
        return entries, mtimes, orphans
    for sub in subdirs:
        subpath = os.path.join(directory, sub)
        if not os.path.isdir(subpath):
            orphans.append((subpath, _path_size(subpath)))
            continue
        try:
            names = sorted(os.listdir(subpath))
        except OSError:
            continue
        metas = {n[: -len(cas_store._META_SUFFIX)]
                 for n in names if n.endswith(cas_store._META_SUFFIX)}
        for name in names:
            path = os.path.join(subpath, name)
            size = _path_size(path)
            if name.endswith(STAGING_SUFFIX):
                orphans.append((path, size))
                continue
            stem = suffix = None
            for sfx in _ENTRY_SUFFIXES:
                if name.endswith(sfx):
                    stem, suffix = name[: -len(sfx)], sfx
                    break
            if stem is None or not stem.startswith(sub):
                # Not a CAS filename shape (or filed under the wrong
                # prefix shard): foreign garbage.
                orphans.append((path, size))
                continue
            if stem not in metas:
                # A payload whose meta never committed (crash between
                # sidecar write and commit) or whose meta was evicted
                # mid-crash: invisible garbage.
                orphans.append((path, size))
                continue
            entries[stem] = entries.get(stem, 0) + size
            if suffix == cas_store._META_SUFFIX:
                try:
                    mtimes[stem] = os.path.getmtime(path)
                except OSError:
                    mtimes[stem] = 0.0
    return entries, mtimes, orphans


def eviction_order(entries: dict[str, int], mtimes: dict[str, float],
                   access: dict[str, float]) -> list[str]:
    """Fingerprints least-recently-used first: entries with no in-process
    access stamp lead (ordered by meta mtime among themselves — the only
    recency signal a cold entry has), stamped entries follow by stamp."""
    return sorted(
        entries,
        key=lambda fp: ((1, access[fp]) if fp in access
                        else (0, mtimes.get(fp, 0.0))),
    )


def collect(directory: str, budget: int | None, *, access=None,
            apply: bool = False, remove_entry=None,
            on_evict=None) -> GCReport:
    """One GC pass: sweep garbage, then evict LRU entries until the store
    fits ``budget`` bytes (None: garbage sweep only). ``apply=False`` (the
    ``gol gc`` default) reports what WOULD happen and touches nothing.

    ``access`` is the store's fingerprint -> perf_counter ledger (absent
    entries evict first); ``remove_entry(fp)`` deletes one entry honoring
    the meta-first order (defaults to a local implementation when no
    ``DiskCAS`` is supplying its own); ``on_evict(fp, bytes)`` observes
    each eviction (the counter feed)."""
    entries, mtimes, orphans = scan(directory)
    total = sum(entries.values()) + sum(b for _p, b in orphans)
    orphan_bytes = sum(b for _p, b in orphans)
    errors = 0
    if apply:
        for path, _size in orphans:
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.unlink(path)
            except OSError as err:
                errors += 1
                logger.warning("cache GC: could not remove orphan %s: %s",
                               path, err)
    live = total - orphan_bytes
    evicted: list[str] = []
    evicted_bytes = 0
    if budget is not None:
        order = eviction_order(entries, mtimes, dict(access or {}))
        for fp in order:
            if live - evicted_bytes <= budget:
                break
            evicted.append(fp)
            evicted_bytes += entries[fp]
            if apply:
                if remove_entry is not None:
                    remove_entry(fp)
                else:
                    _remove_entry(directory, fp)
                if on_evict is not None:
                    on_evict(fp, entries[fp])
    after = total if not apply else (live - evicted_bytes)
    if apply and (orphans or evicted):
        logger.info(
            "cache GC in %s: removed %d orphan(s) (%d bytes), evicted %d "
            "entr(ies) (%d bytes); %d -> %d bytes%s",
            directory, len(orphans), orphan_bytes, len(evicted),
            evicted_bytes, total, after,
            f" (budget {budget})" if budget is not None else "")
    return GCReport(
        dry_run=not apply, entries=len(entries), bytes_total=total,
        bytes_after=after, budget=budget, evicted=evicted,
        evicted_bytes=evicted_bytes, orphans=[p for p, _b in orphans],
        orphan_bytes=orphan_bytes, errors=errors,
    )


def _remove_entry(directory: str, fp: str) -> None:
    """Delete one committed entry, meta FIRST (one unlink makes it
    invisible; leftovers are orphans the next sweep takes). The
    ``on_cas_evict`` fault boundary sits between the two phases."""
    subdir = os.path.join(directory, fp[:2])
    try:
        os.unlink(os.path.join(subdir, fp + cas_store._META_SUFFIX))
    except OSError:
        pass
    faults.on_cas_evict(fp)
    for sfx in (cas_store._PACKED_SUFFIX,):
        try:
            os.unlink(os.path.join(subdir, fp + sfx))
        except OSError:
            pass
    zarr = os.path.join(subdir, fp + cas_store._STORE_SUFFIX)
    if os.path.isdir(zarr):
        shutil.rmtree(zarr, ignore_errors=True)


__all__ = ["GCReport", "collect", "eviction_order", "scan"]
