"""Journal segmentation + snapshot compaction: bounded durable queue state.

The port's copy of ``gol_tpu/serve/compaction.py``: the same files, names,
CRC and trailer, so either package compacts and replays the other's
journal directories.

The job journal is append-only forever — correct, and unbounded: a
long-running partition accretes every submit record (a full board each) and
every terminal record (a full grid each) it ever served, until the disk
ends the service. This module bounds it without touching the append path's
crash contract:

- **Segments**: the live journal (``journal.jsonl``, one ``O_APPEND`` fd,
  unchanged) rotates at a byte threshold into sealed, immutable
  ``journal-<seq>.jsonl`` files (the obs/history ring's staging
  discipline: numbering never reuses an index, so "oldest" stays
  well-defined across restarts AND across compactions — ``next_index``
  reads the snapshot's high-water mark too).
- **Snapshot**: ``compact()`` folds the sealed segments into one
  CRC-stamped ``snapshot.jsonl`` of *live state*: the submit records of
  still-pending jobs plus the terminal records (done/failed/cancelled
  tombstones) — everything replay needs, with the dead weight (submit
  records of finished jobs, superseded duplicates) gone. The snapshot is
  record-for-record the journal's own vocabulary, so replay applies it
  with the same parser it applies segments with.
- **Retirement**: only after the new snapshot commits (staged + fsync +
  ``os.replace`` — the tree's one atomic step) are the folded segments
  deleted. Replay = snapshot + segments newer than it + the live journal.

SIGKILL-safe at every boundary, by construction:

- killed mid-snapshot-write: the staged temp is invisible (staging
  suffix); the old snapshot + all segments are untouched. Retried next
  tick.
- killed between commit and retirement: the new snapshot AND the folded
  segments coexist; replay skips segments ``seq <= covers`` (they are a
  prefix of the snapshot), and the next compaction deletes them.
- a torn/corrupt snapshot (external damage — the commit is atomic) fails
  its CRC/trailer check and is ignored loudly; segments were never
  deleted before a snapshot covering them committed, so full-log replay
  still stands.

Everything here works on RAW record dicts — no ``Job`` objects — so the
state fold is exactly the replay parser's semantics at the record level,
and the module stays import-light (``serve/jobs.py`` imports it, not the
other way around).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import tempfile
import zlib

from gol_tpu_torch.fleet import lease
from gol_tpu_torch.resilience import STAGING_SUFFIX, faults, fsio

logger = logging.getLogger(__name__)

ACTIVE_FILENAME = "journal.jsonl"
SNAPSHOT_FILENAME = "snapshot.jsonl"
LOCK_FILENAME = "compaction.lock"
# Rotate the live journal past this many bytes (gol serve
# --journal-segment-bytes; 0/None disables rotation — the single-file layout).
DEFAULT_SEGMENT_BYTES = 8 << 20

_SEGMENT_RE = re.compile(r"journal-(\d{8})\.jsonl$")
_HEADER_EVENT = "snapshot_header"
_COMMIT_EVENT = "snapshot_commit"
_VERSION = 1

# Journal events that terminate a job (tombstones the snapshot retains).
_TERMINAL_EVENTS = ("done", "failed", "cancelled")


def segment_name(index: int) -> str:
    return f"journal-{index:08d}.jsonl"


def sealed_segments(directory: str) -> list[tuple[int, str]]:
    """(seq, path) for every sealed segment, oldest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _SEGMENT_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def snapshot_covers(directory: str) -> int:
    """The snapshot's segment high-water mark from its HEADER line alone
    (no CRC pass, no record parse — the seq-minting path must not scale
    with history). -1 when absent or unreadable. Over-reading is harmless
    (a skipped seq number); under-reading is impossible for a committed
    snapshot because ``os.replace`` makes header and body one atomic
    unit."""
    try:
        with open(snapshot_path(directory), "rb") as f:
            header = json.loads(f.readline().decode("utf-8"))
        if header.get("event") == _HEADER_EVENT:
            return int(header["covers"])
    except (OSError, ValueError, KeyError, UnicodeDecodeError):
        pass
    return -1


def next_index(directory: str) -> int:
    """The next segment seq: past every sealed segment on disk AND past the
    snapshot's high-water mark — a rotation right after a compaction that
    retired every segment must not mint a seq replay would skip as
    already-folded."""
    segs = sealed_segments(directory)
    high = segs[-1][0] if segs else -1
    return max(high, snapshot_covers(directory)) + 1


def journal_bytes(directory: str) -> int:
    """Total durable journal footprint: snapshot + sealed segments + the
    live journal (the ``journal_bytes`` gauge)."""
    paths = [os.path.join(directory, ACTIVE_FILENAME),
             os.path.join(directory, SNAPSHOT_FILENAME)]
    paths.extend(p for _seq, p in sealed_segments(directory))
    total = 0
    for p in paths:
        try:
            total += os.path.getsize(p)
        except OSError:
            pass
    return total


@dataclasses.dataclass
class Snapshot:
    """A validated snapshot: the records to apply before any segment."""

    covers: int  # every segment with seq <= covers is folded in
    records: list[dict]


@dataclasses.dataclass
class CompactionReport:
    """What one ``compact()`` call did."""

    compacted: bool  # a new snapshot was committed
    covers: int  # the snapshot's segment high-water mark (-1: none)
    segments_retired: int  # sealed segment files deleted
    records_kept: int  # records in the (new or existing) snapshot
    terminal_dropped: int  # tombstones dropped by the retention window
    bytes_before: int
    bytes_after: int
    torn_lines: int  # unparseable lines encountered in the fold


def snapshot_path(directory: str) -> str:
    return os.path.join(directory, SNAPSHOT_FILENAME)


def read_snapshot(directory: str) -> Snapshot | None:
    """The committed snapshot, fully validated (header + record lines +
    CRC-stamped trailer), or None — missing is silent, a torn/corrupt one
    warns loudly and is IGNORED (replay falls back to the segments, which
    are never deleted before a valid snapshot covers them)."""
    path = snapshot_path(directory)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    except OSError as err:
        logger.warning("journal snapshot %s unreadable (%s); ignoring it",
                       path, err)
        return None
    try:
        if raw.endswith(b"\n"):
            body_end = raw.rfind(b"\n", 0, len(raw) - 1) + 1
        else:
            body_end = raw.rfind(b"\n") + 1
        trailer = json.loads(raw[body_end:].decode("utf-8"))
        if trailer.get("event") != _COMMIT_EVENT:
            raise ValueError("missing commit trailer")
        if int(trailer["crc"]) != zlib.crc32(raw[:body_end]):
            raise ValueError("snapshot CRC mismatch")
        lines = [ln for ln in raw[:body_end].split(b"\n") if ln]
        header = json.loads(lines[0].decode("utf-8"))
        if header.get("event") != _HEADER_EVENT:
            raise ValueError("missing snapshot header")
        if header.get("version") != _VERSION:
            raise ValueError(f"unknown snapshot version {header.get('version')}")
        records = [json.loads(ln.decode("utf-8")) for ln in lines[1:]]
        if len(records) != int(trailer["records"]):
            raise ValueError(
                f"record count {len(records)} != trailer {trailer['records']}")
        return Snapshot(covers=int(header["covers"]), records=records)
    except (ValueError, KeyError, IndexError, UnicodeDecodeError) as err:
        logger.warning(
            "journal snapshot %s is torn/corrupt (%s: %s); ignoring it — "
            "the uncompacted segments replay instead and the next "
            "compaction rewrites it", path, type(err).__name__, err)
        return None


def write_snapshot(directory: str, covers: int, records: list[dict]) -> str:
    """Commit a snapshot atomically (staged + fsync + ``os.replace``).
    The ``snapshot`` fault boundary fires with the temp fully staged but
    the commit not yet done — the window where a kill must cost nothing."""
    header = json.dumps(
        {"event": _HEADER_EVENT, "version": _VERSION, "covers": int(covers)},
        separators=(",", ":"),
    ).encode("utf-8") + b"\n"
    body = b"".join(
        json.dumps(rec, separators=(",", ":")).encode("utf-8") + b"\n"
        for rec in records
    )
    trailer = json.dumps(
        {"event": _COMMIT_EVENT, "crc": zlib.crc32(header + body),
         "records": len(records)},
        separators=(",", ":"),
    ).encode("utf-8") + b"\n"
    fd, tmp = tempfile.mkstemp(dir=directory, prefix="snapshot.",
                               suffix=STAGING_SUFFIX)
    try:
        with os.fdopen(fd, "wb") as f:
            fsio.write_stream(f, header + body + trailer, "journal snapshot")
            f.flush()
            os.fsync(f.fileno())
        faults.on_compaction("snapshot")
        os.replace(tmp, snapshot_path(directory))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return snapshot_path(directory)


def _fold(records_iter, pending: dict, terminal: dict, torn: list) -> None:
    """Apply raw records to the fold state: ``pending`` maps id -> submit
    record, ``terminal`` maps id -> tombstone record (both insertion-
    ordered — the snapshot preserves arrival order). The semantics are the
    replay parser's, at the record level."""
    for rec in records_iter:
        try:
            event = rec["event"]
            if event == "submit":
                pending[rec["job"]["id"]] = rec
            elif event in _TERMINAL_EVENTS:
                terminal[rec["id"]] = rec
                pending.pop(rec["id"], None)
            elif event in (_HEADER_EVENT, _COMMIT_EVENT):
                pass  # structural lines never reach here, but be lenient
            else:
                raise ValueError(f"unknown event {event!r}")
        except (KeyError, TypeError, ValueError):
            torn[0] += 1


def _iter_lines(path: str, torn: list):
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            yield json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            torn[0] += 1


def iter_records(directory: str):
    """Every replay-visible record, in replay order: the committed
    snapshot's records, then sealed segments newer than it, then the live
    journal. The ONE enumeration exactly-once auditors must use — reading
    ``journal.jsonl`` alone misses everything rotation sealed and
    compaction folded. Unparseable lines are skipped (replay's leniency)."""
    snap = read_snapshot(directory)
    covers = -1
    if snap is not None:
        covers = snap.covers
        yield from snap.records
    torn = [0]
    paths = [p for seq, p in sealed_segments(directory) if seq > covers]
    paths.append(os.path.join(directory, ACTIVE_FILENAME))
    for path in paths:
        yield from _iter_lines(path, torn)


def compact(directory: str,
            retain_results: int | None = None) -> CompactionReport:
    """Fold every sealed segment into a fresh snapshot, then retire them.

    ``retain_results`` bounds the terminal tombstones the snapshot carries
    (the result-retention window): only the newest N survive compaction —
    a restarted server then answers 404 for results older than the window,
    the documented trade for a bounded journal. None (the default) retains
    every tombstone: replayed state is exactly full-log replay's.

    Touches ONLY sealed segments and the snapshot — the live journal (and
    whoever is appending to it) is never read, never locked, never moved —
    so an online server compacts concurrently with admission. Compactions
    themselves are mutually exclusive via an advisory ``flock`` on
    ``compaction.lock`` (auto-released on process death — SIGKILL-safe):
    two interleaved passes (an offline ``gol compact`` racing the live
    server's idle tick) could otherwise commit a STALE snapshot over a
    newer one whose folded segments are already deleted, losing their
    records. The loser skips and reports ``compacted=False``. (The flock
    discipline itself — open+LOCK_EX|LOCK_NB, close-releases, kernel
    drops it on SIGKILL — is the shared ``fleet/lease.py`` helper; the
    replicated control plane's manifest writes and leader lease ride the
    same primitive.)"""
    lock_fd = lease.acquire(os.path.join(directory, LOCK_FILENAME))
    if lock_fd is None:
        logger.warning(
            "journal compaction in %s skipped: another compaction "
            "holds the lock (a live server's tick, or a concurrent "
            "`gol compact`)", directory)
        bytes_now = journal_bytes(directory)
        return CompactionReport(
            compacted=False, covers=snapshot_covers(directory),
            segments_retired=0, records_kept=0, terminal_dropped=0,
            bytes_before=bytes_now, bytes_after=bytes_now,
            torn_lines=0,
        )
    try:
        return _compact_locked(directory, retain_results)
    finally:
        lease.release(lock_fd)  # closing releases the flock


def _compact_locked(directory: str,
                    retain_results: int | None) -> CompactionReport:
    before = journal_bytes(directory)
    snap = read_snapshot(directory)
    covered = snap.covers if snap is not None else -1
    segs = sealed_segments(directory)
    stale = [(seq, p) for seq, p in segs if seq <= covered]
    fold = [(seq, p) for seq, p in segs if seq > covered]
    torn = [0]
    if not fold:
        # Nothing new to fold; just sweep retirement leftovers from a
        # compaction killed between commit and delete.
        for _seq, p in stale:
            try:
                os.unlink(p)
            except OSError:
                pass
        return CompactionReport(
            compacted=False, covers=covered, segments_retired=len(stale),
            records_kept=len(snap.records) if snap else 0,
            terminal_dropped=0, bytes_before=before,
            bytes_after=journal_bytes(directory), torn_lines=0,
        )
    pending: dict[str, dict] = {}
    terminal: dict[str, dict] = {}
    if snap is not None:
        _fold(snap.records, pending, terminal, torn)
    for _seq, path in fold:
        _fold(_iter_lines(path, torn), pending, terminal, torn)
    dropped = 0
    tombstones = list(terminal.values())
    if retain_results is not None and len(tombstones) > retain_results:
        dropped = len(tombstones) - retain_results
        tombstones = tombstones[dropped:]
    records = tombstones + list(pending.values())
    covers = fold[-1][0]
    write_snapshot(directory, covers, records)
    # The commit landed: the folded (and any stale) segments are now a
    # strict prefix of the snapshot. The ``retire`` fault boundary fires
    # here — a kill leaves them coexisting, which replay handles by
    # skipping seq <= covers.
    faults.on_compaction("retire")
    retired = 0
    for _seq, path in fold + stale:
        try:
            os.unlink(path)
            retired += 1
        except OSError as err:
            logger.warning("compaction: could not retire %s: %s", path, err)
    if torn[0]:
        logger.warning(
            "journal compaction in %s: dropped %d unparseable line(s) "
            "(same leniency as replay)", directory, torn[0])
    return CompactionReport(
        compacted=True, covers=covers, segments_retired=retired,
        records_kept=len(records), terminal_dropped=dropped,
        bytes_before=before, bytes_after=journal_bytes(directory),
        torn_lines=torn[0],
    )


__all__ = [
    "ACTIVE_FILENAME", "CompactionReport", "DEFAULT_SEGMENT_BYTES",
    "LOCK_FILENAME", "SNAPSHOT_FILENAME", "Snapshot", "compact",
    "iter_records", "journal_bytes", "next_index", "read_snapshot",
    "sealed_segments", "segment_name", "snapshot_covers", "snapshot_path",
    "write_snapshot",
]
