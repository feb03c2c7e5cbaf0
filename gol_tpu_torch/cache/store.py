"""The cache's storage tiers: bounded in-process LRU + on-disk CAS.

The port's copy of ``gol_tpu/cache/store.py``: the same directory layout,
meta JSON and packed sidecars, so a CAS written by either package reads in
the other (test-pinned).

``MemoryLRU`` answers the hot set in O(1) per lookup and dies with the
process. ``DiskCAS`` is the durable tier: one content-addressed file per
fingerprint, committed with the staging discipline (temp file in the final
directory + fsync + ``os.replace``), so a crash mid-write leaves either no
entry or a whole one, never a torn file that parses. Reads are CRC-gated
over the *decoded cells*: an entry whose payload fails its checksum — disk
corruption, a torn foreign write, a digest collision — is evicted loudly
and the caller re-runs the engine. The CAS is an accelerator, never a
source of truth: every entry is reconstructible by re-running the (pure)
simulation, so eviction is always safe and recovery is never required.

Payload encodings (the meta JSON is always the commit point):

- ``packed`` (the default): the grid's wire frame (``io/wire.py``) in a
  ``.golp`` sidecar beside the meta, committed with the same staging
  discipline. ~8x smaller than text at any width, and a packed wire hit
  serves its payload words WITHOUT a decode→re-encode round trip.
  Big-endian hosts fall back to ``text`` loudly.
- ``text``: the grid rides inside the meta file in the text-grid encoding
  — the same bytes the journal stores. Always readable regardless of the
  configured payload.
- ``ts``: exact-fit payloads whose width packs (W % 32 == 0) write their
  bitpacked words to a zarr store beside the meta (``io/ts_store.py``, the
  JAX package's TensorStore lane without TensorStore). Anything the lane
  cannot take (an unpackable width) falls back to ``text`` loudly.

On read the payload lane is chosen by the ENTRY's meta, not the store's
configured payload, and the CRC gate covers every encoding identically
(over the decoded answer, so a poisoned payload evicts regardless of how
it was stored).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

from gol_tpu_torch.io import text_grid
from gol_tpu_torch.resilience import STAGING_SUFFIX, fsio

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
_META_SUFFIX = ".json"
_STORE_SUFFIX = ".zarr"
_PACKED_SUFFIX = ".golp"


@dataclasses.dataclass
class CacheEntry:
    """One cached answer (mirrors the engine's per-board result)."""

    grid: np.ndarray  # uint8 {0,1}, (height, width)
    generations: int
    exit_reason: str
    # The grid's packed wire words (io/wire.py row layout) when a lane had
    # them in hand — a packed engine readback on put, the packed sidecar
    # on get. Serving a packed wire response from this entry then skips
    # the re-pack. Never part of the canonical identity below: ``grid``
    # is the answer, words are a cached encoding of it.
    words: np.ndarray | None = None

    def canonical_bytes(self) -> bytes:
        """The whole decoded answer, canonically: row-major uint8 cell
        bytes plus the scalar fields. The CRC gate covers ALL of it — a
        poisoned ``generations`` or ``exit_reason`` is as wrong an answer
        as a poisoned cell."""
        scalars = f"|{int(self.generations)}|{self.exit_reason}".encode()
        return (
            np.ascontiguousarray(self.grid, dtype=np.uint8).tobytes()
            + scalars
        )


class MemoryLRU:
    """Bounded thread-safe LRU of fingerprint -> CacheEntry.

    ``max_bytes`` adds a grid-byte budget on top of the entry count (the
    tile memo's bound — 8192 entries of 256^2 tiles is half a GB, so an
    entry count alone is not a memory bound when entries are big); None
    keeps the entries-only behavior byte-for-byte."""

    def __init__(self, max_entries: int = 1024, max_bytes: int | None = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.evictions = 0
        self._bytes = 0
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[str, CacheEntry] = (
            collections.OrderedDict()
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def grid_bytes(self) -> int:
        """Resident grid payload bytes (the budget ``max_bytes`` caps)."""
        with self._lock:
            return self._bytes

    def get(self, fp: str) -> CacheEntry | None:
        with self._lock:
            entry = self._entries.get(fp)
            if entry is not None:
                self._entries.move_to_end(fp)
            return entry

    def put(self, fp: str, entry: CacheEntry) -> None:
        with self._lock:
            old = self._entries.get(fp)
            if old is not None:
                self._bytes -= old.grid.nbytes
            self._entries[fp] = entry
            self._entries.move_to_end(fp)
            self._bytes += entry.grid.nbytes
            while len(self._entries) > self.max_entries or (
                self.max_bytes is not None
                and self._bytes > self.max_bytes
                and len(self._entries) > 1
            ):
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.grid.nbytes
                self.evictions += 1

    def pop(self, fp: str) -> None:
        with self._lock:
            entry = self._entries.pop(fp, None)
            if entry is not None:
                self._bytes -= entry.grid.nbytes


class DiskCAS:
    """Content-addressed on-disk store: one entry per fingerprint.

    Layout: ``<dir>/<fp[:2]>/<fp>.json`` (+ ``<fp>.zarr`` on the ts lane).
    Writes are idempotent by construction — the same fingerprint always
    encodes the same bytes, so concurrent/repeated puts race harmlessly to
    identical content. ``on_evict(fp, reason)`` fires when a read finds a
    torn/corrupt/mismatched entry (the caller's loud-evict counter).
    """

    def __init__(self, directory: str, payload: str = "packed", on_evict=None,
                 max_bytes: int | None = None, on_gc_evict=None,
                 clock=time.perf_counter):
        if payload not in ("packed", "text", "ts"):
            raise ValueError(
                f"payload must be 'packed', 'text' or 'ts', got {payload!r}"
            )
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.directory = directory
        self.payload = payload
        self.on_evict = on_evict
        # The byte budget (gol serve --cache-disk-bytes) + the atime-LRU
        # ledger behind it: perf_counter stamps per fingerprint, taken on
        # every get/put (the clock is injectable; the wall clock is banned
        # from this package). None = the unbounded tier.
        self.max_bytes = max_bytes
        self.on_gc_evict = on_gc_evict  # (fp, bytes) per budget eviction
        self._clock = clock
        self._access: dict[str, float] = {}
        # Reentrant: a put-triggered GC pass holds it end to end (one pass
        # at a time) while its per-entry removals re-enter for the ledger.
        self._gc_lock = threading.RLock()
        self._usage: int | None = None  # lazy: first enforcement scans once
        os.makedirs(directory, exist_ok=True)

    # -- paths --------------------------------------------------------------

    def _subdir(self, fp: str) -> str:
        return os.path.join(self.directory, fp[:2])

    def meta_path(self, fp: str) -> str:
        return os.path.join(self._subdir(fp), fp + _META_SUFFIX)

    def store_path(self, fp: str) -> str:
        return os.path.join(self._subdir(fp), fp + _STORE_SUFFIX)

    def packed_path(self, fp: str) -> str:
        return os.path.join(self._subdir(fp), fp + _PACKED_SUFFIX)

    # -- writes -------------------------------------------------------------

    def put(self, fp: str, entry: CacheEntry) -> None:
        """Write one entry durably; the meta JSON commit is the atomic step
        (a crash mid-payload leaves no meta — invisible garbage, exactly
        the checkpoint manifests' write-ahead rule)."""
        height, width = (int(x) for x in entry.grid.shape)
        meta = {
            "schema": SCHEMA_VERSION,
            "fingerprint": fp,
            "generations": int(entry.generations),
            "exit_reason": str(entry.exit_reason),
            "height": height,
            "width": width,
            "crc": zlib.crc32(entry.canonical_bytes()),
        }
        subdir = self._subdir(fp)
        os.makedirs(subdir, exist_ok=True)
        if self.payload == "packed" and sys.byteorder == "little":
            try:
                self._write_packed(fp, entry)
                meta["payload"] = "packed"
            except Exception as err:  # noqa: BLE001 - degrade, never fail
                logger.warning(
                    "cache CAS: packed payload for %s failed (%s: %s); "
                    "falling back to text", fp, type(err).__name__, err,
                )
        if self.payload == "ts" and width % 32 == 0 \
                and sys.byteorder == "little":
            try:
                self._write_ts(fp, entry, width)
                meta["payload"] = "ts"
            except Exception as err:  # noqa: BLE001 - optional lane
                logger.warning(
                    "cache CAS: zarr payload for %s failed (%s: %s); "
                    "falling back to text", fp, type(err).__name__, err,
                )
        if "payload" not in meta:
            meta["payload"] = "text"
            meta["grid"] = text_grid.encode(entry.grid).decode("ascii")
        fd, tmp = tempfile.mkstemp(
            dir=subdir, prefix=fp + ".", suffix=STAGING_SUFFIX
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                fsio.write_stream(
                    f, json.dumps(meta, separators=(",", ":")) + "\n",
                    "cache CAS meta",
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.meta_path(fp))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._note_put(fp)

    def _write_packed(self, fp: str, entry: CacheEntry) -> None:
        """The packed sidecar: one wire frame (io/wire.py), staged +
        fsynced + renamed like every durable file in the tree. The meta
        JSON written after it stays the commit point — a crash between
        the two leaves an invisible orphan sidecar, overwritten by the
        next idempotent put."""
        from gol_tpu_torch.io import wire

        height, width = (int(x) for x in entry.grid.shape)
        if entry.words is not None:
            frame = wire.encode_frame(
                {}, words=entry.words, width=width, height=height
            )
        else:
            frame = wire.encode_frame({}, grid=entry.grid)
        subdir = self._subdir(fp)
        fd, tmp = tempfile.mkstemp(
            dir=subdir, prefix=fp + ".", suffix=STAGING_SUFFIX
        )
        try:
            with os.fdopen(fd, "wb") as f:
                fsio.write_stream(f, frame, "cache CAS payload")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.packed_path(fp))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _read_packed(self, fp: str, width: int, height: int):
        """(grid, words) from the packed sidecar; any defect raises (the
        caller's evict-and-re-run gate)."""
        from gol_tpu_torch.io import wire

        with open(self.packed_path(fp), "rb") as f:
            frame = wire.decode_frame(f.read())
        if (frame.width, frame.height) != (width, height):
            raise ValueError(
                f"packed payload geometry {frame.height}x{frame.width} "
                f"does not match meta {height}x{width}"
            )
        return frame.grid(), frame.words

    def _write_ts(self, fp: str, entry: CacheEntry, width: int) -> None:
        import torch

        from gol_tpu_torch.io import bitpack, ts_store

        words = bitpack.pack_words(
            np.ascontiguousarray(entry.grid, dtype=np.uint8)
        )
        ts_store.write_words(self.store_path(fp),
                             torch.from_numpy(words.view(np.int32)), width)

    def _read_ts(self, fp: str, width: int, height: int) -> np.ndarray:
        from gol_tpu_torch.io import bitpack, ts_store

        words = ts_store.read_words(self.store_path(fp), width, height)
        return np.ascontiguousarray(
            bitpack.unpack_words(words.numpy().view(np.uint32), width))

    # -- reads --------------------------------------------------------------

    def get(self, fp: str) -> CacheEntry | None:
        """Read + verify one entry; any defect evicts it loudly and answers
        None (the engine re-runs — correctness never rests on the cache)."""
        path = self.meta_path(fp)
        try:
            with open(path, "r", encoding="utf-8") as f:
                meta = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as err:
            self._evict(fp, f"unreadable meta ({type(err).__name__}: {err})")
            return None
        try:
            if meta["schema"] != SCHEMA_VERSION:
                raise ValueError(f"schema {meta['schema']}")
            if meta["fingerprint"] != fp:
                raise ValueError(
                    f"fingerprint mismatch (stored {meta['fingerprint']!r})"
                )
            width, height = int(meta["width"]), int(meta["height"])
            words = None
            if meta["payload"] == "packed":
                grid, words = self._read_packed(fp, width, height)
            elif meta["payload"] == "ts":
                grid = self._read_ts(fp, width, height)
            else:
                grid = text_grid.decode(
                    meta["grid"].encode("ascii"), width, height
                )
            if grid.shape != (height, width):
                raise ValueError(f"payload shape {grid.shape}")
            entry = CacheEntry(
                grid=grid,
                generations=int(meta["generations"]),
                exit_reason=str(meta["exit_reason"]),
                words=words,
            )
            if zlib.crc32(entry.canonical_bytes()) != int(meta["crc"]):
                raise ValueError("payload CRC mismatch")
        except Exception as err:  # noqa: BLE001 - every defect = evict+rerun
            self._evict(fp, f"{type(err).__name__}: {err}")
            return None
        with self._gc_lock:
            self._access[fp] = self._clock()  # the atime-LRU ledger
        return entry

    # -- the byte budget (cache/gc.py) --------------------------------------

    def access_ledger(self) -> dict[str, float]:
        """Fingerprint -> perf_counter last-access stamps (a copy)."""
        with self._gc_lock:
            return dict(self._access)

    def usage_bytes(self) -> int:
        """The store's on-disk footprint (entries + garbage), scanned once
        and tracked incrementally across puts — the ``cas_bytes`` gauge."""
        from gol_tpu_torch.cache import gc as cas_gc

        with self._gc_lock:
            if self._usage is None:
                entries, _mtimes, orphans = cas_gc.scan(self.directory)
                self._usage = (sum(entries.values())
                               + sum(b for _p, b in orphans))
            return self._usage

    def _entry_bytes(self, fp: str) -> int:
        total = 0
        for path in (self.meta_path(fp), self.packed_path(fp)):
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        store = self.store_path(fp)
        if os.path.isdir(store):
            for root, _dirs, names in os.walk(store):
                for name in names:
                    try:
                        total += os.path.getsize(os.path.join(root, name))
                    except OSError:
                        pass
        return total

    def _note_put(self, fp: str) -> None:
        """Post-commit accounting: stamp the ledger, bump the running
        usage (a re-put of an existing entry overcounts here — harmless,
        the next GC scan recomputes exactly), enforce the budget."""
        with self._gc_lock:
            self._access[fp] = self._clock()
            if self._usage is not None:
                self._usage += self._entry_bytes(fp)
        if self.max_bytes is not None:
            over = self.usage_bytes() > self.max_bytes
            if over:
                self.gc(apply=True)

    def gc(self, budget: int | None = -1, apply: bool = False):
        """One GC pass over this store (cache/gc.collect): sweep orphans,
        evict LRU entries to ``budget`` bytes (-1: the store's own
        ``max_bytes``). Returns the GCReport; ``apply=False`` is dry-run."""
        from gol_tpu_torch.cache import gc as cas_gc

        if budget == -1:
            budget = self.max_bytes
        with self._gc_lock:
            report = cas_gc.collect(
                self.directory, budget, access=self.access_ledger(),
                apply=apply, remove_entry=self.remove,
                on_evict=self.on_gc_evict,
            )
            if apply:
                self._usage = report.bytes_after
                for fp in report.evicted:
                    self._access.pop(fp, None)
        return report

    def remove(self, fp: str) -> None:
        """Delete one entry (eviction, not corruption): meta first — the
        single unlink that makes it invisible — then payloads; leftovers
        of a crash in between are orphans the next sweep collects."""
        from gol_tpu_torch.cache import gc as cas_gc

        cas_gc._remove_entry(self.directory, fp)
        with self._gc_lock:
            self._access.pop(fp, None)

    def _evict(self, fp: str, reason: str) -> None:
        logger.warning(
            "cache CAS: evicting corrupt entry %s (%s); the engine re-runs "
            "— a poisoned cache entry can never be served", fp, reason,
        )
        for path in (self.meta_path(fp), self.packed_path(fp)):
            try:
                os.unlink(path)
            except OSError:
                pass
        store = self.store_path(fp)
        if os.path.isdir(store):
            import shutil

            shutil.rmtree(store, ignore_errors=True)
        with self._gc_lock:
            self._access.pop(fp, None)
            self._usage = None  # rare: let the next enforcement rescan
        if self.on_evict is not None:
            self.on_evict(fp, reason)
