"""The tiered consult: memory LRU -> disk CAS, with obs counters.

The port's copy of ``gol_tpu/cache/tiered.py`` (it differs in its imports).

``ResultCache`` is what the scheduler holds: one ``get`` walks the tiers
(promoting disk hits into memory), one ``put`` feeds both. Every outcome
rides the serving metrics registry so hit ratios merge fleet-wide exactly
like any other serving series:

- ``cache_hits_total`` (+ ``cache_hits_total_memory`` / ``_disk`` — the
  tier label) and ``cache_hit_bytes_total``;
- ``cache_misses_total``;
- ``cache_inflight_coalesced_total`` (fed by the scheduler's dedup);
- ``cache_stored_bytes_total``, ``cache_corrupt_evictions_total``,
  ``cache_store_errors_total``.

A failing CAS write or read NEVER raises into the serving path: the cost
of any cache defect is a log line, a counter, and a re-run.
"""

from __future__ import annotations

import logging

from gol_tpu_torch.cache.store import CacheEntry, DiskCAS, MemoryLRU

logger = logging.getLogger(__name__)


class ResultCache:
    """Tiered fingerprint -> result cache (memory LRU over optional CAS)."""

    def __init__(
        self,
        memory_entries: int = 1024,
        cas_dir: str | None = None,
        metrics=None,
        payload: str = "packed",
        disk_bytes: int | None = None,
        guard=None,
    ):
        self.memory = MemoryLRU(memory_entries)
        self.metrics = metrics
        # The disk-pressure watchdog (resilience/diskguard.DiskGuard) or
        # None: under pressure the disk tier stops taking WRITES — the
        # memory tier and every read keep working, and recovery is
        # automatic when the guard's level clears.
        self.guard = guard
        self.cas = (
            DiskCAS(cas_dir, payload=payload, on_evict=self._on_evict,
                    max_bytes=disk_bytes, on_gc_evict=self._on_gc_evict)
            if cas_dir else None
        )

    def _inc(self, name: str, amount: float = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, amount)

    def _on_evict(self, fp: str, reason: str) -> None:
        self._inc("cache_corrupt_evictions_total")

    def _on_gc_evict(self, fp: str, nbytes: int) -> None:
        self._inc("cache_gc_evictions_total")
        self._inc("cache_gc_evicted_bytes_total", nbytes)

    def get(self, fp: str) -> tuple[CacheEntry, str] | None:
        """(entry, tier) on a hit — tier is ``memory`` or ``disk`` — else
        None (counted as a miss)."""
        entry = self.memory.get(fp)
        if entry is not None:
            self._hit(entry, "memory")
            return entry, "memory"
        if self.cas is not None:
            try:
                entry = self.cas.get(fp)
            except OSError as err:
                # Disk trouble on the read path degrades to a miss.
                logger.warning("cache CAS read failed for %s: %s: %s",
                               fp, type(err).__name__, err)
                entry = None
            if entry is not None:
                self.memory.put(fp, entry)  # promote: the hot set is hot
                self._hit(entry, "disk")
                return entry, "disk"
        self._inc("cache_misses_total")
        return None

    def _hit(self, entry: CacheEntry, tier: str) -> None:
        self._inc("cache_hits_total")
        self._inc("cache_hits_total_" + tier)
        self._inc("cache_hit_bytes_total", entry.grid.nbytes)

    def put(self, fp: str, entry: CacheEntry) -> None:
        """Feed both tiers; CAS failure is loud but non-fatal (ENOSPC on
        the cache volume must not fail jobs whose results are in hand).
        Under disk pressure (the watchdog's first degradation tier) the
        CAS write is SHED preemptively — the cache is the most
        re-creatable durable state on the partition, so it yields its
        bytes to the journal first."""
        self.memory.put(fp, entry)
        if self.cas is not None:
            if self.guard is not None and not self.guard.allow_cas_writes():
                self._inc("cas_writes_shed_total")
                return
            try:
                self.cas.put(fp, entry)
            except OSError as err:
                self._inc("cache_store_errors_total")
                logger.warning(
                    "cache CAS write failed for %s (results still served "
                    "from memory): %s: %s", fp, type(err).__name__, err,
                )
                return
        self._inc("cache_stored_bytes_total", entry.grid.nbytes)
