"""Tile-result memoization: the result cache's CAS machinery keyed at tile
granularity.

The port's copy of ``gol_tpu/sparse/memo.py``: the same keys, entries and
obs counter names, so a memo directory written by either package reads in
the other.

A tile step is a pure function of its halo-extended block — convention,
generation limit, and similarity settings never reach it (they live in the
sparse host loop) — so its result is memoizable under a content key alone.
The key reuses the result cache's collision-hardened digest
(``cache/fingerprint.board_digest``: the checkpoint identity's positional
limb math + a CRC fold) over the ``(tile+2)^2`` block, scoped by a schema
tag and the tile size; the store reuses the result cache's tiers verbatim —
``cache.store.MemoryLRU`` and, when a directory is given, the CRC-verified
``DiskCAS`` (text payload: tiles are not always word-packable widths).

What this buys: repeated tile content — still-life blocks, repeated
pattern stamps, any two tiles anywhere on the board (or in any two jobs on
the same server) whose block bytes match — costs one digest + one dict
hit instead of a kernel dispatch. The flags ride the entry's
``generations`` field as a bit pack, so the CAS CRC gate covers them the
same way it covers the cells.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from gol_tpu_torch.cache.fingerprint import board_digest
from gol_tpu_torch.cache.store import CacheEntry, DiskCAS, MemoryLRU
from gol_tpu_torch.obs import registry as obs_registry

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1

# Flag bits packed into CacheEntry.generations (covered by the CAS CRC).
_ALIVE = 1
_CHANGED = 2

_EXIT_TAG = "tile"  # exit_reason marker: this entry is a tile step, not a job


@dataclasses.dataclass
class TileStep:
    """One memoized tile-step outcome."""

    interior: np.ndarray  # (tile, tile) uint8 — the next interior
    alive: bool
    changed: bool


# The memory tier's grid-byte budget: 8192 entries of 256^2-tile interiors
# would be half a GB resident, so the entry count alone is not a memory
# bound — the byte cap is what actually limits a worker's footprint under
# sustained varied sparse traffic (128 MiB holds ~2048 production tiles).
DEFAULT_MEMO_BYTES = 128 << 20


class TileMemo:
    """Tiered block-digest -> next-interior store (memory LRU over an
    optional on-disk CAS). Misses/hits feed the process obs registry
    (``sparse_memo_hits_total`` / ``sparse_memo_misses_total``)."""

    def __init__(self, entries: int = 8192, cas_dir: str | None = None,
                 max_bytes: int = DEFAULT_MEMO_BYTES):
        self.memory = MemoryLRU(entries, max_bytes=max_bytes)
        self.cas = (
            DiskCAS(cas_dir, payload="text", on_evict=self._on_evict)
            if cas_dir else None
        )

    @staticmethod
    def key(block: np.ndarray, tile: int) -> str:
        """The tile-step fingerprint of one halo-extended block."""
        return f"t{SCHEMA_VERSION}-{board_digest(block)}-{tile}"

    def _on_evict(self, fp: str, reason: str) -> None:
        obs_registry.default().inc("sparse_memo_corrupt_evictions_total")

    def get(self, key: str) -> TileStep | None:
        reg = obs_registry.default()
        entry = self.memory.get(key)
        if entry is None and self.cas is not None:
            try:
                entry = self.cas.get(key)
            except OSError as err:
                logger.warning("tile memo CAS read failed for %s: %s: %s",
                               key, type(err).__name__, err)
                entry = None
            if entry is not None:
                self.memory.put(key, entry)
        if entry is None:
            reg.inc("sparse_memo_misses_total")
            return None
        reg.inc("sparse_memo_hits_total")
        flags = int(entry.generations)
        return TileStep(
            interior=entry.grid,
            alive=bool(flags & _ALIVE),
            changed=bool(flags & _CHANGED),
        )

    def put(self, key: str, step: TileStep) -> None:
        flags = (_ALIVE if step.alive else 0) | (_CHANGED if step.changed else 0)
        entry = CacheEntry(
            grid=np.ascontiguousarray(step.interior, dtype=np.uint8),
            generations=flags,
            exit_reason=_EXIT_TAG,
        )
        self.memory.put(key, entry)
        if self.cas is not None:
            try:
                self.cas.put(key, entry)
            except OSError as err:
                logger.warning(
                    "tile memo CAS write failed for %s (memo still serves "
                    "from memory): %s: %s", key, type(err).__name__, err,
                )
