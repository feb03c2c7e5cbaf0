"""Tile→worker ownership for the sharded single-job engine.

One giant universe spans N workers: the sparse engine's fixed tile grid
(sparse/board.py) is partitioned by rendezvous hashing over tile
coordinates, reusing the fleet's HRW ranking verbatim
(fleet/placement.py — the same score function that places serve
buckets places tiles). Rendezvous hashing is the membership-change
contract the reference's ``MPI_Cart_create`` cannot express: adding a
worker moves ONLY the tiles the new worker now wins, removing one moves
ONLY the departed worker's tiles — every other tile keeps its owner, so
an elastic rebalance ships exactly the moved shards and nothing else
(``moved_tiles`` is the test-pinned statement of that property).

Ownership is a pure function of ``(worker ids, tile coord)`` — never an
enumeration of the grid. A 2^20-square universe has 2^24 tiles; the
partition answers ``owner`` per-coordinate on demand (memoized for the
coords actually asked about: the active set and its neighbors), so the
cost tracks live area exactly like the engine itself does.

Jax-free and numpy-free on purpose: the router's shard coordinator lane
imports this, and the router is a front-end process.
"""

from __future__ import annotations

from gol_tpu_torch.fleet import placement


def tile_label(ty: int, tx: int) -> str:
    """The HRW label of one tile coordinate (the shard analog of the
    serve tier's bucket label)."""
    return f"tile:{ty}:{tx}"


class Partition:
    """Ownership of a ``tiles_y x tiles_x`` tile grid over a worker set.

    Immutable once built; membership change is a NEW Partition over the
    new id set (compare with ``moved_tiles``). With ``weights`` the
    ranking is capacity-weighted (placement.rank_weighted — equal weights
    delegate to plain rank, so weighted-with-no-signal is byte-identical
    to unweighted)."""

    def __init__(self, worker_ids, tiles_y: int, tiles_x: int,
                 weights: dict[str, float] | None = None):
        ids = [str(w) for w in worker_ids]
        if not ids:
            raise ValueError("a partition needs at least one worker")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        if tiles_y <= 0 or tiles_x <= 0:
            raise ValueError(
                f"tile grid must be positive, got {tiles_y}x{tiles_x}"
            )
        self.worker_ids = tuple(ids)
        self.tiles_y = tiles_y
        self.tiles_x = tiles_x
        self.weights = dict(weights) if weights else None
        self._owners: dict[tuple[int, int], str] = {}

    @classmethod
    def for_universe(cls, worker_ids, height: int, width: int, tile: int,
                     weights: dict[str, float] | None = None) -> "Partition":
        if height % tile or width % tile:
            raise ValueError(
                f"universe {height}x{width} does not divide into {tile}^2 "
                "tiles"
            )
        return cls(worker_ids, height // tile, width // tile, weights)

    def owner(self, coord: tuple[int, int]) -> str:
        """The worker id owning one tile (deterministic across every
        process that holds the same membership — both sides of every halo
        boundary compute the same map from the same ids)."""
        own = self._owners.get(coord)
        if own is None:
            ty, tx = coord
            if not (0 <= ty < self.tiles_y and 0 <= tx < self.tiles_x):
                raise ValueError(
                    f"tile {coord} outside the "
                    f"{self.tiles_y}x{self.tiles_x} grid"
                )
            label = tile_label(ty, tx)
            if self.weights:
                own = placement.rank_weighted(label, self.weights)[0]
            else:
                own = placement.rank(label, list(self.worker_ids))[0]
            self._owners[coord] = own
        return own

    def owns(self, worker_id: str):
        """``(ty, tx) -> bool`` membership predicate for one worker — the
        ``owned`` filter SparseBoard.from_rle and engine.step_tiles take."""
        return lambda coord: self.owner(coord) == worker_id

    def neighbors(self, coord: tuple[int, int]) -> list[tuple[int, int]]:
        """The 8 torus neighbors of one tile (self-wrap included on
        1-tile-wide grids, exactly like the engine's activation walk)."""
        ty, tx = coord
        return [
            ((ty + dy) % self.tiles_y, (tx + dx) % self.tiles_x)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx
        ]

    def counts(self, coords) -> dict[str, int]:
        """Ownership histogram over a concrete coord set (the per-worker
        tile-ownership gauges in ``gol top`` ride this)."""
        out: dict[str, int] = {wid: 0 for wid in self.worker_ids}
        for coord in coords:
            out[self.owner(coord)] += 1
        return out


def moved_tiles(old: Partition, new: Partition, coords) -> set:
    """The coords (of a concrete set — live tiles, usually) whose owner
    changes between two memberships. HRW's minimal-disruption property,
    stated operationally: growing the set moves only tiles the NEW worker
    wins; shrinking moves only tiles the DEPARTED worker held. The elastic
    rebalance ships exactly these."""
    if (old.tiles_y, old.tiles_x) != (new.tiles_y, new.tiles_x):
        raise ValueError("partitions cover different tile grids")
    return {c for c in coords if old.owner(c) != new.owner(c)}
