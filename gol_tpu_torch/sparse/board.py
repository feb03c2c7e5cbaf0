"""Sparse tiled board: a giant torus stored as its live 256^2 tiles only.

The port's copy of ``gol_tpu/sparse/board.py`` (numpy only).

The board is decomposed into fixed ``tile``-square tiles on a tile-grid
torus (universe extents must divide evenly into tiles). Only tiles holding
at least one live cell exist — the tile dict IS the live-occupancy index —
so a 2^16-square universe carrying five gliders costs a handful of 64 KB
tiles, not a 4 GB canvas. The dense analog of this invariant is the
reference's ``empty_all`` early exit: where the reference can skip the
whole board only when EVERYTHING is dead, per-tile elision skips every
dead tile every generation (COMPONENTS.md sparse-engine lineage).

Numpy-only on purpose: boards are built by the CLI and the
serve admission path before any engine loads, straight from RLE token
streams (io/rle.py) — geometry-first, the full byte canvas never exists.
"""

from __future__ import annotations

import numpy as np

from gol_tpu_torch.io import rle

# The production tile edge. 256^2 tiles are large enough that a batched
# tile-step amortizes dispatch (each tile is a 64 KB board — serving-batch
# scale) and small enough that a lone glider wakes at most 4 of them.
# tune/space.py names the candidate axis (SPARSE_TILES) around
# this default; tests use small tiles to exercise boundary crossings
# cheaply (the math is tile-size-independent).
DEFAULT_TILE = 256
MIN_TILE = 4

# Dense-materialization ceiling (cells): boards above this must never be
# built as a byte canvas on the host — the guard every dense construction
# path checks BEFORE allocating (cli board construction, to_dense). 2^30
# cells is a 1 GB uint8 canvas; the dense engine carries the grid plus its
# packed buffers.
MAX_DENSE_CELLS = 1 << 30


def dense_cells_guard(height: int, width: int, *, what: str = "board",
                      limit: int = MAX_DENSE_CELLS) -> None:
    """Raise the CLI-contract error for a dense allocation that cannot fit.

    Centralized so every dense lane fails the same way — a clear
    ``gol: <error>`` line naming the sparse lane — instead of an OOM
    traceback from inside ``np.zeros``."""
    cells = height * width
    if cells > limit:
        raise ValueError(
            f"a {height}x{width} {what} is {cells} cells "
            f"({cells / (1 << 30):.1f} GB as bytes), above the dense "
            f"engine's {limit}-cell ceiling; use the sparse lane "
            "(--pattern FILE --universe WxH [--engine sparse]) so the "
            "canvas is never materialized"
        )


class SparseBoard:
    """A ``height x width`` torus holding only its live tiles.

    ``tiles`` maps ``(ty, tx)`` tile-grid coordinates to ``(tile, tile)``
    uint8 arrays; the class invariant is that every stored tile has at
    least one live cell (all-dead tiles are elided, never stored)."""

    def __init__(self, height: int, width: int, tile: int = DEFAULT_TILE,
                 tiles: dict | None = None):
        if tile < MIN_TILE:
            raise ValueError(f"tile must be >= {MIN_TILE}, got {tile}")
        if height <= 0 or width <= 0:
            raise ValueError(
                f"universe extents must be positive, got {height}x{width}"
            )
        if height % tile or width % tile:
            raise ValueError(
                f"universe {height}x{width} does not divide into {tile}^2 "
                f"tiles; extents must be multiples of the tile size"
            )
        self.height = height
        self.width = width
        self.tile = tile
        self.tiles_y = height // tile
        self.tiles_x = width // tile
        self.tiles: dict[tuple[int, int], np.ndarray] = {}
        for coord, arr in (tiles or {}).items():
            self.set_tile(coord, arr)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dense(cls, grid: np.ndarray, tile: int = DEFAULT_TILE
                   ) -> "SparseBoard":
        grid = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
        if grid.ndim != 2:
            raise ValueError(f"grid must be 2D, got shape {grid.shape}")
        board = cls(grid.shape[0], grid.shape[1], tile)
        t = tile
        for ty in range(board.tiles_y):
            for tx in range(board.tiles_x):
                block = grid[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t]
                if block.any():
                    board.tiles[(ty, tx)] = np.ascontiguousarray(block)
        return board

    @classmethod
    def from_pattern(cls, pattern: np.ndarray, x: int, y: int,
                     height: int, width: int, tile: int = DEFAULT_TILE
                     ) -> "SparseBoard":
        """Place a dense pattern with its top-left cell at column ``x``,
        row ``y`` of an otherwise-empty universe (geometry-first: only the
        tiles the pattern touches are ever allocated)."""
        board = cls(height, width, tile)
        board.place(pattern, x, y)
        return board

    @classmethod
    def from_rle(cls, text: str, height: int | None = None,
                 width: int | None = None, tile: int = DEFAULT_TILE,
                 x: int = 0, y: int = 0, owned=None) -> "SparseBoard":
        """Build a board from an RLE document via the streaming run path —
        no dense canvas at any size. With ``height``/``width`` absent the
        RLE header's extents ARE the universe.

        ``owned`` is an optional ``(ty, tx) -> bool`` tile filter: runs are
        split across the tiles they span and only owned tiles materialize
        — the shard-worker loading path, where a worker
        owning one slice of a 2^20-square document must cost O(its runs)
        in memory, never the whole document's tiles. ``None`` (every other
        caller) loads everything, byte-identically to before."""
        (pw, ph), runs = rle.live_runs(text)
        if height is None or width is None:
            height, width = ph, pw
        board = cls(height, width, tile)
        # live_runs bounds content against the RLE header's own extents;
        # the placement of THOSE extents must fit this universe, or
        # _set_run would write phantom tiles outside the tile grid.
        if x < 0 or y < 0 or y + ph > height or x + pw > width:
            raise ValueError(
                f"RLE content {ph}x{pw} at ({x},{y}) does not fit the "
                f"{height}x{width} universe"
            )
        for row, col, count in runs:
            board._set_run(y + row, x + col, count, owned)
        return board

    def place(self, pattern: np.ndarray, x: int, y: int) -> None:
        """Stamp (OR) a dense pattern at column ``x``, row ``y``; the stamp
        may span any number of tile boundaries but not the universe edge."""
        pattern = np.asarray(pattern, dtype=np.uint8)
        if pattern.ndim != 2:
            raise ValueError(f"pattern must be 2D, got shape {pattern.shape}")
        ph, pw = pattern.shape
        if x < 0 or y < 0 or y + ph > self.height or x + pw > self.width:
            raise ValueError(
                f"pattern {ph}x{pw} at ({x},{y}) does not fit the "
                f"{self.height}x{self.width} universe"
            )
        for r in range(ph):
            row = pattern[r]
            for start, end in rle._row_runs(row):
                self._set_run(y + r, x + start, end - start)

    def _set_run(self, row: int, col: int, count: int, owned=None) -> None:
        """Set ``count`` cells live starting at (row, col), splitting the
        run across the tiles it spans. ``owned`` filters which tiles may
        materialize (tile-by-tile: an unowned slice of the run is skipped
        without ever allocating its tile)."""
        t = self.tile
        ty, ly = divmod(row, t)
        while count > 0:
            tx, lx = divmod(col, t)
            take = min(count, t - lx)
            if owned is None or owned((ty, tx)):
                arr = self.tiles.get((ty, tx))
                if arr is None:
                    arr = self.tiles[(ty, tx)] = np.zeros((t, t), np.uint8)
                arr[ly, lx:lx + take] = 1
            col += take
            count -= take

    def set_tile(self, coord: tuple[int, int], arr: np.ndarray) -> None:
        """Install one tile (elided when all-dead — the class invariant)."""
        ty, tx = coord
        if not (0 <= ty < self.tiles_y and 0 <= tx < self.tiles_x):
            raise ValueError(
                f"tile {coord} outside the {self.tiles_y}x{self.tiles_x} grid"
            )
        arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint8))
        if arr.shape != (self.tile, self.tile):
            raise ValueError(
                f"tile {coord} has shape {arr.shape}; need "
                f"({self.tile}, {self.tile})"
            )
        if arr.any():
            self.tiles[coord] = arr
        else:
            self.tiles.pop(coord, None)

    # -- views -------------------------------------------------------------

    @property
    def live_tiles(self) -> int:
        return len(self.tiles)

    def occupancy(self) -> float:
        """Live tiles over total tiles — the sparsity the engine exploits."""
        return len(self.tiles) / (self.tiles_y * self.tiles_x)

    def population(self) -> int:
        return int(sum(int(a.sum()) for a in self.tiles.values()))

    def to_dense(self, limit: int = MAX_DENSE_CELLS) -> np.ndarray:
        """Materialize the full canvas (guarded — giant boards refuse)."""
        dense_cells_guard(self.height, self.width, what="dense view",
                          limit=limit)
        grid = np.zeros((self.height, self.width), np.uint8)
        t = self.tile
        for (ty, tx), arr in self.tiles.items():
            grid[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t] = arr
        return grid

    def to_rle(self, comments: tuple[str, ...] = ()) -> str:
        """The whole universe as one RLE document — O(live runs), rendered
        through the same emitter as the dense codec (io/rle.encode_rows)."""
        t = self.tile

        def rows():
            by_row: dict[int, list[tuple[int, np.ndarray]]] = {}
            for (ty, tx), arr in self.tiles.items():
                by_row.setdefault(ty, []).append((tx, arr))
            for ty in sorted(by_row):
                strip = sorted(by_row[ty])
                for ly in range(t):
                    runs: list[tuple[int, int]] = []
                    for tx, arr in strip:
                        base = tx * t
                        for start, end in rle._row_runs(arr[ly]):
                            if runs and runs[-1][1] == base + start:
                                runs[-1] = (runs[-1][0], base + end)
                            else:
                                runs.append((base + start, base + end))
                    if runs:
                        yield ty * t + ly, runs

        return rle.encode_rows(rows(), self.width, self.height, comments)

    def __eq__(self, other) -> bool:
        if not isinstance(other, SparseBoard):
            return NotImplemented
        return (
            self.height == other.height
            and self.width == other.width
            and self.tile == other.tile
            and self.tiles.keys() == other.tiles.keys()
            and all(
                np.array_equal(a, other.tiles[c])
                for c, a in self.tiles.items()
            )
        )

    def __repr__(self) -> str:
        return (
            f"SparseBoard({self.height}x{self.width}, tile={self.tile}, "
            f"live_tiles={self.live_tiles}, population={self.population()})"
        )
