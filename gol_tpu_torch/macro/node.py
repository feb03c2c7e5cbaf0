"""Hash-consed macrocell quadtree over the sparse lane's tile index.

The port's copy of ``gol_tpu/macro/node.py`` (numpy only).

The time axis of the sparse engine's space-elision argument: a node is a
``tile * 2^level``-square region of the universe, a leaf (level 0) is ONE
sparse tile, and every node is **interned** — two stamps of the same
subtree anywhere on the board (or in any two jobs on the same process)
are one Python object. Identity therefore means cell-equality, which is
what makes the macrocell advance memo (``macro/advance.py``) a dict
lookup instead of a byte comparison.

Interning keys are decomposition-independent by construction: a leaf is
keyed by ``cache/fingerprint.board_digest`` of its cells (the result
cache's positional limb math + CRC fold — the same identity the
checkpoint and result-cache layers trust), and an internal node by the
identities of its four children — so HOW a board was assembled (dense
split, RLE stamp, advance result, CAS reload) never changes which node
it is.

Boards are built from and flattened back to ``sparse.SparseBoard``:
leaves ARE board tiles, aligned to the board's tile grid, so the two
engines exchange state without a dense canvas ever existing.

Numpy-only on purpose: trees are built by the CLI and serve admission
paths before any engine loads; the device work happens in advance.py
through the tile step runners (T1).
"""

from __future__ import annotations

import numpy as np

from gol_tpu_torch.cache.fingerprint import board_digest
from gol_tpu_torch.sparse.board import MIN_TILE, SparseBoard


class MacroNode:
    """One canonical quadtree node (never constructed directly — always
    through a ``NodeStore``, which is what makes identity meaningful).

    ``level`` 0 is a leaf holding a read-only ``(leaf, leaf)`` uint8 cell
    array; level ``m`` holds four level ``m-1`` children (nw, ne, sw, se)
    and spans ``leaf * 2^m`` cells. ``population`` is the live-cell count
    of the whole subtree (O(1) — summed once at intern time)."""

    __slots__ = ("level", "population", "cells", "nw", "ne", "sw", "se",
                 "_digest", "_bbox")

    def __init__(self, level, population, cells=None,
                 nw=None, ne=None, sw=None, se=None):
        self.level = level
        self.population = population
        self.cells = cells
        self.nw = nw
        self.ne = ne
        self.sw = sw
        self.se = se
        self._digest = None
        self._bbox = -1  # unset marker (None is a real value: empty)

    def size(self, leaf: int) -> int:
        """Cell edge of the region this node spans."""
        return leaf << self.level

    def to_dense(self, leaf: int) -> np.ndarray:
        """The node's cells as one dense array (CAS payloads and digests
        — callers gate the size; flattening to a board walks leaves
        instead)."""
        if self.level == 0:
            return self.cells
        half = self.size(leaf) // 2
        out = np.zeros((half * 2, half * 2), np.uint8)
        out[:half, :half] = self.nw.to_dense(leaf)
        out[:half, half:] = self.ne.to_dense(leaf)
        out[half:, :half] = self.sw.to_dense(leaf)
        out[half:, half:] = self.se.to_dense(leaf)
        return out

    def digest(self, leaf: int) -> str:
        """Content digest of the node's cells (cached — interning makes
        the cache exact: one node, one digest)."""
        if self._digest is None:
            self._digest = board_digest(
                np.ascontiguousarray(self.to_dense(leaf))
            )
        return self._digest

    def bbox(self, leaf: int):
        """Live bounding box in node-local cell coords:
        ``(min_row, min_col, max_row, max_col)`` inclusive, or None when
        the subtree is empty. Cached per node (interning shares it)."""
        if self._bbox != -1:
            return self._bbox
        if self.population == 0:
            self._bbox = None
            return None
        if self.level == 0:
            rows, cols = np.nonzero(self.cells)
            self._bbox = (int(rows.min()), int(cols.min()),
                          int(rows.max()), int(cols.max()))
            return self._bbox
        half = self.size(leaf) // 2
        lo_r = lo_c = None
        hi_r = hi_c = None
        for child, dr, dc in ((self.nw, 0, 0), (self.ne, 0, half),
                              (self.sw, half, 0), (self.se, half, half)):
            b = child.bbox(leaf)
            if b is None:
                continue
            r0, c0, r1, c1 = b[0] + dr, b[1] + dc, b[2] + dr, b[3] + dc
            lo_r = r0 if lo_r is None else min(lo_r, r0)
            lo_c = c0 if lo_c is None else min(lo_c, c0)
            hi_r = r1 if hi_r is None else max(hi_r, r1)
            hi_c = c1 if hi_c is None else max(hi_c, c1)
        self._bbox = (lo_r, lo_c, hi_r, hi_c)
        return self._bbox

    def __repr__(self) -> str:
        return (f"MacroNode(level={self.level}, "
                f"population={self.population})")


class NodeStore:
    """The intern tables: content -> THE node for that content.

    One store per process in serving (``macro/serve.py``) so
    identical subtrees across jobs share nodes; tests build their own.
    ``leaf_size`` is the board tile edge — it must be even (the leaf
    base-case advance in advance.py needs an ``leaf/2``-step margin) and
    every board entering this store must agree on it."""

    def __init__(self, leaf_size: int):
        if leaf_size < MIN_TILE:
            raise ValueError(
                f"macro leaf size must be >= {MIN_TILE}, got {leaf_size}"
            )
        if leaf_size % 2:
            raise ValueError(
                f"macro leaf size must be even (the leaf advance needs an "
                f"leaf/2 halo margin), got {leaf_size}"
            )
        self.leaf_size = leaf_size
        self._leaves: dict[str, MacroNode] = {}
        self._nodes: dict[tuple, MacroNode] = {}
        self._empty: dict[int, MacroNode] = {}
        self._zero = np.zeros((leaf_size, leaf_size), np.uint8)
        self._zero.setflags(write=False)

    # -- interning ---------------------------------------------------------

    def leaf(self, cells: np.ndarray) -> MacroNode:
        """THE leaf for these cells (content-keyed via board_digest, the
        same collision-hardened identity the result cache gates on)."""
        cells = np.ascontiguousarray(np.asarray(cells, dtype=np.uint8))
        if cells.shape != (self.leaf_size, self.leaf_size):
            raise ValueError(
                f"leaf cells must be {self.leaf_size}^2, got {cells.shape}"
            )
        population = int(cells.sum())
        if population == 0:
            return self.empty(0)
        key = board_digest(cells)
        node = self._leaves.get(key)
        if node is None:
            cells = cells.copy()
            cells.setflags(write=False)
            node = MacroNode(0, population, cells=cells)
            node._digest = key
            self._leaves[key] = node
        return node

    def node(self, nw: MacroNode, ne: MacroNode, sw: MacroNode,
             se: MacroNode) -> MacroNode:
        """THE node with these four children (identity-keyed: children
        are already canonical, so object ids ARE content ids)."""
        level = nw.level + 1
        if not (ne.level == sw.level == se.level == nw.level):
            raise ValueError("macro node children must share a level")
        population = (nw.population + ne.population
                      + sw.population + se.population)
        if population == 0:
            return self.empty(level)
        key = (level, id(nw), id(ne), id(sw), id(se))
        node = self._nodes.get(key)
        if node is None:
            node = MacroNode(level, population, nw=nw, ne=ne, sw=sw, se=se)
            self._nodes[key] = node
        return node

    def empty(self, level: int) -> MacroNode:
        """THE all-dead node of a level (one per level per store)."""
        node = self._empty.get(level)
        if node is None:
            if level == 0:
                node = MacroNode(0, 0, cells=self._zero)
            else:
                child = self.empty(level - 1)
                node = MacroNode(level, 0, nw=child, ne=child,
                                 sw=child, se=child)
            self._empty[level] = node
        return node

    def interned_nodes(self) -> int:
        """Distinct nodes alive in the tables (obs gauge fodder)."""
        return len(self._leaves) + len(self._nodes) + len(self._empty)

    def from_dense(self, grid: np.ndarray) -> MacroNode:
        """Intern a dense ``(leaf * 2^m)``-square array as a node — the
        CAS-reload path (advance results come back as cell payloads and
        must land on the SAME canonical nodes a live process holds)."""
        grid = np.asarray(grid, dtype=np.uint8)
        edge = grid.shape[0]
        if grid.shape != (edge, edge) or edge % self.leaf_size:
            raise ValueError(
                f"dense macro region must be a square multiple of the "
                f"{self.leaf_size}-cell leaf, got {grid.shape}"
            )
        if edge == self.leaf_size:
            return self.leaf(grid)
        half = edge // 2
        return self.node(
            self.from_dense(grid[:half, :half]),
            self.from_dense(grid[:half, half:]),
            self.from_dense(grid[half:, :half]),
            self.from_dense(grid[half:, half:]),
        )

    # -- centered subnode (the t=0 "advance") ------------------------------

    def centered(self, node: MacroNode) -> MacroNode:
        """The center half-size subnode — what a 0-step advance returns,
        and one leg of the stillness test (advance-by-1 == centered iff
        the window is a fixed point)."""
        if node.level < 1:
            raise ValueError("centered needs a level >= 1 node")
        if node.level == 1:
            half = self.leaf_size // 2
            cells = np.zeros((self.leaf_size, self.leaf_size), np.uint8)
            cells[:half, :half] = node.nw.cells[half:, half:]
            cells[:half, half:] = node.ne.cells[half:, :half]
            cells[half:, :half] = node.sw.cells[:half, half:]
            cells[half:, half:] = node.se.cells[:half, :half]
            return self.leaf(cells)
        return self.node(node.nw.se, node.ne.sw, node.sw.ne, node.se.nw)


class MacroUniverse:
    """A sparse board held as a canonical quadtree plus its placement.

    ``root`` spans tiles ``[oy, oy + 2^level) x [ox, ox + 2^level)`` of
    the board's tile grid (offsets may go negative after padding
    expansion — the tree is plane-semantics scratch space; only the
    flatten clips back to the universe). Instances are treated as
    immutable by the engine: every advance returns a new universe
    sharing the store."""

    def __init__(self, store: NodeStore, height: int, width: int,
                 root: MacroNode, oy: int, ox: int):
        self.store = store
        self.height = height
        self.width = width
        self.root = root
        self.oy = oy
        self.ox = ox

    @property
    def tile(self) -> int:
        return self.store.leaf_size

    @classmethod
    def from_board(cls, store: NodeStore, board: SparseBoard
                   ) -> "MacroUniverse":
        """Build the canonical tree over a board's live-tile bounding box
        (geometry-first: dead regions outside the bbox are never
        visited — they become THE canonical empty nodes)."""
        if board.tile != store.leaf_size:
            raise ValueError(
                f"board tile {board.tile} != store leaf {store.leaf_size}"
            )
        if not board.tiles:
            return cls(store, board.height, board.width, store.empty(1), 0, 0)
        tys = [ty for ty, _ in board.tiles]
        txs = [tx for _, tx in board.tiles]
        oy, ox = min(tys), min(txs)
        span = max(max(tys) - oy, max(txs) - ox) + 1
        level = 1
        while (1 << level) < span:
            level += 1
        live = board.tiles

        def build(lv: int, ty: int, tx: int) -> MacroNode:
            if lv == 0:
                arr = live.get((ty, tx))
                return store.leaf(arr) if arr is not None else store.empty(0)
            h = 1 << (lv - 1)
            if not any(ty <= y < ty + (1 << lv) and tx <= x < tx + (1 << lv)
                       for y, x in live):
                return store.empty(lv)
            return store.node(
                build(lv - 1, ty, tx), build(lv - 1, ty, tx + h),
                build(lv - 1, ty + h, tx), build(lv - 1, ty + h, tx + h),
            )

        return cls(store, board.height, board.width,
                   build(level, oy, ox), oy, ox)

    def population(self) -> int:
        """O(1) — read off the root, never flattened (deep-time census
        queries read this at generation 10^9 without materializing)."""
        return self.root.population

    def bbox_cells(self):
        """Live bbox in universe cell coords (inclusive), None if empty."""
        b = self.root.bbox(self.tile)
        if b is None:
            return None
        t = self.tile
        return (b[0] + self.oy * t, b[1] + self.ox * t,
                b[2] + self.oy * t, b[3] + self.ox * t)

    def expanded(self) -> "MacroUniverse":
        """One ring of empty padding: a new root one level up whose
        CENTER is this root (the auto-expanding padding of the superstep
        driver — advance returns the center half, so capacity must be
        grown before each jump, never during)."""
        s, r = self.store, self.root
        if r.level < 1:
            raise ValueError("cannot expand a leaf root")
        e = s.empty(r.level - 1)
        root = s.node(
            s.node(e, e, e, r.nw), s.node(e, e, r.ne, e),
            s.node(e, r.sw, e, e), s.node(r.se, e, e, e),
        )
        shift = 1 << (r.level - 1)
        return MacroUniverse(s, self.height, self.width, root,
                             self.oy - shift, self.ox - shift)

    def to_board(self) -> SparseBoard:
        """Flatten back to the sparse lane's occupancy index (live leaves
        only; tiles land on the same grid they came from)."""
        board = SparseBoard(self.height, self.width, self.tile)

        def walk(node: MacroNode, ty: int, tx: int) -> None:
            if node.population == 0:
                return
            if node.level == 0:
                board.set_tile((ty, tx), node.cells.copy())
                return
            h = 1 << (node.level - 1)
            walk(node.nw, ty, tx)
            walk(node.ne, ty, tx + h)
            walk(node.sw, ty + h, tx)
            walk(node.se, ty + h, tx + h)

        walk(self.root, self.oy, self.ox)
        return board
