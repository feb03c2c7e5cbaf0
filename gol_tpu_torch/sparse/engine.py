"""The sparse tiled engine: O(live-area) simulation of giant universes.

The port of ``gol_tpu/sparse/engine.py``: the same loop, activation, halo
assembly and accounting, with the batched step on T1
(``engine.make_tile_step_runner``, ``ops/stencil_tile``).

Every dense lane (solo, batched, resident, packed-wire) costs
O(width x height) per generation no matter how dead the board is; this
engine costs O(active tiles). Per generation:

1. **Activation** — the active set is every live tile plus, for each live
   tile whose outermost ring holds a live cell, its 8 tile-grid neighbors
   (torus wrap at the universe edge). A dead tile outside this set cannot
   gain a live cell (all of its halo is dead), so it is elided entirely —
   the per-tile generalization of the reference's whole-board
   ``empty_all`` early exit.
2. **Halo assembly** — each active tile becomes a ``(tile+2)^2`` block:
   interior from the occupancy index, halo ring gathered from the 8
   neighbors (the per-step halo exchange of the distributed lanes, at
   tile granularity, on the host).
3. **Memo consult** — the block's content digest is looked up in the tile
   memo (``sparse/memo.py`` — the result cache's CAS keyed at tile
   granularity); hits skip the kernel entirely.
4. **Batched step** — misses are batched through the serve batcher's
   padding ladder (``batcher.pad_batch`` — tiles ARE a bucket, so a tile
   size builds at most one runner per ladder rung) into
   ``engine.make_tile_step_runner``, one generation per launch: one upload
   and one readback per ladder chunk.
5. **Rebuild** — tiles whose next interior is all-dead are dropped from
   the index; the per-tile ``changed`` flags fold into the global
   similarity answer (the universe is unchanged iff no active tile
   changed — inactive tiles are unchanged by construction).

The loop accounting around those steps reproduces both reference
conventions exactly (``oracle.py`` is the semantics contract), so the
sparse lane is byte-identical to the dense engine — cells, generation
count, and exit reason — on every shape both accept (test-pinned).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig
from gol_tpu_torch.obs import registry as obs_registry, trace as obs_trace
from gol_tpu_torch.sparse.board import SparseBoard
from gol_tpu_torch.sparse.memo import TileMemo, TileStep

# Above this universe area the CLI's auto lane prefers the sparse engine.
# The shipped default is the MEASURED dense/sparse crossover, not a guess:
# BENCH_r14 has dense still winning at 4096^2 = 2^24 (ratio 0.81) and
# losing 4.7x at 8192^2 = 2^26 — dense cost grows linearly with area while
# sparse stays flat at the live tiles, so the crossover sits near the
# geometric middle, 2^25. The value is plan-cached per machine:
# ``gol tune --sparse-crossover`` measures THIS host's crossover and
# persists it (tune.select.sparse_auto_area consults it; this constant is
# the bundled-default/last-resort fallback, kept equal to
# default_plans.json's entry).
SPARSE_AUTO_AREA = 1 << 25

EXIT_GEN_LIMIT = "gen_limit"
EXIT_EMPTY = "empty"
EXIT_SIMILAR = "similar"


@dataclasses.dataclass
class SparseStats:
    """Work accounting of one sparse run (feeds the obs registry and the
    serve metrics: the sparse lane's achieved work is tiles, not canvas)."""

    generations: int = 0
    tiles_active: int = 0  # active-tile steps, summed over generations
    tiles_computed: int = 0  # kernel-dispatched steps (memo misses)
    memo_hits: int = 0

    def cell_updates(self, tile: int) -> int:
        """Actual cells stepped: active tiles x tile area (the number the
        dense engine would report as height x width x generations)."""
        return self.tiles_active * tile * tile

    def tiles_per_generation(self) -> float:
        return self.tiles_active / self.generations if self.generations else 0.0


@dataclasses.dataclass
class SparseResult:
    """Final state of a sparse run (the EngineResult analog)."""

    board: SparseBoard
    generations: int
    exit_reason: str
    stats: SparseStats


def auto_engine(height: int, width: int, tile: int,
                area_threshold: int | None = None) -> str:
    """The auto lane's dense/sparse pick for a universe: sparse above the
    area threshold when the extents tile evenly, dense otherwise.

    The threshold is the tuned/plan-cached crossover when one exists
    (``gol tune --sparse-crossover`` measures it; absent or unreadable
    cache degrades to the bundled default — the usual plan-cache
    contract), or ``area_threshold`` when the caller pins one."""
    if area_threshold is None:
        try:
            from gol_tpu_torch.tune import select

            area_threshold = select.sparse_auto_area(SPARSE_AUTO_AREA)
        except Exception:  # noqa: BLE001 - cache trouble = default
            area_threshold = SPARSE_AUTO_AREA
    if height * width >= area_threshold and height % tile == 0 \
            and width % tile == 0:
        return "sparse"
    return "dense"


def ring_live(arr: np.ndarray) -> bool:
    """True when a tile's outermost ring holds a live cell — the condition
    under which its neighbors activate (and, in the shard lanes, the
    condition under which its ring must cross the wire)."""
    return bool(arr[0].any() or arr[-1].any()
                or arr[:, 0].any() or arr[:, -1].any())


def _ghost_live(ring) -> bool:
    """Ring-liveness of a ghost entry (see ``step_tiles`` for the ghost
    protocol). An all-dead ghost ring activates nothing — exactly like an
    absent tile, which it is indistinguishable from."""
    return bool(ring.top.any() or ring.bottom.any()
                or ring.left.any() or ring.right.any())


def _active_set(board: SparseBoard, ghost=None,
                owned=None) -> set[tuple[int, int]]:
    """Live tiles plus halo-activated neighbors of ring-live tiles.

    ``ghost`` extends ring-liveness to remote tiles (their neighbors
    activate here too); ``owned`` filters the result to this worker's
    ownership slice — a tile another worker owns is stepped there, never
    here. Both default to None: the solo path is byte-identical."""
    active = set(board.tiles)
    ty_n, tx_n = board.tiles_y, board.tiles_x
    seeds = [coord for coord, arr in board.tiles.items() if ring_live(arr)]
    if ghost:
        seeds.extend(c for c, ring in ghost.items() if _ghost_live(ring))
    for ty, tx in seeds:
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    active.add(((ty + dy) % ty_n, (tx + dx) % tx_n))
    if owned is not None:
        active = {coord for coord in active if owned(coord)}
    return active


def _assemble_block(board: SparseBoard, coord: tuple[int, int],
                    ghost=None) -> np.ndarray:
    """One tile's ``(tile+2)^2`` halo-extended block, ring gathered from
    its 8 torus neighbors (self-wrap on 1-tile-wide grids is the universe
    torus, so a single-tile universe assembles its own torus halo).

    A neighbor absent from the board may be present in ``ghost`` — a
    remote tile's ring, received over the halo wire. Only the ring cells
    a block ever reads exist there: edge rows/cols and corners."""
    t = board.tile
    ty, tx = coord
    ty_n, tx_n = board.tiles_y, board.tiles_x
    tiles = board.tiles
    ghost = ghost or {}
    up, down = (ty - 1) % ty_n, (ty + 1) % ty_n
    left, right = (tx - 1) % tx_n, (tx + 1) % tx_n
    block = np.zeros((t + 2, t + 2), np.uint8)
    center = tiles.get(coord)
    if center is not None:
        block[1:-1, 1:-1] = center
    n = tiles.get((up, tx))
    if n is not None:
        block[0, 1:-1] = n[-1]
    elif (g := ghost.get((up, tx))) is not None:
        block[0, 1:-1] = g.bottom
    s = tiles.get((down, tx))
    if s is not None:
        block[-1, 1:-1] = s[0]
    elif (g := ghost.get((down, tx))) is not None:
        block[-1, 1:-1] = g.top
    w = tiles.get((ty, left))
    if w is not None:
        block[1:-1, 0] = w[:, -1]
    elif (g := ghost.get((ty, left))) is not None:
        block[1:-1, 0] = g.right
    e = tiles.get((ty, right))
    if e is not None:
        block[1:-1, -1] = e[:, 0]
    elif (g := ghost.get((ty, right))) is not None:
        block[1:-1, -1] = g.left
    nw = tiles.get((up, left))
    if nw is not None:
        block[0, 0] = nw[-1, -1]
    elif (g := ghost.get((up, left))) is not None:
        block[0, 0] = g.bottom[-1]
    ne = tiles.get((up, right))
    if ne is not None:
        block[0, -1] = ne[-1, 0]
    elif (g := ghost.get((up, right))) is not None:
        block[0, -1] = g.bottom[0]
    sw = tiles.get((down, left))
    if sw is not None:
        block[-1, 0] = sw[0, -1]
    elif (g := ghost.get((down, left))) is not None:
        block[-1, 0] = g.top[-1]
    se = tiles.get((down, right))
    if se is not None:
        block[-1, -1] = se[0, 0]
    elif (g := ghost.get((down, right))) is not None:
        block[-1, -1] = g.top[0]
    return block


def _step(board: SparseBoard, memo: TileMemo | None, stats: SparseStats,
          ghost=None, owned=None) -> tuple[SparseBoard, bool]:
    """One global generation: ``(next_board, changed_any)``."""
    from gol_tpu_torch import engine
    from gol_tpu_torch.serve import batcher

    t = board.tile
    active = sorted(_active_set(board, ghost, owned))
    stats.tiles_active += len(active)
    results: dict[tuple[int, int], TileStep] = {}
    # Each miss is (key, block, [coords]): with a memo, identical blocks
    # WITHIN one generation dedupe onto one kernel slot too (two stamps
    # of the same pattern cost one stamp's dispatches even on their first
    # generation — the repeated-content claim at its strongest).
    misses: list[list] = []
    pending: dict[str, list] = {}
    for coord in active:
        block = _assemble_block(board, coord, ghost)
        if memo is not None:
            key = TileMemo.key(block, t)
            hit = memo.get(key)
            if hit is not None:
                results[coord] = hit
                stats.memo_hits += 1
                continue
            dup = pending.get(key)
            if dup is not None:
                dup[2].append(coord)
                stats.memo_hits += 1
                continue
            entry = [key, block, [coord]]
            pending[key] = entry
            misses.append(entry)
        else:
            misses.append([None, block, [coord]])
    # Batched through the padding-bucket ladder: request counts round up
    # the serve batcher's rungs (a tuned ladder applies here too), so one
    # tile size builds at most one runner per rung for the process's life,
    # each with its own staging and device buffers.
    for lo in range(0, len(misses), batcher.MAX_BATCH):
        chunk = misses[lo:lo + batcher.MAX_BATCH]
        rung = batcher.pad_batch(len(chunk))
        runner = engine.make_tile_step_runner(t, rung)
        operand = np.zeros((rung, t + 2, t + 2), np.uint8)
        for i, (_, block, _) in enumerate(chunk):
            operand[i] = block
        interiors, alive, changed = runner(operand)
        stats.tiles_computed += len(chunk)
        for i, (key, _, coords) in enumerate(chunk):
            step = TileStep(
                interior=interiors[i].copy(),
                alive=bool(alive[i]),
                changed=bool(changed[i]),
            )
            for coord in coords:
                results[coord] = step
            if memo is not None and key is not None:
                memo.put(key, step)
    new_board = SparseBoard(board.height, board.width, t)
    changed_any = False
    for coord, step in results.items():
        changed_any = changed_any or step.changed
        if step.alive:
            # Invariant holds by the flag: only live interiors are stored.
            new_board.tiles[coord] = step.interior
    return new_board, changed_any


def step_tiles(board: SparseBoard, memo: TileMemo | None, stats: SparseStats,
               *, ghost=None, owned=None) -> tuple[SparseBoard, bool]:
    """One super-step over an ownership slice: ``(next_board, changed)``.

    The shard worker's entry point. ``board`` holds only the tiles this
    worker owns; ``ghost`` maps remote neighbor coords to ring views —
    objects with ``top``/``bottom``/``left``/``right`` length-``tile``
    uint8 arrays (a shard halo ring),
    received as packed frames from the tiles' owners; ``owned`` is the
    partition's membership predicate. Because a tile's step reads ONLY its
    neighbors' outermost ring, and a tile with an all-dead ring is
    indistinguishable from an absent one (it activates nothing and
    contributes nothing), the union of every worker's ``step_tiles``
    result equals one solo ``_step`` — byte-exactly, the property the
    shard byte-gates pin. With both None this IS the solo step."""
    return _step(board, memo, stats, ghost=ghost, owned=owned)


def _run_c(board, config, memo, stats):
    """C-convention accounting (oracle._run_c, engine._simulate_c)."""
    generation = 1
    counter = 0
    while board.tiles and generation <= config.gen_limit:
        new_board, changed_any = _step(board, memo, stats)
        stats.generations += 1
        if config.check_similarity:
            counter += 1
            if counter == config.similarity_frequency:
                if not changed_any:
                    return SparseResult(new_board, generation - 1,
                                        EXIT_SIMILAR, stats)
                counter = 0
        board = new_board
        generation += 1
    reason = EXIT_GEN_LIMIT if board.tiles else EXIT_EMPTY
    return SparseResult(board, generation - 1, reason, stats)


def _run_cuda(board, config, memo, stats):
    """CUDA-convention accounting (oracle._run_cuda): similarity checked
    before emptiness, the break precedes the swap — an empty exit keeps
    the last non-empty generation."""
    generation = 0
    counter = 0
    reason = EXIT_GEN_LIMIT
    while generation < config.gen_limit:
        new_board, changed_any = _step(board, memo, stats)
        stats.generations += 1
        if config.check_similarity:
            counter += 1
            if counter == config.similarity_frequency:
                if not changed_any:
                    reason = EXIT_SIMILAR
                    break
                counter = 0
        if not new_board.tiles:
            reason = EXIT_EMPTY
            break
        board = new_board
        generation += 1
    return SparseResult(board, generation, reason, stats)


def simulate_sparse(
    board: SparseBoard,
    config: GameConfig = DEFAULT_CONFIG,
    memo: TileMemo | None = None,
) -> SparseResult:
    """Run a full sparse simulation.

    Byte-identical to the dense engine (and the oracle) on any universe
    both accept, for both conventions, including all three exit reasons —
    with or without a ``memo`` (memoization changes dispatch counts,
    never bytes)."""
    reg = obs_registry.default()
    with obs_trace.span("sparse.simulate",
                        shape=f"{board.height}x{board.width}",
                        tile=board.tile, live_tiles=board.live_tiles,
                        convention=config.convention):
        stats = SparseStats()
        run = _run_cuda if config.convention == Convention.CUDA else _run_c
        result = run(board, config, memo, stats)
    reg.inc("sparse_runs_total")
    reg.inc("sparse_generations_total", stats.generations)
    reg.inc("sparse_tiles_simulated_total", stats.tiles_active)
    reg.inc("sparse_tiles_computed_total", stats.tiles_computed)
    reg.set_gauge("sparse_tiles_per_generation", stats.tiles_per_generation())
    reg.set_gauge("sparse_occupancy", result.board.occupancy())
    return result
