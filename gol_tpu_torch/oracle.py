"""Serial NumPy oracle — the ground truth the port's engine is tested against.

A copy of ``gol_tpu/oracle.py``: the port imports nothing of the JAX
package, so it keeps its own ground truth (numpy only).

Plays the role of the reference's serial program (src/game.c): rule B3/S23 on a
torus (src/game.c:60-101), emptiness checked at the top of every generation
(src/game.c:177), similarity checked every SIMILARITY_FREQUENCY-th generation
by comparing the current and next generations (src/game.c:181-189), reported
count = ``generation - 1`` (src/game.c:202).

Also implements the CUDA program's divergent accounting (src/game_cuda.cu:
213-276) so the ``cuda`` variant can be differential-tested too — see
``gol_tpu_torch.config.Convention``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig


@dataclasses.dataclass
class Result:
    """Final state of a simulation run."""

    grid: np.ndarray  # uint8 {0,1}, shape (height, width)
    generations: int  # the count the reference would print


def neighbor_counts(grid: np.ndarray) -> np.ndarray:
    """Count the 8 Moore neighbors of every cell with toroidal wrap.

    The reference wraps by per-cell index remapping (src/game.c:69-86); with
    whole-array ops the same torus is 8 shifted copies.
    """
    g = grid
    counts = np.zeros(g.shape, dtype=np.uint8)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            counts += np.roll(g, (dy, dx), axis=(0, 1))
    return counts


def evolve(grid: np.ndarray) -> np.ndarray:
    """One generation of B3/S23 (src/game.c:88-98)."""
    g = np.asarray(grid, dtype=np.uint8)
    n = neighbor_counts(g)
    return ((n == 3) | ((n == 2) & (g == 1))).astype(np.uint8)


def _run_c(grid: np.ndarray, config: GameConfig) -> Result:
    """The serial/MPI loop shape (src/game.c:169-196).

    On a similarity exit the reference breaks *before* the buffer swap and
    prints the pre-swap buffer (src/game.c:183-189); the two buffers are equal
    when the check fires, so returning the new grid is byte-identical.
    """
    generation = 1
    counter = 0
    while grid.any() and generation <= config.gen_limit:
        new = evolve(grid)
        if config.check_similarity:
            counter += 1
            if counter == config.similarity_frequency:
                if np.array_equal(grid, new):
                    return Result(new, generation - 1)
                counter = 0
        grid = new
        generation += 1
    return Result(grid, generation - 1)


def _run_cuda(grid: np.ndarray, config: GameConfig) -> Result:
    """The CUDA loop shape (src/game_cuda.cu:222-276).

    Differences vs ``_run_c``: no emptiness test before the first evolve; the
    emptiness test runs on the *new* grid and breaks before the swap, so an
    empty exit keeps (and writes) the last non-empty generation; the counter
    is 0-based and printed un-decremented (src/game_cuda.cu:294).

    Deliberate divergence: the real binary's compare/empty kernels scan the
    *padded* arrays (src/game_cuda.cu:243,259) whose d_new_univ ghost ring is
    stale — the halo kernels only ever run on d_univ (src/game_cuda.cu:
    224-231) — so live leftover border bytes can delay its early exits by a
    generation when death/stabilization coincides with earlier live borders.
    This build checks the interior only (exits are never later than the
    binary's); reproducing the stale-memory artifact is a non-goal.
    """
    generation = 0
    counter = 0
    while generation < config.gen_limit:
        new = evolve(grid)
        if config.check_similarity:
            counter += 1
            if counter == config.similarity_frequency:
                if np.array_equal(grid, new):
                    break
                counter = 0
        if not new.any():
            break
        grid = new
        generation += 1
    return Result(grid, generation)


def run(grid: np.ndarray, config: GameConfig = DEFAULT_CONFIG) -> Result:
    """Run a full simulation on the host, returning final grid + count."""
    grid = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
    if grid.ndim != 2:
        raise ValueError(f"grid must be 2D, got shape {grid.shape}")
    if config.convention == Convention.CUDA:
        return _run_cuda(grid, config)
    return _run_c(grid, config)
