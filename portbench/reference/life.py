"""The plain reference that decides ``correct``: Conway's Game of Life
(B3/S23) on a torus, run under the two loop conventions of the reference
program (v-pap/Game-of-Life-in-parallel-MPI-OpenMP-CUDA).

Plain PyTorch on whatever device its input is on. It imports nothing of
the program under test, and takes nothing the program made: it is handed
the same uint8 input grids the program is handed and works every result
out again from them.

Two forms of one generation:

- ``step_bytes``: the eight neighbours as eight rolls of the uint8 grid,
  the rule read off the count. Obviously right, and slow (at 16384^2 it is
  some seconds per thousand generations on one H100).
- ``step_words``: the same generation on 64 cells a word (bit j of word w
  of a row is column 64w + j). Its two horizontal neighbour planes come
  from one-bit shifts with the carry from the next word, its vertical ones
  from rolls of whole rows, and the count is a small adder network whose
  only output is "n is 2 or 3". Tests hold it to ``step_bytes``; the
  benchmark runs it, since it is about 30 plain tensor operations a
  generation on an eighth of the bytes.

``torus=False`` drops the wrap: every cell past an edge is dead. That is
the control of the benchmark's check, a run that breaks one guarantee the
configuration states (the torus), which the check has to call wrong.

The loops follow src/game.c:169-196 (``C``) and src/game_cuda.cu:222-276
(``CUDA``) generation by generation, with a host check where the program
checks: no generation is skipped and no exit is inferred.
"""

from __future__ import annotations

import torch

C, CUDA = "c", "cuda"
WORD_BITS = 64
_LOW63 = (1 << 63) - 1
# Bit weights of a word's cells: 2^j, with the sign bit for j = 63.
_WEIGHTS = [1 << j for j in range(WORD_BITS - 1)] + [-(1 << 63)]
# Rows packed or unpacked per call, so a 65536-wide grid needs no more
# than 2^26 int64 elements of scratch.
_BLOCK_CELLS = 1 << 26


def _shift(x: torch.Tensor, k: int, dim: int, torus: bool) -> torch.Tensor:
    """``x`` moved by ``k`` (+1 or -1) along ``dim``: element i of the
    result is element i - k of ``x``, wrapped on a torus, 0 past an edge
    otherwise."""
    if torus:
        return torch.roll(x, k, dims=dim)
    out = torch.zeros_like(x)
    n = x.shape[dim]
    if k > 0:
        out.narrow(dim, k, n - k).copy_(x.narrow(dim, 0, n - k))
    else:
        out.narrow(dim, 0, n + k).copy_(x.narrow(dim, -k, n + k))
    return out


def step_bytes(grid: torch.Tensor, torus: bool = True) -> torch.Tensor:
    """One generation of a uint8 0/1 grid: ``(n == 3) | (n == 2 & alive)``
    with ``n`` the live count of the eight neighbours."""
    n = torch.zeros(grid.shape, dtype=torch.uint8, device=grid.device)
    for dy in (-1, 0, 1):
        rows = _shift(grid, dy, 0, torus) if dy else grid
        for dx in (-1, 0, 1):
            if dy or dx:
                n += _shift(rows, dx, 1, torus) if dx else rows
    return ((n == 3) | ((n == 2) & (grid == 1))).to(torch.uint8)


def step_words(x: torch.Tensor, torus: bool = True) -> torch.Tensor:
    """One generation of int64 words, 64 cells a word (see the module
    docstring). Same result as ``step_bytes`` on the packed grid."""
    prev = _shift(x, 1, 1, torus)     # word w - 1 of the row
    nxt = _shift(x, -1, 1, torus)     # word w + 1
    west = (x << 1) | ((prev >> 63) & 1)        # cell c - 1 at c's bit
    east = ((x >> 1) & _LOW63) | (nxt << 63)    # cell c + 1
    del prev, nxt
    # Each row's horizontal count as two bit planes: with the cell itself
    # for the rows above and below, without it for the cell's own row.
    we = west ^ east
    row1 = west & east
    h0 = we ^ x
    h1 = row1 | (x & we)
    del west, east
    up0, up1 = _shift(h0, 1, 0, torus), _shift(h1, 1, 0, torus)
    dn0, dn1 = _shift(h0, -1, 0, torus), _shift(h1, -1, 0, torus)
    del h0, h1
    # n = n0 + 2 * (up1 + dn1 + row1 + carry); the cell lives next
    # generation iff the weight-2 sum is exactly 1 (n is 2 or 3) and
    # n0 | alive (n is 3, or n is 2 and the cell is alive).
    t = up0 ^ dn0
    n0 = t ^ we
    carry = (up0 & dn0) | (we & t)
    del t, up0, dn0, we
    a, b = up1 ^ dn1, up1 & dn1
    c, d = row1 ^ carry, row1 & carry
    return ((a ^ c) & ~(b | d)) & (n0 | x)


def pack(cells: torch.Tensor) -> torch.Tensor:
    """uint8 0/1 (H, W) cells -> int64 (H, W/64) words; W % 64 == 0."""
    height, width = cells.shape
    if width % WORD_BITS:
        raise ValueError(f"width {width} is not a multiple of {WORD_BITS}")
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=cells.device)
    out = torch.empty((height, width // WORD_BITS), dtype=torch.int64,
                      device=cells.device)
    rows = max(1, _BLOCK_CELLS // width)
    for r in range(0, height, rows):
        block = cells[r:r + rows].reshape(-1, width // WORD_BITS, WORD_BITS)
        out[r:r + rows] = ((block != 0).to(torch.int64) * weights).sum(-1)
    return out


def unpack_rows(words: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows ``r0:r1`` of the int64 words as uint8 0/1 cells."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (words[r0:r1].unsqueeze(-1) >> shifts) & 1
    return bits.to(torch.uint8).reshape(r1 - r0, -1)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """int64 (H, W/64) words -> uint8 0/1 (H, W) cells, in blocks of rows."""
    height, nwords = words.shape
    width = nwords * WORD_BITS
    cells = torch.empty((height, width), dtype=torch.uint8, device=words.device)
    rows = max(1, _BLOCK_CELLS // width)
    for r in range(0, height, rows):
        r1 = min(height, r + rows)
        cells[r:r1] = unpack_rows(words, r, r1)
    return cells


def cells_differing(words: torch.Tensor, cells: torch.Tensor) -> int:
    """How many cells of ``cells`` (any uint8 grid) differ from the 0/1
    grid the ``words`` pack, compared in blocks of rows."""
    height, width = cells.shape
    if tuple(words.shape) != (height, width // WORD_BITS):
        raise ValueError(f"words {tuple(words.shape)} do not pack a "
                         f"{height}x{width} grid")
    rows = max(1, _BLOCK_CELLS // width)
    wrong = 0
    for r in range(0, height, rows):
        r1 = min(height, r + rows)
        wrong += int((unpack_rows(words, r, r1) != cells[r:r1]).sum())
    return wrong


def run(cells: torch.Tensor, gen_limit: int, similarity_frequency: int,
        check_similarity: bool, convention: str, torus: bool = True):
    """One simulation from the uint8 0/1 ``cells``: ``(final, generations)``
    with ``generations`` the count the reference program prints. ``final``
    is int64 words where the width packs into them, uint8 cells otherwise
    (``wrong_cells`` compares either with a grid of cells)."""
    if cells.shape[1] % WORD_BITS == 0:
        grid, step = pack(cells), step_words
    else:
        grid, step = (cells != 0).to(torch.uint8), step_bytes
    if convention == C:
        return _run_c(grid, step, gen_limit, similarity_frequency,
                      check_similarity, torus)
    if convention == CUDA:
        return _run_cuda(grid, step, gen_limit, similarity_frequency,
                         check_similarity, torus)
    raise ValueError(f"unknown convention {convention!r}")


def _run_c(grid, step, limit, freq, check, torus):
    """src/game.c:177-196: emptiness at the top of every generation; the
    similarity break (current == next, every ``freq``-th generation) does
    not count; the count printed is ``generation - 1``."""
    generation, counter = 1, 0
    while bool(grid.any()) and generation <= limit:
        new = step(grid, torus)
        if check:
            counter += 1
            if counter == freq:
                if torch.equal(grid, new):
                    return new, generation - 1
                counter = 0
        grid = new
        generation += 1
    return grid, generation - 1


def _run_cuda(grid, step, limit, freq, check, torus):
    """src/game_cuda.cu:222-276: no emptiness test before the first
    generation; the similarity and the emptiness tests break before the
    swap, so an empty exit keeps the last live generation; the count
    printed is the 0-based counter."""
    generation, counter = 0, 0
    while generation < limit:
        new = step(grid, torus)
        if check:
            counter += 1
            if counter == freq:
                if torch.equal(grid, new):
                    break
                counter = 0
        if not bool(new.any()):
            break
        grid = new
        generation += 1
    return grid, generation


def wrong_cells(final: torch.Tensor, cells: torch.Tensor) -> int:
    """Cells of ``cells`` that differ from ``run``'s ``final``."""
    if final.dtype == torch.uint8:
        return int((final != cells).sum())
    return cells_differing(final, cells)
