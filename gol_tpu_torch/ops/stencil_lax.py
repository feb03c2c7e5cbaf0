"""Byte-per-cell 3x3 Moore stencil in plain torch — the any-shape path.

The port of ``gol_tpu/ops/stencil_lax.py``'s ``evolve_torus`` (the toroidal
wrap as whole-tensor rolls, the index-remapping wrap of src/game.c:69-86),
``evolve_padded`` (a mesh shard from its halo-extended block) and
``evolve_padded_batch`` (B halo-extended tiles with per-tile flags). The
JAX package has no Pallas kernel behind the first two, so plain torch is
their implementation on both the CPU and the card; ``auto`` picks them for
widths that do not pack into 32-bit words. ``evolve_padded_batch`` is the
plain version of T1 (``stencil_tile``), the sparse and macro lanes' kernel.
"""

from __future__ import annotations

import torch


def _apply_rule(neighbors: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    # B3/S23 (src/game.c:91-98): born on 3, survive on 2.
    return ((neighbors == 3) | ((neighbors == 2) & (center == 1))).to(torch.uint8)


def neighbor_counts_torus(grid: torch.Tensor) -> torch.Tensor:
    """Sum of the 8 Moore neighbors with toroidal wrap (uint8 is enough).

    Separable: the vertical triple sum of each column, then its horizontal
    triple sum, minus the center — the same counts as eight shifted copies
    with half the rolls."""
    col = grid + torch.roll(grid, 1, dims=0) + torch.roll(grid, -1, dims=0)
    return col + torch.roll(col, 1, dims=1) + torch.roll(col, -1, dims=1) - grid


def evolve_torus(grid: torch.Tensor) -> torch.Tensor:
    """One generation of the full torus of uint8 {0,1} cells."""
    return _apply_rule(neighbor_counts_torus(grid), grid)


def evolve_padded(padded: torch.Tensor) -> torch.Tensor:
    """One generation for the interior of a halo-extended (h+2, w+2) shard
    block (the src/game_mpi.c:73-84 shape); the mesh form of ``lax``. Any
    leading dimensions are a batch of blocks."""
    col = padded[..., :-2, :] + padded[..., 1:-1, :] + padded[..., 2:, :]
    center = padded[..., 1:-1, 1:-1]
    neighbors = col[..., :-2] + col[..., 1:-1] + col[..., 2:] - center
    return _apply_rule(neighbors, center)


def evolve_padded_batch(blocks: torch.Tensor):
    """One generation over B independent halo-extended (h+2, w+2) blocks,
    with the per-block flags the sparse tile engine consumes: ``(interiors
    (B, h, w), alive (B,), changed (B,))`` — any live interior cell, and any
    interior cell that differs from the block's own. Interior cells read
    only in-block neighbours (no wrap)."""
    new = evolve_padded(blocks)
    old = blocks[:, 1:-1, 1:-1]
    return new, new.flatten(1).any(1), (new != old).flatten(1).any(1)
