"""The distributed variants' grid I/O in its single-device (1x1) form.

The port of ``gol_tpu/io/sharded.py`` for one device, where the whole grid
is the one shard. The file is modeled as a ``height x (width+1)`` byte
matrix whose last column holds the newline chars — the
``MPI_Type_create_subarray`` view of the collective variant
(src/game_mpi_collective.c:174-196) — so the sharded reader refuses any file
of another size and reads cells by position through a strided memmap
window, where the serial reader scans past newlines.

- ``read_sharded`` / ``write_sharded``: the collective path (``collective``,
  ``openmp``, ``tpu``); with ``parallel=True`` the async path (``async``),
  which overlaps the per-shard windows. One device has one window, so here
  ``parallel`` changes nothing, as in the JAX package's 1x1 form.
- ``read_gathered`` / ``write_gathered``: the master-scatter path (``mpi``):
  one serial read and write of the whole file (src/game_mpi.c:201-239,
  429-467).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.io.text_grid import NEWLINE, ONE, ZERO, row_stride


def _file_view(path: str, width: int, height: int, mode: str) -> np.memmap:
    return np.memmap(path, dtype=np.uint8, mode=mode, shape=(height, row_stride(width)))


def read_sharded(path: str, width: int, height: int, device=None,
                 parallel: bool = False) -> torch.Tensor:
    """Load a grid file by position into a uint8 (height, width) tensor."""
    size = os.path.getsize(path)
    expected = height * row_stride(width)
    if size != expected:
        raise ValueError(
            f"{path}: size {size} != {expected} for a {height}x{width} text grid "
            f"(sharded I/O requires the exact height x (width+1) layout)"
        )
    dev = platform_env.resolve_device(device)
    cells = _file_view(path, width, height, "r")[:, :width]  # no newline column
    return torch.from_numpy((cells == ONE).astype(np.uint8)).to(dev)


def write_sharded(path: str, grid: torch.Tensor, parallel: bool = False) -> None:
    """Write a grid tensor into its file window by position.

    The reference opens MODE_EXCL and delete-retries if the file exists
    (src/game_mpi_collective.c:429-436) — net effect is replacement, which
    is what sizing the file and writing every byte of it does. The one
    shard is also the east-edge shard, so it owns the newline column
    (src/game_mpi_collective.c:382-393).
    """
    height, width = grid.shape
    host = grid.cpu().numpy()
    text_grid.create_sized(path, height * row_stride(width))
    mm = _file_view(path, width, height, "r+")
    mm[:, :width] = host + ZERO
    mm[:, width] = NEWLINE
    mm.flush()


def read_gathered(path: str, width: int, height: int, device=None) -> torch.Tensor:
    """Master-scatter read: one serial parse of the file (src/game_mpi.c:201-239)."""
    dev = platform_env.resolve_device(device)
    return torch.from_numpy(text_grid.read_grid(path, width, height)).to(dev)


def write_gathered(path: str, grid: torch.Tensor) -> None:
    """Gather-to-master write: one serial write (src/game_mpi.c:429-467)."""
    text_grid.write_grid(path, grid.cpu().numpy())
