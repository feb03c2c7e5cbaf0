"""The distributed variants' grid I/O: every shard reads and writes its own
file window.

The port of ``gol_tpu/io/sharded.py``. The file is modeled as a ``height x
(width+1)`` byte matrix whose last column holds the newline chars — the
``MPI_Type_create_subarray`` view of the collective variant
(src/game_mpi_collective.c:174-196) — so the sharded reader refuses any file
of another size and reads cells by position through a strided memmap
window per shard, where the serial reader scans past newlines. Without a
mesh the whole grid is the one window; with one, the state is the mesh's
row-major list of shards (``parallel/mesh.py``).

- ``read_sharded`` / ``write_sharded``: the collective path (``collective``,
  ``openmp``, ``tpu``); with ``parallel=True`` the async path (``async``),
  whose per-shard windows overlap on a thread pool (the reference's iread
  waits at once). Shards in the last mesh column own their rows' newline
  column (src/game_mpi_collective.c:382-393), so the write needs no gather.
- ``read_gathered`` / ``write_gathered``: the master-scatter path (``mpi``):
  one serial read of the whole file, then the shards are scattered; the
  shards are gathered, then one serial write (src/game_mpi.c:201-239,
  429-467).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.io.text_grid import NEWLINE, ONE, ZERO, row_stride
from gol_tpu_torch.parallel.mesh import Mesh, gather, split, windows


def _file_view(path: str, width: int, height: int, mode: str) -> np.memmap:
    return np.memmap(path, dtype=np.uint8, mode=mode, shape=(height, row_stride(width)))


def _each(fn, jobs, parallel: bool) -> list:
    if parallel:
        with concurrent.futures.ThreadPoolExecutor() as pool:
            return list(pool.map(lambda job: fn(*job), jobs))
    return [fn(*job) for job in jobs]


def read_sharded(path: str, width: int, height: int, device=None,
                 parallel: bool = False, mesh: Mesh | None = None):
    """Load a grid file by position: a uint8 (height, width) tensor on
    ``device``, or with a mesh its list of shards, each read from its own
    window."""
    size = os.path.getsize(path)
    expected = height * row_stride(width)
    if size != expected:
        raise ValueError(
            f"{path}: size {size} != {expected} for a {height}x{width} text grid "
            f"(sharded I/O requires the exact height x (width+1) layout)"
        )
    cells = _file_view(path, width, height, "r")[:, :width]  # no newline column

    def load(window, dev) -> torch.Tensor:
        return torch.from_numpy((cells[window] == ONE).astype(np.uint8)).to(dev)

    if mesh is None:
        return load((slice(None), slice(None)), platform_env.resolve_device(device))
    return _each(load, list(zip(windows(height, width, mesh.shape), mesh.devices)),
                 parallel)


def write_sharded(path: str, grid, parallel: bool = False,
                  mesh: Mesh | None = None) -> None:
    """Write a grid tensor (with a mesh: its list of shards) into the file
    by position, each shard into its own window.

    The reference opens MODE_EXCL and delete-retries if the file exists
    (src/game_mpi_collective.c:429-436) — net effect is replacement, which
    is what sizing the file and writing every byte of it does."""
    shards, shape = ([grid], (1, 1)) if mesh is None else (list(grid), mesh.shape)
    height, width = shards[0].shape[0] * shape[0], shards[0].shape[1] * shape[1]
    text_grid.create_sized(path, height * row_stride(width))
    mm = _file_view(path, width, height, "r+")

    def store(window, shard) -> None:
        rows, cols = window
        mm[rows, cols] = shard.cpu().numpy() + ZERO
        if cols.stop == width:
            mm[rows, width] = NEWLINE  # the east-edge shards' newline column

    _each(store, list(zip(windows(height, width, shape), shards)), parallel)
    mm.flush()


def read_gathered(path: str, width: int, height: int, device=None,
                  mesh: Mesh | None = None):
    """Master-scatter read: one serial parse of the file
    (src/game_mpi.c:201-239), then the shards scattered to their devices."""
    host = text_grid.read_grid(path, width, height)
    if mesh is not None:
        return split(host, mesh)
    return torch.from_numpy(host).to(platform_env.resolve_device(device))


def write_gathered(path: str, grid, mesh: Mesh | None = None) -> None:
    """Gather-to-master write: the shards gathered, then one serial write
    (src/game_mpi.c:429-467)."""
    if mesh is not None:
        grid = gather(grid, mesh.shape)
    text_grid.write_grid(path, grid.cpu().numpy())
