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

In a multi-process run (``parallel/bootstrap.py``) every process reads and
writes only its own shards' windows (the MPI-IO file-view property,
src/game_mpi_collective.c:186-196): the lead sizes the shared output file
with ``create_sized``, which never truncates a peer's bytes, before any
rank writes, and a vote closes the write (``voted``: a rank that failed
makes every rank raise, none waits for ever). The gathered lane parses the
whole file in every process, each keeping its shards, and gathers the grid
on the lead alone, which writes it (the reference's rank 0,
src/game_mpi.c:441-462).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.io.text_grid import NEWLINE, ONE, ZERO, row_stride
from gol_tpu_torch.parallel import bootstrap, collectives
from gol_tpu_torch.parallel.mesh import Mesh, gather, local_windows, split, windows


def _file_view(path: str, width: int, height: int, mode: str) -> np.memmap:
    return np.memmap(path, dtype=np.uint8, mode=mode, shape=(height, row_stride(width)))


def _shared(mesh: Mesh | None) -> bool:
    """Whether the file is shared with the other ranks of the run."""
    return mesh is not None and mesh.owners is not None


def voted(fn, what: str) -> None:
    """Run ``fn`` in every process of a multi-process run and vote on its
    success; the vote is the barrier. Every process raises if any failed
    (the one that failed, its own error), so none is left waiting in a
    collective its peers never reach."""
    err = None
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - voted, then re-raised
        err = e
    if not collectives.host_all_agree(err is None):
        if err is not None:
            raise err
        raise RuntimeError(f"{what}: a peer process failed")


def size_shared(path: str, size: int, mesh: Mesh | None) -> None:
    """Create or size the output file. On a multi-process mesh only the
    lead does, and every rank waits for it before writing its windows."""
    if not _shared(mesh):
        text_grid.create_sized(path, size)
        return
    voted(lambda: mesh.rank == 0 and text_grid.create_sized(path, size),
          f"sizing {path}")


def _each(fn, jobs, parallel: bool) -> list:
    if parallel:
        with concurrent.futures.ThreadPoolExecutor() as pool:
            return list(pool.map(lambda job: fn(*job), jobs))
    return [fn(*job) for job in jobs]


def read_sharded(path: str, width: int, height: int, device=None,
                 parallel: bool = False, mesh: Mesh | None = None):
    """Load a grid file by position: a uint8 (height, width) tensor on
    ``device``, or with a mesh this process's list of shards, each read
    from its own window."""
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
    return _each(load, list(zip(local_windows(height, width, mesh), mesh.devices)),
                 parallel)


def write_sharded(path: str, grid, parallel: bool = False,
                  mesh: Mesh | None = None) -> None:
    """Write a grid tensor (with a mesh: this process's list of shards)
    into the file by position, each shard into its own window.

    The reference opens MODE_EXCL and delete-retries if the file exists
    (src/game_mpi_collective.c:429-436) — net effect is replacement, which
    is what sizing the file and writing every byte of it does."""
    shards, shape = ([grid], (1, 1)) if mesh is None else (list(grid), mesh.shape)
    height, width = shards[0].shape[0] * shape[0], shards[0].shape[1] * shape[1]
    size_shared(path, height * row_stride(width), mesh)
    wins = windows(height, width, shape) if mesh is None else \
        local_windows(height, width, mesh)

    def write() -> None:
        # Opened inside the vote: a rank that cannot open the file still
        # votes once, as its peers do.
        mm = _file_view(path, width, height, "r+")

        def store(window, shard) -> None:
            rows, cols = window
            mm[rows, cols] = shard.cpu().numpy() + ZERO
            if cols.stop == width:
                mm[rows, width] = NEWLINE  # the east-edge shards' newline column

        _each(store, list(zip(wins, shards)), parallel)
        mm.flush()

    if _shared(mesh):
        voted(write, f"writing {path}")
    else:
        write()


def read_gathered(path: str, width: int, height: int, device=None,
                  mesh: Mesh | None = None):
    """Master-scatter read: one serial parse of the file
    (src/game_mpi.c:201-239), then the shards scattered to their devices
    (in a multi-process run every process parses it and keeps its own)."""
    host = text_grid.read_grid(path, width, height)
    if mesh is not None:
        return split(host, mesh)
    return torch.from_numpy(host).to(platform_env.resolve_device(device))


def write_gathered(path: str, grid, mesh: Mesh | None = None) -> None:
    """Gather-to-master write: the shards gathered, then one serial write
    (src/game_mpi.c:429-467). Across processes the lead receives every
    peer's shards (one message per peer, its shards in global order) and
    writes; the peers wait for its vote."""
    if _shared(mesh):
        full = _gather_to_lead(list(grid), mesh)
        voted(lambda: full is not None and text_grid.write_grid(path, full),
              f"writing {path}")
        return
    if mesh is not None:
        grid = gather(grid, mesh.shape)
    text_grid.write_grid(path, grid.cpu().numpy())


def _gather_to_lead(shards: list, mesh: Mesh):
    """The grid on the lead (a host array), None on the other ranks: the
    reference's MPI_Recv-per-rank gather loop (src/game_mpi.c:441-458)."""
    import torch.distributed as dist

    group = bootstrap.world().host_group
    h, w = shards[0].shape
    if mesh.rank != 0:
        flat = torch.cat([s.reshape(-1).cpu() for s in shards])
        dist.send(flat, dst=0, group=group)
        return None
    every = windows(h * mesh.shape[0], w * mesh.shape[1], mesh.shape)
    full = np.empty((h * mesh.shape[0], w * mesh.shape[1]), np.uint8)
    for i, s in zip(mesh.local, shards):
        full[every[i]] = s.cpu().numpy()
    for peer in sorted(set(mesh.owners) - {0}):
        owned = [i for i, r in enumerate(mesh.owners) if r == peer]
        flat = torch.empty(len(owned) * h * w, dtype=torch.uint8)
        dist.recv(flat, src=peer, group=group)
        for k, i in enumerate(owned):
            full[every[i]] = flat[k * h * w:(k + 1) * h * w].view(h, w).numpy()
    return full
