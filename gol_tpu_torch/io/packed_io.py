"""Grid files straight to and from packed word state, on one device or
over a mesh.

The port of ``gol_tpu/io/packed_io.py``: text bytes -> uint32 cell words on
the host (the native codec, ``native/codec.c``) -> one copy to the device,
and back — the uint8 cell grid never exists, on the host or on the device.
The state is the engine's packed form: an int32 (height, width/32) tensor
holding the uint32 bit patterns (bit j of word w = column 32w+j), or with a
mesh the row-major list of its (local_h, local_w/32) shards, each packed
from and unpacked into its own window of the file. Same file-layout
contract as the sharded reader: ``height x (width+1)`` bytes, the newline
column written by the east-edge shards.

In a multi-process run (``parallel/bootstrap.py``) each process packs and
unpacks only its own shards' windows, and the write goes to the output
file in place (JAX: ``atomic = process_count() == 1``): every rank owns
disjoint windows of one file, so a per-rank staging file and rename would
commit a partial grid. The lead sizes the file before any rank writes
(``io.sharded.size_shared``), and a vote closes the write. The
durability of a multi-process run is the manifested checkpoint lane's.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os

import numpy as np
import torch

from gol_tpu_torch import native, platform_env
from gol_tpu_torch.io.text_grid import create_sized, row_stride
from gol_tpu_torch.io import sharded
from gol_tpu_torch.parallel.mesh import Mesh, local_windows, windows
from gol_tpu_torch.resilience import STAGING_SUFFIX

BITS = 32
# Host-side pack granularity (text bytes per codec call) and device->host
# transfer granularity (packed bytes per fetch). Module-level so tests can
# shrink them to exercise the chunked paths on small grids.
_READ_CHUNK_BYTES = 128 << 20
_WRITE_CHUNK_BYTES = 64 << 20
# Codec threads, and the most fetched blocks waiting for them.
_WORKERS = os.cpu_count() or 4


def _check_shape(width: int, mesh: Mesh | None) -> None:
    cols = 1 if mesh is None else mesh.shape[1]
    if width % (BITS * cols) != 0:
        raise ValueError(
            f"packed I/O needs width ({width}) divisible by 32 x mesh cols ({cols})"
        )


def _chunk_rows(height: int, cap_rows: int) -> int:
    """Rows per codec call: at most the byte cap, and few enough that every
    worker of the pool gets a chunk."""
    return max(1, min(cap_rows, -(-height // _WORKERS)))


def read_packed(path: str, width: int, height: int, device=None,
                mesh: Mesh | None = None):
    """Text grid file -> packed int32 (height, width/32) tensor on ``device``,
    or with a ``mesh`` this process's list of word shards on their devices.

    Row chunks pack on a thread pool (the codec releases the GIL) into one
    host array, which goes to the device in one copy; on a mesh every shard
    packs its own window of the file. (The JAX package's pipelined
    chunk-by-chunk upload is not ported.)"""
    _check_shape(width, mesh)
    size, expected = os.path.getsize(path), height * row_stride(width)
    if size != expected:
        raise ValueError(
            f"{path}: size {size} != {expected} for a {height}x{width} text grid"
        )
    native.load()
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(height, row_stride(width)))
    if mesh is not None:
        def load_window(job) -> torch.Tensor:
            (rows, wcols), dev = job
            window = mm[rows, wcols.start * BITS:wcols.stop * BITS]
            words = native.pack_text(window, (wcols.stop - wcols.start) * BITS)
            return torch.from_numpy(words.view(np.int32)).to(dev)

        with concurrent.futures.ThreadPoolExecutor() as pool:
            return list(pool.map(load_window, zip(
                local_windows(height, width // BITS, mesh), mesh.devices)))
    dev = platform_env.resolve_device(device)
    out = np.empty((height, width // BITS), dtype=np.uint32)
    chunk = _chunk_rows(height, _READ_CHUNK_BYTES // row_stride(width))

    def pack_rows(r0: int) -> None:
        r1 = min(height, r0 + chunk)
        out[r0:r1] = native.pack_text(mm[r0:r1], width)

    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(pack_rows, range(0, height, chunk)))
    return torch.from_numpy(out.view(np.int32)).to(dev)


def write_packed(path: str, words, width: int, mesh: Mesh | None = None) -> None:
    """Packed word tensor (with a ``mesh``: this process's list of shards)
    -> text grid file, with no gather and no cell grid in between.

    Crash-consistent on one process: the bytes land in a
    ``<path>.inprogress`` sibling that atomically replaces ``path`` only
    once complete, so overwriting a prior snapshot can never leave a torn
    file as the only copy. Across processes the windows go to ``path`` in
    place (see the module docstring). Each shard
    writes its own window of the file, the newline column with the
    east-edge shards; its row chunks come to the host one at a time and
    unpack on a thread pool while the next chunk is fetched."""
    shards, shape = ([words], (1, 1)) if mesh is None else (list(words), mesh.shape)
    height, nwords = shards[0].shape[0] * shape[0], shards[0].shape[1] * shape[1]
    wins = windows(height, nwords, shape) if mesh is None else \
        local_windows(height, nwords, mesh)
    if len(shards) != len(wins):
        raise ValueError(f"this process holds {len(wins)} shards of the "
                         f"{shape[0]}x{shape[1]} mesh, got {len(shards)}")
    if nwords * BITS != width:
        raise ValueError(f"width {width} != {nwords} words x {BITS}")
    native.load()
    shared = mesh is not None and mesh.owners is not None
    dest = path if shared else path + STAGING_SUFFIX
    if shared:
        sharded.size_shared(dest, height * row_stride(width), mesh)
        sharded.voted(lambda: _unpack_into(dest, shards, wins, height, width),
                      f"writing {path}")
        return
    create_sized(dest, height * row_stride(width))
    _unpack_into(dest, shards, wins, height, width)
    os.replace(dest, path)


def _unpack_into(dest: str, shards, wins, height: int, width: int) -> None:
    """Unpack every shard into its window of the sized file ``dest``."""
    nwords = width // BITS
    mm = np.memmap(dest, dtype=np.uint8, mode="r+", shape=(height, row_stride(width)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        jobs = collections.deque()
        for shard, (rows, wcols) in zip(shards, wins):
            local_h, local_n = shard.shape
            east_edge = wcols.stop == nwords
            window = mm[rows, wcols.start * BITS:
                        wcols.stop * BITS + (1 if east_edge else 0)]
            chunk = _chunk_rows(local_h, _WRITE_CHUNK_BYTES // max(local_n * 4, 1))
            for r0 in range(0, local_h, chunk):
                block = shard[r0:r0 + chunk].cpu().numpy().view(np.uint32)
                if len(jobs) >= _WORKERS:
                    jobs.popleft().result()
                jobs.append(pool.submit(native.unpack_text, block,
                                        window[r0:r0 + block.shape[0]],
                                        local_n * BITS, east_edge))
        for job in jobs:
            job.result()
    mm.flush()
    del mm
