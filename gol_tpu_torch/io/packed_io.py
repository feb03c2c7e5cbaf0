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

Both directions overlap the host codec with the link. A single-device
read packs row chunks on a thread pool, each into its rows of one
preallocated tensor, and on the card copies each chunk from pinned host
memory on a copy stream as soon as it is packed. JAX concatenates its
uploaded parts, so it gates its pipeline to words of at most 2 GiB and to
more than one chunk; here nothing is concatenated, so there is no 2x
transient and no gate: every read is this one. A write keeps
``GOL_D2H_DEPTH`` device->host chunk copies in flight (JAX's knob and
default, ``d2h_depth``) and unpacks each on the codec pool as soon as it
lands.

In a multi-process run (``parallel/bootstrap.py``) each process packs and
unpacks only its own shards' windows, and the write goes to the output
file in place (JAX: ``atomic = process_count() == 1``): every rank owns
disjoint windows of one file, so a per-rank staging file and rename would
commit a partial grid. The lead sizes the file before any rank writes
(``io.sharded.size_shared``), and a vote closes the write. The
durability of a multi-process run is the manifested checkpoint lane's.
"""

from __future__ import annotations

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
# Codec threads.
_WORKERS = os.cpu_count() or 4
D2H_DEPTH_ENV = "GOL_D2H_DEPTH"


def _check_shape(width: int, mesh: Mesh | None) -> None:
    cols = 1 if mesh is None else mesh.shape[1]
    if width % (BITS * cols) != 0:
        raise ValueError(
            f"packed I/O needs width ({width}) divisible by 32 x mesh cols ({cols})"
        )


def d2h_depth() -> int:
    """Device->host chunk copies a write keeps in flight: ``GOL_D2H_DEPTH``,
    2 when unset or malformed (as JAX's), and at least 1."""
    try:
        depth = int(os.environ.get(D2H_DEPTH_ENV, "2"))
    except ValueError:
        depth = 2
    return max(1, depth)


def _chunk_rows(height: int, cap_rows: int) -> int:
    """Rows per codec call: at most the byte cap, and few enough that every
    worker of the pool gets a chunk."""
    return max(1, min(cap_rows, -(-height // _WORKERS)))


def read_packed(path: str, width: int, height: int, device=None,
                mesh: Mesh | None = None):
    """Text grid file -> packed int32 (height, width/32) tensor on ``device``,
    or with a ``mesh`` this process's list of word shards on their devices.

    Row chunks pack on a thread pool (the codec releases the GIL) into
    their rows of one preallocated tensor: on the CPU straight into it, on
    the card into a pinned block each, copied ``non_blocking`` on a copy
    stream as soon as it is packed, all copies complete on return. On a
    mesh every shard packs its own window of the file and goes to its
    device in one copy."""
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
    nwords = width // BITS
    words = torch.empty((height, nwords), dtype=torch.int32, device=dev)
    cuda = dev.type == "cuda"
    copies = torch.cuda.Stream(dev) if cuda else None
    if cuda:  # the tensor's memory may have served work queued there
        copies.wait_stream(torch.cuda.current_stream(dev))
    chunk = _chunk_rows(height, _READ_CHUNK_BYTES // row_stride(width))

    def pack_rows(r0: int):
        r1 = min(height, r0 + chunk)
        block = (torch.empty((r1 - r0, nwords), dtype=torch.int32, pin_memory=True)
                 if cuda else words[r0:r1])
        native.pack_text(mm[r0:r1], width, out=block.numpy().view(np.uint32))
        return r0, block

    with concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        jobs = [pool.submit(pack_rows, r0) for r0 in range(0, height, chunk)]
        for job in concurrent.futures.as_completed(jobs):
            r0, block = job.result()
            if cuda:
                with torch.cuda.stream(copies):
                    words[r0:r0 + block.shape[0]].copy_(block, non_blocking=True)
        if cuda:  # before the pinned blocks go
            copies.synchronize()
    return words


def write_packed(path: str, words, width: int, mesh: Mesh | None = None) -> None:
    """Packed word tensor (with a ``mesh``: this process's list of shards)
    -> text grid file, with no gather and no cell grid in between.

    Crash-consistent on one process: the bytes land in a
    ``<path>.inprogress`` sibling that atomically replaces ``path`` only
    once complete, so overwriting a prior snapshot can never leave a torn
    file as the only copy. Across processes the windows go to ``path`` in
    place (see the module docstring). Each shard
    writes its own window of the file, the newline column with the
    east-edge shards; its row chunks come to the host ``d2h_depth()``
    ahead and unpack on a thread pool as they land (``_unpack_into``)."""
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
    """Unpack every shard into its window of the sized file ``dest``.

    The shards' row chunks form one sequence, fetched ``depth =
    d2h_depth()`` ahead of the one being handed to the codec: each chunk's
    copy goes into one of ``2 x depth`` host blocks (pinned, for the
    card), ``non_blocking`` on its device's copy stream with an event per
    chunk, and unpacks on the codec pool once its event has fired, cut
    into one row piece per pool thread, so the codec keeps every thread
    busy at any depth. So at most ``depth`` copies run ahead and ``2 x
    depth`` fetched blocks are alive, as in JAX's write, and a block is
    refilled only after all of its unpack has finished. On the CPU the
    copies are plain copies."""
    nwords = width // BITS
    mm = np.memmap(dest, dtype=np.uint8, mode="r+", shape=(height, row_stride(width)))
    chunks = []  # (shard, first row, end row, its window, east edge)
    for shard, (rows, wcols) in zip(shards, wins):
        local_h, local_n = shard.shape
        east_edge = wcols.stop == nwords
        window = mm[rows, wcols.start * BITS:
                    wcols.stop * BITS + (1 if east_edge else 0)]
        step = _chunk_rows(local_h, _WRITE_CHUNK_BYTES // max(local_n * 4, 1))
        chunks += [(shard, r0, min(local_h, r0 + step), window, east_edge)
                   for r0 in range(0, local_h, step)]
    depth = d2h_depth()
    nblocks = min(2 * depth, len(chunks))
    cuda = any(s.device.type == "cuda" for s in shards)
    most = max((r1 - r0) * s.shape[1] for s, r0, r1, _, _ in chunks)
    blocks = [torch.empty(most, dtype=torch.int32, pin_memory=cuda)
              for _ in range(nblocks)]
    streams = {}  # a copy stream per card, after the work queued there
    for s in shards:
        if s.device.type == "cuda" and s.device not in streams:
            streams[s.device] = torch.cuda.Stream(s.device)
            streams[s.device].wait_stream(torch.cuda.current_stream(s.device))
    fetched, events = [None] * len(chunks), [None] * len(chunks)

    def fetch(i: int) -> None:
        shard, r0, r1, _, _ = chunks[i]
        block = blocks[i % nblocks][:(r1 - r0) * shard.shape[1]].view(
            r1 - r0, shard.shape[1])
        if shard.device.type == "cuda":
            stream = streams[shard.device]
            with torch.cuda.stream(stream):
                block.copy_(shard[r0:r1], non_blocking=True)
            events[i] = torch.cuda.Event()
            events[i].record(stream)
        else:
            block.copy_(shard[r0:r1])
        fetched[i] = block

    def unpack(i: int, pool) -> list:
        shard, r0, r1, window, east_edge = chunks[i]
        block = fetched[i].numpy().view(np.uint32)
        piece = -(-(r1 - r0) // _WORKERS)
        return [pool.submit(native.unpack_text, block[p:p + piece],
                            window[r0 + p:r0 + p + piece], shard.shape[1] * BITS,
                            east_edge)
                for p in range(0, r1 - r0, piece)]

    unpacks = [None] * len(chunks)
    with concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        for i in range(min(depth, len(chunks))):
            fetch(i)
        for i in range(len(chunks)):
            ahead = i + depth
            if ahead < len(chunks):
                if ahead >= nblocks:  # its block's last chunk is unpacked
                    for job in unpacks[ahead - nblocks]:
                        job.result()
                fetch(ahead)
            if events[i] is not None:
                events[i].synchronize()
            unpacks[i] = unpack(i, pool)
            fetched[i] = events[i] = None
        for jobs in unpacks:
            for job in jobs:
                job.result()
    mm.flush()
    del mm
