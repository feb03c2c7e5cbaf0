"""Sharded zarr word storage: the port of ``gol_tpu/io/ts_store.py``,
without TensorStore.

The JAX package stores the bitpacked word state through TensorStore's zarr
driver (BASELINE.md config 5's "sharded TensorStore I/O"). The port writes
and reads the same zarr v2 arrays itself, so a store written by either
package reads in the other: a ``.zarray`` of JAX's metadata, byte for byte
(``dtype "<u4"``, C order, ``.`` separators, blosc LZ4 at clevel 5 with
byte shuffle), and one chunk file ``"i.j"`` per chunk, each one blosc-1
frame (``native/zarr_codec.c``; the bytes may differ from c-blosc's, the
words they decode to do not). Edge chunks are stored full size, padded
with zeros; a missing chunk file reads back as the fill value (zeros).

The chunk grid aligns with the mesh's shard blocks (``_shard_chunks``), so
- every process writes ONLY its own shards (no gather, no cross-process
  traffic: the collective-write discipline of MPI_File_write_all),
- reads assemble each shard from the chunks it covers, onto any mesh,
- chunks encode in parallel on a codec pool, and a CUDA state comes to the
  host chunk by chunk, ``d2h_depth()`` copies ahead, as the packed write's.

The state is the engine's packed form, as ``io/packed_io.write_packed``
takes it: an int32 (height, width/32) tensor holding the uint32 words, or
with a ``mesh`` this process's row-major list of shards; ``write_words``
also takes the ``pipeline.HostSnapshot`` the async checkpoint writer
passes. Only file paths are served: an object store (a ``://`` path)
needs a network, and is refused with a ``ValueError``.

Failure semantics (JAX's): ``write_words`` NEVER deletes the only durable
copy of prior state. Overwriting an existing store writes a fresh
``<path>.inprogress`` sibling, fsyncs its chunk files and directory, and
swaps it in only after every shard is durable, so a crash mid-write leaves
the previous store readable (as ``path`` or, in the two-rename commit
window, ``path.replaced``, which ``read_words`` recovers). Shard-write
failures are awaited to completion, aggregated, and reported with the
failing shard indices; opens and transient shard writes retry under the
unified ``resilience.retry`` policy. In a multi-process run the lead
decides staging and creates the store, a barrier follows, every rank
writes its own shards, a vote precedes the commit barrier, and the lead
swaps.

Snapshots stored this way carry the same no-sidecar resume property as
text snapshots: the array plus its generation count (in the store path,
like gen_NNNNNN) is a complete checkpoint (``engine.resume_scalars``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.io import packed_io
from gol_tpu_torch.native import blosc
from gol_tpu_torch.parallel import bootstrap, collectives
from gol_tpu_torch.parallel.mesh import Mesh, local_windows, windows
from gol_tpu_torch.resilience import REPLACED_SUFFIX, STAGING_SUFFIX, faults, fsio
from gol_tpu_torch.resilience.retry import (
    DEFAULT_IO_RETRY,
    RetryPolicy,
    is_transient_io,
)

logger = logging.getLogger(__name__)

BITS = 32
# The store's switch, in the role of JAX's ``HAVE_TENSORSTORE``: the port
# needs nothing installed, so it is always on; a test turns it off (with
# JAX's) to run the lanes that fall back without a store.
HAVE_STORE = True
# Suffixes of the two-phase overwrite commit (shared package-wide so the
# checkpoint GC sweeps the same names the writers stage).
_INPROGRESS = STAGING_SUFFIX
_REPLACED = REPLACED_SUFFIX
_ZARRAY = ".zarray"
# JAX's spec leaves the compressor to TensorStore's zarr default.
COMPRESSOR = {"blocksize": 0, "clevel": 5, "cname": "lz4", "id": "blosc",
              "shuffle": -1}


def refuse_object_store(path: str) -> None:
    """An object-store path (``gs://``, ``s3://``, ...) needs a network,
    which the port's store never uses: a ``ValueError``."""
    if "://" in path:
        raise ValueError(
            f"{path}: an object-store zarr path needs a network; the "
            f"PyTorch port's zarr store takes file paths only")


def _require(path: str) -> None:
    if not HAVE_STORE:
        raise RuntimeError("the zarr store is switched off (ts_store.HAVE_STORE); "
                           "the POSIX text/packed lanes cover shared filesystems")
    refuse_object_store(path)


def metadata(shape, chunks) -> bytes:
    """The ``.zarray`` TensorStore writes for JAX's spec: compact JSON,
    sorted keys, no trailing newline."""
    return json.dumps({
        "chunks": list(chunks), "compressor": COMPRESSOR,
        "dimension_separator": ".", "dtype": "<u4", "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2,
    }, sort_keys=True, separators=(",", ":")).encode()


@dataclasses.dataclass(frozen=True)
class _Store:
    """An open store: its directory, shape and chunk grid."""

    path: str
    shape: tuple[int, int]
    chunks: tuple[int, int]

    def chunk_path(self, i: int, j: int) -> str:
        return os.path.join(self.path, f"{i}.{j}")


def _parse(path: str, meta: dict) -> _Store:
    """Check a ``.zarray`` is a word store as JAX's spec makes it: a 2-D
    ``<u4`` C-order array of blosc chunks, ``.``-separated, zero-filled."""
    problems = [
        f"{key} {meta.get(key)!r}" for key, ok in (
            ("zarr_format", meta.get("zarr_format") == 2),
            ("dtype", meta.get("dtype") == "<u4"),
            ("order", meta.get("order") == "C"),
            ("filters", not meta.get("filters")),
            ("dimension_separator", meta.get("dimension_separator", ".") == "."),
            ("fill_value", meta.get("fill_value") in (None, 0)),
            ("compressor", (meta.get("compressor") or {}).get("id") == "blosc"),
            ("shape", len(meta.get("shape", ())) == 2),
            ("chunks", len(meta.get("chunks", ())) == 2
             and all(int(c) > 0 for c in meta["chunks"])),
        ) if not ok]
    if problems:
        raise ValueError(f"{path}: not a word store this reader takes "
                         f"({', '.join(problems)})")
    return _Store(path, tuple(int(x) for x in meta["shape"]),
                  tuple(int(x) for x in meta["chunks"]))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _create(path: str, shape, chunks) -> _Store:
    """A new empty store at ``path``, replacing whatever was there
    (TensorStore's ``create=True, delete_existing=True``)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.unlink(path)
    os.makedirs(path)
    fd = os.open(os.path.join(path, _ZARRAY), os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                 0o644)
    try:
        fsio.write_all(fd, metadata(shape, chunks), "zarr store metadata")
        os.fsync(fd)
    finally:
        os.close(fd)
    return _Store(path, tuple(shape), tuple(chunks))


def _load(path: str) -> _Store:
    try:
        with open(os.path.join(path, _ZARRAY), "rb") as f:
            meta = json.loads(f.read())
    except FileNotFoundError:
        raise ValueError(f"{path}: no zarr store here (no {_ZARRAY})") from None
    except json.JSONDecodeError as err:
        raise ValueError(f"{path}: unreadable {_ZARRAY}: {err}") from None
    return _parse(path, meta)


def _open(path: str, retry: RetryPolicy, shape=None, chunks=None) -> _Store:
    """Open (or, with a shape, create) the store, with the fault hook and
    transient-outage retry applied."""

    def attempt():
        faults.on_ts_open()
        return _load(path) if shape is None else _create(path, shape, chunks)

    return retry.call(
        attempt,
        retryable=is_transient_io,
        on_retry=lambda n, err, delay: logger.warning(
            "zarr store open of %s failed (attempt %d, retrying in %.2fs): "
            "%s: %s", path, n, delay, type(err).__name__, err),
    )


def _shard_chunks(shape, mesh: Mesh | None):
    """Chunk grid aligned to the mesh decomposition: one chunk per shard
    block (or row-block chunks on a single device so writes parallelize)."""
    h, w = shape
    if mesh is None:
        rows = max(1, min(h, 4096))
        return (rows, w)
    mr, mc = mesh.shape
    return (math.ceil(h / mr), math.ceil(w / mc))


def _write_chunk(store: _Store, i: int, j: int, block: np.ndarray) -> None:
    """Encode one full-size chunk (uint32) and write it durably."""
    frame = blosc.encode(block.astype("<u4", copy=False))
    fd = os.open(store.chunk_path(i, j), os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                 0o644)
    try:
        fsio.write_all(fd, frame, "zarr chunk")
        os.fsync(fd)
    finally:
        os.close(fd)


def _chunk_jobs(store: _Store, shard: torch.Tensor, origin):
    """The chunks of one shard: (i, j, local row slice, local col slice).
    The grid aligns with the shards, so each chunk lies in one shard."""
    ch, cw = store.chunks
    r0, c0 = origin
    h, w = shard.shape
    return [(i, j, slice(i * ch - r0, min((i + 1) * ch, r0 + h) - r0),
             slice(j * cw - c0, min((j + 1) * cw, c0 + w) - c0))
            for i in range(r0 // ch, -(-(r0 + h) // ch))
            for j in range(c0 // cw, -(-(c0 + w) // cw))]


def _write_chunks(store: _Store, jobs) -> dict[int, Exception]:
    """Encode and write every chunk of ``jobs`` (shard index, shard, its
    chunk jobs); the first error of each shard, all chunks awaited.

    CPU shards encode from views of their rows (an edge chunk from a
    zero-padded copy). CUDA chunks come to the host ``d2h_depth()`` ahead
    into ``2 x depth`` pinned blocks, each copy ``non_blocking`` on its
    device's copy stream with an event, and encode on the pool once their
    event has fired; a block is refilled only after its encode is done."""
    ch, cw = store.chunks
    chunks = [(k, shard, *job) for k, shard, own in jobs for job in own]
    errors: dict[int, Exception] = {}
    if not chunks:
        return errors
    depth = packed_io.d2h_depth()
    cuda = any(s.device.type == "cuda" for _, s, *_ in chunks)
    nblocks = min(2 * depth, len(chunks))
    blocks = [torch.empty((ch, cw), dtype=torch.int32, pin_memory=True)
              for _ in range(nblocks)] if cuda else []
    streams = {}
    for _, s, *_ in chunks:
        if s.device.type == "cuda" and s.device not in streams:
            streams[s.device] = torch.cuda.Stream(s.device)
            streams[s.device].wait_stream(torch.cuda.current_stream(s.device))
    fetched, events = [None] * len(chunks), [None] * len(chunks)

    def fail(n: int, err: Exception) -> None:
        errors.setdefault(chunks[n][0], err)

    def fetch(n: int) -> None:
        _, shard, _, _, rows, cols = chunks[n]
        try:
            part = shard[rows, cols]
            full = part.shape == (ch, cw)
            if shard.device.type != "cuda":
                block = part.numpy().view(np.uint32)
                if not (full and part.is_contiguous()):
                    block = np.zeros((ch, cw), dtype=np.uint32)
                    block[:part.shape[0], :part.shape[1]] = part.numpy().view(np.uint32)
                fetched[n] = block
                return
            block = blocks[n % nblocks]
            if not full:
                block.zero_()
            stream = streams[shard.device]
            with torch.cuda.stream(stream):
                block[:part.shape[0], :part.shape[1]].copy_(part, non_blocking=True)
            events[n] = torch.cuda.Event()
            events[n].record(stream)
            fetched[n] = block.numpy().view(np.uint32)
        except Exception as e:  # noqa: BLE001 - attributed to its shard
            fail(n, e)

    def encode(n: int, block: np.ndarray) -> None:
        _, _, i, j, _, _ = chunks[n]
        _write_chunk(store, i, j, block)

    tasks = [None] * len(chunks)
    ahead = depth if cuda else len(chunks)
    with concurrent.futures.ThreadPoolExecutor(max_workers=packed_io._WORKERS) as pool:
        for n in range(min(ahead, len(chunks))):
            fetch(n)
        for n in range(len(chunks)):
            nxt = n + ahead
            if nxt < len(chunks):
                if nxt >= nblocks and tasks[nxt - nblocks] is not None:
                    # the last chunk in its block is encoded
                    concurrent.futures.wait([tasks[nxt - nblocks]])
                fetch(nxt)
            if fetched[n] is not None:
                try:
                    if events[n] is not None:
                        events[n].synchronize()
                    tasks[n] = pool.submit(encode, n, fetched[n])
                except Exception as e:  # noqa: BLE001 - attributed to its shard
                    fail(n, e)
            fetched[n] = events[n] = None
    for n, task in enumerate(tasks):
        if task is not None and task.exception() is not None:
            fail(n, task.exception())
    return errors


def _write_shards(store: _Store, shards, retry: RetryPolicy) -> None:
    """Submit every shard write, await ALL of them, aggregate failures.

    ``shards`` is this process's ``(tensor, (row0, col0))`` list. Every
    shard's chunks are drained each round; transient failures are
    re-submitted under the retry policy, and whatever remains raises ONE
    error naming the failed shard indices."""
    pending = list(enumerate(shards))
    delay = retry.base_delay
    for attempt in range(1, retry.attempts + 1):
        failures: dict[int, Exception] = {}
        jobs = []
        for i, (shard, origin) in pending:
            try:
                faults.on_ts_shard_write(i)
                jobs.append((i, shard, _chunk_jobs(store, shard, origin)))
            except Exception as e:  # noqa: BLE001 - submit-time failure still gets awaited peers
                failures[i] = e
        failures.update(_write_chunks(store, jobs))
        if not failures:
            return
        hard = [i for i, e in failures.items() if not is_transient_io(e)]
        if hard or attempt >= retry.attempts:
            indices = sorted(failures)
            detail = "; ".join(
                f"shard {i}: {type(failures[i]).__name__}: {failures[i]}"
                for i in indices)
            raise OSError(
                f"write_words: {len(failures)}/{len(shards)} shard writes "
                f"failed (shard indices {indices}): {detail}")
        logger.warning(
            "write_words: %d transient shard-write failure(s) (indices %s), "
            "retrying in %.2fs", len(failures), sorted(failures), delay)
        pending = [(i, shards[i]) for i in sorted(failures)]
        if delay > 0:
            time.sleep(delay)
        delay = retry.next_delay(delay)


def _swap_in(path: str, staged: str) -> None:
    """Commit ``staged`` over ``path``: old aside, new in, old gone. Between
    the renames the prior state survives as ``path.replaced`` — at no point
    do zero durable copies exist."""
    old = path + _REPLACED
    if os.path.exists(old):
        shutil.rmtree(old, ignore_errors=True)
    os.rename(path, old)
    os.rename(staged, path)
    shutil.rmtree(old, ignore_errors=True)


def _local_shards(words, width: int, mesh: Mesh | None):
    """(height, nwords, [(shard, (row0, col0))]) of this process's state."""
    state = getattr(words, "state", words)  # a pipeline.HostSnapshot
    shards, shape = ([state], (1, 1)) if mesh is None else (list(state), mesh.shape)
    height, nwords = shards[0].shape[0] * shape[0], shards[0].shape[1] * shape[1]
    wins = windows(height, nwords, shape) if mesh is None else \
        local_windows(height, nwords, mesh)
    if len(shards) != len(wins):
        raise ValueError(f"this process holds {len(wins)} shards of the "
                         f"{shape[0]}x{shape[1]} mesh, got {len(shards)}")
    if nwords * BITS != width:
        raise ValueError(f"width {width} != {nwords} words x {BITS}")
    return height, nwords, [(s, (rows.start, cols.start))
                            for s, (rows, cols) in zip(shards, wins)]


def write_words(
    path: str,
    words,
    width: int,
    mesh: Mesh | None = None,
    *,
    retry: RetryPolicy = DEFAULT_IO_RETRY,
) -> None:
    """Bitpacked state -> sharded zarr store, crash-consistently.

    Each process writes only its own shards; chunk boundaries equal shard
    boundaries, so no write crosses a chunk another process owns (the
    multi-writer safety MPI_File_write_all gets from its subarray views).
    Overwriting an existing store stages into ``.inprogress`` and swaps
    after all shards land (see the module docstring)."""
    _require(path)
    height, nwords, shards = _local_shards(words, width, mesh)
    chunks = _shard_chunks((height, nwords), mesh)
    blosc.load()

    multihost = bootstrap.process_count() > 1
    stage = os.path.exists(path)
    if multihost:
        # The staging decision feeds the target path, so every process must
        # make the same call: the lead's view of the shared FS wins.
        stage = bool(np.asarray(collectives.process_allgather(
            np.asarray(stage, np.int32))).ravel()[0])
    staged = None
    target = path
    if stage:
        # Never destroy the only durable copy: build the new store beside it.
        staged = path + _INPROGRESS
        target = staged
    if multihost:
        # Only the lead creates (a concurrent delete on every process would
        # clobber peers' chunks); a barrier orders create before any peer's
        # write. Barriers are never retried: a process re-entering one its
        # peers already passed would pair with the wrong one.
        create_err: Exception | None = None
        if bootstrap.process_index() == 0:
            try:
                if staged is not None:
                    shutil.rmtree(staged, ignore_errors=True)
                _open(target, retry, (height, nwords), chunks)
            except Exception as e:  # noqa: BLE001 - voted, then re-raised
                create_err = e
        # The lead's create failure must reach every process BEFORE peers
        # park at the create barrier.
        if not collectives.host_all_agree(create_err is None):
            if create_err is not None:
                raise create_err
            raise OSError(
                f"write_words: lead process failed to create {target}")
        collectives.barrier(f"gol_tpu_torch.ts_store.create:{target}")
        store = None  # opened inside the guarded region below
    else:
        if staged is not None:
            shutil.rmtree(staged, ignore_errors=True)
        store = _open(target, retry, (height, nwords), chunks)
    write_err: Exception | None = None
    try:
        if store is None:
            # The post-barrier open is guarded too: an open failure on one
            # process must reach the vote below, not bypass it.
            store = _open(target, retry)
        _write_shards(store, shards, retry)
        _fsync_dir(target)
    except Exception as e:
        if not (multihost and staged is not None):
            raise
        write_err = e
    if staged is not None:
        if multihost:
            # A process whose shard writes failed must not exit while its
            # peers park at the commit barrier: vote on success first, the
            # failing process voting False before re-raising, so everyone
            # abandons the staged store together (``path`` stays untouched).
            if not collectives.host_all_agree(write_err is None):
                if write_err is not None:
                    raise write_err
                raise OSError(
                    f"write_words: a peer process failed its shard writes; "
                    f"abandoning staged store {staged}")
            # Every shard everywhere is durable before anyone swaps; only
            # the lead renames, and peers wait for the commit.
            collectives.barrier(f"gol_tpu_torch.ts_store.commit:{path}")
            if bootstrap.process_index() == 0:
                _swap_in(path, staged)
            collectives.barrier(f"gol_tpu_torch.ts_store.committed:{path}")
        else:
            _swap_in(path, staged)


def _read_chunk(store: _Store, i: int, j: int, out: np.ndarray) -> None:
    """Chunk (i, j) -> ``out`` (its full uint32 shape); a missing chunk
    file is the fill value, zeros."""
    path = store.chunk_path(i, j)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        out.fill(0)
        return
    try:
        blosc.decode(data, out)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
    if sys.byteorder == "big":  # pragma: no cover - the chunks hold "<u4"
        out.byteswap(inplace=True)


def _read_region(store: _Store, rows: slice, cols: slice, dev: torch.device,
                 retry: RetryPolicy) -> torch.Tensor:
    """The words of ``[rows, cols]`` as an int32 tensor on ``dev``.

    The chunks it covers decode on the codec pool: on the CPU a full-width
    chunk straight into its rows, any other into a block whose part is
    copied in; on the card each into a pinned block, uploaded
    ``non_blocking`` on a copy stream as soon as it is decoded, all copies
    complete on return."""
    ch, cw = store.chunks
    out = torch.empty((rows.stop - rows.start, cols.stop - cols.start),
                      dtype=torch.int32, device=dev)
    cuda = dev.type == "cuda"
    copies = torch.cuda.Stream(dev) if cuda else None
    if cuda:  # the tensor's memory may have served work queued there
        copies.wait_stream(torch.cuda.current_stream(dev))
    cells = [(i, j) for i in range(rows.start // ch, -(-rows.stop // ch))
             for j in range(cols.start // cw, -(-cols.stop // cw))]

    def span(i: int, j: int):
        """The chunk's part of the region: its slices in the region and
        in the chunk."""
        r0, r1 = max(rows.start, i * ch), min(rows.stop, (i + 1) * ch)
        c0, c1 = max(cols.start, j * cw), min(cols.stop, (j + 1) * cw)
        return ((slice(r0 - rows.start, r1 - rows.start),
                 slice(c0 - cols.start, c1 - cols.start)),
                (slice(r0 - i * ch, r1 - i * ch), slice(c0 - j * cw, c1 - j * cw)))

    def load(ij):
        (dst, src) = span(*ij)
        whole = (src[0].stop - src[0].start, src[1].stop - src[1].start) == (ch, cw)
        if not cuda and whole and cw == out.shape[1]:
            retry.call(lambda: _read_chunk(store, *ij, out[dst].numpy().view(np.uint32)))
            return ij, None
        block = torch.empty((ch, cw), dtype=torch.int32, pin_memory=cuda)
        retry.call(lambda: _read_chunk(store, *ij, block.numpy().view(np.uint32)))
        return ij, block

    with concurrent.futures.ThreadPoolExecutor(max_workers=packed_io._WORKERS) as pool:
        jobs = [pool.submit(load, ij) for ij in cells]
        try:
            for job in concurrent.futures.as_completed(jobs):
                ij, block = job.result()
                if block is None:
                    continue
                dst, src = span(*ij)
                if cuda:
                    with torch.cuda.stream(copies):
                        out[dst].copy_(block[src], non_blocking=True)
                else:
                    out[dst].copy_(block[src])
        finally:
            if cuda:  # before the pinned blocks go
                copies.synchronize()
    return out


def read_words(
    path: str,
    width: int,
    height: int,
    mesh: Mesh | None = None,
    *,
    device=None,
    retry: RetryPolicy = DEFAULT_IO_RETRY,
):
    """Sharded zarr store -> bitpacked int32 (height, width/32) words: a
    CPU tensor, or on ``device``; with a ``mesh``, this process's list of
    shards on their devices, read side by side. The store may have any
    chunk grid (a store written on another mesh reads onto this one)."""
    _require(path)
    nwords = width // BITS
    if nwords * BITS != width:
        raise ValueError(f"width {width} must be a multiple of {BITS}")
    if not os.path.exists(path):
        # A crash inside _swap_in's two-rename window leaves the prior state
        # as path.replaced: recover it rather than failing the resume.
        displaced = path + _REPLACED
        if os.path.exists(displaced):
            logger.warning(
                "%s missing but %s exists (crash mid-overwrite); recovering "
                "the displaced prior state", path, displaced)
            try:
                os.rename(displaced, path)
            except OSError:
                # A peer process recovering the same shared-FS store won the
                # rename; losing the race is fine as long as someone did.
                if not os.path.exists(path):
                    raise
    store = _open(path, retry)
    if tuple(store.shape) != (height, nwords):
        raise ValueError(
            f"{path}: stored shape {tuple(store.shape)} != ({height}, {nwords})"
        )
    blosc.load()
    if mesh is None:
        dev = torch.device("cpu") if device is None else platform_env.resolve_device(device)
        return _read_region(store, slice(0, height), slice(0, nwords), dev, retry)
    jobs = list(zip(local_windows(height, nwords, mesh), mesh.devices))
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(
            lambda job: _read_region(store, *job[0], job[1], retry), jobs))
