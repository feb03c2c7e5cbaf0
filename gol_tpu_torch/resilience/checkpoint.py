"""Crash-consistent checkpoints: fresh payload + atomically-committed manifest.

The port of ``gol_tpu/resilience/checkpoint.py``, with the same files on
disk: a checkpoint directory written by either package restores in the
other. The write-ahead discipline:

1. the state is written to a **fresh payload path** (``ckpt-<gen>.<ext>``),
   never over the previous checkpoint;
2. a small JSON **manifest** (generation, similarity counter, grid geometry,
   geometry-keyed CRC32 checksums, payload name, run fingerprint) is
   written to a temp file, fsynced, and committed with ``os.replace``, the
   one atomic step. A checkpoint exists iff its manifest does;
3. older checkpoints are garbage-collected only **after** the new manifest
   is durable (manifest deleted before its payload).

Recovery (``restore``) walks manifests newest-first and returns the first
whose payload reads back and checksums clean.

The port's state is one tensor, or a mesh's row-major list of shard
tensors: (height, width) uint8 cells or (height, width/32) int32 words
holding the uint32 bit patterns. ``state_blocks`` maps it onto the shards'
windows of the global array, so the CRC blocks (keyed ``r0:r1,c0:c1``)
are the JAX package's for the same mesh, and ``run_fingerprint`` is its
positional digest, equal under any mesh. The payload encoding is the
codec's (``PayloadCodec``): the byte lane writes a text grid through the
variant's own I/O, the packed lane the packed text codec; both are
topology-independent, so a checkpoint taken on one mesh restores on
another.

The process is single: the JAX package's multi-process votes, allgathers
and barriers (its ``jax.process_count() > 1`` branches) come with
multi-process runs of the port, which are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from gol_tpu_torch.obs import registry as obs_registry, trace as obs_trace
from gol_tpu_torch.parallel.mesh import windows
from gol_tpu_torch.resilience import REPLACED_SUFFIX, STAGING_SUFFIX, faults
from gol_tpu_torch.resilience.retry import DEFAULT_IO_RETRY, RetryPolicy

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
_MANIFEST_SUFFIX = ".manifest.json"
_PREFIX = "ckpt-"


@dataclasses.dataclass(frozen=True)
class PayloadCodec:
    """How checkpoint state gets to and from disk; the manager owns naming,
    manifests and GC, the codec only the array encoding."""

    format: str  # recorded in the manifest; must match on restore
    suffix: str  # payload file extension, e.g. ".out"
    write: Callable[[str, Any], None]  # (path, state) -> None
    read: Callable[[str], Any]  # path -> state on the run's devices


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    generation: int  # completed generations (the reported count convention)
    counter: int  # similarity counter at that point
    path: str  # manifest path


def _block_key(r0: int, r1: int, c0: int, c1: int) -> str:
    return f"{r0}:{r1},{c0}:{c1}"


def _parse_key(key: str) -> tuple[int, int, int, int]:
    rows, cols = key.split(",")
    r0, r1 = (int(x) for x in rows.split(":"))
    c0, c1 = (int(x) for x in cols.split(":"))
    return r0, r1, c0, c1


def _shards(state) -> list:
    return list(state) if isinstance(state, (list, tuple)) else [state]


def _host(t: torch.Tensor) -> np.ndarray:
    """A shard's host array in the JAX package's dtype: uint8 cells, or
    the uint32 words an int32 word tensor holds."""
    arr = np.ascontiguousarray(t.cpu().numpy())
    return arr.view(np.uint32) if arr.dtype == np.int32 else arr


def state_shape(state, mesh_shape=(1, 1)) -> tuple[int, int]:
    """The global shape of a state laid over a ``mesh_shape`` mesh."""
    h, w = _shards(state)[0].shape
    return h * mesh_shape[0], w * mesh_shape[1]


def state_blocks(state, mesh_shape=(1, 1)):
    """``((r0, r1, c0, c1), ndarray)`` per shard of ``state``: its window of
    the global array (``parallel.mesh.windows``, row-major) and its host
    copy. The decomposition ``positional_digest`` and the CRC pass consume."""
    h, w = state_shape(state, mesh_shape)
    shards = _shards(state)
    if len(shards) != mesh_shape[0] * mesh_shape[1]:
        raise ValueError(f"a {mesh_shape[0]}x{mesh_shape[1]} mesh has "
                         f"{mesh_shape[0] * mesh_shape[1]} shards, got {len(shards)}")
    return [((rows.start, rows.stop, cols.start, cols.stop), _host(shard))
            for shard, (rows, cols) in zip(shards, windows(h, w, mesh_shape))]


def positional_digest(blocks) -> int:
    """Each cell of each ``((r0, r1, c0, c1), block)`` piece contributes
    ``value * mix(global_row, global_col)``, summed mod 2^64: commutative
    and per cell, so the same state digests identically under any block
    decomposition (the JAX package's ``positional_digest``, bit for bit)."""
    local = np.uint64(0)
    for (r0, r1, c0, c1), block in blocks:
        cc = (np.arange(c0, c1, dtype=np.uint64)[None, :] + np.uint64(1)) \
            * np.uint64(0xC2B2AE3D27D4EB4F)
        # Row chunks bound the uint64 temporaries at a full-size grid; the
        # sum is the same in any order.
        step = max(1, (1 << 22) // max(c1 - c0, 1))
        for i in range(0, r1 - r0, step):
            rr = np.arange(r0 + i, min(r1, r0 + i + step), dtype=np.uint64)[:, None]
            mix = (rr + np.uint64(1)) * np.uint64(0x9E3779B97F4A7C15) ^ cc
            with np.errstate(over="ignore"):
                local += (block[i:i + step].astype(np.uint64) * mix).sum(
                    dtype=np.uint64)
    return int(local)


def run_fingerprint(state, tag: str = "", mesh_shape=(1, 1)) -> str:
    """Fingerprint of a run's identity from its initial state: the
    positional digest over the mesh's windows, so the same grid gives the
    same fingerprint under any mesh (and equals the JAX package's).
    Recorded in each manifest and checked on restore, so a checkpoint
    directory reused with another input never hands an old run's state to
    a new run. ``tag`` folds in the convention."""
    total = positional_digest(state_blocks(state, mesh_shape))
    return f"{total:016x}" + (f":{tag}" if tag else "")


def _shard_checksums(state, mesh_shape=(1, 1)) -> dict[str, int]:
    """CRC32 per shard, keyed by the shard's window of the global array:
    geometry-keyed, so restore can re-verify under any mesh."""
    return {_block_key(*bounds): zlib.crc32(block)
            for bounds, block in state_blocks(state, mesh_shape)}


def _verify_checksums(state, checksums: dict[str, int], mesh_shape=(1, 1)) -> bool:
    """Re-slice every recorded block from the state's host copy and CRC it:
    any writer decomposition verifies against any reader mesh."""
    h, w = state_shape(state, mesh_shape)
    blocks = state_blocks(state, mesh_shape)
    host = np.empty((h, w), blocks[0][1].dtype)
    for (r0, r1, c0, c1), block in blocks:
        host[r0:r1, c0:c1] = block
    for key, want in checksums.items():
        r0, r1, c0, c1 = _parse_key(key)
        if zlib.crc32(np.ascontiguousarray(host[r0:r1, c0:c1])) != int(want):
            return False
    return True


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit_file(path: str, data: bytes) -> None:
    """Write ``data`` durably at ``path`` via tmp + fsync + atomic rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _rmtree_or_file(path: str) -> None:
    if os.path.isdir(path):
        import shutil

        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass


class CheckpointManager:
    """Atomic checkpoints for one run's geometry in one directory.

    ``keep`` retains that many newest checkpoints (>= 1); ``mesh_shape`` is
    the run's mesh, which lays the state's shards onto the global array.
    """

    def __init__(
        self,
        directory: str,
        *,
        height: int,
        width: int,
        codec: PayloadCodec,
        keep: int = 2,
        retry: RetryPolicy = DEFAULT_IO_RETRY,
        run_fingerprint: str | None = None,
        guard=None,
        mesh_shape=(1, 1),
    ):
        if keep < 1:
            raise ValueError(f"checkpoint keep must be >= 1, got {keep}")
        self.directory = directory
        self.height = height
        self.width = width
        self.codec = codec
        self.keep = keep
        self.retry = retry
        self.run_fingerprint = run_fingerprint
        self.mesh_shape = tuple(mesh_shape)
        # The disk-pressure watchdog (resilience/diskguard.DiskGuard) or
        # None: under its shed-checkpoints tier, saves are skipped loudly.
        self.guard = guard
        # Serializes --checkpoint-keep pruning against payload writes: the
        # async writer (pipeline/writer.py) runs ``_write_payload`` on a
        # background thread, and a prune sweeping the directory while a
        # codec stages payload files there could collect the in-flight
        # write's staging as stale.
        self._io_lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    # -- naming --------------------------------------------------------------

    def _manifest_path(self, generation: int) -> str:
        return os.path.join(self.directory,
                            f"{_PREFIX}{generation:08d}{_MANIFEST_SUFFIX}")

    def _payload_name(self, generation: int) -> str:
        return f"{_PREFIX}{generation:08d}{self.codec.suffix}"

    def _list_generations(self) -> list[int]:
        """Generations with a committed manifest, newest first."""
        gens = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if name.startswith(_PREFIX) and name.endswith(_MANIFEST_SUFFIX):
                digits = name[len(_PREFIX) : -len(_MANIFEST_SUFFIX)]
                if digits.isdigit():
                    gens.append(int(digits))
        return sorted(gens, reverse=True)

    # -- save ----------------------------------------------------------------

    def save(self, state, generation: int, counter: int) -> str:
        """Checkpoint ``state`` after ``generation`` completed generations
        and return the manifest path: payload first (fresh path), manifest
        committed atomically second, GC of older checkpoints last, so a
        crash at any point leaves the previous checkpoint intact. Every
        outcome is counted in the global registry, and the save is one
        trace span."""
        reg = obs_registry.default()
        if self.sheds_save():
            return self._manifest_path(generation)
        with obs_trace.span("checkpoint.save", generation=int(generation)):
            try:
                path = self._save(state, generation, counter)
            except BaseException:
                # BaseException: an InjectedCrash is counted too.
                reg.inc("checkpoint_save_failures_total")
                raise
        reg.inc("checkpoint_saves_total")
        return path

    def sheds_save(self) -> bool:
        """Disk-pressure shed decision for one boundary (the sync path's and
        the async writer's): tick the guard, and under its shed-checkpoints
        tier skip the save loudly, counted."""
        if self.guard is None:
            return False
        self.guard.tick()
        if self.guard.allow_checkpoints():
            return False
        obs_registry.default().inc("checkpoint_sheds_total")
        logger.warning(
            "checkpoint shed: %s is under disk pressure (%s, %s bytes "
            "free); the previous committed checkpoint remains the restore "
            "point", self.directory, self.guard.level_name,
            self.guard.free_bytes,
        )
        return True

    def _save(self, state, generation: int, counter: int) -> str:
        """The synchronous save: the staged phases back to back. The async
        writer drives the same phases but defers ``_commit_manifest`` to
        the next boundary and runs ``_write_payload`` on its thread."""
        faults.on_checkpoint_boundary(generation)
        if self._already_committed(generation):
            # A resumed run re-reached a boundary it had already committed;
            # the engine is bit-exact, so the existing checkpoint is this
            # state.
            return self._manifest_path(generation)
        self._sweep_stale(generation)
        sums = self._write_payload(state, generation)
        path = self._commit_manifest(state_shape(state, self.mesh_shape),
                                     generation, counter, sums)
        self.prune()
        return path

    def _already_committed(self, generation: int) -> bool:
        """Whether a valid checkpoint for ``generation`` already exists."""
        return (os.path.exists(self._manifest_path(generation))
                and self._load(generation) is not None)

    def _sweep_stale(self, generation: int) -> None:
        """Clear invalid leftovers at this generation's paths before writing."""
        _rmtree_or_file(self._manifest_path(generation))
        _rmtree_or_file(os.path.join(self.directory,
                                     self._payload_name(generation)))

    def _write_payload(self, state, generation: int) -> dict[str, int]:
        """Write the payload and checksum it. ``state`` may be the live
        state or a ``pipeline.HostSnapshot``'s host copy of it: both give
        the same payload bytes and CRC blocks."""
        payload_path = os.path.join(self.directory, self._payload_name(generation))
        # Serialized against prune(): the async writer runs this on its
        # thread, and the codecs stage files in the checkpoint directory.
        with self._io_lock:
            self.retry.call(lambda: self.codec.write(payload_path, state))
            faults.on_payload_write(payload_path)
        return _shard_checksums(state, self.mesh_shape)

    def _commit_manifest(self, state_shape, generation: int, counter: int,
                         checksums: dict[str, int]) -> str:
        """Commit the manifest atomically: the only phase that makes a
        checkpoint exist. The async writer defers exactly this call to the
        next boundary."""
        manifest = {
            "format_version": FORMAT_VERSION,
            "generation": int(generation),
            "counter": int(counter),
            "height": int(self.height),
            "width": int(self.width),
            "state_shape": [int(d) for d in state_shape],
            "payload": self._payload_name(generation),
            "payload_format": self.codec.format,
            "run_fingerprint": self.run_fingerprint,
            "checksums": checksums,
            "created_unix": time.time(),
        }
        path = self._manifest_path(generation)
        _commit_file(path, json.dumps(manifest, indent=1).encode())
        return path

    def prune(self) -> None:
        """``--checkpoint-keep`` pruning, behind the commit and under the
        lock the payload write holds. The ``prune`` fault boundary
        (kill_during_prune) fires inside, between a doomed checkpoint's
        manifest delete and its payload delete."""
        with self._io_lock:
            self._gc()

    def _manifest_is_foreign(self, generation: int) -> bool:
        """True when the manifest readably belongs to another run (its
        fingerprint exists and mismatches ours)."""
        if self.run_fingerprint is None:
            return False
        try:
            with open(self._manifest_path(generation)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False  # unreadable != foreign; restore() handles invalid
        return manifest.get("run_fingerprint") != self.run_fingerprint

    def _gc(self) -> None:
        """Drop all but the ``keep`` newest of this run's checkpoints,
        manifest first; foreign-run leftovers are garbage outright. Then
        sweep tmp/staging files and manifest-less payloads older than the
        newest."""
        gens, doomed = [], []
        for gen in self._list_generations():
            (doomed if self._manifest_is_foreign(gen) else gens).append(gen)
        doomed.extend(gens[self.keep :])
        for gen in doomed:
            manifest_path = self._manifest_path(gen)
            # A foreign manifest may name a payload of another lane; trust
            # its own record first, basename-d so it cannot reach outside
            # the checkpoint directory.
            payload_name = self._payload_name(gen)
            try:
                with open(manifest_path) as f:
                    payload_name = os.path.basename(
                        json.load(f).get("payload", payload_name))
            except (OSError, ValueError):
                pass
            _rmtree_or_file(manifest_path)
            # A crash here orphans a payload, never dangles a manifest.
            faults.on_checkpoint_prune(manifest_path)
            _rmtree_or_file(os.path.join(self.directory, payload_name))
        newest = gens[0] if gens else None
        live = {self._payload_name(g) for g in gens[: self.keep]}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.endswith(".tmp") or (
                name.startswith(_PREFIX)
                and name.endswith((STAGING_SUFFIX, REPLACED_SUFFIX))
            ):
                _rmtree_or_file(path)  # torn manifest commits, codec staging
            elif (
                name.startswith(_PREFIX)
                and name.endswith(self.codec.suffix)
                and name not in live
            ):
                digits = name[len(_PREFIX) : -len(self.codec.suffix)]
                if digits.isdigit() and newest is not None and int(digits) <= newest:
                    _rmtree_or_file(path)

    # -- restore -------------------------------------------------------------

    def _load(self, generation: int):
        """``(state, CheckpointInfo)`` of one checkpoint, or None if
        anything about it (manifest JSON, geometry, codec, fingerprint,
        payload read, checksums) fails to verify."""
        try:
            with open(self._manifest_path(generation)) as f:
                manifest = json.load(f)
            if manifest.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"unknown format_version {manifest.get('format_version')}")
            if (manifest["height"], manifest["width"]) != (self.height, self.width):
                raise ValueError(
                    f"geometry {manifest['height']}x{manifest['width']} != "
                    f"run geometry {self.height}x{self.width}")
            if manifest["payload_format"] != self.codec.format:
                raise ValueError(
                    f"payload format {manifest['payload_format']!r} != "
                    f"this lane's {self.codec.format!r}")
            if (
                self.run_fingerprint is not None
                and manifest.get("run_fingerprint") != self.run_fingerprint
            ):
                raise ValueError(
                    f"checkpoint belongs to a different run (fingerprint "
                    f"{manifest.get('run_fingerprint')!r} != this run's "
                    f"{self.run_fingerprint!r}) — stale checkpoint dir?")
            payload = os.path.join(self.directory, manifest["payload"])
            state = self.retry.call(lambda: self.codec.read(payload))
            shape = state_shape(state, self.mesh_shape)
            if shape != tuple(manifest["state_shape"]):
                raise ValueError(
                    f"payload shape {shape} != manifest "
                    f"{tuple(manifest['state_shape'])}")
            if not _verify_checksums(state, manifest["checksums"], self.mesh_shape):
                raise ValueError("shard checksum mismatch")
            return state, CheckpointInfo(
                generation=int(manifest["generation"]),
                counter=int(manifest["counter"]),
                path=self._manifest_path(generation),
            )
        except Exception as e:  # noqa: BLE001 - any defect means "not valid"
            logger.warning(
                "checkpoint %s/%s%08d invalid, trying older: %s: %s",
                self.directory, _PREFIX, generation, type(e).__name__, e)
            return None

    def restore(self, max_generation: int | None = None):
        """``(state, info)`` of the newest valid checkpoint, or None.

        ``max_generation`` skips checkpoints past it: a rerun with a reduced
        --gen-limit resumes from the newest checkpoint at or below the
        limit (an exact prefix of the shorter run) or starts fresh."""
        reg = obs_registry.default()
        with obs_trace.span("checkpoint.restore"):
            for gen in self._list_generations():
                if max_generation is not None and gen > max_generation:
                    continue
                loaded = self._load(gen)
                if loaded is not None:
                    logger.info("auto-resume: restored checkpoint at "
                                "generation %d from %s",
                                loaded[1].generation, loaded[1].path)
                    reg.inc("checkpoint_restores_total")
                    return loaded
                reg.inc("checkpoint_restore_rejected_total")
        return None
