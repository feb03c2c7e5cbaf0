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

In a multi-process run (``parallel/bootstrap.py``) each process holds its
own shards (``local``: their global indices), and the JAX package's
protocol runs over the ranks (``parallel/collectives.py``):
``run_fingerprint`` all-gathers its 16-bit limbs; a save votes on whether
the generation is already committed, lets the lead sweep stale leftovers
behind a barrier, writes every rank's payload windows (an error is
returned, then voted), merges every rank's CRCs, and commits the manifest
on the lead alone between two barriers; ``--checkpoint-keep`` pruning runs
on the lead; a restore walks the union of every rank's candidates, each
checked locally (collective-free) and decided by one collective per
candidate, so no two ranks resume from different generations.
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
from gol_tpu_torch.parallel import bootstrap, collectives
from gol_tpu_torch.parallel.mesh import windows
from gol_tpu_torch.resilience import REPLACED_SUFFIX, STAGING_SUFFIX, faults
from gol_tpu_torch.resilience.retry import DEFAULT_IO_RETRY, RetryPolicy

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
_MANIFEST_SUFFIX = ".manifest.json"
_PREFIX = "ckpt-"
_LIMB_BITS, _LIMB_COUNT = 16, 4
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class PayloadCodec:
    """How checkpoint state gets to and from disk; the manager owns naming,
    manifests and GC, the codec only the array encoding."""

    format: str  # recorded in the manifest; must match on restore
    suffix: str  # payload file extension, e.g. ".out"
    write: Callable[[str, Any], None]  # (path, state) -> None
    read: Callable[[str], Any]  # path -> state on the run's devices
    # True when write/read run their own RetryPolicy internally (the zarr
    # codec): the manager then must not stack its outer retry on top.
    self_retrying: bool = False


@dataclasses.dataclass(frozen=True)
class CheckpointInfo:
    generation: int  # completed generations (the reported count convention)
    counter: int  # similarity counter at that point
    path: str  # manifest path


@dataclasses.dataclass(frozen=True)
class _LoadedCheckpoint:
    """One process's local view of a candidate checkpoint: its state, and
    which recorded blocks this process could check."""

    state: Any
    info: CheckpointInfo
    local_ok: bool  # every block this process checked matched
    verified: frozenset  # keys of the blocks this process checked
    recorded: frozenset  # every key the manifest records


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


def state_blocks(state, mesh_shape=(1, 1), local=None):
    """``((r0, r1, c0, c1), ndarray)`` per shard of ``state``: its window of
    the global array (``parallel.mesh.windows``, row-major) and its host
    copy. ``local`` is the shards' global indices in a multi-process run
    (None: every shard). The decomposition ``positional_digest`` and the
    CRC pass consume."""
    h, w = state_shape(state, mesh_shape)
    shards = _shards(state)
    every = windows(h, w, mesh_shape)
    if local is None:
        if len(shards) != len(every):
            raise ValueError(f"a {mesh_shape[0]}x{mesh_shape[1]} mesh has "
                             f"{len(every)} shards, got {len(shards)}")
        local = range(len(every))
    elif len(shards) != len(local):
        raise ValueError(f"this process holds {len(local)} shards, got {len(shards)}")
    return [((every[i][0].start, every[i][0].stop, every[i][1].start,
              every[i][1].stop), _host(shard)) for shard, i in zip(shards, local)]


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


def _fingerprint_limbs(partial: int) -> np.ndarray:
    """A 64-bit digest partial as four 16-bit limbs: summed over the ranks
    without overflow, then carried (JAX ``_fingerprint_limbs``)."""
    return np.asarray([(partial >> (_LIMB_BITS * i)) & 0xFFFF
                       for i in range(_LIMB_COUNT)], np.int32)


def _merge_fingerprint_limbs(everyone) -> int:
    """``sum(partials) mod 2**64`` from every rank's limbs."""
    sums = np.asarray(everyone, np.int64).reshape(-1, _LIMB_COUNT).sum(axis=0)
    return sum(int(v) << (_LIMB_BITS * i) for i, v in enumerate(sums)) & _MASK64


def run_fingerprint(state, tag: str = "", mesh_shape=(1, 1), local=None) -> str:
    """Fingerprint of a run's identity from its initial state: the
    positional digest over the mesh's windows, so the same grid gives the
    same fingerprint under any mesh (and equals the JAX package's); in a
    multi-process run the sum over every rank's shards. Recorded in each
    manifest and checked on restore, so a checkpoint directory reused with
    another input never hands an old run's state to a new run. ``tag``
    folds in the convention."""
    total = positional_digest(state_blocks(state, mesh_shape, local))
    if bootstrap.process_count() > 1:
        everyone = collectives.process_allgather(_fingerprint_limbs(total))
        total = _merge_fingerprint_limbs(everyone)
    return f"{total:016x}" + (f":{tag}" if tag else "")


def _shard_checksums(state, mesh_shape=(1, 1), local=None) -> dict[str, int]:
    """CRC32 per shard, keyed by the shard's window of the global array:
    geometry-keyed, so restore can re-verify under any mesh."""
    return {_block_key(*bounds): zlib.crc32(block)
            for bounds, block in state_blocks(state, mesh_shape, local)}


def _allgather_json(obj) -> list:
    """One JSON value per process, in rank order: a length-prefixed byte
    blob through ``process_allgather`` (JAX ``_allgather_json``)."""
    blob = np.frombuffer(json.dumps(obj, sort_keys=True).encode(), np.uint8)
    lens = collectives.process_allgather(np.asarray([len(blob)], np.int64)).ravel()
    padded = np.zeros((max(int(lens.max()), 1),), np.uint8)
    padded[: len(blob)] = blob
    everyone = collectives.process_allgather(padded)
    return [json.loads(bytes(everyone[i, : int(n)]).decode())
            for i, n in enumerate(lens)]


def _allgather_checksums(sums: dict[str, int]) -> dict[str, int]:
    """Union of every process's shard checksums: the manifest the lead
    commits covers every rank's shards."""
    if bootstrap.process_count() == 1:
        return sums
    merged: dict[str, int] = {}
    for peer in _allgather_json(sums):
        merged.update(peer)
    return merged


def _verify_checksums(state, checksums: dict[str, int], mesh_shape=(1, 1),
                      local=None) -> tuple[bool, set]:
    """Local re-verification: ``(every checked block matched, keys
    checked)``. Collective-free, so a process that fails anywhere in
    ``_load`` can skip it without desynchronizing its peers.

    On one process every recorded block is re-sliced from the host copy,
    so any writer decomposition verifies against any reader mesh. Across
    processes a block is checked where this process's shards tile it
    (assembled across them if it straddles several) and skipped where part
    of it lives on a peer; ``_collective_is_valid`` pools the keys."""
    h, w = state_shape(state, mesh_shape)
    blocks = state_blocks(state, mesh_shape, local)
    ok, verified = True, set()
    if local is None:
        host = np.empty((h, w), blocks[0][1].dtype)
        for (r0, r1, c0, c1), block in blocks:
            host[r0:r1, c0:c1] = block
        for key, want in checksums.items():
            r0, r1, c0, c1 = _parse_key(key)
            if zlib.crc32(np.ascontiguousarray(host[r0:r1, c0:c1])) != int(want):
                ok = False
            else:
                verified.add(key)
        return ok, verified
    for key, want in checksums.items():
        r0, r1, c0, c1 = _parse_key(key)
        pieces, covered = [], 0
        for (sr0, sr1, sc0, sc1), block in blocks:
            ir0, ir1, ic0, ic1 = max(r0, sr0), min(r1, sr1), max(c0, sc0), min(c1, sc1)
            if ir0 < ir1 and ic0 < ic1:
                pieces.append(((ir0, ir1, ic0, ic1), (sr0, sc0), block))
                covered += (ir1 - ir0) * (ic1 - ic0)
        if covered != (r1 - r0) * (c1 - c0):
            continue  # part of the block lives on a peer; the vote pools this
        region = np.empty((r1 - r0, c1 - c0), blocks[0][1].dtype)
        for (ir0, ir1, ic0, ic1), (sr0, sc0), block in pieces:
            region[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = \
                block[ir0 - sr0:ir1 - sr0, ic0 - sc0:ic1 - sc0]
        if zlib.crc32(np.ascontiguousarray(region)) != int(want):
            ok = False
        else:
            verified.add(key)
    return ok, verified


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
    the run's mesh, which lays the state's shards onto the global array;
    ``local`` the global indices of this process's shards in a
    multi-process run (None: every shard is here).
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
        local=None,
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
        self.local = None if local is None else tuple(local)
        self.multihost = bootstrap.process_count() > 1
        self.lead = bootstrap.process_index() == 0
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
        sums, write_err = self._write_payload(state, generation)
        path = self._commit_manifest(state_shape(state, self.mesh_shape),
                                     generation, counter, sums, write_err)
        self.prune()
        return path

    def _already_committed(self, generation: int) -> bool:
        """Whether a valid checkpoint for ``generation`` already exists.
        Across processes a collective decision: a lone rank skipping while
        its peers rewrite would desynchronize the barriers of the save; the
        exists check only decides whether to attempt the local load, and
        every rank reaches the one vote."""
        exists = os.path.exists(self._manifest_path(generation))
        if self.multihost:
            return self._collective_is_valid(
                self._load(generation) if exists else None)
        return exists and self._load(generation) is not None

    def _sweep_stale(self, generation: int) -> None:
        """Clear invalid leftovers at this generation's paths before writing:
        on the lead, and across processes behind a barrier, so no peer
        writes its windows into a payload path the lead is removing."""
        if not self.multihost or self.lead:
            _rmtree_or_file(self._manifest_path(generation))
            _rmtree_or_file(os.path.join(self.directory,
                                         self._payload_name(generation)))
        if self.multihost:
            collectives.barrier(f"gol_tpu_torch.ckpt.clean:{self.directory}:{generation}")

    def _write_payload(self, state, generation: int):
        """Write the payload and checksum it: ``(local_sums, write_err)``.
        On one process a failure raises; across processes it is returned,
        so the commit phase votes on it before any other collective.
        ``state`` may be the live state or a ``pipeline.HostSnapshot``'s
        host copy of it: both give the same payload bytes and CRC blocks."""
        payload_path = os.path.join(self.directory, self._payload_name(generation))
        write_err: Exception | None = None
        sums: dict[str, int] = {}
        try:
            # Serialized against prune(): the async writer runs this on its
            # thread, and the codecs stage files in the checkpoint directory.
            with self._io_lock:
                if self.multihost or self.codec.self_retrying:
                    # No outer retry. Across ranks: the codec's write votes,
                    # and one rank re-entering it would pair with a peer's
                    # next collective. Self-retrying codecs: stacking this
                    # policy on the codec's own would cube the time to
                    # failure of a persistent outage.
                    self.codec.write(payload_path, state)
                else:
                    self.retry.call(lambda: self.codec.write(payload_path, state))
                faults.on_payload_write(payload_path)
            sums = _shard_checksums(state, self.mesh_shape, self.local)
        except Exception as e:  # noqa: BLE001 - returned, then voted
            if not self.multihost:
                raise
            write_err = e
        return sums, write_err

    def _commit_manifest(self, state_shape, generation: int, counter: int,
                         local_sums: dict[str, int],
                         write_err: Exception | None = None) -> str:
        """Vote, merge the CRCs, commit the manifest atomically: the only
        phase that makes a checkpoint exist. The async writer defers
        exactly this call to the next boundary.

        Across processes every rank first votes on its payload write (the
        one that failed re-raises its error, the others abandon the
        checkpoint with it), the CRCs of every rank are merged, and the
        lead commits between two barriers: the peers' payload windows are
        written before any manifest claims them, and no rank goes on
        before the manifest exists."""
        if self.multihost and not collectives.host_all_agree(write_err is None):
            if write_err is not None:
                raise write_err
            raise RuntimeError(
                "checkpoint abandoned: a peer process failed to write its "
                f"payload shards for generation {generation}")
        checksums = _allgather_checksums(local_sums)
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
        data = json.dumps(manifest, indent=1).encode()
        if self.multihost:
            collectives.barrier(f"gol_tpu_torch.ckpt.commit:{self.directory}:{generation}")
            if self.lead:
                _commit_file(path, data)
            collectives.barrier(f"gol_tpu_torch.ckpt.committed:{self.directory}:{generation}")
        else:
            _commit_file(path, data)
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
        newest. Across processes only the lead collects."""
        if self.multihost and not self.lead:
            return
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

    def _load(self, generation: int) -> _LoadedCheckpoint | None:
        """One checkpoint's local view, or None if anything about it
        (manifest JSON, geometry, codec, fingerprint, payload read, and on
        one process the checksums) fails to verify.

        Collective-free: ranks fail here at different points, so a
        collective inside would pair with a different one on a peer. Across
        processes a local CRC mismatch is carried in ``local_ok`` for the
        one vote of ``_collective_is_valid``."""
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
            if self.codec.self_retrying:
                state = self.codec.read(payload)
            else:
                state = self.retry.call(lambda: self.codec.read(payload))
            shape = state_shape(state, self.mesh_shape)
            if shape != tuple(manifest["state_shape"]):
                raise ValueError(
                    f"payload shape {shape} != manifest "
                    f"{tuple(manifest['state_shape'])}")
            ok, verified = _verify_checksums(state, manifest["checksums"],
                                             self.mesh_shape, self.local)
            if not self.multihost and not ok:
                raise ValueError("shard checksum mismatch")
            info = CheckpointInfo(
                generation=int(manifest["generation"]),
                counter=int(manifest["counter"]),
                path=self._manifest_path(generation),
            )
            return _LoadedCheckpoint(state, info, ok, frozenset(verified),
                                     frozenset(manifest["checksums"]))
        except Exception as e:  # noqa: BLE001 - any defect means "not valid"
            logger.warning(
                "checkpoint %s/%s%08d invalid, trying older: %s: %s",
                self.directory, _PREFIX, generation, type(e).__name__, e)
            return None

    def _collective_is_valid(self, loaded: _LoadedCheckpoint | None) -> bool:
        """The run's verdict on one candidate, by one collective that every
        process reaches once (a rank whose ``_load`` failed votes False
        instead of skipping it). Valid when every process loaded the
        checkpoint and its own checks matched; a recorded block no process
        could tile from its shards (written on another mesh, straddling a
        rank boundary here) is logged as unverified, not refused."""
        if not self.multihost:
            return loaded is not None
        ok = loaded is not None and loaded.local_ok
        votes = _allgather_json([bool(ok), sorted(loaded.verified) if loaded else []])
        if not all(v[0] for v in votes):
            return False
        covered = set()
        for _, keys in votes:
            covered.update(keys)
        unverified = loaded.recorded - covered
        if unverified:
            logger.warning(
                "restoring with %d/%d recorded block(s) CRC-UNVERIFIED: "
                "they straddle process boundaries on this topology (written "
                "on a different mesh); every process read its payload "
                "shards successfully", len(unverified), len(loaded.recorded))
        return True

    def _global_candidates(self) -> list[int]:
        """Every process's manifest generations, newest first: a manifest
        only one rank can list still gets voted on (and down)."""
        local = self._list_generations()
        if not self.multihost:
            return local
        width = max(2 * self.keep, 4)
        mine = np.full((width,), -1, np.int64)
        mine[: min(len(local), width)] = local[:width]
        everyone = collectives.process_allgather(mine)
        return sorted({int(g) for g in everyone.ravel() if g >= 0}, reverse=True)

    def restore(self, max_generation: int | None = None):
        """``(state, info)`` of the newest checkpoint every process can
        read and verify, or None. Each candidate is checked locally and
        decided by one collective, so no two ranks resume from different
        generations.

        ``max_generation`` skips checkpoints past it: a rerun with a reduced
        --gen-limit resumes from the newest checkpoint at or below the
        limit (an exact prefix of the shorter run) or starts fresh."""
        reg = obs_registry.default()
        with obs_trace.span("checkpoint.restore"):
            for gen in self._global_candidates():
                if max_generation is not None and gen > max_generation:
                    continue
                loaded = self._load(gen)
                if self._collective_is_valid(loaded):
                    logger.info("auto-resume: restored checkpoint at "
                                "generation %d from %s",
                                loaded.info.generation, loaded.info.path)
                    reg.inc("checkpoint_restores_total")
                    return loaded.state, loaded.info
                reg.inc("checkpoint_restore_rejected_total")
                if loaded is not None:
                    logger.warning(
                        "checkpoint generation %d readable here but not "
                        "verified on every process; falling back to an "
                        "older one", gen)
        return None
