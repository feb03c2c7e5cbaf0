"""The ``Job`` record and the crash-safe append-only job journal.

The port's copy of ``gol_tpu/serve/jobs.py`` (the port imports nothing of
the JAX package). The journal's on-disk format is the JAX package's,
record for record, so a journal written by either package replays under
the other, sparse and macro jobs included.

A job is one board's simulation request plus its lifecycle state machine:

    QUEUED -> SCHEDULED -> RUNNING -> DONE | FAILED
    QUEUED -> CANCELLED

The journal is the serving counterpart of ``gol_tpu/resilience/checkpoint``'s
durability discipline, adapted to a queue: instead of write-fresh-then-commit
(state that is *replaced*), a queue's history only ever *grows*, so the
crash-safe shape is an append-only JSONL log where every record is a single
``os.write`` to an ``O_APPEND`` descriptor followed by ``fsync``. A crash can
tear at most the final line; replay tolerates (and drops) a torn tail, so the
journal a restarted server reads is always a prefix of accepted truth —
exactly the property the checkpoint manifest's atomic ``os.replace`` buys for
snapshots.

Replay returns (a) every accepted job with no terminal record — the work a
restarted server must finish — and (b) the results of completed jobs, so
``GET /result/<id>`` keeps answering across restarts. A job is DONE exactly
once: the scheduler only dispatches jobs replay handed back as pending, and
replay drops a pending job the moment a ``done`` record for its id appears.

Timestamps: queue/run latencies use ``time.perf_counter()`` (monotonic;
wall clocks step under NTP and make p99s lie).
Perf-counter values are process-local, so they are never journaled; replayed
jobs get fresh arrival stamps.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import uuid

import numpy as np

from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.resilience import fsio
from gol_tpu_torch.serve import compaction

logger = logging.getLogger(__name__)

# Lifecycle states (the serving state machine).
QUEUED = "queued"
SCHEDULED = "scheduled"  # claimed by a forming batch, not yet on device
RUNNING = "running"  # batch dispatched to the compiled program
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

TERMINAL_STATES = frozenset({DONE, FAILED, CANCELLED})

# Legal transitions; anything else is a server bug and raises loudly.
# Batch retries happen while jobs are held in RUNNING (the RetryPolicy wraps
# the dispatch; nothing ever re-queues a claimed job), so RUNNING's only
# exits are terminal.
# QUEUED -> DONE is the result-cache path (gol_tpu/cache): a hit — or a
# coalesced duplicate completed by its in-flight leader — finishes without
# ever being claimed by a batch.
_TRANSITIONS = {
    QUEUED: {SCHEDULED, CANCELLED, FAILED, DONE},
    SCHEDULED: {RUNNING, FAILED},
    RUNNING: {DONE, FAILED},
    DONE: set(),
    FAILED: set(),
    CANCELLED: set(),
}


@dataclasses.dataclass
class JobResult:
    """What a finished job hands back (mirrors engine.BatchBoardResult).

    Sparse jobs (gol_tpu/sparse/) answer with ``grid=None`` and the final
    universe as RLE instead — a giant universe's dense cells must never
    travel the stack; ``universe`` carries the (height, width) the dense
    path reads off ``grid.shape``."""

    grid: np.ndarray | None  # uint8 {0,1}, (height, width); None = sparse
    generations: int
    exit_reason: str  # engine.EXIT_REASONS member
    # How the answer was produced: None = the engine ran it; "memory"/"disk"
    # = a result-cache tier served it; "coalesced" = an identical in-flight
    # submission's engine run completed it. Journaled in the done record so
    # restarted servers keep reporting it (clients print the marker).
    cached: str | None = None
    # The grid's packed wire words (io/wire.py row layout), when a hop
    # already had them in hand — a packed-kernel engine readback or a
    # packed CAS payload. Lets a packed GET /result answer without a
    # re-pack; None (replayed results, masked/byte kernels) means the
    # responder packs from ``grid`` on demand. Process-local, never
    # journaled (the journal's done records stay text).
    words: np.ndarray | None = None
    # Sparse-lane result fields (gol_tpu/sparse/): the final universe as
    # an RLE document + its live-cell count, with the universe extents
    # (height, width) the dense path reads off ``grid.shape``. RLE and
    # population are journaled (they ARE the result); the work accounting
    # below is process-local (serving metrics only — tile-steps executed
    # and the cell updates they represent, the sparse analog of
    # height x width x generations).
    rle: str | None = None
    population: int | None = None
    universe: tuple[int, int] | None = None
    tiles_simulated: int | None = None
    cell_updates: int | None = None
    occupancy: float | None = None


@dataclasses.dataclass
class Job:
    """One simulation request moving through the service.

    Two input forms: dense (``board`` holds the (height, width) cells —
    the classic lane) and sparse (``rle`` holds a pattern placed at
    ``(place_x, place_y)`` in an otherwise-empty ``height x width``
    universe; ``board`` is None and the job runs on the sparse tiled
    engine). ``width``/``height`` are the universe extents either way, so
    routing (fleet placement, bucket keys) reads one vocabulary."""

    id: str
    width: int
    height: int
    board: np.ndarray | None  # uint8 {0,1}, (height, width); None = sparse
    convention: str = Convention.C
    gen_limit: int = GameConfig().gen_limit
    check_similarity: bool = True
    similarity_frequency: int = GameConfig().similarity_frequency
    priority: int = 0  # higher dispatches first within a bucket
    deadline_s: float | None = None  # seconds from acceptance; orders dispatch
    no_cache: bool = False  # opt this submission out of the result cache
    # Sparse job fields (gol_tpu/sparse/): an RLE pattern document placed
    # with its top-left cell at column place_x, row place_y of the
    # universe; tile 0 means the engine default. All journaled — a
    # replayed sparse job re-runs from exactly this spec (the occupancy
    # index is rebuilt from it, so replay needs no dense cells).
    rle: str | None = None
    place_x: int = 0
    place_y: int = 0
    tile: int = 0
    # Run this sparse job on the macrocell engine (gol_tpu/macro/) instead
    # of the per-generation sparse loop. Journaled (replay must pick the
    # same engine for work-accounting stability) but NOT a result axis:
    # the macro engine is byte-identical to sparse by contract, so the
    # flag is an execution hint, like picking a kernel.
    macro: bool = False
    # The sharded single-job form (gol_tpu/shard): accepted ONLY by a
    # fleet router, which runs the job as coordinated super-steps across
    # its workers instead of queueing it here. The field exists on Job so
    # a shard submit aimed at a plain worker fails loudly at admission
    # (400) rather than silently running single-worker.
    shard: bool = False
    state: str = QUEUED
    # The result-cache key (gol_tpu/cache/fingerprint.py), computed by the
    # scheduler at admission when a cache is mounted; None otherwise (and
    # for no_cache jobs). Process-local — replayed jobs re-derive it.
    fingerprint: str | None = None
    # The board's packed wire words, retained from a packed submit
    # (io/wire.py) when the width packs (W % 32 == 0): the batcher hands
    # them straight to the packed-kernel staging lane, skipping the
    # ``np.packbits`` pass the text path pays (engine_stage_packs_total
    # visibly drops under packed traffic). Process-local like the stamps
    # below — never journaled; replayed jobs re-stage from ``board``.
    words: np.ndarray | None = None
    # The propagated fleet trace id (obs/propagate.py): set at admission
    # when the router stamped an ``X-Gol-Trace`` header AND tracing is
    # enabled in this process — the job's flow events then carry the
    # fleet-wide id and chain onto the router's trace. Process-local like
    # the perf_counter stamps; never journaled (replayed jobs have no
    # live trace to join).
    trace: str | None = None
    # The propagated deadline budget's expiry (obs/propagate.py
    # X-Gol-Deadline): an ABSOLUTE perf_counter instant set at admission
    # when the submit carried a remaining-budget header. Enforced at batch
    # dispatch (scheduler: an expired job fails with the 504 contract
    # instead of burning a batch slot). Process-local like every other
    # perf_counter stamp — never journaled; a replayed job has no live
    # client waiting on the old budget, so it simply runs (the journal's
    # every-accepted-job-terminates contract wins).
    expires_at: float | None = None
    # perf_counter stamps, process-local (never journaled).
    accepted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    result: JobResult | None = None
    error: str | None = None
    # Per-job milestone stamps (obs/timeline.py vocabulary): perf_counter
    # values keyed by milestone name, stamped by the scheduler identically
    # across the classic/pipelined/resident lanes. Process-local like the
    # *_at fields above — never journaled; replayed jobs restart empty.
    timeline: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # Normalize numeric fields FIRST: jobs arrive from untrusted JSON,
        # and a job admitted with e.g. priority=None would not fail until a
        # worker computes its dispatch key — killing the worker thread, not
        # the request. int()/float() raise TypeError/ValueError here, inside
        # the admission path, where the server maps them to HTTP 400.
        self.width, self.height = int(self.width), int(self.height)
        self.gen_limit = int(self.gen_limit)
        self.similarity_frequency = int(self.similarity_frequency)
        # Strict bool: bool("false") is True, so coercion would silently
        # ENABLE the check a string-typed client asked to disable.
        if not isinstance(self.check_similarity, bool):
            raise TypeError(
                f"check_similarity must be a JSON boolean, got "
                f"{type(self.check_similarity).__name__}"
            )
        # Same strictness for the cache opt-out: bool("false") is True, and
        # a truthy-string no_cache would silently bypass the cache (the
        # harmless direction) while {"no_cache": 0} meaning "do cache"
        # already works — a non-bool is a client error either way.
        if not isinstance(self.no_cache, bool):
            raise TypeError(
                f"no_cache must be a JSON boolean, got "
                f"{type(self.no_cache).__name__}"
            )
        # Same strictness again for the engine hint, and it only means
        # anything on the sparse input form.
        if not isinstance(self.macro, bool):
            raise TypeError(
                f"macro must be a JSON boolean, got "
                f"{type(self.macro).__name__}"
            )
        if self.macro and self.rle is None:
            raise ValueError("macro jobs take the sparse input form (rle)")
        if not isinstance(self.shard, bool):
            raise TypeError(
                f"shard must be a JSON boolean, got "
                f"{type(self.shard).__name__}"
            )
        if self.shard:
            raise ValueError(
                "shard jobs are router-driven: submit them to a fleet "
                "router (gol fleet), not directly to a worker"
            )
        self.priority = int(self.priority)
        if self.deadline_s is not None:
            self.deadline_s = float(self.deadline_s)
        if self.width <= 0 or self.height <= 0:
            raise ValueError(
                f"job dimensions must be positive, got {self.height}x{self.width}"
            )
        if self.gen_limit < 0:
            raise ValueError(f"gen_limit must be >= 0, got {self.gen_limit}")
        if self.similarity_frequency <= 0:
            raise ValueError(
                f"similarity_frequency must be > 0, got {self.similarity_frequency}"
            )
        if self.convention not in (Convention.C, Convention.CUDA):
            raise ValueError(f"unknown convention: {self.convention!r}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.rle is not None:
            self._init_sparse()
        else:
            self.board = np.ascontiguousarray(
                np.asarray(self.board, dtype=np.uint8)
            )
            if self.board.shape != (self.height, self.width):
                raise ValueError(
                    f"board shape {self.board.shape} does not match declared "
                    f"{self.height}x{self.width}"
                )
        # Retained wire words are a pure staging accelerator: anything that
        # does not exactly match the packed-kernel operand shape is dropped
        # (the board stages through the classic pack), never trusted.
        if self.words is not None and (
            self.width % 32 != 0
            or self.words.shape != (self.height, self.width // 32)
        ):
            self.words = None

    def _init_sparse(self) -> None:
        """Validate + pre-parse a sparse (RLE) job at admission: every
        malformed shape raises here, inside the server's 400 mapping,
        never on a worker thread. The full byte canvas is NEVER built —
        only the small pattern array (process-local; replay re-parses)."""
        from gol_tpu_torch.io import rle as rle_codec
        from gol_tpu_torch.sparse.board import DEFAULT_TILE, MIN_TILE

        if not isinstance(self.rle, str):
            raise TypeError(
                f"rle must be a string, got {type(self.rle).__name__}"
            )
        if self.board is not None:
            raise ValueError("a job carries either cells or rle, not both")
        self.place_x = int(self.place_x)
        self.place_y = int(self.place_y)
        self.tile = int(self.tile)
        if self.tile == 0:
            self.tile = DEFAULT_TILE
        if self.tile < MIN_TILE:
            raise ValueError(f"tile must be >= {MIN_TILE}, got {self.tile}")
        if self.height % self.tile or self.width % self.tile:
            raise ValueError(
                f"universe {self.height}x{self.width} does not divide into "
                f"{self.tile}^2 tiles"
            )
        self.pattern = rle_codec.parse(self.rle)
        ph, pw = self.pattern.shape
        if (self.place_x < 0 or self.place_y < 0
                or self.place_y + ph > self.height
                or self.place_x + pw > self.width):
            raise ValueError(
                f"pattern {ph}x{pw} at ({self.place_x},{self.place_y}) does "
                f"not fit the {self.height}x{self.width} universe"
            )

    @property
    def config(self) -> GameConfig:
        return GameConfig(
            gen_limit=self.gen_limit,
            check_similarity=self.check_similarity,
            similarity_frequency=self.similarity_frequency,
            convention=self.convention,
        )

    def transition(self, new_state: str) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise ValueError(
                f"job {self.id}: illegal transition {self.state} -> {new_state}"
            )
        self.state = new_state

    def flow_id(self) -> str:
        """The Perfetto flow id this job's lifecycle events ride: the
        propagated fleet trace id when a router stamped one (so the chain
        crosses the process boundary), the job id otherwise — byte-for-byte
        the pre-propagation behavior."""
        return self.trace or self.id

    def dispatch_key(self):
        """Sort key for dispatch order inside a bucket: higher priority
        first, then nearest deadline, then arrival order."""
        deadline = (
            self.accepted_at + self.deadline_s
            if self.deadline_s is not None
            else float("inf")
        )
        return (-self.priority, deadline, self.accepted_at, self.id)

    def to_record(self) -> dict:
        """The journaled (durable) fields — everything needed to re-run.

        Sparse jobs journal their RLE spec (pattern + placement + tile)
        instead of dense cells: the occupancy index is a pure function of
        the spec, so replay rebuilds it without a canvas ever existing."""
        if self.rle is not None:
            payload = {
                "rle": self.rle,
                "x": self.place_x,
                "y": self.place_y,
                "tile": self.tile,
                # Only when set, like no_cache below: default-engine
                # records stay byte-stable and old journals replay sparse.
                **({"macro": True} if self.macro else {}),
            }
        else:
            payload = {"cells": text_grid.encode(self.board).decode("ascii")}
        return {
            "id": self.id,
            "width": self.width,
            "height": self.height,
            "convention": self.convention,
            "gen_limit": self.gen_limit,
            "check_similarity": self.check_similarity,
            "similarity_frequency": self.similarity_frequency,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            **payload,
            # Only when set: default-path submit records stay byte-stable,
            # and old journals replay with the default (cache allowed).
            **({"no_cache": True} if self.no_cache else {}),
        }

    @classmethod
    def from_record(cls, rec: dict) -> "Job":
        sparse = "rle" in rec
        board = None if sparse else text_grid.decode(
            rec["cells"].encode("ascii"), rec["width"], rec["height"]
        )
        extra = {}
        if sparse:
            extra = {
                "rle": rec["rle"],
                "place_x": rec.get("x", 0),
                "place_y": rec.get("y", 0),
                "tile": rec.get("tile", 0),
                "macro": rec.get("macro", False),
            }
        return cls(
            id=rec["id"],
            width=rec["width"],
            height=rec["height"],
            board=board,
            **extra,
            convention=rec.get("convention", Convention.C),
            gen_limit=rec.get("gen_limit", GameConfig().gen_limit),
            check_similarity=rec.get("check_similarity", True),
            similarity_frequency=rec.get(
                "similarity_frequency", GameConfig().similarity_frequency
            ),
            priority=rec.get("priority", 0),
            deadline_s=rec.get("deadline_s"),
            no_cache=rec.get("no_cache", False),
            accepted_at=time.perf_counter(),
        )


def priority_class(priority: int) -> str:
    """The SLO bucketing of a job priority: objectives are declared per
    *class* (high > 0, normal == 0, low < 0), not per raw integer — a fleet
    cannot carry one latency histogram per arbitrary client-chosen int."""
    if priority > 0:
        return "high"
    if priority < 0:
        return "low"
    return "normal"


def new_job(width: int, height: int, board, **kwargs) -> Job:
    return Job(
        id=uuid.uuid4().hex,
        width=width,
        height=height,
        board=board,
        accepted_at=time.perf_counter(),
        **kwargs,
    )


@dataclasses.dataclass
class ReplayState:
    """What a journal replay recovers."""

    pending: list  # Jobs accepted but not terminal — re-run these
    results: dict  # id -> JobResult for DONE jobs — keep serving these
    failed: dict  # id -> error string
    cancelled: set  # ids
    torn_lines: int  # dropped unparseable tail/garbage lines


class JobJournal:
    """Append-only JSONL journal; every append is one write + fsync.

    **Segmented** (gol_tpu/serve/compaction.py): the live file rotates into
    sealed ``journal-<seq>.jsonl`` segments past ``segment_bytes``, and
    ``compact()`` folds sealed segments into a CRC-stamped snapshot so the
    durable footprint stays bounded. Replay = snapshot + segments newer
    than it + the live file — the append path (and its crash contract) is
    byte-identical to the unsegmented journal; rotation is one atomic
    rename under the same lock. ``segment_bytes`` None/0 disables rotation
    (the single-file layout, which replay still reads forever)."""

    FILENAME = compaction.ACTIVE_FILENAME

    def __init__(self, directory: str,
                 segment_bytes: int | None = compaction.DEFAULT_SEGMENT_BYTES):
        self.directory = directory
        self.segment_bytes = segment_bytes or 0
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.FILENAME)
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._active_bytes = os.fstat(self._fd).st_size
        # The next segment seq, computed ONCE (one snapshot-header read)
        # and counted up in-process: seqs are minted only here, and our
        # own compactions can only fold seqs we already minted, so the
        # cached counter can never fall at or below `covers` — and the
        # append lock never waits on an O(history) snapshot re-read.
        self._next_seq = (compaction.next_index(directory)
                          if self.segment_bytes else 0)
        # Appends come from both the accept path and worker threads. A
        # process-level lock (not just O_APPEND) keeps records whole even
        # when os.write returns short (large done records, ENOSPC mid-way):
        # the write-all loop below may take several syscalls, and another
        # thread's record landing between two chunks would weld both records
        # into one unparseable line — losing TWO events, one of which could
        # be a `done` (a replay would then re-run a completed job).
        self._lock = threading.Lock()

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _append(self, record: dict) -> None:
        self._append_encoded(
            (json.dumps(record, separators=(",", ":")) + "\n").encode("utf-8")
        )

    def _append_encoded(self, data: bytes) -> None:
        with self._lock:
            fsio.write_all(self._fd, data, "journal append")
            os.fsync(self._fd)
            self._active_bytes += len(data)
            if self.segment_bytes and self._active_bytes >= self.segment_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Seal the live file as the next segment and open a fresh one.

        Rename first, close-and-reopen second: the O_APPEND fd stays valid
        across the rename, so if anything here fails the journal keeps
        appending with zero lost records. A failure BETWEEN the two steps
        is rolled back (rename the file back under the live name): the
        appender must never keep writing a file that carries a SEALED
        name, because compaction folds-and-deletes sealed segments — a
        concurrent compaction would silently drop every record appended
        after the half-rotation."""
        sealed = os.path.join(self.directory,
                              compaction.segment_name(self._next_seq))
        try:
            os.replace(self.path, sealed)
        except OSError as err:
            logger.warning(
                "journal rotation in %s failed (%s); continuing to append "
                "to the current file", self.directory, err)
            return
        try:
            new_fd = os.open(
                self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
            )
        except OSError as err:
            try:
                os.replace(sealed, self.path)
                logger.warning(
                    "journal rotation in %s could not open a fresh live "
                    "file (%s); rolled the rename back", self.directory, err)
            except OSError as undo_err:
                # Same-directory rename-back almost cannot fail; if it
                # does, appends continue on the held fd but the file now
                # wears a sealed name — scream, because only an operator
                # can restore the invariant.
                logger.critical(
                    "journal rotation in %s stranded the live journal "
                    "under sealed name %s (open: %s; rollback: %s) — "
                    "records keep appending there but COMPACTION MAY "
                    "RETIRE IT; free descriptors/space and restart",
                    self.directory, sealed, err, undo_err)
            return
        os.close(self._fd)
        self._fd = new_fd
        self._active_bytes = 0
        self._next_seq += 1

    # -- storage lifecycle --------------------------------------------------

    def bytes_on_disk(self) -> int:
        """Durable footprint: snapshot + sealed segments + the live file."""
        return compaction.journal_bytes(self.directory)

    def sealed_count(self) -> int:
        return len(compaction.sealed_segments(self.directory))

    def compact(self, retain_results: int | None = None):
        """Fold sealed segments into the snapshot (compaction.compact):
        safe while this journal is live — compaction never touches the
        file the appender holds."""
        return compaction.compact(self.directory,
                                  retain_results=retain_results)

    def record_submit(self, job: Job) -> None:
        self._append({"event": "submit", "job": job.to_record()})

    @staticmethod
    def _done_record(job: Job) -> dict:
        r = job.result
        if r.grid is None:
            # Sparse result: the final universe travels as RLE (O(live
            # runs) — a 2^16-square answer must never be journaled dense).
            h, w = r.universe
            return {
                "event": "done",
                "id": job.id,
                "generations": r.generations,
                "exit_reason": r.exit_reason,
                "width": int(w),
                "height": int(h),
                "rle": r.rle,
                "population": int(r.population or 0),
                **({"cached": r.cached} if r.cached else {}),
            }
        return {
            "event": "done",
            "id": job.id,
            "generations": r.generations,
            "exit_reason": r.exit_reason,
            # Self-contained: replay decodes the result without needing
            # the submit record to have survived.
            "width": int(r.grid.shape[1]),
            "height": int(r.grid.shape[0]),
            "grid": text_grid.encode(r.grid).decode("ascii"),
            # Only on cache/coalesced completions: engine-path records stay
            # byte-stable, old journals replay as engine results.
            **({"cached": r.cached} if r.cached else {}),
        }

    def record_done(self, job: Job) -> None:
        self._append(self._done_record(job))

    def record_done_many(self, jobs: list[Job]) -> None:
        """One write-all + ONE fsync for a whole batch's done records.

        The lines are byte-identical to ``record_done`` per job, so replay
        is oblivious; batching only amortizes the fsync — the dominant
        per-job serial host cost of the serve hot path. A torn tail still
        loses at most a suffix of complete lines (each line is appended
        whole), which replay already tolerates by re-running those jobs.
        A single job routes through ``record_done`` so the two paths cannot
        drift (and tests that instrument it see every singleton append).
        """
        if not jobs:
            return
        if len(jobs) == 1:
            self.record_done(jobs[0])
            return
        self._append_encoded(b"".join(
            (json.dumps(self._done_record(j), separators=(",", ":")) + "\n")
            .encode("utf-8")
            for j in jobs
        ))

    def record_failed(self, job: Job) -> None:
        self._append({"event": "failed", "id": job.id, "error": job.error or ""})

    def record_cancelled(self, job: Job) -> None:
        self._append({"event": "cancelled", "id": job.id})

    @staticmethod
    def _apply_record(rec: dict, pending: dict, results: dict,
                      failed: dict, cancelled: set) -> None:
        """Apply ONE parsed journal record to the replay state (shared by
        snapshot records and journal lines — the snapshot speaks the
        journal's exact vocabulary, so one parser serves both)."""
        event = rec["event"]
        if event == "submit":
            job = Job.from_record(rec["job"])
            pending[job.id] = job
        elif event == "done":
            if "rle" in rec:
                results[rec["id"]] = JobResult(
                    grid=None,
                    generations=rec["generations"],
                    exit_reason=rec["exit_reason"],
                    rle=rec["rle"],
                    population=rec.get("population"),
                    universe=(rec["height"], rec["width"]),
                    cached=rec.get("cached"),
                )
            else:
                grid = text_grid.decode(
                    rec["grid"].encode("ascii"),
                    rec["width"],
                    rec["height"],
                )
                results[rec["id"]] = JobResult(
                    grid=grid,
                    generations=rec["generations"],
                    exit_reason=rec["exit_reason"],
                    cached=rec.get("cached"),
                )
            pending.pop(rec["id"], None)
        elif event == "failed":
            failed[rec["id"]] = rec.get("error", "")
            pending.pop(rec["id"], None)
        elif event == "cancelled":
            cancelled.add(rec["id"])
            pending.pop(rec["id"], None)
        else:
            raise ValueError(f"unknown event {event!r}")

    def _replay_file(self, path: str, pending: dict, results: dict,
                     failed: dict, cancelled: set) -> int:
        """Apply one JSONL file's records; returns the torn-line count."""
        torn = 0
        if not os.path.exists(path):
            return 0
        with open(path, "rb") as f:
            raw = f.read()
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
                self._apply_record(rec, pending, results, failed, cancelled)
            except (ValueError, KeyError, UnicodeDecodeError):
                torn += 1
        return torn

    def replay(self) -> ReplayState:
        """Rebuild queue state from the journal (crash-tolerant).

        Reads, in order: the committed snapshot (if any), sealed segments
        NEWER than it — a segment at or below the snapshot's high-water
        mark is a fully-folded leftover of a compaction killed between
        commit and retirement, skipped here and swept by the next
        compaction — and finally the live file. Unparseable lines are
        dropped, not fatal: the only way one arises is a crash mid-append
        (a torn tail) — by the append discipline there can be at most one,
        but replay is lenient to all of them and reports the count so
        operators see unexpected corruption.
        """
        pending: dict[str, Job] = {}
        results: dict[str, JobResult] = {}
        failed: dict[str, str] = {}
        cancelled: set[str] = set()
        torn = 0
        covers = -1
        snap = compaction.read_snapshot(self.directory)
        if snap is not None:
            covers = snap.covers
            for rec in snap.records:
                try:
                    self._apply_record(rec, pending, results, failed,
                                       cancelled)
                except (ValueError, KeyError, UnicodeDecodeError):
                    torn += 1
        for seq, seg_path in compaction.sealed_segments(self.directory):
            if seq <= covers:
                continue  # folded into the snapshot (torn retirement)
            torn += self._replay_file(seg_path, pending, results, failed,
                                      cancelled)
        torn += self._replay_file(self.path, pending, results, failed,
                                  cancelled)
        if torn:
            logger.warning(
                "job journal %s: dropped %d unparseable line(s) on replay "
                "(a crash tears at most the final append; more suggests "
                "external corruption)",
                self.path, torn,
            )
        return ReplayState(
            pending=list(pending.values()),
            results=results,
            failed=failed,
            cancelled=cancelled,
            torn_lines=torn,
        )
