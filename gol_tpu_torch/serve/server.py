"""Stdlib-only HTTP JSON API over the scheduler.

The port's copy of ``gol_tpu/serve/server.py``: the same endpoints, status
codes, error JSON and ``/metrics`` text as the JAX package's server
(test-pinned), so a client of either package talks to it, sparse and
macro jobs (a body with ``rle``) and the sharded single-job lane's
``POST /shard/<leg>`` RPCs (``shard/worker.py``) included. The
dispatch-gap monitor reads the marginal rates of the port's own plan
cache (``tune/select.py``).

Endpoints (all JSON unless noted):

- ``POST /jobs``      — submit a job; body ``{"width", "height", "cells",
  "convention"?, "gen_limit"?, "check_similarity"?, "similarity_frequency"?,
  "priority"?, "deadline_s"?, "no_cache"?}`` where ``cells`` is the
  text-grid encoding (the same bytes the CLI reads/writes). 202 + ``{"id",
  "state"}`` on acceptance, 429 when the queue is full or draining, 400 on
  a bad request. With the result cache mounted (``--result-cache``) a
  repeat board completes at admission; ``no_cache: true`` opts out. An
  ``X-Gol-Trace`` header (a tracing fleet router's stamp) is adopted as
  the job's flow id when tracing is enabled here, and ignored otherwise —
  requests and responses are byte-identical either way (obs/propagate.py).

  **Wire negotiation** (``io/wire.py``): with ``Content-Type:
  application/x-gol-packed`` the body is ONE packed wire frame — the
  header carries width/height, the frame meta carries the remaining
  fields (everything above except ``cells``), the payload carries the
  board at a bit per cell (~8x smaller than text). The retained payload
  words stage straight into packed-kernel buckets (no text decode, no
  ``packbits`` pass). Unknown ``application/x-gol-*`` types (and
  newer frame versions) answer 415 — the client's retry-as-text signal;
  anything else takes the JSON path, byte-identically to pre-wire
  servers (test-pinned). The body cap is content-type-aware: both
  formats accept the same universe of board AREAS
  (``wire.max_body_bytes``), not the same byte count.
- ``GET /jobs/<id>``  — lifecycle state + timings.
- ``GET /result/<id>``— final grid (text-grid string), generations, exit
  reason; 409 while the job is not DONE, 410 for FAILED/CANCELLED. A
  result served by the cache (or a coalesced duplicate) carries
  ``"cached": "memory"|"disk"|"coalesced"``. With
  ``Accept: application/x-gol-packed`` the 200 answer is a packed wire
  frame instead (meta: id/generations/exit_reason/cached; payload: the
  grid) — encoded from result words already in hand when the packed
  kernel or a packed CAS payload produced them, so a binary hit never
  decodes and re-encodes. Error statuses stay JSON for all clients.
- ``DELETE /jobs/<id>`` — cancel a still-QUEUED job; 409 once it has been
  claimed by a batch (dispatch is not interruptible), 404 if unknown.
- ``GET /jobs/<id>/timeline`` — the job's milestone/segment decomposition
  (obs/timeline.py): where this request's latency went, queue-wait through
  journaled DONE. 404 unknown; restored (pre-restart) jobs report
  ``restored`` with no timeline (milestones are process-local).
- ``GET /metrics``    — Prometheus text format (contract byte-stable);
  ``?format=json`` for the JSON snapshot, which additionally carries the
  process-global registry (gauges + histogram summaries — ring occupancy,
  dispatch-gap histogram) under ``process``, the same values
  ``gol trace-report`` renders from a flight dump.
- ``GET /slo``        — the SLO engine's status (obs/slo.py): overall
  health, per-objective multi-window burn rates, shedding state.
- ``GET /debug/trace``— observability snapshot (``obs/``): tracing
  state, the retained span ring, and the process-global registry counters. Live and read-only — the HTTP
  counterpart of a SIGUSR1 flight-recorder dump.
- ``POST /drain``     — stop admission, flush the queue, wait for in-flight
  batches; responds when quiescent. Idempotent.
- ``GET /healthz``    — liveness + queue stats.

With ``slo_shed`` (CLI ``--slo-shed``) a critical SLO burn sheds new jobs:
``POST /jobs`` answers 429 with a ``Retry-After`` header until the burn
clears. The default is observe-only (test-pinned): burns log and export,
admission is untouched.

The server composes replay-on-start with the checkpoint lane's auto-resume
story: started on a journal directory that holds unfinished jobs, it re-queues exactly
those (``JobJournal.replay``) and keeps serving results of finished ones —
kill -9 at any point loses no accepted job and double-runs none.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

from gol_tpu_torch.io import text_grid, wire
from gol_tpu_torch.obs import (
    history as obs_history,
    propagate as obs_propagate,
    recorder as obs_recorder,
    registry as obs_registry,
    sampler as obs_sampler,
    slo as obs_slo,
    timeline as obs_timeline,
    trace as obs_trace,
)
from gol_tpu_torch.serve.jobs import (
    CANCELLED, DONE, FAILED, JobJournal, new_job,
)
from gol_tpu_torch.serve.metrics import Metrics
from gol_tpu_torch.serve.scheduler import (
    DeadlineExceeded, Draining, JournalUnavailable, QueueFull, Scheduler,
)

# The journaled error-string prefix that marks a failure as a deadline
# expiry (scheduler._fail_batch formats errors as "TypeName: message"):
# result fetches answer 504 for these — including REPLAYED failures,
# where the prefix is all that survives the restart.
_DEADLINE_ERROR_PREFIX = DeadlineExceeded.__name__ + ":"

logger = logging.getLogger(__name__)

# Body caps live in io/wire.py (wire.max_body_bytes, shared with the
# router so both tiers agree): 64 MiB for text/JSON —
# byte-identical to the pre-wire cap, test-pinned — and the same
# board-AREA universe for packed bodies.


def _decode_cells(cells, width: int, height: int):
    """Strict submit-body board decode: the ``cells`` field must be an
    ASCII string whose cell count matches the declared geometry EXACTLY.
    Every malformed shape — wrong type, non-ASCII bytes, too short, too
    long — raises ValueError/TypeError here, which the handler maps to the
    400 error contract (the reference parser's lenient truncation is for
    FILES; an API body that disagrees with its own geometry is a client
    error, never a silently-cropped board)."""
    if not isinstance(cells, str):
        raise TypeError(
            f"cells must be a string, got {type(cells).__name__}"
        )
    try:
        raw = cells.encode("ascii")
    except UnicodeEncodeError:
        raise ValueError(
            "cells must be ASCII ('0'/'1' rows, newline-separated); "
            "got non-ASCII characters"
        ) from None
    return text_grid.decode(raw, width, height, exact=True)


def _tuned_marginal_rates() -> dict[str, float]:
    """The tuned plan's recorded marginal kernel rates for the dispatch-gap
    monitor, degrading to {} like every other cache problem (a server with
    no tuned marginals still serves; it just has no roofline to compare
    against)."""
    try:
        from gol_tpu_torch.tune import select

        return select.marginal_rates()
    except Exception:  # noqa: BLE001 - cache trouble must not block boot
        logger.warning("could not load tuned marginal rates; the "
                       "dispatch-gap monitor will report rates only",
                       exc_info=True)
        return {}


class GolServer:
    """The serving process: scheduler + journal + HTTP front end."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        journal_dir: str | None = None,
        scheduler: Scheduler | None = None,
        metrics: Metrics | None = None,
        slo: obs_slo.SloEngine | None = None,
        slo_shed: bool = False,
        slo_latency_target: float = 60.0,
        sample_interval: float = 1.0,
        result_cache: bool = False,
        cache_dir: str | None = None,
        cache_entries: int = 1024,
        cache_payload: str = "packed",
        cache_disk_bytes: int | None = None,
        journal_segment_bytes: int | None = None,
        journal_retain: int | None = None,
        disk_reserve: int = 0,
        history_dir: str | None = None,
        history_bytes: int | None = None,
        **scheduler_kwargs,
    ):
        self.metrics = metrics or Metrics()
        journal = (
            JobJournal(journal_dir, **(
                {"segment_bytes": journal_segment_bytes}
                if journal_segment_bytes is not None else {}
            ))
            if journal_dir else None
        )
        self.journal_dir = journal_dir
        self.journal_retain = journal_retain
        # The sharded single-job lane (shard/): mounted lazily on
        # the first /shard/* RPC — a worker that never joins a sharded
        # job pays nothing for the subsystem.
        self._shard = None
        self._shard_lock = threading.Lock()
        # Durable metrics history (obs/history.py): OFF by default — no
        # writer object, no per-tick work. With --metrics-history, every
        # sampler tick appends the serving registry snapshot to the
        # size-capped ring, so this process's window survives it. Built
        # FIRST so the disk guard can journal its transitions into it.
        self.history = None
        if history_dir:
            kwargs = {}
            if history_bytes:
                kwargs["total_bytes"] = history_bytes
                kwargs["segment_bytes"] = min(
                    obs_history.DEFAULT_SEGMENT_BYTES,
                    max(1, history_bytes // 4),
                )
            self.history = obs_history.HistoryWriter(
                history_dir, source="serve", **kwargs
            )
        # The disk-pressure watchdog (resilience/diskguard.py): with
        # --disk-reserve N, free bytes on the journal partition are read
        # every sampler tick and the service degrades in tiers — shed CAS
        # writes, shed checkpoints, refuse admission with 507 — recovering
        # automatically. 0 (the default) mounts no guard.
        self.disk_guard = None
        if disk_reserve and journal_dir:
            from gol_tpu_torch.resilience.diskguard import DiskGuard

            self.disk_guard = DiskGuard(
                journal_dir,
                admission_bytes=disk_reserve,
                registry=self.metrics,
                history=self.history,
                partition=journal_dir,
            )
        # The tiered result cache (cache/): --result-cache mounts the
        # in-process LRU, --cache-dir adds the on-disk CAS tier (and implies
        # enablement). Counters ride the serving registry so hit ratios
        # merge fleet-wide like any other serving series. --cache-disk-bytes
        # budgets the CAS (atime-LRU GC, cache/gc.py); the disk guard sheds
        # its writes first under pressure.
        cache = None
        if result_cache or cache_dir:
            from gol_tpu_torch.cache import ResultCache

            cache = ResultCache(
                memory_entries=cache_entries,
                cas_dir=cache_dir,
                metrics=self.metrics,
                payload=cache_payload,
                disk_bytes=cache_disk_bytes,
                guard=self.disk_guard,
            )
        self.cache = cache
        self.scheduler = scheduler or Scheduler(
            journal=journal, metrics=self.metrics, cache=cache,
            **scheduler_kwargs
        )
        # The SLO engine evaluates the scheduler's own metrics registry;
        # observe-only unless slo_shed (the pinned default). An injected
        # engine keeps its own objectives/thresholds.
        self.slo = slo or obs_slo.SloEngine(
            obs_slo.default_objectives(
                self.scheduler.max_queue_depth,
                latency_target_s=slo_latency_target,
            ),
            registry=self.metrics,
            shed=slo_shed,
        )
        # One background thread ticks the SLO evaluation AND the dispatch-
        # gap monitor (and, when mounted, the metrics-history append);
        # sample_interval <= 0 disables the thread (tests call
        # sampler.tick() themselves).
        self.sampler = obs_sampler.ServeSampler(
            self.metrics,
            slo=self.slo,
            interval=sample_interval if sample_interval > 0 else 1.0,
            marginal_rates=_tuned_marginal_rates(),
            history=self.history,
        )
        # The storage-lifecycle tick: disk-guard watermarks, journal/CAS
        # byte gauges, and idle-time journal compaction all ride the
        # sampler (one thread, one cadence — the gol-serve-sampler).
        self.sampler.add_hook(self.storage_tick)
        self._sample_interval = sample_interval
        # The capacity weight this worker advertises on /healthz: the tuned
        # per-bucket marginal rates folded to one number — the mean. None
        # when untuned (key omitted).
        rates = self.sampler.marginal_rates
        self.advertised_weight = (
            sum(rates.values()) / len(rates) if rates else None
        )
        self.replayed = 0
        self._replay_results = {}
        self._replay_failed = {}
        self._replay_cancelled = set()
        if journal is not None:
            replay = journal.replay()
            self._replay_results = replay.results
            self._replay_failed = replay.failed
            self._replay_cancelled = replay.cancelled
            self.replayed = self.scheduler.resubmit_replayed(replay.pending)
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def _boot(self) -> None:
        self.scheduler.start()
        # The SLO state rides every flight-recorder dump: a crash report
        # answers "was the service healthy when it died" on its own.
        obs_recorder.add_state_provider(obs_slo.STATE_PROVIDER, self.slo.state)
        if self.disk_guard is not None:
            # Same standard for the disk guard: a post-mortem should show
            # what pressure level the process died at.
            from gol_tpu_torch.resilience import diskguard

            obs_recorder.add_state_provider(
                diskguard.STATE_PROVIDER, self.disk_guard.state
            )
        if self._sample_interval > 0:
            self.sampler.start()

    def start(self) -> None:
        self._boot()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="gol-serve-http", daemon=True
        )
        self._thread.start()
        logger.info("gol serve listening on %s", self.url)

    def serve_forever(self) -> None:
        self._boot()
        logger.info("gol serve listening on %s", self.url)
        self.httpd.serve_forever()

    def drain(self, timeout: float | None = None) -> bool:
        return self.scheduler.drain(timeout=timeout)

    def shutdown(self, drain: bool = True) -> None:
        self.sampler.stop()
        if self.history is not None:
            self.history.close()
        obs_recorder.remove_state_provider(obs_slo.STATE_PROVIDER)
        if self.disk_guard is not None:
            from gol_tpu_torch.resilience import diskguard

            obs_recorder.remove_state_provider(diskguard.STATE_PROVIDER)
        self.scheduler.stop(drain=drain)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.scheduler.journal is not None:
            self.scheduler.journal.close()

    @property
    def shard(self):
        """The lazily-mounted shard host (``shard/worker.py``): its
        checkpoint logs live in this worker's journal partition, so a
        respawn on the same partition finds them."""
        if self._shard is None:
            with self._shard_lock:
                if self._shard is None:
                    from gol_tpu_torch.shard.worker import ShardHost

                    self._shard = ShardHost(journal_dir=self.journal_dir)
        return self._shard

    def shard_request(self, leg: str, raw: bytes):
        """One ``POST /shard/<leg>`` RPC -> (status, payload). The packed
        legs (halo, adopt) take GOLP frames; the rest JSON bodies.
        ValueError (ShardError, WireError, malformed JSON) propagates to
        the handler's 400 mapping; an exhausted halo-send budget answers
        503 naming the peer — the coordinator's recovery cue."""
        from gol_tpu_torch.shard.worker import PeerUnreachable

        host = self.shard
        try:
            if leg == "halo":
                return 200, host.halo_in(raw)
            if leg == "adopt":
                return 200, host.adopt(raw)
            body = json.loads(raw.decode("utf-8"))
            if not isinstance(body, dict):
                raise ValueError("shard request body must be a JSON object")
            if leg == "init":
                return 200, host.init_job(body)
            if leg == "step":
                return 200, host.step_job(body["job"], body["step"])
            if leg == "checkpoint":
                return 200, host.checkpoint(body["job"], body["step"])
            if leg == "rewind":
                return 200, host.rewind(body["job"], body["step"],
                                        body.get("peers"))
            if leg == "restore":
                return 200, host.restore_job(body)
            if leg == "status":
                return 200, host.status(body["job"])
            if leg == "rebalance":
                return 200, host.rebalance(body)
            if leg == "collect":
                return 200, host.collect(body["job"],
                                         body.get("which", "current"))
            if leg == "done":
                return 200, host.finish(body["job"])
            return 404, {"error": f"unknown shard leg {leg!r}"}
        except PeerUnreachable as e:
            return 503, {"error": str(e)}

    # -- request-level operations (handler methods stay thin) -------------

    def submit_json(self, body: dict, trace_header: str | None = None,
                    deadline_header: str | None = None) -> dict:
        if "rle" in body:
            return self._submit_sparse(body, trace_header, deadline_header)
        if body.get("shard"):
            raise ValueError("shard jobs take the sparse input form (rle)")
        required = ("width", "height", "cells")
        missing = [k for k in required if k not in body]
        if missing:
            raise ValueError(f"missing required field(s): {missing}")
        width, height = int(body["width"]), int(body["height"])
        if width <= 0 or height <= 0:
            raise ValueError(f"dimensions must be positive, got {height}x{width}")
        board = _decode_cells(body["cells"], width, height)
        return self._submit_board(board, None, width, height, body,
                                  trace_header, deadline_header)

    def _submit_sparse(self, body: dict,
                       trace_header: str | None = None,
                       deadline_header: str | None = None) -> dict:
        """``POST /jobs`` with an ``rle`` field: a sparse job — a pattern
        placed at (``x``, ``y``) of an otherwise-empty ``width x height``
        universe, run on the sparse tiled engine. Same contract shape as a
        dense submit (202 + id); the full canvas never exists anywhere."""
        required = ("width", "height", "rle")
        missing = [k for k in required if k not in body]
        if missing:
            raise ValueError(f"missing required field(s): {missing}")
        if "cells" in body:
            raise ValueError("a job carries either cells or rle, not both")
        width, height = int(body["width"]), int(body["height"])
        if width <= 0 or height <= 0:
            raise ValueError(f"dimensions must be positive, got {height}x{width}")
        kwargs = {}
        for field in (
            "convention", "gen_limit", "check_similarity",
            "similarity_frequency", "priority", "no_cache", "macro",
            "shard",
        ):
            if field in body:
                kwargs[field] = body[field]
        if body.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(body["deadline_s"])
        job = new_job(
            width, height, None,
            rle=body["rle"],
            place_x=body.get("x", 0),
            place_y=body.get("y", 0),
            tile=body.get("tile", 0),
            **kwargs,
        )
        self.metrics.inc("sparse_submits_total")
        if job.macro:
            self.metrics.inc("macro_submits_total")
        return self._admit(job, trace_header, deadline_header)

    def submit_packed(self, raw: bytes,
                      trace_header: str | None = None,
                      deadline_header: str | None = None) -> dict:
        """``POST /jobs`` with the packed wire Content-Type: one frame in,
        the same 202 payload out. The frame's payload words are retained
        on the job (when the width packs), so a packed-kernel bucket
        stages them without the text decode OR the ``packbits`` pass."""
        frame = wire.decode_frame(raw)
        clash = {"cells", "width", "height", "words"} & frame.meta.keys()
        if clash:
            raise ValueError(
                f"packed frame meta must not carry {sorted(clash)} — "
                "geometry rides the header, the board rides the payload"
            )
        width, height = frame.width, frame.height
        if width <= 0 or height <= 0:
            raise ValueError(f"dimensions must be positive, got {height}x{width}")
        board = frame.grid()
        words = frame.words if width % 32 == 0 else None
        self.metrics.inc("wire_packed_submits_total")
        return self._submit_board(board, words, width, height, frame.meta,
                                  trace_header, deadline_header)

    def _submit_board(self, board, words, width: int, height: int,
                      body: dict, trace_header: str | None,
                      deadline_header: str | None = None) -> dict:
        """The format-independent half of a submit: field validation via
        Job, trace adoption, scheduler admission. ``body`` is the JSON
        object (text lane) or the frame meta (packed lane) — identical
        field vocabulary, so the two lanes cannot drift."""
        kwargs = {}
        for field in (
            "convention", "gen_limit", "check_similarity",
            "similarity_frequency", "priority", "no_cache",
        ):
            if field in body:
                kwargs[field] = body[field]
        if body.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(body["deadline_s"])
        job = new_job(width, height, board, words=words, **kwargs)
        return self._admit(job, trace_header, deadline_header)

    def _admit(self, job, trace_header: str | None,
               deadline_header: str | None = None) -> dict:
        """Trace adoption + deadline adoption + scheduler admission (shared
        by the dense text, packed wire, and sparse RLE submit lanes).

        Trace-context adoption (obs/propagate.py): a router forwarding
        under `--trace` stamps X-Gol-Trace; when tracing is enabled HERE
        too, the job's flow events ride the fleet-wide id and chain onto
        the router's trace. Tracing disabled (the default) never looks at
        the header — an old client (no header) and a headered forward are
        byte-identical through this path, response included (test-pinned).

        Deadline adoption (X-Gol-Deadline, same degradation standard): a
        submit carrying a remaining-budget header is refused 504 HERE when
        the budget arrived spent (scheduler-admission enforcement: no job,
        no journal record, no queue slot), and otherwise stamps
        ``job.expires_at`` for the dispatch-time gate. The budget also
        tightens ``deadline_s`` so dispatch ORDERING sees the urgency. No
        header — every old client and router — changes nothing (pinned);
        malformed values drop silently, exactly like a malformed trace.
        """
        if trace_header is not None and obs_trace.enabled():
            ctx = obs_propagate.decode(trace_header)
            if ctx is not None:
                job.trace = ctx[0]
        budget = obs_propagate.decode_deadline(deadline_header)
        if budget is not None:
            if budget <= 0:
                self.metrics.inc("deadline_expired_total")
                raise DeadlineExceeded(
                    f"deadline budget spent before admission "
                    f"({budget:.3f}s remaining)"
                )
            job.expires_at = self.scheduler.now() + budget
            if job.deadline_s is None or budget < job.deadline_s:
                job.deadline_s = budget
        self.scheduler.submit(job)
        return {"id": job.id, "state": job.state}

    def should_shed(self) -> tuple[bool, float]:
        """Admission-path SLO check (observe-only engines always pass)."""
        shed, retry_after = self.slo.should_shed()
        if shed:
            self.metrics.inc("jobs_shed_total")
        return shed, retry_after

    def should_refuse_disk(self):
        """Admission-path disk check: ``(refuse, free_bytes)``. True only
        at the watchdog's deepest level — the handler answers 507 naming
        the partition, BEFORE reading the body (refusing for lack of disk
        must not first buffer a 17MB board)."""
        if self.disk_guard is None or not self.disk_guard.refuse_admission():
            return False, None
        self.metrics.inc("jobs_refused_disk_total")
        return True, self.disk_guard.free_bytes

    def storage_tick(self) -> None:
        """One storage-lifecycle tick (riding the gol-serve-sampler):
        watchdog watermarks, durable-footprint gauges, and idle-time
        journal compaction — a sealed segment compacts as soon as the
        queue is quiet, or regardless once four have piled up (a busy
        server must still converge on a bounded journal)."""
        if self.disk_guard is not None:
            self.disk_guard.tick()
        journal = self.scheduler.journal
        if journal is not None:
            self.metrics.set_gauge("journal_bytes", journal.bytes_on_disk())
            sealed = journal.sealed_count()
            self.metrics.set_gauge("journal_segments", sealed)
            if sealed >= 1 and (sealed >= 4
                                or self.scheduler.stats()["queued"] == 0):
                try:
                    report = journal.compact(
                        retain_results=self.journal_retain
                    )
                except OSError as err:
                    # ENOSPC while compacting: the segments stay, replay
                    # still works, the next tick retries (ideally after
                    # the guard shed enough writers to free space).
                    self.metrics.inc("journal_errors_total")
                    logger.warning("journal compaction failed (will retry): "
                                   "%s: %s", type(err).__name__, err)
                else:
                    if report.compacted:
                        self.metrics.inc("compactions_total")
                        self.metrics.set_gauge(
                            "journal_bytes", journal.bytes_on_disk()
                        )
                        self.metrics.set_gauge("journal_segments",
                                               journal.sealed_count())
        if self.cache is not None and self.cache.cas is not None:
            self.metrics.set_gauge("cas_bytes", self.cache.cas.usage_bytes())

    def timeline_json(self, job_id: str) -> dict | None:
        """GET /jobs/<id>/timeline payload, or None for an unknown id."""
        job = self.scheduler.job(job_id)
        if job is None:
            if (job_id in self._replay_results
                    or job_id in self._replay_failed
                    or job_id in self._replay_cancelled):
                # The job predates this process; its perf_counter milestones
                # died with the process that ran it.
                return {"id": job_id, "restored": True,
                        "milestones": {}, "segments": {}}
            return None
        # dict() snapshot: worker/journal threads stamp concurrently.
        return {
            "id": job.id,
            "state": job.state,
            **obs_timeline.summary(dict(job.timeline)),
        }

    def job_json(self, job_id: str) -> dict | None:
        job = self.scheduler.job(job_id)
        if job is None:
            if job_id in self._replay_results:
                return {"id": job_id, "state": DONE, "restored": True}
            if job_id in self._replay_failed:
                return {
                    "id": job_id, "state": FAILED, "restored": True,
                    "error": self._replay_failed[job_id],
                }
            if job_id in self._replay_cancelled:
                return {"id": job_id, "state": CANCELLED, "restored": True}
            return None
        out = {"id": job.id, "state": job.state}
        if job.error:
            out["error"] = job.error
        if job.started_at is not None:
            out["queue_seconds"] = job.started_at - job.accepted_at
        if job.finished_at is not None and job.started_at is not None:
            out["run_seconds"] = job.finished_at - job.started_at
        return out

    def _find_result(self, job_id: str):
        """The job's JobResult when it is DONE (live or replayed), else
        None — the format-independent half of GET /result/<id>."""
        job = self.scheduler.job(job_id)
        result = job.result if job is not None and job.state == DONE else None
        if result is None and job_id in self._replay_results:
            result = self._replay_results[job_id]
        return job, result

    def result_json(self, job_id: str):
        """(status_code, payload) for GET /result/<id>."""
        job, result = self._find_result(job_id)
        if result is not None:
            if result.grid is None:
                # Sparse result: the universe answers as RLE (O(live runs)
                # — never dense), plus its live-cell count.
                h, w = result.universe
                return 200, {
                    "id": job_id,
                    "generations": result.generations,
                    "exit_reason": result.exit_reason,
                    "width": int(w),
                    "height": int(h),
                    "rle": result.rle,
                    "population": int(result.population or 0),
                    **({"cached": result.cached} if result.cached else {}),
                }
            return 200, {
                "id": job_id,
                "generations": result.generations,
                "exit_reason": result.exit_reason,
                "width": int(result.grid.shape[1]),
                "height": int(result.grid.shape[0]),
                "grid": text_grid.encode(result.grid).decode("ascii"),
                # Only on cache/coalesced completions (clients print the
                # marker; old-server payloads simply lack the key).
                **({"cached": result.cached} if result.cached else {}),
            }
        if job is None:
            if job_id in self._replay_failed:
                error = self._replay_failed[job_id]
                if error.startswith(_DEADLINE_ERROR_PREFIX):
                    # A deadline expiry that predates this process: the
                    # 504 contract survives the restart (the prefix is
                    # journaled); its perf_counter timeline did not.
                    return 504, {"id": job_id, "state": FAILED,
                                 "error": error, "restored": True}
                return 410, {"id": job_id, "state": FAILED, "error": error}
            if job_id in self._replay_cancelled:
                return 410, {"id": job_id, "state": CANCELLED, "error": None}
            return 404, {"error": f"unknown job {job_id}"}
        if (job.state == FAILED and job.error
                and job.error.startswith(_DEADLINE_ERROR_PREFIX)):
            # The deadline-expiry contract: 504 (the budget ran out, the
            # engine never saw the job) with the job's timeline attached —
            # where the budget actually went is the answer the client
            # needs, and this job will never have a result to carry it.
            return 504, {
                "id": job_id,
                "state": FAILED,
                "error": job.error,
                **obs_timeline.summary(dict(job.timeline)),
            }
        if job.state in (FAILED, CANCELLED):
            return 410, {"id": job_id, "state": job.state, "error": job.error}
        return 409, {"id": job_id, "state": job.state,
                     "error": "result not ready"}

    def result_packed(self, job_id: str):
        """GET /result/<id> under ``Accept: application/x-gol-packed``:
        (status, frame bytes) on success — encoded from the result's
        retained words when a packed kernel or packed CAS payload produced
        them (zero re-pack), from the grid otherwise, byte-identically —
        or (status, JSON payload) on every non-200 (errors stay JSON for
        all clients)."""
        _job, result = self._find_result(job_id)
        if result is None or result.grid is None:
            # No result yet, or a sparse (RLE) result — a giant universe
            # has no packed-frame form; clients parse by response
            # content type, so the JSON answer degrades transparently.
            return self.result_json(job_id)
        meta = {
            "id": job_id,
            "generations": result.generations,
            "exit_reason": result.exit_reason,
            **({"cached": result.cached} if result.cached else {}),
        }
        height, width = (int(x) for x in result.grid.shape)
        self.metrics.inc("wire_packed_results_total")
        if result.words is not None:
            return 200, wire.encode_frame(
                meta, words=result.words, width=width, height=height
            )
        return 200, wire.encode_frame(meta, grid=result.grid)


def _make_handler(server: GolServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Socket timeout for the whole exchange: a client announcing more
        # Content-Length than it sends must not pin a handler thread forever.
        timeout = 60

        # Route logs through logging, not the BaseHTTPRequestHandler default
        # of raw stderr writes (the tree-wide lint rule).
        def log_message(self, format, *args):  # noqa: A002 - stdlib signature
            logger.debug("%s - %s", self.address_string(), format % args)

        def _reply(self, code: int, payload, content_type="application/json",
                   headers=None):
            if isinstance(payload, (bytes, bytearray)):
                body = bytes(payload)  # packed wire frames go out verbatim
            elif content_type == "application/json":
                body = json.dumps(payload).encode("utf-8")
            else:
                body = payload.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            if code >= 400:
                # Error paths may not have consumed the request body (e.g.
                # an over-MAX_BODY reject); closing is the safe way to keep
                # a keep-alive client from desynchronizing.
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _read_raw(self) -> bytes:
            """Read the request body under the CONTENT-TYPE-AWARE cap
            (wire.max_body_bytes): the 64 MiB text cap was sized for
            text's ~8x inflation, so packed bodies are capped by the
            equivalent board AREA — the two formats accept the same
            universe of board sizes (boundary-pinned by tests)."""
            length = int(self.headers.get("Content-Length", 0))
            cap = wire.max_body_bytes(self.headers.get("Content-Type"))
            if length > cap:
                raise ValueError(f"body of {length} bytes exceeds {cap}")
            return self.rfile.read(length) if length else b"{}"

        def _read_body(self) -> dict:
            body = json.loads(self._read_raw().decode("utf-8"))
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            return body

        def _discard_body(self) -> None:
            """Drain an unparsed request body: on HTTP/1.1 keep-alive,
            unread body bytes would be parsed as the NEXT request line and
            desynchronize the connection."""
            length = int(self.headers.get("Content-Length", 0))
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 16))
                if not chunk:
                    break
                length -= len(chunk)

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                if path == "/jobs":
                    # SLO-driven shedding (only ever with --slo-shed): a
                    # critical burn answers 429 + Retry-After BEFORE the
                    # body is read — load shedding that first parses a 17MB
                    # board sheds nothing.
                    shed, retry_after = server.should_shed()
                    if shed:
                        self._reply(
                            429,
                            {"error": "shedding load: SLO burn is critical",
                             "retry_after_s": retry_after},
                            headers={"Retry-After": str(int(retry_after))},
                        )
                        return
                    # Disk-pressure admission refusal (the watchdog's
                    # deepest tier): 507 Insufficient Storage naming the
                    # partition and its free bytes, BEFORE the body is
                    # read. In-flight jobs keep running and their done
                    # records still land — only NEW work is refused, and
                    # admission recovers on its own above the watermark.
                    refuse, free = server.should_refuse_disk()
                    if refuse:
                        self._reply(507, {
                            "error": "insufficient storage: journal "
                                     "partition is under disk pressure",
                            "partition": server.journal_dir,
                            "free_bytes": free,
                        })
                        return
                    ctype = wire.content_type_of(
                        self.headers.get("Content-Type")
                    )
                    trace_header = self.headers.get(
                        obs_propagate.TRACE_HEADER
                    )
                    deadline_header = self.headers.get(
                        obs_propagate.DEADLINE_HEADER
                    )
                    try:
                        if ctype == wire.CONTENT_TYPE:
                            out = server.submit_packed(
                                self._read_raw(), trace_header=trace_header,
                                deadline_header=deadline_header,
                            )
                        elif ctype.startswith(wire.CONTENT_TYPE_FAMILY):
                            # A gol wire format this server does not speak
                            # (a future revision's content type): 415 is
                            # the client's retry-as-text signal. Anything
                            # OUTSIDE the family takes the JSON path — the
                            # compat default, byte-identical to pre-wire
                            # servers (test-pinned).
                            self._discard_body()
                            self._reply(415, {
                                "error": f"unsupported content type "
                                         f"{ctype}; this server speaks "
                                         f"{wire.CONTENT_TYPE} and "
                                         "application/json",
                            })
                            return
                        else:
                            out = server.submit_json(
                                self._read_body(),
                                trace_header=trace_header,
                                deadline_header=deadline_header,
                            )
                    except wire.UnsupportedWire as e:
                        self._reply(415, {"error": str(e)})
                        return
                    except DeadlineExceeded as e:
                        # Admission-time deadline enforcement: the budget
                        # arrived spent — no job was created, no batch
                        # slot will burn for it.
                        self._reply(504, {"error": str(e)})
                        return
                    except (QueueFull, Draining) as e:
                        self._reply(429, {"error": str(e)})
                        return
                    except JournalUnavailable as e:
                        # The submit record could not be journaled (ENOSPC
                        # on the partition): nothing was admitted — 503 is
                        # the client's retry signal, and acknowledging a
                        # job the journal never heard of would let it
                        # vanish on replay.
                        self._reply(503, {"error": str(e)})
                        return
                    self._reply(202, out)
                elif path == "/drain":
                    self._discard_body()
                    drained = server.drain()
                    self._reply(200, {
                        "drained": drained,
                        "stats": server.scheduler.stats(),
                    })
                elif path.startswith("/shard/"):
                    # The sharded single-job lane's worker RPCs
                    # (shard/): halo frames, super-steps, checkpoints,
                    # recovery. Driven by the router's coordinator,
                    # worker-to-worker for halo/adopt.
                    code, payload = server.shard_request(
                        path[len("/shard/"):], self._read_raw()
                    )
                    self._reply(code, payload)
                else:
                    self._discard_body()
                    self._reply(404, {"error": f"no such endpoint {path}"})
            except (ValueError, KeyError, TypeError, OverflowError,
                    json.JSONDecodeError) as e:
                # TypeError covers wrong JSON *types* in otherwise-present
                # fields (priority: null, gen_limit: "x"); OverflowError
                # covers absurd numeric fields reaching numpy/struct
                # boundaries — client errors all, never allowed past Job
                # validation into the queue (and never a 500).
                self._reply(400, {"error": str(e)})

        def do_DELETE(self):
            path = urlparse(self.path).path
            if not path.startswith("/jobs/"):
                self._reply(404, {"error": f"no such endpoint {path}"})
                return
            job_id = path[len("/jobs/"):]
            if server.scheduler.cancel(job_id):
                self._reply(200, {"id": job_id, "state": "cancelled"})
                return
            out = server.job_json(job_id)
            if out is None:
                self._reply(404, {"error": f"unknown job {job_id}"})
            else:
                # Known but no longer cancellable (claimed or terminal).
                self._reply(409, {
                    "id": job_id, "state": out["state"],
                    "error": "job is not queued; cannot cancel",
                })

        def do_GET(self):
            parsed = urlparse(self.path)
            path = parsed.path
            if path.startswith("/jobs/"):
                rest = path[len("/jobs/"):]
                if rest.endswith("/timeline"):
                    out = server.timeline_json(rest[: -len("/timeline")])
                else:
                    out = server.job_json(rest)
                if out is None:
                    self._reply(404, {"error": "unknown job"})
                else:
                    self._reply(200, out)
            elif path.startswith("/result/"):
                job_id = path[len("/result/"):]
                if wire.accepts_packed(self.headers.get("Accept")):
                    code, payload = server.result_packed(job_id)
                    self._reply(
                        code, payload,
                        content_type=(
                            wire.CONTENT_TYPE
                            if isinstance(payload, (bytes, bytearray))
                            else "application/json"
                        ),
                    )
                else:
                    code, payload = server.result_json(job_id)
                    self._reply(code, payload)
            elif path == "/metrics":
                fmt = parse_qs(parsed.query).get("format", ["prometheus"])[0]
                if fmt == "json":
                    # Parity with what `gol trace-report` renders from a
                    # flight dump: the serving snapshot PLUS the process-
                    # global registry's gauges and histogram summaries
                    # (ring occupancy, dispatch-gap distribution, engine
                    # counters) under "process". The Prometheus text
                    # contract below stays byte-stable — serving series
                    # only, test-pinned.
                    snap = server.metrics.snapshot()
                    snap["process"] = obs_registry.default().snapshot()
                    self._reply(200, snap)
                else:
                    self._reply(
                        200, server.metrics.prometheus(),
                        content_type="text/plain; version=0.0.4",
                    )
            elif path == "/slo":
                self._reply(200, server.slo.status())
            elif path == "/debug/trace":
                tracer = obs_trace.tracer()
                self._reply(200, {
                    "enabled": tracer.enabled,
                    "meta": tracer.metadata(),
                    "spans": tracer.snapshot(),
                    "registry": obs_registry.default().snapshot(),
                })
            elif path == "/healthz":
                payload = {"ok": True, "stats": server.scheduler.stats()}
                # The tuned marginal rate of this host's plan cache, when
                # one was measured; absent (the untuned default), the key
                # is omitted.
                if server.advertised_weight is not None:
                    payload["weight"] = server.advertised_weight
                self._reply(200, payload)
            else:
                self._reply(404, {"error": f"no such endpoint {path}"})

    return Handler
