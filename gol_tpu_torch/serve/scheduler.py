"""Admission control, batch forming, and dispatch.

The port's copy of ``gol_tpu/serve/scheduler.py``: the same admission
errors, flush rules, dispatch order, cancel, result cache consult and
in-flight coalescing, per-batch retry, worker pools, pipelined
dispatcher/completer pair and journal ordering, with the JAX package's
messages, metric names and journal records, and the resident ring
(``resident_ring >= 2``: ``serve/resident.py``'s per-bucket ring lanes
under the pipelined pair, with its ``gol-serve-journal`` writer thread).

The queueing half of the serving story. Jobs arrive one at a time; the
scheduler pools them per padding bucket and flushes a bucket to the device
when it is *worth a dispatch*:

- **size**: the bucket reached ``max_batch`` boards (a full program), or
- **age**: its oldest job has waited ``flush_age`` seconds (bounded latency
  for sparse traffic), or
- **deadline**: some job's deadline is due, or
- **drain**: the server is shutting down and flushes everything queued.

Which ready bucket goes first — and which jobs within it when it holds more
than a batch — follows ``Job.dispatch_key``: priority first, then nearest
deadline, then arrival. Deadlines order dispatch; they do not abandon work
(a job past its deadline runs at the front, not never — dropping accepted
jobs would violate the journal's every-accepted-job-terminates contract).

Admission control is a hard queue-depth cap: past it ``submit`` raises
``QueueFull`` (the server maps it to HTTP 429) instead of letting the queue
grow unboundedly while compile-warming buckets.

Dispatch is wrapped in the tree's one ``RetryPolicy``: a transient device
error retries the whole batch (GoL runs are pure functions of the input, so
a re-run is idempotent); a persistent one fails the batch's jobs with the
error recorded in journal and job state.

Graceful drain: ``drain()`` stops admission, flushes every queued bucket,
and returns when the last in-flight batch completes — the SIGTERM story for
``gol serve``.

**Result cache** (``cache=ResultCache(...)``, ``gol serve
--result-cache``): the scheduler consults the tiered content-addressed
cache (``cache/``) BEFORE enqueueing work. A hit completes the job at
admission — journaled as a completely normal DONE record, so exactly-once
and replay semantics are unchanged (a crash between the submit and done
records re-runs the job idempotently, exactly like a lost engine-path
record). A miss registers the job's fingerprint as *in flight*: further
identical submissions coalesce behind that leader and are all completed —
each with its own journaled DONE — by the leader's single engine run.
Engine results write through to every tier; ``no_cache`` jobs bypass all
of it. The cache is an accelerator, never a source of truth.

**Pipelined dispatch** (``pipeline_depth`` >= 2, ``gol serve
--pipeline-depth``): the single synchronous worker — stage, compute,
readback, journal strictly in series — is replaced by a two-thread
pipeline over a bounded in-flight window: a *dispatcher* claims batches,
stages host operands (``batcher.stage``: stacking + ``packbits``) and
dispatches; a *completer* fetches the results, journals, and finalizes
(``pipeline/inflight.py`` is the handoff). The port's
``engine.dispatch_batch`` runs the whole blocked loop before it returns
(one flag readback per 16-generation block), so the dispatcher holds each
batch for its run and what overlaps is staging and journaling, not device
work — unless the resident ring is on (``resident_ring >= 2``), whose
dispatch refills a ring slot and returns, with the drain's loop on the
lane's own thread. Everything observable is preserved: exactly-once
journal semantics, admission caps, drain, and
per-batch retry (the retry wraps dispatch+complete of one batch — a
failed completion re-dispatches from the retained host staging), and
COMPLETION order, not submission order, drives ``inflight_batches``. At
the default depth 1 the original worker loop runs, untouched.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any

from gol_tpu_torch.cache.fingerprint import job_fingerprint
from gol_tpu_torch.cache.store import CacheEntry
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.registry import metric_label
from gol_tpu_torch.resilience.retry import RetryPolicy, is_transient_io
from gol_tpu_torch.serve import batcher
from gol_tpu_torch.serve.batcher import BucketKey, bucket_for, pad_batch
from gol_tpu_torch.serve.jobs import (
    CANCELLED, DONE, FAILED, QUEUED, RUNNING, SCHEDULED,
    Job, JobJournal, JobResult, priority_class,
)
from gol_tpu_torch.serve.metrics import Metrics

logger = logging.getLogger(__name__)


class QueueFull(Exception):
    """Admission rejected: the queue is at max depth."""


class Draining(Exception):
    """Admission rejected: the server is draining."""


class JournalUnavailable(Exception):
    """Admission rejected: the SUBMIT record could not be journaled.

    The asymmetry with terminal records is the whole point: a lost *done*
    record costs an idempotent re-run after a restart (the job is still in
    the journal), so ``_journal_terminal`` survives ENOSPC/EIO there. A lost
    *submit* record is a job the server acknowledged but the journal never
    heard of — it would silently VANISH on replay, breaking the
    every-accepted-job-terminates contract. So a failing submit append
    refuses the accept instead: the server maps this to HTTP 503 (the
    client's retry signal; nothing was admitted, nothing will run)."""


class DeadlineExceeded(Exception):
    """The job's propagated deadline budget (X-Gol-Deadline) is spent.

    Raised at admission when the budget arrives already expired (the server
    maps it to HTTP 504 without creating a job) and used as the failure
    error at batch dispatch when a queued job's budget runs out before the
    device sees it — the job terminates (journaled FAILED, so the
    every-accepted-job-terminates contract holds) and ``GET /result``
    answers 504 with the job's timeline attached instead of 410."""


# Dispatch retry: a transient device/runtime hiccup retries the batch twice
# more with short backoff; anything else fails the jobs immediately.
DEFAULT_DISPATCH_RETRY = RetryPolicy(attempts=3, base_delay=0.05,
                                     multiplier=4.0, max_delay=1.0)


@dataclasses.dataclass
class _Flight:
    """One claimed batch moving through the dispatcher->completer pipeline.

    ``inflight`` holds the dispatched batch's device results (None when the
    split path is unavailable — an injected ``run_batch`` — or when staging
    itself failed, recorded in ``error`` for the completer's retry policy
    to classify)."""

    key: BucketKey
    batch: list
    started: float
    staged: Any = None  # retained host staging (retries re-dispatch from it)
    inflight: Any = None
    error: Exception | None = None
    consumed: bool = False  # first completion attempt taken


class Scheduler:
    """Owns the queue, the worker threads, and the job table."""

    def __init__(
        self,
        journal: JobJournal | None = None,
        metrics: Metrics | None = None,
        max_queue_depth: int = 1024,
        max_batch: int = batcher.MAX_BATCH,
        flush_age: float = 0.05,
        max_inflight: int = 1,
        pipeline_depth: int = 1,
        resident_ring: int = 0,
        retry: RetryPolicy = DEFAULT_DISPATCH_RETRY,
        retryable=is_transient_io,
        run_batch=batcher.run_batch,
        split_batch=None,
        cache=None,
        retry_budget=None,
        clock=time.perf_counter,
    ):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if not 1 <= max_batch <= batcher.MAX_BATCH:
            raise ValueError(
                f"max_batch must be in [1, {batcher.MAX_BATCH}], got {max_batch}"
            )
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}"
            )
        if pipeline_depth > 1 and max_inflight != 1:
            raise ValueError(
                "pipeline_depth > 1 replaces the worker pool with the "
                "dispatcher/completer pipeline; leave max_inflight at 1"
            )
        if resident_ring < 0 or resident_ring == 1:
            raise ValueError(
                f"resident_ring must be 0 (off) or >= 2, got {resident_ring}"
            )
        if resident_ring > 1 and pipeline_depth < 2:
            raise ValueError(
                "the resident ring rides the dispatcher/completer pipeline; "
                "set pipeline_depth >= 2 (>= 2x the ring keeps the device "
                "stream fed)"
            )
        if resident_ring > 1 and (
            run_batch is not batcher.run_batch or split_batch is not None
        ):
            raise ValueError(
                "resident_ring requires the default batcher engine; an "
                "injected run_batch/split_batch has no ring lane"
            )
        self.journal = journal
        self.metrics = metrics or Metrics()
        self.max_queue_depth = max_queue_depth
        self.max_batch = max_batch
        self.flush_age = flush_age
        self.max_inflight = max_inflight
        self.pipeline_depth = pipeline_depth
        self.retry = retry
        self.retryable = retryable
        # The token-bucket retry budget (resilience/retry.RetryBudget) or
        # None (unlimited — the pre-budget behavior, test-pinned). Shared
        # across every batch retry this scheduler takes: under a brownout
        # the budget drains and dispatch degrades to first-attempt-only
        # instead of amplifying the overload with retry traffic.
        self.retry_budget = retry_budget
        if retry_budget is not None:
            self.metrics.set_gauge("retry_budget_remaining",
                                   round(retry_budget.remaining(), 3))
        self._run_batch = run_batch
        # The staged dispatch path (stage -> dispatch -> complete).
        # Auto-wired to the batcher's split only when run_batch is the
        # default batcher entry: an injected run_batch (tests, alternative
        # engines) has no split, so the completer runs it whole — pipeline
        # semantics hold, only the stage/compute overlap is lost. With
        # resident_ring on, the split's dispatch/complete ride the
        # per-bucket ring lanes (serve/resident.py) instead of running one
        # batch per dispatch.
        self.resident_ring = resident_ring
        self._resident = None
        if resident_ring > 1:
            from gol_tpu_torch.serve.resident import ResidentEngine

            self._resident = ResidentEngine(resident_ring, clock=clock)
            split_batch = self._resident.split()
        elif split_batch is None and run_batch is batcher.run_batch:
            split_batch = (batcher.stage, batcher.dispatch, batcher.complete)
        self._split = split_batch
        self._window = None  # dispatcher->completer handoff (pipelined mode)
        # Resident mode detaches terminal journaling from the completer's
        # critical path: record appends ride a dedicated writer thread. The
        # durability contract is unchanged — a done record was always
        # allowed to be lost to a crash (the re-run is idempotent); stop()
        # drains the queue before returning, so a clean shutdown loses
        # nothing.
        self._journal_window = None
        self._journal_thread = None
        self._clock = clock
        # The tiered result cache (cache.ResultCache) or None.
        # _inflight_fp maps a fingerprint to its LEADER job (queued or
        # running); _followers holds identical submissions coalescing
        # behind it. Both are guarded by _cv.
        self.cache = cache
        self._inflight_fp: dict[str, Job] = {}
        self._followers: dict[str, list[Job]] = {}
        self._cv = threading.Condition()
        self._jobs: dict[str, Job] = {}
        self._buckets: dict[BucketKey, list[Job]] = {}
        self._queued = 0
        self._inflight = 0
        self._draining = False
        self._stopped = False
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._threads:
                return
            self._stopped = False
            if self._resident is not None:
                self._resident.reopen()  # state provider (no-op first time)
            if self.pipeline_depth > 1:
                # Pipelined dispatch: one dispatcher (claim + stage +
                # dispatch) and one completer (readback + journal), with at
                # most pipeline_depth batches between claim and completion.
                from gol_tpu_torch.pipeline.inflight import Handoff

                if self._resident is not None and self.journal is not None:
                    self._journal_window = Handoff()
                    self._journal_thread = threading.Thread(
                        target=self._journal_loop, name="gol-serve-journal",
                        daemon=True,
                    )
                    self._journal_thread.start()
                self._window = Handoff()
                for name, target in (
                    ("gol-serve-dispatch", self._dispatch_loop),
                    ("gol-serve-complete", self._complete_loop),
                ):
                    t = threading.Thread(target=target, name=name, daemon=True)
                    t.start()
                    self._threads.append(t)
                return
            # One worker per allowed in-flight batch: the thread count IS
            # the max-in-flight-batches admission knob.
            for i in range(self.max_inflight):
                t = threading.Thread(
                    target=self._worker, name=f"gol-serve-worker-{i}", daemon=True
                )
                t.start()
                self._threads.append(t)

    def stop(self, drain: bool = True, timeout: float | None = None) -> bool:
        drained = self.drain(timeout=timeout) if drain else True
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5)
        if self._journal_window is not None:
            # After the completer is gone nothing enqueues: close the
            # window and let the writer drain every pending record — even
            # a drain=False stop flushes the journal before returning.
            # (If a completer join above timed out, its late enqueue races
            # the close — _journal_terminal falls back to an inline append
            # in that case, so the record still lands.)
            self._journal_window.close()
            self._journal_thread.join(timeout=30)
            if self._journal_thread.is_alive():
                logger.warning(
                    "gol-serve-journal did not drain within 30s; pending "
                    "done records may be lost (restart re-runs those jobs)"
                )
            self._journal_window = None
            self._journal_thread = None
        if self._resident is not None:
            # After the threads are gone: drop the recorder state provider,
            # join the lanes' drain threads and forget the lanes (ring
            # hygiene; start() re-registers).
            self._resident.close()
        return drained

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission, flush everything queued, wait for quiescence.

        Returns True when the queue and all in-flight batches emptied within
        ``timeout`` (None = wait forever)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._queued > 0 or self._inflight > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return False
                self._cv.wait(timeout=remaining)
            return True

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    # -- admission ---------------------------------------------------------

    def submit(self, job: Job, record: bool = True) -> Job:
        """Accept a job into its bucket (raises QueueFull/Draining).

        ``record=False`` resubmits a journal-replayed job: it is not
        journaled again (its submit record already exists) and it bypasses
        the draining/depth admission gates — a replayed job was ALREADY
        accepted by a previous server, and bouncing it at restart would
        turn a full-queue crash into an unrecoverable restart loop (replay
        can legitimately exceed ``max_queue_depth`` by the jobs that were
        in flight when the process died)."""
        key = bucket_for(job)  # raises on un-runnable jobs before admission
        # Fingerprint + tier consult OUTSIDE the lock: hashing the board and
        # a CAS read are real work, and workers must not stall behind them.
        # The race this opens (a leader completing between our miss and our
        # lock) costs at most one redundant — idempotent — engine run.
        # The admission gates are pre-checked FIRST (racy, lock-free reads;
        # the authoritative checks re-run under the lock below): a
        # submission that will be 429'd must not amplify overload with a
        # CAS disk read, nor count a consult in the hit/miss series.
        fp = hit = None
        # Sparse jobs (job.board is None) never enter the job-level result
        # cache: their answer IS memoized tile work (sparse/memo), and a
        # dense CacheEntry cannot carry an RLE universe.
        if self.cache is not None and not job.no_cache \
                and job.board is not None and not (
            record and (self._draining
                        or self._queued >= self.max_queue_depth)
        ):
            fp = job_fingerprint(job)
            hit = self.cache.get(fp)
        with self._cv:
            if record and self._draining:
                self.metrics.inc("jobs_rejected_total")
                raise Draining("server is draining; not accepting jobs")
            if record and self._queued >= self.max_queue_depth:
                self.metrics.inc("jobs_rejected_total")
                raise QueueFull(
                    f"queue at max depth {self.max_queue_depth}"
                )
            if job.id in self._jobs:
                raise ValueError(f"duplicate job id {job.id}")
            # Journal BEFORE the job becomes visible to workers (still under
            # the lock): otherwise a fast worker could append this job's
            # `done` record ahead of its `submit` record, and a replay would
            # re-queue — i.e. double-run — an already-completed job. The
            # fsync inside the critical section is the price of the
            # exactly-once ledger ordering.
            # A FAILING submit append (ENOSPC, EIO) refuses the accept: an
            # acknowledged job absent from the journal would vanish on
            # replay — the one failure mode strictly worse than a 503.
            # Nothing is admitted here (the job is not yet in _jobs, no
            # bucket slot, no in-flight registration), so the refusal is
            # clean and the client's retry starts from zero.
            if record and self.journal is not None:
                try:
                    self.journal.record_submit(job)
                except OSError as err:
                    self.metrics.inc("journal_errors_total")
                    self.metrics.inc("jobs_rejected_total")
                    logger.error(
                        "journal submit append failed for job %s — refusing "
                        "the accept (an acknowledged-but-unjournaled job "
                        "would vanish on replay): %s: %s",
                        job.id, type(err).__name__, err,
                    )
                    raise JournalUnavailable(
                        f"cannot journal the submit record: "
                        f"{type(err).__name__}: {err}"
                    ) from err
            job.accepted_at = self._clock()
            job.timeline["accepted"] = job.accepted_at
            self._jobs[job.id] = job
            self.metrics.inc("jobs_accepted_total")
            if hit is not None:
                # Cache hit: complete at admission — never enqueued, never
                # batched. State flips under the lock; the (fsynced) done
                # record is appended after it, on this thread, so its
                # ledger ordering after the submit record holds.
                entry, tier = hit
                self._complete_from_cache_locked(job, entry, tier)
            elif fp is not None and fp in self._inflight_fp:
                # An identical board is already queued/running: coalesce.
                # The leader's ONE engine run completes every follower,
                # each with its own journaled DONE record.
                job.fingerprint = fp
                self._followers.setdefault(fp, []).append(job)
                self._queued += 1
                self.metrics.inc("cache_inflight_coalesced_total")
                self.metrics.set_gauge("queue_depth", self._queued)
                self._fold_urgency_locked(self._inflight_fp[fp], job)
            else:
                if fp is not None:
                    job.fingerprint = fp
                    self._inflight_fp[fp] = job
                self._buckets.setdefault(key, []).append(job)
                self._queued += 1
                self.metrics.set_gauge("queue_depth", self._queued)
                self._cv.notify_all()
        # Flow START: with tracing on, the job's lifecycle becomes a Perfetto
        # arrow chain from here to its finish inside a batch span. A job
        # carrying a propagated trace id (obs/propagate.py) chains onto the
        # ROUTER's flow start instead of opening its own — phase "t", under
        # the fleet-wide id.
        obs_trace.flow("job", job.flow_id(), "t" if job.trace else "s",
                       bucket=key.label())
        if hit is not None:
            self._journal_terminal(JobJournal.record_done, job)
            obs_trace.flow("job", job.flow_id(), "f", state="cached")
        return job

    def _complete_from_cache_locked(self, job: Job, entry: CacheEntry,
                                    tier: str) -> None:
        """Finish a job from a cache entry (caller holds the lock and
        journals the done record afterwards). Engine-work counters
        (batches/boards/cell-updates) are deliberately NOT fed — a hit did
        no engine work, and claiming otherwise would corrupt the
        dispatch-gap monitor's achieved-rate numerator."""
        finished = self._clock()
        job.finished_at = finished
        job.timeline["done"] = finished
        job.result = JobResult(
            grid=entry.grid,
            generations=entry.generations,
            exit_reason=entry.exit_reason,
            cached=tier,
            # A packed CAS payload's words ride through to the response:
            # a binary hit answers a packed GET /result with the stored
            # word bytes — no decode→re-encode round trip.
            words=entry.words,
        )
        job.transition(DONE)
        self.metrics.inc("jobs_completed_total")
        latency = finished - job.accepted_at
        self.metrics.observe("job_latency_seconds", latency)
        self.metrics.observe(
            "job_latency_seconds_" + priority_class(job.priority), latency
        )

    def resubmit_replayed(self, replayed: list[Job]) -> int:
        """Queue journal-replayed jobs (already durable; not re-recorded)."""
        n = 0
        for job in replayed:
            self.submit(job, record=False)
            n += 1
        if n:
            logger.info("replayed %d unfinished job(s) from the journal", n)
        return n

    def now(self) -> float:
        """This scheduler's clock reading (the server stamps deadline
        expiries with it so injected-clock tests stay coherent)."""
        return self._clock()

    def job(self, job_id: str) -> Job | None:
        with self._cv:
            return self._jobs.get(job_id)

    def cancel(self, job_id: str) -> bool:
        """Cancel a job that has not been claimed by a batch yet.

        A coalesced follower cancels out of its leader's wait list; a
        QUEUED *leader* with followers hands the bucket slot (and the
        in-flight registration) to its first follower, so the remaining
        duplicates still run exactly once."""
        with self._cv:
            job = self._jobs.get(job_id)
            if job is None or job.state != QUEUED:
                return False
            key = bucket_for(job)
            bucket = self._buckets.get(key, [])
            followers = (self._followers.get(job.fingerprint, [])
                         if job.fingerprint is not None else [])
            if job in bucket:
                bucket.remove(job)
                self._promote_follower_locked(job, bucket)
            elif job in followers:
                followers.remove(job)
            else:
                # QUEUED but in neither structure: another thread is
                # completing it right now (cache/coalesce handoff window).
                return False
            self._queued -= 1
            job.transition(CANCELLED)
            self.metrics.inc("jobs_cancelled_total")
            self.metrics.set_gauge("queue_depth", self._queued)
            self._cv.notify_all()
        if self.journal is not None:
            self.journal.record_cancelled(job)
        return True

    def _fold_urgency_locked(self, leader: Job, follower: Job) -> None:
        """Fold a follower's dispatch urgency into its still-QUEUED leader.

        Followers never sit in a bucket, so ``_claim_locked`` and
        ``_bucket_due_at`` only ever see the leader — without this fold, a
        high-priority or tight-deadline duplicate would inherit its
        leader's (possibly lowest) urgency, breaking the priority/deadline
        ordering guarantee for exactly the repeat traffic the cache
        targets. The leader's priority class (SLO histograms) follows the
        bump deliberately: its one engine run IS serving the most urgent
        request coalesced behind it. Once claimed, dispatch order is
        already decided — nothing to fold."""
        if leader.state != QUEUED:
            return
        changed = False
        if follower.priority > leader.priority:
            leader.priority = follower.priority
            changed = True
        if follower.deadline_s is not None:
            follower_due = follower.accepted_at + follower.deadline_s
            leader_due = (leader.accepted_at + leader.deadline_s
                          if leader.deadline_s is not None else None)
            if leader_due is None or follower_due < leader_due:
                leader.deadline_s = follower_due - leader.accepted_at
                changed = True
        if changed:
            # The leader's bucket may have become due earlier than the
            # wait a worker computed from the old urgency.
            self._cv.notify_all()

    def _promote_follower_locked(self, leader: Job, bucket: list) -> None:
        """A queued leader left the bucket (cancel): its first follower —
        if any — takes over as the fingerprint's leader and engine run,
        inheriting the remaining followers' folded urgency."""
        fp = leader.fingerprint
        if fp is None or self._inflight_fp.get(fp) is not leader:
            return
        followers = self._followers.get(fp, [])
        if followers:
            promoted = followers.pop(0)
            self._inflight_fp[fp] = promoted
            bucket.append(promoted)  # same board => same bucket key
            for waiting in followers:
                self._fold_urgency_locked(promoted, waiting)
        else:
            del self._inflight_fp[fp]

    # -- batch forming -----------------------------------------------------

    def _bucket_due_at(self, jobs: list[Job]) -> float:
        """When this bucket becomes dispatch-ready on its own (age/deadline)."""
        oldest = min(j.accepted_at for j in jobs)
        due = oldest + self.flush_age
        for j in jobs:
            if j.deadline_s is not None:
                due = min(due, j.accepted_at + j.deadline_s)
        return due

    def _bucket_ready(self, pending: list[Job], now: float) -> bool:
        """The ONE dispatch-readiness predicate (size / age+deadline /
        drain), shared by claiming and by the pipelined dispatcher's
        stall classification so the two can never disagree."""
        return (
            self._draining
            or len(pending) >= self.max_batch
            or self._bucket_due_at(pending) <= now
        )

    def _claim_locked(self, now: float):
        """Pick the most urgent ready bucket and take a batch from it."""
        best = None
        for key, pending in self._buckets.items():
            if not pending or not self._bucket_ready(pending, now):
                continue
            urgency = min(j.dispatch_key() for j in pending)
            if best is None or urgency < best[0]:
                best = (urgency, key)
        if best is None:
            return None
        key = best[1]
        pending = sorted(self._buckets[key], key=Job.dispatch_key)
        take, rest = pending[: self.max_batch], pending[self.max_batch:]
        self._buckets[key] = rest
        self._queued -= len(take)
        for job in take:
            job.transition(SCHEDULED)
        self._inflight += 1
        self.metrics.set_gauge("queue_depth", self._queued)
        self.metrics.set_gauge("inflight_batches", self._inflight)
        return key, take

    def _next_due(self) -> float | None:
        due = None
        for pending in self._buckets.values():
            if pending:
                d = self._bucket_due_at(pending)
                due = d if due is None else min(due, d)
        return due

    # -- the worker --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                claimed = None
                while not self._stopped:
                    claimed = self._claim_locked(self._clock())
                    if claimed is not None:
                        break
                    due = self._next_due()
                    wait = None if due is None else max(0.0, due - self._clock())
                    self._cv.wait(timeout=wait)
                if claimed is None:
                    return  # stopped
            key, batch = claimed
            try:
                self._execute(key, batch)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self.metrics.set_gauge("inflight_batches", self._inflight)
                    self._cv.notify_all()

    @staticmethod
    def _stamp(batch: list[Job], milestone: str, t: float) -> None:
        """Stamp one timeline milestone on every job of a batch (the splits
        run at batch granularity, so batchmates share each stamp)."""
        for job in batch:
            job.timeline[milestone] = t

    def _begin_batch(self, batch: list[Job], started: float) -> None:
        for job in batch:
            job.started_at = started
            job.timeline["claimed"] = started
            job.transition(RUNNING)
            self.metrics.observe(
                "queue_latency_seconds", started - job.accepted_at
            )
            obs_trace.flow("job", job.flow_id(), "t", state="claimed")

    def _on_retry(self, key: BucketKey, batch: list[Job]):
        def on_retry(attempt, err, delay):
            self.metrics.inc("batch_retries_total")
            if self.retry_budget is not None:
                # Exported on the SERVING registry so it fleet-merges and
                # reaches `gol top` like every other serving series.
                self.metrics.set_gauge(
                    "retry_budget_remaining",
                    round(self.retry_budget.remaining(), 3),
                )
            logger.warning(
                "batch %s (%d jobs) failed attempt %d, retrying in %.2fs "
                "(%s: %s)",
                key.label(), len(batch), attempt, delay,
                type(err).__name__, err,
            )

        return on_retry

    def _fail_batch(self, key: BucketKey, batch: list[Job], err) -> None:
        finished = self._clock()
        logger.error(
            "batch %s (%d jobs) failed: %s: %s",
            key.label(), len(batch), type(err).__name__, err,
        )
        # Followers coalesced behind these leaders share their fate: the
        # one engine run they were waiting on is not coming.
        for job in batch + self._take_followers(batch):
            job.finished_at = finished
            job.timeline["done"] = finished
            job.error = f"{type(err).__name__}: {err}"
            job.transition(FAILED)
            self.metrics.inc("jobs_failed_total")
            obs_trace.flow("job", job.flow_id(), "f", state="failed")
            self._journal_terminal(JobJournal.record_failed, job)

    def _take_followers(self, batch: list[Job]) -> list[Job]:
        """Atomically claim every follower coalesced behind these jobs and
        retire their in-flight registrations. Called AFTER the leaders'
        results are in the cache (finish) or known unobtainable (fail), so
        a submit racing this pop either still coalesces or hits the
        fresh cache entry — never falls through to a third path that
        loses the result."""
        taken: list[Job] = []
        with self._cv:
            for job in batch:
                if job.fingerprint is None:
                    continue
                # Followers belong to whoever holds the in-flight
                # registration. A deadline-expired leader hands its
                # registration to a promoted follower BEFORE failing —
                # the waiters behind the new leader are not this job's
                # to take.
                if self._inflight_fp.get(job.fingerprint) is job:
                    del self._inflight_fp[job.fingerprint]
                    taken.extend(self._followers.pop(job.fingerprint, []))
            if taken:
                self._queued -= len(taken)
                self.metrics.set_gauge("queue_depth", self._queued)
                self._cv.notify_all()
        return taken

    def _finish_batch(self, key: BucketKey, batch: list[Job], results,
                      started: float) -> None:
        finished = self._clock()
        elapsed = max(finished - started, 1e-9)
        # The same rung run_batch padded to: occupancy is boards over the
        # slots the compiled program actually ran.
        slots = pad_batch(len(batch))
        self.metrics.inc("batches_total")
        self.metrics.inc("boards_total", len(batch))
        self.metrics.observe("batch_occupancy", len(batch) / slots)
        self.metrics.observe("run_latency_seconds", elapsed)
        self.metrics.set_gauge("boards_per_sec", len(batch) / elapsed)
        cells = 0
        sparse_tiles = 0
        sparse_occupancy = None
        for job, result in zip(batch, results):
            job.finished_at = finished
            job.timeline["done"] = finished
            job.result = result
            job.transition(DONE)
            self.metrics.inc("jobs_completed_total")
            # End-to-end latency per SLO priority class (obs/slo.py keys
            # its per-priority p99 objectives on these histogram names).
            latency = finished - job.accepted_at
            self.metrics.observe("job_latency_seconds", latency)
            self.metrics.observe(
                "job_latency_seconds_" + priority_class(job.priority), latency
            )
            # Achieved useful work: actual board cells times the generations
            # the board really ran (padding slots and canvas don't count).
            # Sparse results report their own achieved work — active tiles
            # times tile area — because universe x generations is exactly
            # the cost the sparse lane exists to NOT pay.
            if result.cell_updates is not None:
                cells += result.cell_updates
            else:
                cells += job.height * job.width * result.generations
            if result.tiles_simulated is not None:
                sparse_tiles += result.tiles_simulated
            if result.occupancy is not None:
                sparse_occupancy = result.occupancy
        # Fed to the dispatch-gap sampler (obs/sampler.py): achieved
        # cell-updates per bucket.
        self.metrics.inc("serve_cell_updates_total", cells)
        self.metrics.inc(
            "serve_cell_updates_total_" + metric_label(key.label()), cells
        )
        # Sparse-lane work series on the serving registry (they reach
        # `top` like any serving series): tile-steps executed and the last
        # finished universe's live-tile occupancy.
        if sparse_tiles:
            self.metrics.inc("sparse_tiles_simulated_total", sparse_tiles)
        if sparse_occupancy is not None:
            self.metrics.set_gauge("sparse_occupancy", sparse_occupancy)
        # Write-through BEFORE retiring the in-flight registrations: a
        # submit racing the handoff either still coalesces behind the
        # leader or hits the tier the result just landed in — there is no
        # window where it would redundantly re-run. A no_cache job never
        # acquired a fingerprint, so it never writes.
        if self.cache is not None:
            for job in batch:
                if job.fingerprint is not None:
                    r = job.result
                    self.cache.put(job.fingerprint, CacheEntry(
                        grid=r.grid,
                        generations=r.generations,
                        exit_reason=r.exit_reason,
                        # Packed-kernel readbacks carry their word layout:
                        # the CAS packed payload then writes without a
                        # re-pack, exactly as a packed response serves.
                        words=r.words,
                    ))
        followers = self._take_followers(batch)
        for f in followers:
            leader = self._inflight_result(f, batch)
            f.finished_at = finished
            f.timeline["done"] = finished
            f.result = JobResult(
                grid=leader.grid,
                generations=leader.generations,
                exit_reason=leader.exit_reason,
                cached="coalesced",
                words=leader.words,
            )
            f.transition(DONE)
            self.metrics.inc("jobs_completed_total")
            latency = finished - f.accepted_at
            self.metrics.observe("job_latency_seconds", latency)
            self.metrics.observe(
                "job_latency_seconds_" + priority_class(f.priority), latency
            )
            obs_trace.flow("job", f.flow_id(), "f", state="coalesced")
        # One journal append + fsync for the whole batch's done records
        # (identical lines to per-job appends — replay is oblivious): the
        # per-record fsync was the last per-*job* serial host cost on the
        # hot path. Durability contract unchanged: a crash before the
        # append re-runs the batch idempotently after replay, exactly like
        # a single lost record.
        self._journal_terminal(JobJournal.record_done_many, batch + followers)

    @staticmethod
    def _inflight_result(follower: Job, batch: list[Job]) -> JobResult:
        """The leader result a follower coalesced behind (same fingerprint,
        same batch — leaders complete with their own batch)."""
        for job in batch:
            if job.fingerprint == follower.fingerprint:
                return job.result
        raise RuntimeError(
            f"follower {follower.id} has no leader in its batch "
            f"(fingerprint {follower.fingerprint})"
        )

    def _drop_expired(self, key: BucketKey, batch: list[Job]) -> list[Job]:
        """Deadline enforcement at batch dispatch: jobs whose propagated
        budget (X-Gol-Deadline -> Job.expires_at) is already spent fail
        HERE — with the DeadlineExceeded 504 contract and their timeline
        intact — instead of burning a slot in the compiled program for an
        answer nobody is waiting for. Jobs without a budget (every old
        client) pass untouched; a batch can lose any subset including all
        of it (the caller skips the dispatch entirely then)."""
        now = self._clock()
        expired = [j for j in batch
                   if j.expires_at is not None and j.expires_at <= now]
        if not expired:
            return batch
        self.metrics.inc("deadline_expired_total", len(expired))
        # An expired LEADER's followers are other clients' jobs with
        # their own (possibly absent) budgets — only the leader's clock
        # ran out. Promote the first follower into the bucket as the
        # fingerprint's new leader (the cancel path's move) before
        # failing, so _fail_batch's follower sweep — which only claims
        # followers still registered to the failing job — takes nobody
        # who can still make their deadline.
        with self._cv:
            bucket = self._buckets.setdefault(key, [])
            for job in expired:
                self._promote_follower_locked(job, bucket)
            self._cv.notify_all()
        self._fail_batch(key, expired, DeadlineExceeded(
            "deadline budget spent before dispatch"
        ))
        return [j for j in batch if j not in expired]

    def _execute(self, key: BucketKey, batch: list[Job]) -> None:
        batch = self._drop_expired(key, batch)
        if not batch:
            return
        started = self._clock()
        self._begin_batch(batch, started)
        staged = None

        def attempt():
            # Stage ONCE, retry dispatch+complete from the retained host
            # staging: re-staging on retry would re-run the whole stack +
            # np.packbits pass for operands that are already retained (and
            # bit-identical — staging is deterministic). A failure inside stage() itself leaves ``staged``
            # unset, so the next attempt re-stages — the only case where
            # staging can legitimately run twice.
            nonlocal staged
            if self._split is None:
                return self._run_batch(key, batch)
            stage_fn, dispatch_fn, complete_fn = self._split
            if staged is None:
                t0 = self._clock()
                with obs_trace.span("pipeline.stage", bucket=key.label(),
                                    jobs=len(batch)):
                    staged = stage_fn(key, batch)
                self._stamp(batch, "stage_start", t0)
                self._stamp(batch, "staged", self._clock())
            inflight = dispatch_fn(staged)
            t = self._clock()
            self._stamp(batch, "dispatched", t)
            # The classic worker blocks on readback immediately, so the
            # device segment collapses to ~0 here and the compute time
            # shows in `readback` — the pipelined lanes pull them apart.
            self._stamp(batch, "readback_start", t)
            results = complete_fn(inflight)
            self._stamp(batch, "completed", self._clock())
            return results

        try:
            # The batch span: what a traced `gol serve` session exports and
            # what `GET /debug/trace` shows mid-flight. One span per
            # dispatched batch, labeled with its padding bucket — a session
            # serving two bucket shapes shows two distinct batch lanes.
            with obs_trace.span("serve.batch", bucket=key.label(),
                                jobs=len(batch)):
                results = self.retry.call(
                    attempt,
                    retryable=self.retryable,
                    on_retry=self._on_retry(key, batch),
                    budget=self.retry_budget,
                )
                # Flow FINISH inside the batch span, so Perfetto binds the
                # arrow head to the enclosing serve.batch slice.
                for job in batch:
                    obs_trace.flow("job", job.flow_id(), "f",
                                   bucket=key.label())
        except Exception as err:  # noqa: BLE001 - every job must terminate
            self._fail_batch(key, batch, err)
            return
        self._finish_batch(key, batch, results, started)

    # -- the pipelined dispatcher/completer pair ---------------------------

    def _ready_bucket_exists(self, now: float) -> bool:
        """Whether some bucket is dispatch-ready (the claim predicate,
        without claiming) — used only to classify a full-window wait as a
        pipeline stall."""
        return any(
            pending and self._bucket_ready(pending, now)
            for pending in self._buckets.values()
        )

    def _dispatch_loop(self) -> None:
        """Claim -> stage -> dispatch (the per-batch dispatch runs the
        batch's loop, a resident lane's refills a slot and returns; the
        completer fetches and crops).

        Claims only while fewer than ``pipeline_depth`` batches are between
        claim and completion (the bounded in-flight window); a wait forced
        by a full window with work ready counts as ``pipeline_stalls_total``
        (the signal that depth, not load, is the limiter)."""
        window = self._window
        while True:
            with self._cv:
                claimed = None
                stalled = False
                while not self._stopped:
                    now = self._clock()
                    if self._inflight >= self.pipeline_depth:
                        # Window full: only a completion (or stop) can make
                        # progress — wait for its notify, NOT for a bucket
                        # due time (a past-due bucket would turn the timed
                        # wait into a hot spin against the completer's lock).
                        if not stalled and self._ready_bucket_exists(now):
                            stalled = True
                            self.metrics.inc("pipeline_stalls_total")
                        self._cv.wait()
                        continue
                    claimed = self._claim_locked(now)
                    if claimed is not None:
                        break
                    due = self._next_due()
                    wait = None if due is None else max(0.0, due - self._clock())
                    self._cv.wait(timeout=wait)
                if claimed is None:
                    break  # stopped
            key, batch = claimed
            window.put(self._launch(key, batch))
        # Completion order is the window order; the sentinel follows every
        # already-posted flight, so the completer drains then exits.
        window.close()

    def _launch(self, key: BucketKey, batch: list[Job]) -> _Flight:
        batch = self._drop_expired(key, batch)
        started = self._clock()
        flight = _Flight(key=key, batch=batch, started=started)
        if not batch:
            return flight  # everything expired: an empty (no-op) flight
        self._begin_batch(batch, started)
        if self._split is None:
            return flight  # completer runs self._run_batch whole
        stage_fn, dispatch_fn, _ = self._split
        try:
            t0 = self._clock()
            with obs_trace.span("pipeline.stage", bucket=key.label(),
                                jobs=len(batch)):
                flight.staged = stage_fn(key, batch)
            self._stamp(batch, "stage_start", t0)
            self._stamp(batch, "staged", self._clock())
            flight.inflight = dispatch_fn(flight.staged)
            self._stamp(batch, "dispatched", self._clock())
        except Exception as err:  # noqa: BLE001 - completer owns terminality
            # Carried to the completer so ONE code path (its retry policy)
            # classifies every failure: a transient dispatch error retries
            # the whole batch there; a hard one fails the jobs there.
            flight.error = err
        return flight

    def _complete_loop(self) -> None:
        """Readback + journal, in completion (window) order."""
        window = self._window
        while True:
            flight = window.get()
            if flight is None:
                return  # dispatcher closed the window after its last put
            try:
                self._complete_flight(flight)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self.metrics.set_gauge("inflight_batches", self._inflight)
                    self._cv.notify_all()

    def _complete_flight(self, flight: _Flight) -> None:
        key, batch = flight.key, flight.batch
        if not batch:
            return  # every job expired at launch; nothing was dispatched
        complete_fn = self._split[2] if self._split is not None else None

        def attempt():
            # First attempt consumes the pipelined dispatch; retries re-run
            # dispatch + complete of THIS batch from the retained host
            # staging (no re-stacking/packbits) — GoL runs are pure
            # functions of the input, so a re-run is idempotent (the same
            # contract the depth-1 worker's retry relies on). When there is
            # no staging to retain (injected run_batch, or the failure was
            # in stage() itself), the retry re-runs the whole batch.
            if not flight.consumed:
                flight.consumed = True
                if flight.error is not None:
                    raise flight.error
                if flight.inflight is not None:
                    self._stamp(batch, "readback_start", self._clock())
                    results = complete_fn(flight.inflight)
                    self._stamp(batch, "completed", self._clock())
                    return results
            if self._split is not None and flight.staged is not None:
                _, dispatch_fn, _ = self._split
                inflight = dispatch_fn(flight.staged)
                t = self._clock()
                self._stamp(batch, "dispatched", t)
                self._stamp(batch, "readback_start", t)
                results = complete_fn(inflight)
                self._stamp(batch, "completed", self._clock())
                return results
            return self._run_batch(key, batch)

        try:
            with obs_trace.span("serve.batch", bucket=key.label(),
                                jobs=len(batch)):
                results = self.retry.call(
                    attempt,
                    retryable=self.retryable,
                    on_retry=self._on_retry(key, batch),
                    budget=self.retry_budget,
                )
                for job in batch:
                    obs_trace.flow("job", job.flow_id(), "f",
                                   bucket=key.label())
        except Exception as err:  # noqa: BLE001 - every job must terminate
            self._fail_batch(key, batch, err)
            return
        self._finish_batch(key, batch, results, flight.started)

    def _journal_terminal(self, record_fn, job_or_batch) -> None:
        """Append terminal record(s), surviving journal I/O failure.

        A failing fsync/write (ENOSPC, EIO) here must never escape: it would
        kill the worker thread, strand the rest of the batch in RUNNING, and
        stop all dispatch. The in-memory state stays authoritative for this
        process; the cost of a dropped terminal record is a re-run after a
        restart (idempotent), logged loudly and counted so operators see the
        journal degrading before that.

        In resident mode the append rides the ``gol-serve-journal`` writer
        thread so the completer's readbacks overlap the fsyncs; everywhere
        else (the classic worker and the plain pipeline) it runs inline."""
        if self.journal is None:
            return
        window = self._journal_window  # snapshot: stop() may null the field
        if window is not None:
            try:
                window.put((record_fn, job_or_batch))
            except RuntimeError:
                # stop() closed the window after a join timeout while this
                # completion was still in flight — append inline rather
                # than drop the record (or kill the completer).
                self._journal_append(record_fn, job_or_batch)
                return
            self.metrics.set_gauge("journal_queue_depth", len(window))
            return
        self._journal_append(record_fn, job_or_batch)

    def _journal_append(self, record_fn, job_or_batch) -> None:
        jobs = job_or_batch if isinstance(job_or_batch, list) else [job_or_batch]
        try:
            record_fn(self.journal, job_or_batch)
        except OSError as err:
            self.metrics.inc("journal_errors_total")
            logger.error(
                "journal append failed for job(s) %s (%s) — state is held "
                "in-memory only; a restart will re-run them: %s: %s",
                ",".join(j.id for j in jobs), jobs[0].state,
                type(err).__name__, err,
            )
            return
        # The timeline's final milestone: the terminal record is durable
        # (fsynced) — on both journal lanes, inline and the resident writer
        # thread, where it visibly trails `done`.
        t = self._clock()
        for j in jobs:
            j.timeline["journaled"] = t

    def _journal_loop(self) -> None:
        """The resident lanes' journal writer: drains (record_fn, jobs)
        items until the window closes, then exits — stop() joins it, so a
        clean shutdown (drained or not) flushes every pending record. The
        window is captured once: a stop() that times out waiting and nulls
        the field cannot make a still-draining writer drop queued items."""
        window = self._journal_window
        while True:
            item = window.get()
            if item is None:
                return
            self._journal_append(*item)
            self.metrics.set_gauge("journal_queue_depth", len(window))

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            out = {
                "queued": self._queued,
                "coalesced_waiting": sum(
                    len(v) for v in self._followers.values()
                ),
                "inflight_batches": self._inflight,
                "buckets": {
                    k.label(): len(v) for k, v in self._buckets.items() if v
                },
                "draining": self._draining,
                "jobs": len(self._jobs),
            }
        if self._resident is not None:
            out["resident_rings"] = self._resident.state()
        return out


# Re-exported for callers that only import the scheduler module.
__all__ = [
    "DEFAULT_DISPATCH_RETRY",
    "DeadlineExceeded",
    "Draining",
    "JournalUnavailable",
    "QueueFull",
    "Scheduler",
]
