"""Device-resident ring lanes: the serve hot path's drain engine.

The port of ``gol_tpu/serve/resident.py``. The pipelined scheduler
(``serve/scheduler.py``, ``pipeline_depth >= 2``) overlaps host staging
with the card, but the port's ``engine.dispatch_batch`` runs each batch's
whole loop before it returns. This module takes that per-batch tax off the
dispatcher: each padding bucket gets a **ResidentLane**, a ring of R slots
over an ``engine.RingRunner`` per batch rung (the lane's own preallocated
slot storage, scratch stacks and flag buffer, its copy and compute streams
and its drain thread). The dispatcher stages batches into slots — each
slot's operand is copied to the card at submit time on the copy stream,
while an earlier drain computes — and a drain of up to R batches runs as
ONE batched loop over the filled slots on the drain thread.

The drain policy is JAX's:

- **ring full** — R slots staged: dispatch now (the steady-state path);
- **rung change** — a staged batch padded to a different batch-size rung
  cannot share the runner: flush the open slots first;
- **completion demand** — the completer reached a flight whose slot is
  staged but not dispatched: flush immediately (waiting could deadlock —
  the dispatcher may have nothing more to stage).

An idle lane (no unresolved drain) dispatches a slot at once, and a drain
read back by the completer flushes the slots that accumulated meanwhile.

Observability (the obs default registry, as in JAX): a
``serve.resident_loop`` span per drain readback (bucket, filled, ring);
the ``dispatch_gap_seconds`` histogram (host-observed idle between a drain
finishing and the next dispatch; 0 when the next drain queued behind it);
the ``ring_slot_occupancy`` gauge (filled/ring at each dispatch); and the
``resident_rings`` flight-recorder state provider (per-lane ``open``,
``ring``, ``unresolved_drains``, ``drains_total``).

Exactly-once is untouched: the lane never journals — the scheduler's
completer journals per batch from drain results, and a SIGKILL mid-ring
replays the unfinished jobs from the journal as the classic lanes do.
Unlike JAX's lane, the port's owns threads (one drain thread per rung
while drains are pending); ``close`` joins them, so none outlives the
scheduler.
"""

from __future__ import annotations

import threading
import time

from gol_tpu_torch import engine, platform_env
from gol_tpu_torch.obs import (
    recorder as obs_recorder,
    registry as obs_registry,
    trace as obs_trace,
)
from gol_tpu_torch.serve import batcher
from gol_tpu_torch.serve.batcher import BucketKey, StagedServeBatch
from gol_tpu_torch.serve.jobs import Job, JobResult

STATE_PROVIDER = "resident_rings"


class RingTicket:
    """One staged batch's claim on a ring slot (the lane's flight handle).
    ``fill`` keeps the slot's pinned host buffer alive until its copy's
    event has passed."""

    __slots__ = ("key", "jobs", "staged", "lane", "drain", "slot", "fill")

    def __init__(self, sstaged: StagedServeBatch, lane: "ResidentLane"):
        self.key = sstaged.key
        self.jobs = sstaged.jobs
        self.staged = sstaged.staged  # engine.StagedBatch (retained host side)
        self.lane = lane
        self.drain: _Drain | None = None  # set when the slot's drain dispatches
        self.slot = -1
        self.fill: engine.SlotFill | None = None


class _Drain:
    """One dispatched drain; resolved (read back) exactly once."""

    def __init__(self, lane: "ResidentLane", tickets: list[RingTicket],
                 inflight: engine.InflightRing):
        self._lane = lane
        self._tickets = tickets
        self._inflight = inflight
        self._lock = threading.Lock()
        self._results = None
        self._error: Exception | None = None

    def resolve(self, slot: int):
        """Per-slot results; the first caller waits for the drain thread
        (under the drain's own lock), later callers get the cached lists."""
        with self._lock:
            if self._results is None and self._error is None:
                try:
                    with obs_trace.span(
                        "serve.resident_loop",
                        bucket=self._lane.key.label(),
                        filled=len(self._tickets), ring=self._lane.ring,
                    ):
                        self._results = engine.complete_ring(self._inflight)
                except Exception as err:  # noqa: BLE001 - carried per ticket
                    self._error = err
                finally:
                    self._lane._drain_finished()
            if self._error is not None:
                # Every ticket of a failed drain surfaces the same error; the
                # scheduler's retry policy classifies it per batch and
                # re-dispatches from that batch's retained staging.
                raise self._error
            return self._results[slot]


class ResidentLane:
    """One bucket's ring: staged slots, at most one open (undispatched) set,
    and a ring runner per batch rung."""

    def __init__(self, key: BucketKey, ring: int, clock=time.perf_counter):
        self.key = key
        self.ring = ring
        self._clock = clock
        self._cv = threading.Condition()
        self._open: list[RingTicket] = []
        self._open_rung: int | None = None
        self._runners: dict[int, engine.RingRunner] = {}
        self._unresolved = 0  # dispatched drains not yet read back
        self._last_drain_end: float | None = None
        self.drains_total = 0

    def _runner(self, eng: engine.StagedBatch) -> engine.RingRunner:
        runner = self._runners.get(eng.total)
        if runner is None:
            runner = self._runners[eng.total] = engine.RingRunner(
                eng.padded_shape, eng.total, self.ring, eng.convention,
                eng.check_similarity, eng.similarity_frequency, eng.mode,
                eng.temporal_depth, platform_env.resolve_device(),
                thread_name=f"gol-serve-ring-{self.key.label()}-{eng.total}",
            )
        return runner

    def submit(self, sstaged: StagedServeBatch) -> RingTicket:
        """Stage a batch into the open ring and refill its slot on the card
        now (the copy runs while the previous drain computes). With no drain
        in flight the slot dispatches at once — an idle card must never wait
        for a fuller ring — while a busy one lets slots accumulate until the
        ring fills or the in-flight drain resolves (``_drain_finished``)."""
        ticket = RingTicket(sstaged, self)
        eng = sstaged.staged
        with self._cv:
            if self._open and self._open_rung != eng.total:
                # A different batch-size rung cannot share the runner —
                # flush the open slots ahead of it.
                self._flush_locked()
            ticket.slot = len(self._open)
            ticket.fill = self._runner(eng).fill(ticket.slot, eng.operand)
            self._open.append(ticket)
            self._open_rung = eng.total
            if len(self._open) >= self.ring or self._unresolved == 0:
                self._flush_locked()
        return ticket

    def complete(self, ticket: RingTicket) -> list[engine.BatchBoardResult]:
        """Block on the ticket's slot results (the deferred Wait)."""
        with self._cv:
            if ticket.drain is None:
                # The ticket's slot was staged behind a still-unresolved
                # drain whose resolution comes from THIS call chain —
                # dispatch now rather than deadlock.
                self._flush_locked()
        assert ticket.drain is not None
        return ticket.drain.resolve(ticket.slot)

    def _flush_locked(self) -> None:
        if not self._open:
            return
        tickets, self._open = self._open, []
        runner = self._runners[self._open_rung]
        self._open_rung = None
        # Compile-for-filled's counterpart: the drain runs the batched loop
        # over its k filled slots' boards only, never over R slots.
        staged_ring = engine.stage_ring([t.staged for t in tickets],
                                        self.ring, runner=runner)
        reg = obs_registry.default()
        now = self._clock()
        if self._last_drain_end is None or self._unresolved > 0:
            # Another drain is (or was just) occupying the card — this
            # dispatch queues behind it on the drain thread, no gap.
            gap = 0.0
        else:
            gap = max(0.0, now - self._last_drain_end)
        reg.observe("dispatch_gap_seconds", gap)
        reg.set_gauge("ring_slot_occupancy", len(tickets) / self.ring)
        inflight = engine.dispatch_ring(staged_ring,
                                        device_slots=[t.fill for t in tickets])
        drain = _Drain(self, tickets, inflight)
        self._unresolved += 1
        self.drains_total += 1
        for t in tickets:
            t.drain = drain

    def _drain_finished(self) -> None:
        with self._cv:
            self._unresolved -= 1
            self._last_drain_end = self._clock()
            # The card just went (or is about to go) idle: dispatch the
            # slots that accumulated while the drain ran BEFORE the
            # completer journals its results.
            if self._open:
                self._flush_locked()

    def state(self) -> dict:
        with self._cv:
            return {
                "open": len(self._open),
                "ring": self.ring,
                "unresolved_drains": self._unresolved,
                "drains_total": self.drains_total,
            }

    def close(self) -> None:
        """Join every rung's drain thread."""
        with self._cv:
            runners = list(self._runners.values())
        for runner in runners:
            runner.close()


class ResidentEngine:
    """The (stage, dispatch, complete) split the pipelined scheduler mounts
    when ``resident_ring > 1`` — same contract as the per-batch batcher
    split, with ``dispatch`` feeding a per-bucket ring instead of running
    one batch."""

    def __init__(self, ring: int, clock=time.perf_counter):
        if ring < 2:
            raise ValueError(f"resident ring must be >= 2, got {ring}")
        self.ring = ring
        self._clock = clock
        self._lock = threading.Lock()
        self._lanes: dict[BucketKey, ResidentLane] = {}
        self.reopen()

    # -- the split ---------------------------------------------------------

    def stage(self, key: BucketKey, jobs: list[Job]) -> StagedServeBatch:
        return batcher.stage(key, jobs)

    def dispatch(self, sstaged: StagedServeBatch):
        # Sparse buckets have no ring lane (their tile batching lives in
        # the sparse engine): they take the plain batcher split, so a
        # resident server serves sparse jobs through the same scheduler.
        if sstaged.key.kernel == batcher.SPARSE_KERNEL:
            return batcher.dispatch(sstaged)
        return self._lane(sstaged.key).submit(sstaged)

    def complete(self, ticket) -> list[JobResult]:
        if not isinstance(ticket, RingTicket):
            return batcher.complete(ticket)
        results = ticket.lane.complete(ticket)
        return [
            JobResult(grid=r.grid, generations=r.generations,
                      exit_reason=r.exit_reason)
            for r in results
        ]

    def split(self):
        return (self.stage, self.dispatch, self.complete)

    # -- lifecycle / introspection ----------------------------------------

    def _lane(self, key: BucketKey) -> ResidentLane:
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = ResidentLane(
                    key, self.ring, self._clock
                )
            return lane

    def state(self) -> dict:
        """Flat per-lane snapshot (the flight-recorder state provider)."""
        with self._lock:
            lanes = list(self._lanes.values())
        out = {}
        for lane in lanes:
            for k, v in lane.state().items():
                out[f"{lane.key.label()}.{k}"] = v
        return out

    def reopen(self) -> None:
        """(Re-)register the flight-recorder state provider."""
        obs_recorder.add_state_provider(STATE_PROVIDER, self.state)

    def close(self) -> None:
        """Drop the state provider, join the lanes' drain threads and forget
        the lanes (ring hygiene: no thread outlives the scheduler)."""
        obs_recorder.remove_state_provider(STATE_PROVIDER)
        with self._lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
        for lane in lanes:
            lane.close()
