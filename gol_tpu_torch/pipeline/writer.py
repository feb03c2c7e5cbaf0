"""Async checkpoint writer: hide payload I/O behind device compute.

The port of ``gol_tpu/pipeline/writer.py``, same protocol. The synchronous
``CheckpointManager.save`` stalls the card for the whole save: device->host
copy, serialize, payload write, fsync, manifest commit. This writer splits
it into the reference's async-variant shape (src/game_mpi_async.c posts
``MPI_File_iwrite_at`` at one boundary and ``MPI_Wait``s at the next):

- **foreground** (``save``, on the segment loop's thread): drain the
  previous boundary's write and commit its manifest, fire the boundary
  fault probe, then take a ``HostSnapshot`` (the side-stream copy into
  this writer's pinned buffers) and hand it to the writer thread. The
  segment loop runs the next segment at once.
- **background** (one ``gol-ckpt-writer`` thread): payload write, fsync
  and CRCs from the snapshot (``CheckpointManager._write_payload``, the
  sync path's code fed host shards).
- **deferred commit** (foreground, at the next boundary or at
  ``drain()``): manifest commit and GC. A checkpoint does not exist until
  its deferred wait lands, so a kill mid-write leaves the previous
  committed checkpoint as the newest durable state.

Observability: ``pipeline.stage`` / ``pipeline.write`` / ``pipeline.drain``
spans; ``checkpoint_write_hidden_seconds`` and ``pipeline_stalls_total``
counters and the ``ckpt_writer_queue_depth`` gauge in the global registry;
the flight recorder's dump carries the writer's queue state.
"""

from __future__ import annotations

import logging
import threading
import time

from gol_tpu_torch.obs import recorder, registry as obs_registry, trace as obs_trace
from gol_tpu_torch.pipeline.snapshot import HostSnapshot, SnapshotBuffers
from gol_tpu_torch.resilience import faults
from gol_tpu_torch.resilience.checkpoint import state_shape

logger = logging.getLogger(__name__)

_STATE_PROVIDER = "checkpoint_writer"
QUEUE_DEPTH_GAUGE = "ckpt_writer_queue_depth"


class _WriteTask:
    """One boundary's pending write: snapshot in, checksums (or error) out."""

    __slots__ = ("snapshot", "shape", "generation", "counter", "started",
                 "done", "checksums", "error", "write_seconds")

    def __init__(self, snapshot, shape, generation: int, counter: int):
        self.snapshot = snapshot
        self.shape = shape
        self.generation = generation
        self.counter = counter
        self.started = False
        self.done = False
        self.checksums: dict | None = None
        self.error: BaseException | None = None
        self.write_seconds = 0.0


class AsyncCheckpointWriter:
    """Pipelined front end over one ``CheckpointManager``.

    At most one write is in flight. ``save`` is called from the segment
    loop at each boundary; ``drain`` commits the final pending checkpoint
    at the end of the run; ``close`` joins the thread and never raises
    (call it in a ``finally``).
    """

    THREAD_NAME = "gol-ckpt-writer"

    def __init__(self, manager, registry=None):
        self._mgr = manager
        self._reg = registry or obs_registry.default()
        self._cv = threading.Condition()
        self._task: _WriteTask | None = None
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False
        self._buffers = SnapshotBuffers()
        recorder.add_state_provider(_STATE_PROVIDER, self._state)

    # -- the foreground half -------------------------------------------------

    def save(self, state, generation: int, counter: int) -> None:
        """The boundary call: drain the previous write, snapshot, hand off.
        Returns once the snapshot is on the host; the caller may run the
        next segment at once."""
        self.drain()  # the Wait-at-next-boundary: commit the previous write
        if self._mgr.sheds_save():
            return
        try:
            faults.on_checkpoint_boundary(generation)
            if self._mgr._already_committed(generation):
                # A resumed run re-reached a committed boundary; counted as
                # the sync path counts it.
                self._reg.inc("checkpoint_saves_total")
                return
            self._mgr._sweep_stale(generation)
            with obs_trace.span("pipeline.stage", generation=int(generation)):
                snapshot = HostSnapshot(state, self._buffers)
            task = _WriteTask(snapshot, state_shape(state, self._mgr.mesh_shape),
                              int(generation), int(counter))
            with self._cv:
                if self._closed:
                    raise RuntimeError("async checkpoint writer is closed")
                self._ensure_thread()
                self._task = task
                self._reg.set_gauge(QUEUE_DEPTH_GAUGE, 1)
                self._cv.notify_all()
        except BaseException:
            # BaseException: an InjectedCrash at the boundary probe is
            # counted as the sync path counts it.
            self._reg.inc("checkpoint_save_failures_total")
            raise

    def drain(self) -> None:
        """Wait for the in-flight payload write and commit its manifest.
        Raises the background write's error, if any, one boundary late,
        like the ``MPI_Wait`` status of the reference's async writes."""
        with self._cv:
            task = self._task
        if task is None:
            return
        with obs_trace.span("pipeline.drain", generation=task.generation):
            t0 = time.perf_counter()
            with self._cv:
                stalled = not task.done
                while not task.done:
                    self._cv.wait()
                self._task = None
                self._reg.set_gauge(QUEUE_DEPTH_GAUGE, 0)
            waited = time.perf_counter() - t0
            if stalled:
                # The segment finished before the write did.
                self._reg.inc("pipeline_stalls_total")
            self._reg.inc(
                "checkpoint_write_hidden_seconds",
                max(0.0, task.write_seconds - waited),
            )
            try:
                if task.error is not None:
                    raise task.error
                self._mgr._commit_manifest(task.shape, task.generation,
                                           task.counter, task.checksums)
                # --checkpoint-keep pruning, behind the deferred commit and
                # under the manager's lock the payload write also holds.
                self._mgr.prune()
            except BaseException:
                self._reg.inc("checkpoint_save_failures_total")
                raise
            self._reg.inc("checkpoint_saves_total")

    def close(self) -> None:
        """Join the writer thread. Never raises: a crash unwinding through
        the segment loop must not be masked by a pending write's failure,
        which is logged instead."""
        with self._cv:
            self._closed = True
            self._stop = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
            task, self._task = self._task, None
        if thread is not None:
            thread.join(timeout=60)
            if thread.is_alive():  # pragma: no cover - pathological I/O hang
                logger.error("async checkpoint writer thread did not join")
        recorder.remove_state_provider(_STATE_PROVIDER)
        self._reg.set_gauge(QUEUE_DEPTH_GAUGE, 0)
        if task is not None and task.error is not None:
            logger.warning(
                "async checkpoint writer: dropping failed write for "
                "generation %d at close: %s: %s", task.generation,
                type(task.error).__name__, task.error,
            )
        elif task is not None and not task.done:
            logger.warning(
                "async checkpoint writer: abandoning uncommitted write for "
                "generation %d at close", task.generation,
            )

    # -- the background half -------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name=self.THREAD_NAME, daemon=True
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                    self._task is None or self._task.started
                ):
                    self._cv.wait()
                if self._stop:
                    return
                task = self._task
                task.started = True
            t0 = time.perf_counter()
            try:
                with obs_trace.span("pipeline.write",
                                    generation=task.generation):
                    task.checksums = self._mgr._write_payload(
                        task.snapshot.state, task.generation)
            except BaseException as err:  # noqa: BLE001 - InjectedCrash too
                task.error = err
            task.write_seconds = time.perf_counter() - t0
            task.snapshot = None  # release the buffer before the next one
            with self._cv:
                task.done = True
                self._cv.notify_all()

    # -- introspection (flight recorder) ------------------------------------

    def _state(self) -> dict:
        with self._cv:
            task = self._task
            return {
                "queue_depth": 0 if task is None else 1,
                "pending_generation": None if task is None else task.generation,
                "busy": bool(task is not None and task.started and not task.done),
            }
