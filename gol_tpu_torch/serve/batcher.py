"""Padding-bucket batcher: which requests share a batch runner.

The port's copy of ``gol_tpu/serve/batcher.py``. Two jobs may ride one
batch iff they agree on everything the runner is built for. That
agreement is the ``BucketKey`` — (padded height, padded width,
convention, kernel flavor, similarity settings). Everything else (each
board's true extent and its generation limit) is a runtime operand of the
batched runner, so one runner per bucket and batch size serves every job
the bucket ever sees (``engine.make_batch_runner`` is lru-cached; the first
dispatch of a bucket builds the kernels, every later one only runs).

Padding policy: board extents round up to ``PAD_QUANTUM`` so near-miss
shapes (30x30, 31x32, ...) pool in one bucket; boards that exactly fill
their canvas take the packed kernel (B1) where the width packs, padded
boards the masked kernel (B2). Batch sizes round up the ``BATCH_SIZES``
ladder, with inert zero boards in the padding slots.

The geometry comes from ``_plan()``: the serve plan ``tune`` measured and
cached (``tune/select.serve_plan``), or the built-in one — quantum 32, the
full ladder, depth 1 — when none was, byte-identically.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from gol_tpu_torch import engine, platform_env
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.ops import packed_math, stencil_batch
from gol_tpu_torch.serve.jobs import Job, JobResult

# Board extents round up to multiples of this (also the packed-word width, so
# every exact-fit bucket width packs).
PAD_QUANTUM = 32

# The batch-size ladder: request counts round up to the next rung. The last
# rung is the hard batch cap.
BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64)
MAX_BATCH = BATCH_SIZES[-1]

# The sparse-lane bucket kernel tag (``sparse/``): jobs submitted as RLE
# patterns over giant universes. A sparse bucket's jobs are not stacked
# into one canvas — each job batches its own active TILES through this
# module's ladder inside the sparse engine — so the stage/dispatch/complete
# split below routes sparse keys to ``sparse/serve``.
SPARSE_KERNEL = "sparse"


_PLAN = None  # resolved once per process; tests reset via _reset_plan()


def _plan():
    global _PLAN
    if _PLAN is None:
        from gol_tpu_torch.tune import select

        _PLAN = select.serve_plan(MAX_BATCH)
    return _PLAN


def _reset_plan() -> None:
    """Forget the consulted plan (tests, and an in-process tune-then-serve)."""
    global _PLAN
    _PLAN = None


def pad_dim(n: int, plan=None) -> int:
    """Round a board extent up to the bucket quantum.

    ``plan`` (a tune ``ServePlan``) overrides the consulted geometry — the
    tuner's search measures THROUGH these helpers, so the geometry it times
    is by construction the geometry the server later runs."""
    quantum = (plan or _plan()).pad_quantum
    return max(quantum, -(-n // quantum) * quantum)


def pad_batch(n: int, plan=None) -> int:
    """Round a job count (1..MAX_BATCH) up the plan's batch-size ladder:
    the padded size the runner actually runs, also the denominator of the
    occupancy metric (occupancy never exceeds 1)."""
    if not 1 <= n <= MAX_BATCH:
        raise ValueError(f"batch count must be in [1, {MAX_BATCH}], got {n}")
    ladder = (plan or _plan()).batch_ladder
    return ladder[bisect.bisect_left(ladder, n)]


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Everything two jobs must agree on to share a batch runner."""

    height: int  # padded canvas height
    width: int  # padded canvas width
    convention: str
    kernel: str  # engine batch mode: packed | byte | masked
    check_similarity: bool = True
    similarity_frequency: int = 3

    def label(self) -> str:
        return (
            f"{self.height}x{self.width}/{self.convention}/{self.kernel}"
            + ("" if self.check_similarity else "/nosim")
        )


def bucket_for(job: Job) -> BucketKey:
    """Assign a job its padding bucket: exact-fit boards (extents already on
    the quantum) get the uniform kernels, anything else the masked bucket of
    its rounded shape (``engine.resolve_batch_mode`` decides). Sparse (RLE)
    jobs get the sparse bucket of their universe extents."""
    if job.rle is not None:
        return BucketKey(
            height=job.height,
            width=job.width,
            convention=job.convention,
            kernel=SPARSE_KERNEL,
            check_similarity=job.check_similarity,
            similarity_frequency=job.similarity_frequency,
        )
    ph, pw = pad_dim(job.height), pad_dim(job.width)
    mode = engine.resolve_batch_mode([job.height], [job.width], (ph, pw))
    return BucketKey(
        height=ph,
        width=pw,
        convention=job.convention,
        kernel=mode,
        check_similarity=job.check_similarity,
        similarity_frequency=job.similarity_frequency,
    )


@dataclasses.dataclass
class StagedServeBatch:
    """One bucket batch staged on the host (validated, stacked, packed)."""

    key: BucketKey
    jobs: list
    staged: engine.StagedBatch


@dataclasses.dataclass
class InflightServeBatch:
    """One bucket batch dispatched to the device, results not yet fetched."""

    key: BucketKey
    jobs: list
    inflight: engine.InflightBatch


def _check_batch(key: BucketKey, jobs: list[Job]) -> None:
    if len(jobs) > MAX_BATCH:
        raise ValueError(f"batch of {len(jobs)} exceeds MAX_BATCH={MAX_BATCH}")
    for job in jobs:
        jk = bucket_for(job)
        if jk != key:
            raise ValueError(
                f"job {job.id} belongs to bucket {jk.label()}, "
                f"not {key.label()}"
            )


def _results(results) -> list[JobResult]:
    return [
        JobResult(grid=r.grid, generations=r.generations,
                  exit_reason=r.exit_reason, words=r.words)
        for r in results
    ]


def stage(key: BucketKey, jobs: list[Job]) -> StagedServeBatch:
    """Host half of a dispatch: validate membership, stack, pad, pack.
    Raises on empty/oversized batches and foreign jobs."""
    if key.kernel == SPARSE_KERNEL:
        from gol_tpu_torch.sparse import serve as sparse_serve

        return sparse_serve.stage(key, jobs)
    if not jobs:
        raise ValueError("cannot stage an empty batch")
    _check_batch(key, jobs)
    staged = engine.stage_batch(
        [job.board for job in jobs],
        [job.config for job in jobs],
        padded_shape=(key.height, key.width),
        pad_batch_to=pad_batch(len(jobs)),
        temporal_depth=_plan().temporal_depth,
        # Jobs that retained their packed words stage straight from them
        # (no np.packbits pass; engine_stage_packs_total does not move).
        packed_boards=(
            [job.words for job in jobs] if key.kernel == "packed" else None
        ),
    )
    return StagedServeBatch(key=key, jobs=list(jobs), staged=staged)


def dispatch(staged: StagedServeBatch) -> InflightServeBatch:
    """Dispatch a staged batch (``engine.dispatch_batch``: the loop runs
    here, one sync per block; results stay on the device)."""
    if staged.key.kernel == SPARSE_KERNEL:
        from gol_tpu_torch.sparse import serve as sparse_serve

        return sparse_serve.dispatch(staged)
    return InflightServeBatch(
        key=staged.key, jobs=staged.jobs,
        inflight=engine.dispatch_batch(staged.staged),
    )


def complete(inflight: InflightServeBatch) -> list[JobResult]:
    """Fetch an in-flight batch and crop per-job results (job order)."""
    if inflight.key.kernel == SPARSE_KERNEL:
        from gol_tpu_torch.sparse import serve as sparse_serve

        return sparse_serve.complete(inflight)
    return _results(engine.complete_batch(inflight.inflight))


def run_batch(key: BucketKey, jobs: list[Job]) -> list[JobResult]:
    """Run one bucket's batch through the batched engine.

    Stacks the boards into the bucket canvas (batch dimension rounded up the
    ladder with inert zero boards), runs the cached runner, and crops each
    board's slice back out. Per-board results are bit-identical to solo runs
    (the engine contract); ordering matches ``jobs``."""
    if key.kernel == SPARSE_KERNEL:
        from gol_tpu_torch.sparse import serve as sparse_serve

        return sparse_serve.run_batch(key, jobs)
    if not jobs:
        return []
    _check_batch(key, jobs)
    total = pad_batch(len(jobs))
    with obs_trace.span("batcher.run_batch", bucket=key.label(),
                        jobs=len(jobs), slots=total):
        results = engine.simulate_batch(
            [job.board for job in jobs],
            [job.config for job in jobs],
            padded_shape=(key.height, key.width),
            pad_batch_to=total,
            temporal_depth=_plan().temporal_depth,
        )
    return _results(results)


def warm(key: BucketKey, batch: int = MAX_BATCH) -> None:
    """Build a bucket's runner and its kernels ahead of traffic: one run on
    inert operands (all-zero boards with generation limit 0 never enter
    the loop in either convention; on the card that builds and loads the
    kernel library the bucket launches)."""
    if key.kernel == SPARSE_KERNEL:
        return  # sparse buckets build runners per tile size, not per canvas
    total = pad_batch(min(batch, MAX_BATCH))
    runner = engine.make_batch_runner(
        (key.height, key.width),
        total,
        key.convention,
        key.check_similarity,
        key.similarity_frequency,
        key.kernel,
        _plan().temporal_depth,
    )
    device = platform_env.resolve_device()
    if key.kernel == "packed":
        boards = packed_math.words_from_numpy(
            np.zeros((total, key.height, key.width // 32), np.uint32), device)
    else:
        boards = torch.zeros((total, key.height, key.width), dtype=torch.uint8,
                             device=device)
    if device.type == "cuda":
        stencil_batch.load_kernels()
    # Extents of 1 (not 0): the masked kernel wraps indices mod each
    # board's extent.
    ones = np.ones((total,), np.int32)
    runner(boards, ones, ones, np.zeros((total,), np.int32))
