"""The sparse job lane of the serving stack.

The port's copy of ``gol_tpu/sparse/serve.py``.

Sparse jobs arrive through the same ``POST /jobs`` contract as dense ones
(``rle`` + universe extents instead of ``cells``), land in a dedicated
bucket (``batcher.SPARSE_KERNEL``), and ride every scheduler lane —
classic worker, pipelined dispatcher/completer, resident servers —
through the same stage/dispatch/complete split the batcher exposes. The
difference is WHERE the batching happens: a dense bucket batches boards
into one batch runner; a sparse job batches its own active TILES
through the bucket ladder inside ``sparse.engine``, so the split here is
thin — stage validates membership, dispatch is a pass-through (the sparse
loop needs the host, there is nothing to launch asynchronously), and
complete runs the simulations (idempotent, so the scheduler's retry
policy applies unchanged).

Tile memoization is process-global on purpose: every sparse job on a
worker shares one ``TileMemo``, so repeated tile content ACROSS jobs
(the same pattern resubmitted, common still-life debris) hits without any
job-level fingerprint — the sparse counterpart of the result cache,
which sparse jobs deliberately do not enter (their answer is the memo'd
tile work itself; ``scheduler.submit`` skips the consult for them).
"""

from __future__ import annotations

import logging

from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.sparse.board import SparseBoard
from gol_tpu_torch.sparse.engine import simulate_sparse
from gol_tpu_torch.sparse.memo import TileMemo

logger = logging.getLogger(__name__)

_MEMO: TileMemo | None = None
_MEMO_ENTRIES = 8192


def memo() -> TileMemo:
    """The worker-wide tile memo (built on first sparse dispatch)."""
    global _MEMO
    if _MEMO is None:
        _MEMO = TileMemo(entries=_MEMO_ENTRIES)
    return _MEMO


def configure(entries: int | None = None, cas_dir: str | None = None) -> None:
    """Rebuild the worker-wide memo (tests, and servers mounting a CAS
    tier beside their journal partition)."""
    global _MEMO
    _MEMO = TileMemo(entries=entries or _MEMO_ENTRIES, cas_dir=cas_dir)


def board_for(job) -> SparseBoard:
    """A job's initial occupancy index, straight from its journaled spec
    (geometry-first — the dense canvas never exists)."""
    return SparseBoard.from_pattern(
        job.pattern, job.place_x, job.place_y,
        job.height, job.width, job.tile,
    )


def run_batch(key, jobs) -> list:
    """Run a sparse bucket's claimed jobs, in order (the sparse analog of
    ``batcher.run_batch``; per-job tile batching happens inside the sparse
    engine). Pure function of the specs — safe to re-run on retry."""
    from gol_tpu_torch.macro import serve as macro_serve
    from gol_tpu_torch.serve.jobs import JobResult

    out = []
    for job in jobs:
        if getattr(job, "macro", False):
            # Macro jobs share the sparse bucket (same input form, same
            # scheduler lanes); only the engine differs — and its results
            # are byte-identical by contract, just reached in O(log) jumps.
            out.append(macro_serve.run_job(job))
            continue
        with obs_trace.span("sparse.job", job=job.id,
                            universe=f"{job.height}x{job.width}",
                            tile=job.tile):
            result = simulate_sparse(board_for(job), job.config, memo())
        out.append(JobResult(
            grid=None,
            generations=result.generations,
            exit_reason=result.exit_reason,
            rle=result.board.to_rle(),
            population=result.board.population(),
            universe=(job.height, job.width),
            tiles_simulated=result.stats.tiles_active,
            cell_updates=result.stats.cell_updates(job.tile),
            occupancy=result.board.occupancy(),
        ))
    return out


def stage(key, jobs):
    """Membership-validated no-op staging (there is no host stacking to
    overlap — tile staging happens per generation inside the engine)."""
    from gol_tpu_torch.serve import batcher

    if not jobs:
        raise ValueError("cannot stage an empty batch")
    for job in jobs:
        jk = batcher.bucket_for(job)
        if jk != key:
            raise ValueError(
                f"job {job.id} belongs to bucket {jk.label()}, "
                f"not {key.label()}"
            )
    return batcher.StagedServeBatch(key=key, jobs=list(jobs), staged=None)


def dispatch(staged):
    """Pass-through: the sparse loop is host-driven, so the work runs at
    complete() on the completer/worker thread (retries re-run it whole)."""
    from gol_tpu_torch.serve import batcher

    return batcher.InflightServeBatch(
        key=staged.key, jobs=staged.jobs, inflight=None
    )


def complete(inflight) -> list:
    return run_batch(inflight.key, inflight.jobs)
