"""Macro jobs on the serving stack.

The port's copy of ``gol_tpu/macro/serve.py``.

A macro job is a sparse job with ``"macro": true`` in its submitted (and
journaled) spec: same ``rle`` + universe extents contract, same
``batcher.SPARSE_KERNEL`` bucket and scheduler lanes — the flag only
changes WHICH engine ``sparse.serve.run_batch`` hands the board to. The
results are byte-identical to the sparse lane's (that is the macro
engine's contract), so the flag is an execution hint, not a semantic
axis: replaying a journal with the flag flipped would produce the same
answer, only slower or faster.

The memo is process-global like the sparse tile memo, but keyed per leaf
size (one hash-consed ``NodeStore`` + ``MacroMemo`` per tile edge):
node identity is only meaningful within one store, and jobs with
different tiles cannot share trees. Mounting a CAS directory makes the
content tier a cross-restart, cross-job knowledge base — every deep run
warms every later one.
"""

from __future__ import annotations

import logging

from gol_tpu_torch.macro.advance import MacroMemo
from gol_tpu_torch.macro.engine import simulate_macro
from gol_tpu_torch.macro.node import NodeStore
from gol_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

_MEMOS: dict[int, MacroMemo] = {}
_MEMO_ENTRIES = 8192
_CAS_DIR: str | None = None


def memo(tile: int) -> MacroMemo:
    """The worker-wide macro memo for one leaf size (built on first
    use)."""
    m = _MEMOS.get(tile)
    if m is None:
        m = MacroMemo(NodeStore(tile), entries=_MEMO_ENTRIES,
                      cas_dir=_CAS_DIR)
        _MEMOS[tile] = m
    return m


def configure(entries: int | None = None, cas_dir: str | None = None) -> None:
    """Reset the worker-wide memos (tests, and servers mounting a CAS
    tier beside their journal partition)."""
    global _MEMO_ENTRIES, _CAS_DIR
    _MEMO_ENTRIES = entries or 8192
    _CAS_DIR = cas_dir
    _MEMOS.clear()


def run_job(job):
    """Run one macro job to completion (pure function of the journaled
    spec — safe to re-run on retry, and the memo makes the re-run
    cheap)."""
    from gol_tpu_torch.serve.jobs import JobResult
    from gol_tpu_torch.sparse.serve import board_for

    board = board_for(job)
    with obs_trace.span("macro.job", job=job.id,
                        universe=f"{job.height}x{job.width}",
                        tile=job.tile):
        result = simulate_macro(board, job.config, memo(job.tile))
    return JobResult(
        grid=None,
        generations=result.generations,
        exit_reason=result.exit_reason,
        rle=result.board.to_rle(),
        population=result.board.population(),
        universe=(job.height, job.width),
        tiles_simulated=result.stats.leaf_cases,
        cell_updates=result.stats.leaf_gen_steps * (2 * job.tile) ** 2,
        occupancy=result.board.occupancy(),
    )
