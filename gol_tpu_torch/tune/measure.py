"""Timed trials behind a byte-exact correctness gate.

The port of ``gol_tpu/tune/measure.py``, the dense/sparse crossover
included. Measurement discipline:

- ``time.perf_counter`` ONLY;
- every candidate is warmed (its kernels built and launched once) before
  any sample;
- per-candidate samples are reduced by an **outlier-trimmed median** (drop
  the extremes, median the rest);
- completion is forced by a device sync on the final state
  (``obs.profiler.fence``);
- and NO timing counts until the candidate passes the **correctness gate**:
  its final grid and generation count are byte-compared against the
  reference output (the default candidate's run — itself oracle-checked on
  small grids). A mismatching candidate is excluded from selection.

A candidate that fails to build or run is excluded too, never hidden: the
failure is logged, counted (``tuner_gate_failures_total``), kept in the
result as an ``error: <type>`` trial, and listed in the report's
``excluded`` line. The searches are exhaustive over ``space`` candidates;
winners are returned as plans ready for ``plans.PlanStore.put``.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.obs import registry as obs_registry, trace as obs_trace
from gol_tpu_torch.obs.profiler import fence
from gol_tpu_torch.tune import space

logger = logging.getLogger(__name__)


def _count_trial(trial: Trial) -> Trial:
    """Record a finished trial in the global obs registry (and as a trace
    event): a tuning session's progress is then visible over SIGUSR1 /
    ``GET /debug/trace`` like every other long-running phase."""
    reg = obs_registry.default()
    reg.inc("tuner_trials_total")
    if trial.gate != "ok":
        reg.inc("tuner_gate_failures_total")
    obs_trace.event("tune.trial", label=trial.label, gate=trial.gate,
                    median_s=trial.median_s)
    return trial

# A grid this small is cheap to oracle-check, so the reference output itself
# is verified against ground truth before any candidate is gated on it.
_ORACLE_GATE_CELLS = 1 << 16


def trimmed_median(samples) -> float:
    """Median after dropping the min and max (when there are enough samples
    to spare them): one cold-cache or preempted run cannot shift the stat."""
    ordered = sorted(samples)
    if not ordered:
        raise ValueError("no samples")
    if len(ordered) >= 4:
        ordered = ordered[1:-1]
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2


def timed_samples(fn, *, warmup: int = 1, iters: int = 5) -> list[float]:
    """Run ``fn`` ``warmup`` untimed + ``iters`` timed times."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return samples


@dataclasses.dataclass
class Trial:
    label: str
    plan: object  # EnginePlan | ServePlan
    median_s: float | None  # None when the gate failed (never timed)
    samples: list[float]
    gate: str  # "ok" | "mismatch" | "error: <type>"

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "plan": self.plan.to_dict(),
            "median_s": self.median_s,
            "samples": [round(s, 6) for s in self.samples],
            "gate": self.gate,
        }


@dataclasses.dataclass
class SearchResult:
    kind: str  # "engine" | "serve"
    context: dict  # human-readable search context (shape, convention, ...)
    trials: list[Trial]
    default_label: str
    winner: object  # the winning plan (EnginePlan | ServePlan)
    # Serve searches only: the winner geometry's marginal kernel rate per
    # bucket (sanitized label -> cell-updates/s), the roofline the live
    # dispatch-gap monitor (obs/sampler.py) compares achieved rates against.
    marginal: dict | None = None

    @property
    def winner_trial(self) -> Trial:
        label = self.winner.label()
        return next(t for t in self.trials if t.label == label)

    @property
    def default_trial(self) -> Trial:
        return next(t for t in self.trials if t.label == self.default_label)

    @property
    def speedup(self) -> float:
        """default median / winner median: >= 1.0 by construction (the
        default is in the candidate set and the winner is the argmin)."""
        return self.default_trial.median_s / self.winner_trial.median_s

    def to_dict(self) -> dict:
        out = {
            "kind": self.kind,
            "context": self.context,
            "default": self.default_label,
            "winner": self.winner.label(),
            "winner_plan": self.winner.to_dict(),
            "tuned_vs_default": round(self.speedup, 4),
            "gates_all_ok": all(t.gate == "ok" for t in self.trials),
            "trials": [t.to_dict() for t in self.trials],
        }
        if self.marginal:
            out["marginal_kernel_cells_per_sec"] = self.marginal
        return out


def _pick_winner(trials: list[Trial], default_label: str):
    ok = [t for t in trials if t.gate == "ok"]
    if not ok:
        raise RuntimeError("no candidate passed the correctness gate")
    bad = [t.label for t in trials if t.gate != "ok"]
    if bad:
        logger.warning("correctness gate FAILED for candidate(s) %s — "
                       "excluded from selection", bad)
    winner = min(ok, key=lambda t: t.median_s)
    # Within measurement noise, keep the default: a plan should only exist
    # when it buys something real (2% here is well inside the trimmed-median
    # scatter of shared machines).
    default = next((t for t in ok if t.label == default_label), None)
    if default is not None and default is not winner:
        if default.median_s / winner.median_s < 1.02:
            winner = default
    return winner


def run_engine_search(
    height: int,
    width: int,
    config: GameConfig,
    mesh=None,
    *,
    packed_state: bool = False,
    seed: int = 42,
    warmup: int = 1,
    iters: int = 5,
    quick: bool = False,
    device=None,
) -> SearchResult:
    """Exhaustively measure the engine candidates for one shape/context.

    The reference output is the DEFAULT candidate's run (the built-in
    ladder's choice, built with its explicit plan so an existing plan cache
    cannot shift the baseline), itself byte-checked against the NumPy
    oracle when the grid is small enough to afford it.
    """
    from gol_tpu_torch import engine, platform_env
    from gol_tpu_torch.io import bitpack
    from gol_tpu_torch.ops import packed_math
    from gol_tpu_torch.parallel.mesh import gather, split

    dev = platform_env.resolve_device(device)
    ctx = space.context_for((height, width), config, mesh, packed_state, dev)
    candidates = space.engine_candidates(ctx, quick=quick)
    default_label = candidates[0].label()

    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 2, size=(height, width), dtype=np.uint8)
    host_state = bitpack.pack_words(grid).view(np.int32) if packed_state else grid
    if mesh is None:
        operand = torch.from_numpy(host_state).to(dev)
    else:
        operand = split(host_state, mesh)

    def fetch(final) -> np.ndarray:
        if mesh is not None:
            final = gather(final, mesh.shape)
        if packed_state:
            return packed_math.words_to_numpy(final)
        return final.cpu().numpy()

    reference: tuple[np.ndarray, int] | None = None
    trials: list[Trial] = []
    for cand in candidates:
        try:
            runner = engine._build_runner(
                (height, width), config, cand.kernel or "auto", dev,
                segmented=False, packed_state=packed_state, mesh=mesh,
                plan=cand,
            )

            def run_once(runner=runner):
                final, gen = runner(operand)
                return fetch(final), int(gen)

            out_grid, out_gen = run_once()  # build + warm + gate material
        except Exception as err:  # noqa: BLE001 - candidate isolation
            # Candidates are built with explicit kernel names (no
            # fallback): one candidate that fails to build or launch
            # costs that candidate, logged and reported, not the whole
            # search. The default candidate stays fatal: with no
            # reference there is nothing to tune.
            if reference is None:
                raise
            logger.warning(
                "candidate %s failed to build/run (%s: %s); excluded",
                cand.label(), type(err).__name__, err,
            )
            trials.append(_count_trial(
                Trial(cand.label(), cand, None, [],
                      f"error: {type(err).__name__}")
            ))
            continue
        if reference is None:
            # First candidate IS the default: it becomes the reference,
            # after an oracle check where affordable.
            if not packed_state and height * width <= _ORACLE_GATE_CELLS:
                from gol_tpu_torch import oracle

                expect = oracle.run(grid, config)
                if not (np.array_equal(out_grid, expect.grid)
                        and out_gen == expect.generations):
                    raise RuntimeError(
                        f"default candidate {cand.label()} disagrees "
                        f"with the oracle on {height}x{width}/"
                        f"{config.convention} — refusing to tune against "
                        "a wrong reference"
                    )
            reference = (out_grid, out_gen)
        ok = (
            np.array_equal(out_grid, reference[0])
            and out_gen == reference[1]
        )
        if not ok:
            trials.append(_count_trial(
                Trial(cand.label(), cand, None, [], "mismatch")
            ))
            continue

        def timed(runner=runner):
            final, _ = runner(operand)
            fence(final)

        samples = timed_samples(timed, warmup=max(0, warmup - 1), iters=iters)
        trials.append(_count_trial(
            Trial(cand.label(), cand, trimmed_median(samples), samples, "ok")
        ))
        logger.info("  %-28s %8.3f ms", cand.label(),
                    trials[-1].median_s * 1e3)

    winner = _pick_winner(trials, default_label)
    return SearchResult(
        kind="engine",
        context={
            "height": height,
            "width": width,
            "convention": config.convention,
            "family": ctx.family,
            "mesh": f"{ctx.mesh_shape[0]}x{ctx.mesh_shape[1]}",
            "device_kind": ctx.device_kind,
            "gen_limit": config.gen_limit,
            "seed": seed,
            "iters": iters,
        },
        trials=trials,
        default_label=default_label,
        winner=winner.plan,
    )


# Serving-shaped request-count mix: the sizes a flush under light-to-bursty
# load actually dispatches (partial buckets, odd counts, one full batch).
_SERVE_COUNTS = (1, 3, 5, 8, 13, 21)


def measure_marginal_rate(
    board_height: int,
    board_width: int,
    convention: str,
    plan,
    *,
    gen_limit: int = 8,
    batch: int = 8,
    seed: int = 7,
    repeats: int = 3,
) -> dict[str, float]:
    """The winner geometry's **marginal kernel rate**: cell-updates/s of the
    batch runner with every fixed cost differenced out (timed at G and 3G
    generation limits, rate from the difference). Returned as {sanitized
    bucket label:
    rate} so the serve-side dispatch-gap monitor (obs/sampler.py) can match
    it against the live ``serve_cell_updates_total_<bucket>`` counters —
    both sides spell the bucket through ``obs.registry.metric_label``."""
    from gol_tpu_torch import engine
    from gol_tpu_torch.obs.registry import metric_label
    from gol_tpu_torch.serve import batcher
    from gol_tpu_torch.serve.batcher import BucketKey

    ph = batcher.pad_dim(board_height, plan=plan)
    pw = batcher.pad_dim(board_width, plan=plan)
    total = batcher.pad_batch(
        min(batch, plan.batch_ladder[-1]), plan=plan
    )
    rng = np.random.default_rng(seed)
    chunk = [
        rng.integers(0, 2, size=(board_height, board_width), dtype=np.uint8)
        for _ in range(min(batch, total))
    ]
    config_for = lambda g: GameConfig(gen_limit=g, convention=convention)
    g1, g2 = gen_limit, 3 * gen_limit

    def staged_for(g):
        return engine.stage_batch(
            chunk, config_for(g), padded_shape=(ph, pw), pad_batch_to=total,
            temporal_depth=plan.temporal_depth,
        )

    times = {}
    for g in (g1, g2):
        engine.complete_batch(engine.dispatch_batch(staged_for(g)))  # warm
        best = float("inf")
        for _ in range(repeats):
            # Fresh staging per run, as the server stages; the transfer
            # cost is identical at g1 and g2, so the difference subtracts
            # it out along with dispatch and readback.
            s = staged_for(g)
            t0 = time.perf_counter()
            engine.complete_batch(engine.dispatch_batch(s))
            best = min(best, time.perf_counter() - t0)
        times[g] = best
    per_gen = max(times[g2] - times[g1], 1e-9) / (g2 - g1)
    rate = board_height * board_width * len(chunk) / per_gen
    mode = engine.resolve_batch_mode(
        [board_height] * len(chunk), [board_width] * len(chunk), (ph, pw)
    )
    key = BucketKey(height=ph, width=pw, convention=convention, kernel=mode)
    return {metric_label(key.label()): round(rate, 1)}


def run_serve_search(
    board_height: int,
    board_width: int,
    convention: str = "c",
    *,
    gen_limit: int = 8,
    nboards: int = 21,
    seed: int = 42,
    warmup: int = 1,
    iters: int = 5,
    max_batch: int = 64,
) -> SearchResult:
    """Measure the serve-bucket geometry candidates on one request shape.

    Each candidate's bucket math is applied THROUGH the batcher's own
    ``pad_dim``/``pad_batch`` (with the candidate as the plan override), so
    the measured geometry is exactly what the server later runs, driving
    ``engine.simulate_batch`` over a serving-shaped mix of request counts;
    the gate byte-compares every board of every candidate against solo
    engine runs.
    """
    from gol_tpu_torch import engine
    from gol_tpu_torch.serve import batcher

    candidates = space.serve_candidates(max_batch)
    default_label = candidates[0].label()
    config = GameConfig(gen_limit=gen_limit, convention=convention)

    rng = np.random.default_rng(seed)
    boards = [
        rng.integers(0, 2, size=(board_height, board_width), dtype=np.uint8)
        for _ in range(nboards)
    ]
    solo = [engine.simulate(b, config) for b in boards]
    chunks = []
    i = 0
    for count in _SERVE_COUNTS:
        count = min(count, nboards)
        chunks.append([boards[(i + j) % nboards] for j in range(count)])
        i += count

    trials: list[Trial] = []
    for cand in candidates:
        ph = batcher.pad_dim(board_height, plan=cand)
        pw = batcher.pad_dim(board_width, plan=cand)

        def dispatch(cand=cand, ph=ph, pw=pw, gate=False):
            for chunk in chunks:
                results = engine.simulate_batch(
                    chunk, config, padded_shape=(ph, pw),
                    pad_batch_to=batcher.pad_batch(len(chunk), plan=cand),
                    temporal_depth=cand.temporal_depth,
                )
                if gate:
                    for board, result in zip(chunk, results):
                        idx = next(
                            k for k, b in enumerate(boards) if b is board
                        )
                        if not (
                            np.array_equal(result.grid, solo[idx].grid)
                            and result.generations == solo[idx].generations
                        ):
                            return False
            return True

        if not dispatch(gate=True):  # build + warm + gate in one pass
            trials.append(_count_trial(
                Trial(cand.label(), cand, None, [], "mismatch")
            ))
            continue
        samples = timed_samples(dispatch, warmup=max(0, warmup - 1),
                                iters=iters)
        trials.append(_count_trial(
            Trial(cand.label(), cand, trimmed_median(samples), samples, "ok")
        ))
        logger.info("  %-28s %8.3f ms", cand.label(),
                    trials[-1].median_s * 1e3)

    winner = _pick_winner(trials, default_label)
    try:
        marginal = measure_marginal_rate(
            board_height, board_width, convention, winner.plan,
            gen_limit=gen_limit,
        )
    except Exception as err:  # noqa: BLE001 - the plan is still good
        logger.warning(
            "marginal-rate measurement failed (%s: %s); the plan persists "
            "without a dispatch-gap roofline", type(err).__name__, err,
        )
        marginal = None
    return SearchResult(
        kind="serve",
        context={
            "board": f"{board_height}x{board_width}",
            "convention": convention,
            "gen_limit": gen_limit,
            "counts": [len(c) for c in chunks],
            "device_kind": space.context_for(
                (board_height, board_width), config
            ).device_kind,
            "seed": seed,
            "iters": iters,
        },
        trials=trials,
        default_label=default_label,
        winner=winner.plan,
        marginal=marginal,
    )


@dataclasses.dataclass
class CrossoverResult:
    """One ``tune --sparse-crossover`` measurement: the per-host area
    where dense per-generation cost overtakes the sparse engine's."""

    auto_area: int
    dense_points: list  # [(area_cells, s_per_gen), ...]
    sparse_s_per_gen: float
    tile: int

    def to_dict(self) -> dict:
        return {
            "kind": "sparse_crossover",
            "auto_area": self.auto_area,
            "dense_points": [
                [int(a), round(s, 6)] for a, s in self.dense_points
            ],
            "sparse_s_per_gen": round(self.sparse_s_per_gen, 6),
            "tile": self.tile,
        }


def fit_crossover(dense_points, sparse_s_per_gen: float,
                  floor: int = 1 << 16, ceil: int = 1 << 36) -> int:
    """Solve the dense/sparse crossover area from measurements.

    Dense per-generation cost is linear in the canvas area (every cell is
    touched a fixed number of times: BENCH_r14's column grows ~4x per 4x
    area); the sparse engine's cost is flat in the UNIVERSE area (it
    tracks live tiles, which a fixed pattern load pins). Least-squares
    fit ``dense(area) = a * area + b`` through the measured points and
    solve ``dense(area) == sparse`` for area, clamped to the admissible
    band (a machine where dense wins everywhere measured still gets a
    finite threshold instead of infinity)."""
    if len(dense_points) < 2:
        raise ValueError("need >= 2 dense measurements to fit a slope")
    if sparse_s_per_gen <= 0:
        raise ValueError(f"sparse_s_per_gen must be > 0, "
                         f"got {sparse_s_per_gen}")
    xs = np.array([float(a) for a, _ in dense_points])
    ys = np.array([float(s) for _, s in dense_points])
    a, b = np.polyfit(xs, ys, 1)
    # Dense cost must GROW measurably across the probed band (>= 5% of
    # the mean sample over the span): a flat or negative fit — a fast
    # device, probe sizes all under its dispatch floor, or pure noise —
    # measures nothing, and extrapolating it would put the crossover at
    # an arbitrary clamp. Fail loudly instead.
    if a <= 0 or a * (xs.max() - xs.min()) < 0.05 * float(ys.mean()):
        raise ValueError(
            f"dense cost did not grow with area over the probe "
            f"(slope {a:.3e}); measure larger sizes"
        )
    crossover = (sparse_s_per_gen - b) / a
    return int(min(max(crossover, floor), ceil))


def run_sparse_crossover_search(
    tile: int = 256,
    gens: int = 12,
    iters: int = 3,
    quick: bool = False,
    device=None,
) -> CrossoverResult:
    """Measure THIS host's dense/sparse crossover (`--engine auto`'s
    threshold): dense per-generation wall time at a ladder of square
    universes (linear in area) vs the sparse engine on the same
    glider load (flat), fit and solved by ``fit_crossover``.

    The load mirrors BENCH_r14's: a handful of gliders — sparse cost
    pinned to a few tiles regardless of universe size. Dense probes stay
    small (the fit extrapolates the linear cost; probing 2^26 cells to
    learn the slope would burn minutes measuring what 2^22 already
    says). Sparse is measured at the LARGEST probe size: its flatness is
    the model, its value the only free parameter. ``device`` is the run's
    device (the platform default when None): the dense probes run there,
    and the sparse engine follows the platform default."""
    from gol_tpu_torch import engine, platform_env
    from gol_tpu_torch.io import rle as rle_codec
    from gol_tpu_torch.sparse.board import SparseBoard
    from gol_tpu_torch.sparse.engine import simulate_sparse

    sides = (1024, 2048) if quick else (1024, 2048, 4096)
    config = GameConfig(gen_limit=gens, check_similarity=False)
    glider = rle_codec.parse("x = 3, y = 3\nbob$2bo$3o!")

    def place_gliders(side: int) -> np.ndarray:
        grid = np.zeros((side, side), np.uint8)
        gh, gw = glider.shape
        # 5 gliders spread across the universe (tile-boundary crossers
        # included), the BENCH_r14 load shape; positions wrap into the
        # in-bounds band so every glider lands whole.
        for k in range(5):
            y = (k * side // 5) % (side - gh)
            x = (k * 2 * side // 7) % (side - gw)
            grid[y:y + gh, x:x + gw] = glider
        return grid

    dev = platform_env.resolve_device(device)
    dense_points = []
    for side in sides:
        grid = torch.from_numpy(place_gliders(side)).to(dev)
        runner = engine.make_runner((side, side), config, "auto", dev)

        def run_dense(runner=runner, grid=grid):
            final, _ = runner(grid)
            fence(final)  # the completion barrier

        s = trimmed_median(timed_samples(run_dense, warmup=1, iters=iters))
        dense_points.append((side * side, s / gens))
        logger.info("sparse-crossover: dense %dx%d = %.3f ms/gen",
                    side, side, 1000 * s / gens)

    side = sides[-1]
    # Built ONCE outside the timer: from_dense scans the whole canvas —
    # exactly the O(area) work the sparse engine elides — and timing it
    # would inflate sparse_s_per_gen and bias the crossover toward
    # dense. Each timed run simulates a fresh O(live-tiles) deep copy
    # (simulate_sparse mutates the board in place).
    import copy as _copy

    sparse_board = SparseBoard.from_dense(place_gliders(side), tile)

    def run_sparse():
        simulate_sparse(_copy.deepcopy(sparse_board), config)

    s = trimmed_median(timed_samples(run_sparse, warmup=1, iters=iters))
    sparse_s_per_gen = s / gens
    logger.info("sparse-crossover: sparse %dx%d (tile %d) = %.3f ms/gen "
                "(%d live tiles)", side, side, tile,
                1000 * sparse_s_per_gen, sparse_board.live_tiles)
    area = fit_crossover(dense_points, sparse_s_per_gen)
    logger.info("sparse-crossover: dense overtakes sparse at ~%d cells "
                "(%.0f^2)", area, area ** 0.5)
    return CrossoverResult(
        auto_area=area,
        dense_points=dense_points,
        sparse_s_per_gen=sparse_s_per_gen,
        tile=tile,
    )


def render_report(results: list[SearchResult]) -> str:
    """Human-readable tuning report (``gol tune`` prints/writes this)."""
    lines = ["# gol tune report", ""]
    for res in results:
        ctx = ", ".join(f"{k}={v}" for k, v in res.context.items())
        lines.append(f"## {res.kind}: {ctx}")
        lines.append("")
        lines.append("| candidate | median | vs default | gate |")
        lines.append("|---|---|---|---|")
        default_s = res.default_trial.median_s
        for t in sorted(res.trials,
                        key=lambda t: (t.median_s is None, t.median_s)):
            if t.median_s is None:
                lines.append(f"| {t.label} | — | — | {t.gate} |")
                continue
            marks = []
            if t.label == res.winner.label():
                marks.append("**winner**")
            if t.label == res.default_label:
                marks.append("default")
            ratio = default_s / t.median_s
            lines.append(
                f"| {t.label} {' '.join(marks)} | {t.median_s * 1e3:.3f} ms "
                f"| {ratio:.3f}x | {t.gate} |"
            )
        lines.append("")
        excluded = [f"{t.label} ({t.gate})" for t in res.trials
                    if t.gate != "ok"]
        if excluded:
            lines.append(f"excluded: {', '.join(excluded)}")
            lines.append("")
        lines.append(
            f"winner: `{res.winner.label()}` at {res.speedup:.3f}x the "
            "default ladder"
        )
        lines.append("")
    return "\n".join(lines)
