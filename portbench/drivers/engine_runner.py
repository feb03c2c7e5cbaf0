"""Closed-loop simulations through the port's main path.

The runner is what ``python -m gol_tpu_torch <width> <height> <input>``
times as ``Execution time``: ``engine.make_runner(shape, config,
kernel="auto")`` called on a uint8 grid on the card, then fenced
(``cli._execute``). File reading and writing are not in the window.

Set-up makes the configuration's ``grids`` distinct soups (the traffic's
``density``) on the card from the seed, builds
the runner (the kernels' build or load, the tuner's plan consult) and runs
every grid once. The window then runs simulations back to back, cycling
through the grids, until ``seconds`` have passed; the last one runs to its
end. With ``trace`` the head of the window (``TRACE_S``) runs under
``torch.profiler`` and the program's span tracer is on throughout.

The check: every simulation's generation count, and the final grids of a
sample drawn from the seed (for each grid one occurrence in the first
``PICK_SPAN``, and the last one), against the plain reference
(``portbench/reference/life.py``) run once per distinct grid after the
window. A soup this large runs to the generation limit, so the window
never reaches an exit; after the window the same runner therefore also
runs two grids that settle (``SETTLING``: a pattern drawn from the seed,
tiled over the cell's shape and rolled by a seeded offset), one that dies
and one that goes still, and their counts and final grids are held to the
reference too: the emptiness and similarity tests, the flag readbacks
and the replays that find the exit's generation.

``memory_peak_bytes`` is one input grid, what the runner keeps between
calls and the most it held at once during a window simulation (its
scratch and its result), not what the harness keeps for the check.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from gol_tpu_torch import engine
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.profiler import fence
from gol_tpu_torch.ops import stencil_packed
from gol_tpu_torch.tune import select

from portbench import devtrace
from portbench.harness import Outcome, process_age_s
from portbench.readings import Readings
from portbench.reference import life

TRACE_S = 3.0
PICK_SPAN = 4
SPAN_RING = 1 << 20
_RAND_CELLS = 1 << 26
SETTLING = Path(__file__).resolve().parent.parent / "reference" / "settling.json"


def log(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def make_grid(height: int, width: int, density: float,
              gen: torch.Generator, device) -> torch.Tensor:
    """A uint8 grid whose cells are each 1 with probability ``density``,
    drawn on ``device`` in blocks of rows."""
    grid = torch.empty((height, width), dtype=torch.uint8, device=device)
    rows = max(1, _RAND_CELLS // width)
    for r in range(0, height, rows):
        n = min(rows, height - r)
        grid[r:r + n] = torch.rand((n, width), generator=gen,
                                   device=device) < density
    return grid


def settling_grids(height: int, width: int, pick: random.Random,
                   device) -> dict:
    """``{"dies": grid, "still": grid}``: for each kind a pattern of
    ``SETTLING`` drawn with ``pick``, rolled by a drawn offset within its
    box and tiled over ``height`` x ``width`` (cut where the box does not
    divide it)."""
    with open(SETTLING) as f:
        table = json.load(f)
    box = table["box"]
    grids = {}
    for kind in ("dies", "still"):
        rows = pick.choice(table[kind])["rows"]
        tile = torch.tensor([[ch == "o" for ch in row.ljust(box, ".")]
                             for row in rows], dtype=torch.uint8)
        tile = torch.nn.functional.pad(tile, (0, 0, 0, box - len(rows)))
        tile = torch.roll(tile, (pick.randrange(box), pick.randrange(box)),
                          (0, 1)).to(device)
        reps = (-(-height // box), -(-width // box))
        grids[kind] = tile.repeat(*reps)[:height, :width].contiguous()
    return grids


def game_config(config: dict, traffic: dict) -> GameConfig:
    return GameConfig(gen_limit=config["gen_limit"],
                      check_similarity=config["check_similarity"],
                      similarity_frequency=config["similarity_frequency"],
                      convention=traffic["convention"])


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device: str, make_runner=None) -> Outcome:
    stages = [process_age_s()]
    dev = torch.device(device)
    height, width = config["height"], config["width"]
    cells = height * width
    gcfg = game_config(config, traffic)
    pick = random.Random(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    grids = [make_grid(height, width, traffic["density"], gen, dev)
             for _ in range(config["grids"])]
    n = len(grids)
    picks = [pick.randrange(PICK_SPAN) for _ in range(n)]
    settling = settling_grids(height, width, pick, dev)
    fence(grids)
    stages.append(process_age_s())
    cuda = dev.type == "cuda"
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    if trace:
        obs_trace.enable(SPAN_RING)
    runner = (make_runner or engine.make_runner)(
        (height, width), gcfg, kernel="auto", device=dev)
    plan = select.engine_plan((height, width), gcfg, device=dev)
    stages.append(process_age_s())
    for g in grids:
        fence(runner(g))
    # What the runner keeps between calls, beside what it holds in one.
    resident = torch.cuda.memory_allocated(dev) - before if cuda else 0
    stages.append(process_age_s())
    log(f"{n} grids of {height}x{width}, convention {gcfg.convention}, "
        f"tuned plan {plan.label() if plan else None}; set-up s: start to "
        f"driver {stages[0]:.2f}, grids {stages[1] - stages[0]:.2f}, runner "
        f"{stages[2] - stages[1]:.2f}, a simulation of each grid "
        f"{stages[3] - stages[2]:.2f}")
    if cuda:
        # Room in the allocator's cache for the kept grids, so that the
        # window allocates nothing new.
        spare = [torch.empty_like(grids[0]) for _ in range(2 * n + 2)]
        del spare

    records = []                  # (grid, generations, seconds)
    kept = [{} for _ in range(n)]
    seen = [0] * n
    launches0 = dict(stencil_packed.LAUNCHES)
    counters0 = obs_registry.default().snapshot()["counters"]
    prof, trace_path = None, None
    held = 0                      # the most the runner held in a call
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    setup_s = process_age_s()
    t_start = time.perf_counter()
    i = 0
    while True:
        g = i % n
        ranges = (torch.profiler.record_function if prof is not None
                  else lambda name: contextlib.nullcontext())
        if cuda:
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with ranges("portbench.sim"):
            t0 = time.perf_counter()
            final, gens = runner(grids[g])
            with ranges("portbench.fence"):
                fence(final)
            t1 = time.perf_counter()
        if cuda:
            held = max(held, torch.cuda.max_memory_allocated(dev) - base)
        records.append((g, gens, t1 - t0))
        if seen[g] == picks[g]:
            kept[g]["pick"] = (seen[g], final)
        kept[g]["last"] = (seen[g], final)
        seen[g] += 1
        del final
        i += 1
        if prof is not None and (t1 - t_start >= TRACE_S
                                 or t1 - t_start >= seconds):
            trace_path = _stop(prof)
            traced = (i, _deltas(launches0, stencil_packed.LAUNCHES))
            prof = None
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    traced_sims = traced[0] if trace else 0
    launches = _deltas(launches0, stencil_packed.LAUNCHES)
    counters = _deltas(counters0, obs_registry.default().snapshot()["counters"])
    spans = obs_trace.snapshot() if trace else []
    obs_trace.disable()
    dtrace = None
    if trace_path:
        dtrace = devtrace.load(trace_path)
        os.unlink(trace_path)
        if dtrace is not None:
            log(f"traced {traced[0]} simulations: {dtrace.device_events} "
                f"device events, launches counted {traced[1]}")
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if cuda:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": grids[0].nbytes + resident + held}
    if dtrace is not None:
        info["busy_s"] = dtrace.busy_s
        info["window_s"] = dtrace.window_s
    settled = {}
    for kind, grid in settling.items():
        final, gens = runner(grid)
        fence(final)
        settled[kind] = (final, gens)
    del runner, final
    if cuda:
        torch.cuda.empty_cache()
        log(smi())

    t_check = time.perf_counter()
    check, failed = _check(grids, records, kept, settling, settled, gcfg)
    log(f"{len(records)} simulations in {window_s:.3f} s; reference "
        f"{time.perf_counter() - t_check:.3f} s over {n} grids and "
        f"{len(settling)} that settle")

    sim_s = [r[2] for r in records]
    work = sum(cells * r[1] for r in records)
    e2e = {
        "cell_updates_per_s": work / window_s,
        "execution_ms_p95": _p95(sim_s) * 1e3,
        "setup_s": setup_s,
    }
    readings = Readings(
        height=height, width=width, generations=[r[1] for r in records],
        sim_s=sim_s, launches=launches, counters=counters, spans=spans,
        trace=dtrace, traced_sims=traced_sims)
    breakdown = None
    if dtrace is not None:
        breakdown = {"device_ops": dtrace.device_ops,
                     "idle_gaps": dtrace.idle_gaps}
    return Outcome(end_to_end=e2e, readings=readings, check=check,
                   attempted=len(records), failed=failed, device=info,
                   breakdown=breakdown)


def _deltas(before: dict, after: dict) -> dict:
    """The counters of ``after`` that moved since ``before``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _stop(prof) -> str:
    """Stop the profiler and export its Chrome trace to a temporary file."""
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def _p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _check(grids, records, kept, settling, settled, gcfg):
    """``(check, failed)``: each number compared with its limit, and how
    many answers were found wrong (window simulations and settling grids)."""
    def reference(grid):
        return life.run(grid, gcfg.gen_limit, gcfg.similarity_frequency,
                        gcfg.check_similarity, gcfg.convention)

    def wrong(ref, grid, final):
        if final.shape != grid.shape or final.dtype != torch.uint8:
            return grid.numel()
        return life.wrong_cells(ref, final)

    counts_wrong = cells_wrong = grids_wrong = unsampled = compared = 0
    for g, grid in enumerate(grids):
        ref, ref_gens = reference(grid)
        counts_wrong += sum(1 for r in records if r[0] == g and r[1] != ref_gens)
        sample = dict(kept[g].values())  # occurrence -> final grid
        unsampled += not sample
        for final in sample.values():
            compared += 1
            cells = wrong(ref, grid, final)
            cells_wrong += cells
            grids_wrong += cells > 0
        del ref
    settle_counts = settle_cells = settle_grids = 0
    exits = []
    for kind, grid in settling.items():
        final, gens = settled[kind]
        ref, ref_gens = reference(grid)
        exits.append(f"{kind} {gens} (reference {ref_gens})")
        cells = wrong(ref, grid, final)
        settle_counts += gens != ref_gens
        settle_cells += cells
        settle_grids += cells > 0 or gens != ref_gens
        del ref
    log(f"{compared} final grids and {len(records)} generation counts "
        f"compared; settling grids' generations: {', '.join(exits)}")
    check = {
        "cells_wrong": {"value": cells_wrong, "limit": 0},
        "counts_wrong": {"value": counts_wrong, "limit": 0},
        "grids_unsampled": {"value": unsampled, "limit": 0},
        "settle_cells_wrong": {"value": settle_cells, "limit": 0},
        "settle_counts_wrong": {"value": settle_counts, "limit": 0},
    }
    return check, counts_wrong + grids_wrong + settle_grids


def smi() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return "nvidia-smi: " + out.stdout.strip().replace("\n", " | ")
