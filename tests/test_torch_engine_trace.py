"""The solo engine's own tracing (gol_tpu_torch.engine, on the CPU): the
``engine.run`` span of each runner call, its ``engine.launch``,
``engine.readback`` and ``engine.replay`` ranges in a ``torch.profiler``
capture, and the ``engine_readbacks_total``, ``engine_runs_total`` and
``engine_generations_total`` counters.

The CPU takes the same blocked loop as the card (the ``packed`` kernel with
its 8-generation pass), so a 64 x 128 soup that lives past generation 40
runs blocks of 16, 16 and 8 generations: under the C convention the opening
alive test and three block reads, under the CUDA convention the three block
reads alone.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gol_tpu_torch import engine
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.obs import registry, trace

SHAPE = (64, 128)
LIMIT = 40
CONVENTIONS = (Convention.C, Convention.CUDA)
# (blocks, readbacks) of one whole run of the soup.
STAGES = {Convention.C: (3, 4), Convention.CUDA: (3, 3)}
COUNTERS = ("engine_readbacks_total", "engine_runs_total",
            "engine_generations_total", "engine_segments_total")
RANGES = ("engine.run", "engine.launch", "engine.readback", "engine.replay")
# A pattern that dies alone on a 64 x 64 torus, empty first at generation
# 52 (C): inside the first 8-generation pass of the block of generations
# 49-64, whose summary then hides the death, so the pass reruns exactly.
DIES_AT_52 = ["..oo.oo", "..oo.oo", "o.o.ooo", ".o.o.oo", ".o.o.o.", "oo..ooo",
              "..oo.oo"]


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    trace.disable()
    trace.clear()


def _soup() -> torch.Tensor:
    rng = np.random.default_rng(24)
    return torch.from_numpy((rng.random(SHAPE) < 0.5).astype(np.uint8))


def _dies() -> torch.Tensor:
    grid = torch.zeros((64, 64), dtype=torch.uint8)
    for r, row in enumerate(DIES_AT_52):
        for c, ch in enumerate(row):
            grid[r, c] = ch == "o"
    return grid


def _config(convention, limit=LIMIT) -> GameConfig:
    return GameConfig(gen_limit=limit, convention=convention)


def _counters() -> dict:
    reg = registry.default()
    return {k: reg.counter(k) for k in COUNTERS}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters().items()}


def _runs() -> list:
    return [s for s in trace.snapshot() if s["name"] == "engine.run"]


def _traced_call(runner, grid):
    """One runner call with tracing on: its result and the ring's spans."""
    trace.enable()
    trace.clear()
    out = runner(grid)
    return out, trace.snapshot()


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_run_span_counts_blocks_and_readbacks(convention):
    runner = engine.make_runner(SHAPE, _config(convention), device="cpu")
    (_, gens), spans = _traced_call(runner, _soup())
    assert gens == LIMIT  # the soup lives past the limit: no exit
    assert [s["name"] for s in spans] == ["engine.run"]
    attrs = spans[0]["attrs"]
    assert (attrs["blocks"], attrs["readbacks"]) == STAGES[convention]
    for key in ("launch_s", "wait_s", "turnaround_s"):
        assert attrs[key] > 0
    assert (attrs["launch_s"] + attrs["wait_s"] + attrs["turnaround_s"]
            <= spans[0]["duration_s"])


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_counters_move_once_a_call_on_every_path(convention):
    cfg = _config(convention)
    readbacks = STAGES[convention][1]
    runner = engine.make_runner(SHAPE, cfg, device="cpu")
    before = _counters()
    runner(_soup())
    assert _moved(before) == {"engine_readbacks_total": readbacks,
                              "engine_runs_total": 1,
                              "engine_generations_total": LIMIT,
                              "engine_segments_total": 0}
    before = _counters()
    assert engine.simulate(_soup().numpy(), cfg, device="cpu").generations == LIMIT
    assert _moved(before) == {"engine_readbacks_total": readbacks,
                              "engine_runs_total": 1,
                              "engine_generations_total": LIMIT,
                              "engine_segments_total": 0}
    # Segments of 16: three runner calls of one block each, the C loop's
    # each opening with its alive test; no whole run.
    trace.enable()
    trace.clear()
    before = _counters()
    segs = list(engine.simulate_segments(_soup(), cfg, segment=16, device="cpu"))
    assert [g for g, _, _ in segs] == [16, 32, 40]
    per_call = 2 if convention == Convention.C else 1
    assert _moved(before) == {"engine_readbacks_total": 3 * per_call,
                              "engine_runs_total": 0,
                              "engine_generations_total": LIMIT,
                              "engine_segments_total": 3}
    assert [(s["attrs"]["blocks"], s["attrs"]["readbacks"])
            for s in _runs()] == [(1, per_call)] * 3


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_tracing_off_records_nothing_and_still_counts(convention):
    runner = engine.make_runner(SHAPE, _config(convention), device="cpu")
    trace.clear()
    assert not trace.enabled()
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, gens = runner(_soup())
    assert gens == LIMIT
    assert trace.snapshot() == []
    names = {e.name for e in prof.events()}
    assert not names & set(RANGES)
    moved = _moved(before)
    assert moved["engine_readbacks_total"] == STAGES[convention][1]
    assert moved["engine_runs_total"] == 1


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_ring_holds_one_run_span_and_no_block_entry(convention):
    runner = engine.make_runner(SHAPE, _config(convention), device="cpu")
    _, spans = _traced_call(runner, _soup())
    assert len(spans) == 1 and spans[0]["name"] == "engine.run"
    _, spans = _traced_call(runner, _soup())
    assert [s["name"] for s in spans] == ["engine.run"]


def _captured(runner, grid, tmp_path):
    """A runner call under a CPU capture with tracing on: its span and the
    engine's ranges, ``(name, start_us, end_us)`` in start order."""
    runner(grid)  # warm, outside the capture
    trace.enable()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner(grid)
    path = tmp_path / "capture.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"] in RANGES)
    return _runs(), [(n, s, t) for s, t, n in ranges]


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_capture_holds_the_loop_ranges_nested_in_order(convention, tmp_path):
    runner = engine.make_runner(SHAPE, _config(convention), device="cpu")
    runs, ranges = _captured(runner, _soup(), tmp_path)
    assert len(runs) == 1
    names = [n for n, _, _ in ranges]
    block = ["engine.launch", "engine.readback", "engine.replay"]
    opening = ["engine.readback"] if convention == Convention.C else []
    assert names == ["engine.run", *opening, *block * 3]
    _, run_lo, run_hi = ranges[0]
    inner = ranges[1:]
    for (_, lo, hi), (_, next_lo, _) in zip(inner, inner[1:]):
        assert lo < hi <= next_lo  # one after another, none overlapping
    assert run_lo <= inner[0][1] and inner[-1][2] <= run_hi
    attrs = runs[0]["attrs"]
    assert (attrs["blocks"], attrs["readbacks"]) == STAGES[convention]


def test_exact_rerun_counts_its_readback_inside_the_replay(tmp_path):
    cfg = _config(Convention.C, limit=100)
    runner = engine.make_runner((64, 64), cfg, device="cpu")
    runs, ranges = _captured(runner, _dies(), tmp_path)
    # Empty at 52, after the opening alive test and four blocks (1-16,
    # 17-32, 33-48, 49-64), the last block's first pass rerun exactly: one
    # more read.
    attrs = runs[0]["attrs"]
    assert (attrs["blocks"], attrs["readbacks"]) == (4, 1 + 4 + 1)
    assert runner(_dies())[1] == 52
    replays = [(lo, hi) for n, lo, hi in ranges if n == "engine.replay"]
    reads = [(lo, hi) for n, lo, hi in ranges if n == "engine.readback"]
    assert len(replays) == 4 and len(reads) == 6
    nested = [(lo, hi) for lo, hi in reads
              if any(r_lo <= lo and hi <= r_hi for r_lo, r_hi in replays)]
    assert len(nested) == 1
    assert replays[-1][0] <= nested[0][0] and nested[0][1] <= replays[-1][1]
    assert attrs["launch_s"] + attrs["wait_s"] + attrs["turnaround_s"] <= (
        runs[0]["duration_s"])
