"""CPU tests of the benchmark's pieces:

    python -m pytest portbench/tests -q

The plain reference against the program's oracle and its CPU path, the
roofline arithmetic, the files found by name, the result line's shape, the
check's control and planted faults, the trace reduction, and that nothing
loads JAX or the JAX package.
"""

import dataclasses
import json
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import GameConfig
from portbench import control, devtrace, harness, roofline
from portbench.drivers import engine_runner
from portbench.readings import Readings
from portbench.reference import life

REPO = Path(__file__).resolve().parents[2]
CONVENTIONS = ("c", "cuda")


def _grids():
    rng = np.random.default_rng(5)
    soup = (rng.random((32, 64)) < 0.5).astype(np.uint8)
    still = np.zeros((16, 64), np.uint8)
    still[4:6, 10:12] = 1                      # a block
    dying = np.zeros((16, 128), np.uint8)
    dying[3, 3] = dying[8, 70] = 1             # two lone cells
    blinker = np.zeros((8, 64), np.uint8)
    blinker[3, 62:64] = blinker[3, 0] = 1      # across the column wrap
    odd = (rng.random((9, 30)) < 0.4).astype(np.uint8)  # the byte form
    return {"soup": soup, "still": still, "dying": dying,
            "empty": np.zeros((8, 64), np.uint8), "blinker": blinker,
            "odd": odd}


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("name", sorted(_grids()))
@pytest.mark.parametrize("limit", [0, 1, 5, 60])
def test_reference_matches_oracle_and_the_port(name, convention, limit):
    grid = _grids()[name]
    cfg = GameConfig(gen_limit=limit, convention=convention)
    want = oracle.run(grid, cfg)
    final, gens = life.run(torch.from_numpy(grid), limit, 3, True, convention)
    assert gens == want.generations
    assert life.wrong_cells(final, torch.from_numpy(want.grid)) == 0
    port, port_gens = engine.make_runner(grid.shape, cfg, device="cpu")(
        torch.from_numpy(grid))
    assert port_gens == gens
    assert life.wrong_cells(final, port) == 0


@pytest.mark.parametrize("torus", [True, False])
@pytest.mark.parametrize("shape", [(8, 64), (33, 128), (3, 192)])
def test_word_form_matches_byte_form(shape, torus):
    gen = torch.Generator().manual_seed(sum(shape))
    cells = (torch.rand(shape, generator=gen) < 0.45).to(torch.uint8)
    words = life.pack(cells)
    for _ in range(12):
        cells = life.step_bytes(cells, torus)
        words = life.step_words(words, torus)
        assert life.wrong_cells(words, cells) == 0
    assert torch.equal(life.unpack(words), cells)


def test_byte_form_matches_oracle_and_dead_edges_differ():
    grid = _grids()["soup"]
    t = torch.from_numpy(grid)
    assert np.array_equal(life.step_bytes(t).numpy(), oracle.evolve(grid))
    assert not torch.equal(life.step_bytes(t, torus=False), life.step_bytes(t))


def test_roofline_matches_the_hand_worked_figures():
    assert roofline.LOGIC_OPS_PER_S == pytest.approx(1.6727e13, rel=1e-4)
    least, bound = roofline.least_seconds(16384, 16384, 1000)
    assert (round(least * 1e3, 3), bound) == (6.018, "operations")
    least, bound = roofline.least_seconds(65536, 65536, 1000)
    assert (round(least * 1e3, 2), bound) == (96.29, "operations")
    _, bound = roofline.least_seconds(16384, 16384, 1)
    assert bound == "bytes"


def _bench():
    return harness.load_benchmark()


def test_every_cell_finds_its_files_by_name():
    bench = _bench()
    for cell in bench["workloads"]:
        cfg = harness.config(bench, cell["config"])
        mix = harness.traffic(cell["traffic"])
        assert callable(harness.driver(mix["driver"]).run)
        for key in ("width", "height", "gen_limit", "similarity_frequency",
                    "check_similarity"):
            assert key in cfg
        assert harness.end_to_end(bench, cell["name"])
        assert harness.per_layer(bench, cell["name"])
    for entry in bench["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"]
        assert set(entry["reduced"]) <= set(cfg) & set(cfg.get("published", {}))
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_keeps_to_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    assert len(pairs) == len(bench["workloads"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for name in names:
        assert _NAME.match(name), name
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _tiny(monkeypatch, gen_limit=60):
    """BENCHMARK.json's cells at 64 x 128 and ``gen_limit`` generations."""
    real = harness.config
    monkeypatch.setattr(harness, "config", lambda bench, name: dict(
        real(bench, name), width=128, height=64, gen_limit=gen_limit))
    bench = _bench()
    return bench, harness.workload(bench, "g16k-soup-c")


def test_result_line_shape(monkeypatch):
    bench, cell = _tiny(monkeypatch)
    line = harness.run_cell(bench, cell, seed=2**33 + 1, seconds=0.3,
                            trace=False, device="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"cell_updates_per_s", "execution_ms_p95",
                                    "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["check"]) == {"cells_wrong", "counts_wrong",
                                  "grids_unsampled", "settle_cells_wrong",
                                  "settle_counts_wrong"}
    json.dumps(line)
    traced = harness.run_cell(bench, cell, seed=7, seconds=0.3, trace=True,
                              device="cpu")
    assert list(traced)[-1] == "check" and traced["correct"] is True
    per_layer = {m["name"] for m in harness.per_layer(bench, cell["name"])}
    assert set(traced["metrics"]) <= per_layer
    assert "ops.build_s" in traced["metrics"]


def test_control_is_called_wrong(monkeypatch):
    bench, cell = _tiny(monkeypatch)
    for seed in (1, 2, 3):
        line = harness.run_cell(bench, cell, seed=seed, seconds=0.3,
                                trace=False, device="cpu",
                                make_runner=control.control_runner)
        assert line["correct"] is False
        assert line["check"]["cells_wrong"]["value"] > 0


def _faulty(fault):
    def make(shape, config, kernel="auto", device=None):
        if fault == "no_similarity":
            config = dataclasses.replace(config, check_similarity=False)
        runner = engine.make_runner(shape, config, kernel, device)

        def run(grid):
            final, gens = runner(grid)
            if fault == "unchanged":
                return grid.clone(), gens
            if fault == "cell":
                final = final.clone()
                final[-1, -1] ^= 1
            if fault == "count":
                gens += 1
            if fault == "no_exit":          # an exit left unreported
                gens = config.gen_limit
            if fault == "exit_emptied" and gens < config.gen_limit:
                final = torch.zeros_like(final)  # not the exit's generation
            return final, gens

        return run

    return make


@pytest.mark.parametrize("fault", ["unchanged", "cell", "count"])
def test_planted_faults_are_called_wrong(monkeypatch, fault):
    bench, cell = _tiny(monkeypatch)
    line = harness.run_cell(bench, cell, seed=11, seconds=0.3, trace=False,
                            device="cpu", make_runner=_faulty(fault))
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("fault, traffic", [
    ("no_similarity", "soup-c"), ("no_similarity", "soup-cuda"),
    ("no_exit", "soup-c"), ("no_exit", "soup-cuda"),
    # The CUDA loop's empty exit keeps the last live generation; under the
    # C loop a dead or still grid is the same one generation on.
    ("exit_emptied", "soup-cuda")])
def test_faults_at_the_exits_are_called_wrong(monkeypatch, fault, traffic):
    # A soup of a cell's size runs to the limit, so only the settling grids
    # can see these there. Every table pattern settles within 300.
    bench, _ = _tiny(monkeypatch, gen_limit=300)
    cell = next(c for c in bench["workloads"] if c["traffic"] == traffic)
    line = harness.run_cell(bench, cell, seed=2**32 + 5, seconds=0.3,
                            trace=False, device="cpu",
                            make_runner=_faulty(fault))
    check = line["check"]
    assert line["correct"] is False and line["failed"] > 0
    wrong = check["settle_counts_wrong"]["value"] + check["settle_cells_wrong"]["value"]
    assert wrong > 0


@pytest.mark.parametrize("kind", ["dies", "still"])
def test_settling_patterns_settle_when_the_table_says(kind):
    table = json.loads(engine_runner.SETTLING.read_text())
    box = table["box"]
    assert {e["settles_at"] % 16 for e in table[kind]} == set(range(16))
    for entry in table[kind]:
        grid = np.zeros((box, box), np.uint8)
        for r, row in enumerate(entry["rows"]):
            grid[r, :len(row)] = [ch == "o" for ch in row]
        for t in range(1, entry["settles_at"] + 1):
            new = oracle.evolve(grid)
            settled = not new.any() if kind == "dies" else np.array_equal(new, grid)
            assert settled == (t == entry["settles_at"]), (entry, t)
            grid = new


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_settling_grids_exit_early_in_the_port_and_the_reference(convention):
    pick = random.Random(2**31 + 3)
    grids = engine_runner.settling_grids(128, 192, pick, "cpu")
    cfg = GameConfig(gen_limit=1000, convention=convention)
    runner = engine.make_runner((128, 192), cfg, device="cpu")
    for kind, grid in grids.items():
        final, gens = runner(grid)
        ref, ref_gens = life.run(grid, 1000, 3, True, convention)
        assert 40 <= gens == ref_gens < 1000, kind
        assert life.wrong_cells(ref, final) == 0
        assert grid.shape == (128, 192) and grid.any()


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev("user_annotation", "portbench.sim", 0, 100),
        _ev("user_annotation", "portbench.sim", 100, 100),
        _ev("cpu_op", "aten::copy_", 10, 20),
        _ev("kernel", "void k<1>(int)", 20, 30),
        _ev("kernel", "void k<1>(int)", 40, 20),    # overlaps the first
        _ev("gpu_memcpy", "Memcpy DtoH", 150, 10),
        _ev("gpu_user_annotation", "portbench.sim", 0, 200),
        _ev("kernel", "late", 250, 10),              # outside the window
    ]
    t = devtrace.reduce(events)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(50e-6)
    assert t.sim_device_s == pytest.approx([40e-6, 10e-6])
    assert t.device_events == 3
    assert t.device_ops[0] == ["k<1>", pytest.approx(50e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(150e-6)
    assert devtrace.reduce(events[2:5]) is None


def test_readers():
    # Two profiled simulations, slowed by the profiler's host work, then two
    # without it: the host time is the untraced ones', the device time the
    # trace's.
    trace = devtrace.DeviceTrace(window_s=0.05, busy_s=0.024,
                                 sim_s=[0.025, 0.025],
                                 sim_device_s=[0.012, 0.012], device_events=4,
                                 device_ops=[], idle_gaps=[])
    r = Readings(height=16384, width=16384, generations=[1000] * 4,
                 sim_s=[0.025, 0.025, 0.019, 0.021],
                 launches={"bandt_fast": 500, "encode": 4},
                 counters={}, spans=[{"name": "engine.compile",
                                      "duration_s": 0.5}], trace=trace,
                 traced_sims=2)
    read = {m: harness.reader(m)(r) for m in (
        "engine.idle_ms_per_sim", "ops.launches_per_sim", "ops.build_s",
        "kernels.roofline_share", "device.idle_share")}
    assert read == pytest.approx({
        "engine.idle_ms_per_sim": 8.0, "ops.launches_per_sim": 126.0,
        "ops.build_s": 0.5, "kernels.roofline_share": 100 * 6.018e-3 / 0.012,
        "device.idle_share": 40.0}, rel=1e-3)
    empty = Readings(16384, 16384, [1000], [0.02], {}, {}, [], None)
    assert all(harness.reader(m)(empty) is None for m in read)
    # Every simulation profiled: no untraced host time to read the idle by.
    whole = dataclasses.replace(r, sim_s=r.sim_s[:2], traced_sims=2)
    assert harness.reader("engine.idle_ms_per_sim")(whole) is None
    assert harness.reader("device.idle_share")(whole) is None


def test_per_layer_metrics_name_their_cells():
    bench = _bench()
    for cell in bench["workloads"]:
        names = {m["name"] for m in harness.per_layer(bench, cell["name"])}
        assert names == {m["name"] for m in bench["per_layer"]
                         if cell["name"] in m["workloads"]}
    with pytest.raises(KeyError):
        harness.per_layer({"per_layer": [{"name": "x", "moves": "setup_s"}]},
                          "g16k-soup-c")


_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from portbench import control, devtrace, harness, roofline
from portbench.drivers import engine_runner
from portbench.reference import life
bench = harness.load_benchmark()
for m in bench["per_layer"]:
    harness.reader(m["name"])
cfg = dict(harness.config(bench, "gol-16384"), width=64, height=32, gen_limit=20)
engine_runner.run(cfg, harness.traffic("soup-c"), seed=3, seconds=0.1,
                  trace=True, device="cpu")
print(harness.forbidden_modules())
"""


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _SCRIPT.format(repo=str(REPO))],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_exits_without_a_result_where_it_cannot_run(tmp_path):
    # No card here: exit 2 and print nothing.
    run = [sys.executable, "portbench/run.py", "--workload", "g16k-soup-c",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(run, capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    # A directory with only the benchmark's files: no result either.
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(run, capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
