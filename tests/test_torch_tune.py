"""The port's tuner (gol_tpu_torch/tune/, ``ops.with_temporal_depth``, the
engine's plan consult, the batcher's ``_plan()``, the ``tune`` subcommand
and ``serve --warm-plans``) against the JAX package's, on the CPU.

Mirrors ``tests/test_tune.py``:

- ``ServePlan``/``EnginePlan`` round-trips and labels, ``serve_candidates``
  and the axes equal JAX's; ``engine_candidates`` equals JAX's minus
  ``packed-jnp`` (a known difference: the port has no jnp fallback kernel);
- a plans file written by either package's ``PlanStore`` is read by the
  other without a hit and survives the other's commit;
- no plan cached leaves the engine and the batcher exactly as built in; a
  tuned serve plan moves the port's buckets; a tuned engine plan (block 64,
  depth 1) gives ``auto`` the same bytes and generations as JAX's ``auto``
  under its own plan;
- ``with_temporal_depth`` is bit-exact at depths 1, 2, 4 and 8, and any
  termination block is;
- ``tune --quick`` at 64x64 writes a plan that ``serve --warm-plans`` then
  uses; ``--sparse-crossover`` measures and caches the dense/sparse
  crossover as JAX's does (``fit_crossover``, ``sparse_auto_area`` and
  ``macro_auto_gens`` equal JAX's); a candidate that fails to run is
  excluded, logged and listed in the report.

Every test that writes a plan points ``GOL_PLAN_CACHE`` at its own
``tmp_path``. Grids are small and made from a numpy seed; bytes and
integers are compared exactly.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gol_tpu import engine as jax_engine
from gol_tpu.config import GameConfig as JaxConfig
from gol_tpu.serve import batcher as jax_batcher
from gol_tpu.tune import plans as jax_plans
from gol_tpu.tune import select as jax_select
from gol_tpu.tune import space as jax_space
from gol_tpu_torch import cli, engine, oracle
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.ops import get_kernel, with_temporal_depth
from gol_tpu_torch.ops import stencil_packed
from gol_tpu_torch.serve import batcher
from gol_tpu_torch.serve.jobs import new_job
from gol_tpu_torch.tune import measure, plans, select, space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """A private, initially absent plan cache shared by both packages; the
    consult caches are dropped on entry and exit."""
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv("GOL_PLAN_CACHE", path)
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    for mod in (select, jax_select):
        mod.reset()
    for mod in (batcher, jax_batcher):
        mod._reset_plan()
    yield path
    for mod in (select, jax_select):
        mod.reset()
    for mod in (batcher, jax_batcher):
        mod._reset_plan()


def _grid(h=48, w=64, seed=11):
    return np.random.default_rng(seed).integers(0, 2, (h, w), dtype=np.uint8)


# ---------------------------------------------------------------------------
# The space.


def test_axes_match_jax():
    for name in ("TEMPORAL_DEPTHS", "TERMINATION_BLOCKS", "PAD_QUANTA",
                 "BATCH_LADDERS", "SERVE_TEMPORAL_DEPTHS"):
        assert getattr(space, name) == getattr(jax_space, name), name
    assert space.DEFAULT_SERVE_PLAN.to_dict() == jax_space.DEFAULT_SERVE_PLAN.to_dict()


@pytest.mark.parametrize("plan", [
    {}, {"kernel": "packed"}, {"kernel": "lax", "temporal_depth": 1},
    {"kernel": "packed", "temporal_depth": 2, "termination_block": 64},
    {"kernel": "pallas", "temporal_depth": 8, "termination_block": 8,
     "band_bytes": 1 << 20},
    {"kernel": "packed", "temporal_depth": "4", "junk": 1, "band_bytes": None},
])
def test_engine_plan_round_trip_matches_jax(plan):
    ours, theirs = space.EnginePlan.from_dict(plan), jax_space.EnginePlan.from_dict(plan)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.label() == theirs.label()
    assert space.EnginePlan.from_dict(ours.to_dict()) == ours


@pytest.mark.parametrize("plan", [
    {"pad_quantum": 32, "batch_ladder": [1, 2, 4, 8, 16, 32, 64]},
    {"pad_quantum": 64, "batch_ladder": [1, 8, 64], "temporal_depth": 4},
    {"pad_quantum": 128, "batch_ladder": [1, 4, 16, 64], "temporal_depth": 1},
])
def test_serve_plan_round_trip_matches_jax(plan):
    ours, theirs = space.ServePlan.from_dict(plan), jax_space.ServePlan.from_dict(plan)
    assert (ours.to_dict(), ours.label()) == (theirs.to_dict(), theirs.label())
    for max_batch in (32, 64):
        assert space.valid_serve_plan(ours, max_batch) == \
            jax_space.valid_serve_plan(theirs, max_batch)


@pytest.mark.parametrize("max_batch", [64, 32])
def test_serve_candidates_match_jax(max_batch):
    assert [c.label() for c in space.serve_candidates(max_batch)] == \
        [c.label() for c in jax_space.serve_candidates(max_batch)]


@pytest.mark.parametrize("shape, packed_state", [
    ((64, 64), False), ((256, 256), False), ((48, 96), False), ((40, 40), False),
    ((64, 64), True), ((256, 256), True), ((48, 96), True),
], ids=lambda v: "packed" if v is True else "byte" if v is False
   else f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_engine_candidates_match_jax_minus_packed_jnp(shape, packed_state, quick):
    """Known difference: JAX's ``packed-jnp`` (its jnp fallback for a
    Mosaic refusal) has no counterpart in the port; every other candidate
    is JAX's, in JAX's order. ``pallas`` is a candidate on neither package
    here (JAX offers it on a TPU, the port on a card)."""
    h, w = shape
    ctx = space.TuneContext(h, w, "c", packed_state, device_kind="cpu")
    jctx = jax_space.TuneContext(h, w, "c", packed_state, device_kind="cpu")
    ours = [c.label() for c in space.engine_candidates(ctx, quick=quick)]
    theirs = [c.label() for c in jax_space.engine_candidates(jctx, quick=quick)
              if c.kernel != "packed-jnp"]
    assert ours == theirs


def test_pallas_is_a_candidate_on_a_card_only():
    on_card = space.TuneContext(64, 64, "c", False, device_kind="NVIDIA H100")
    labels = [c.label() for c in space.engine_candidates(on_card, quick=True)]
    assert [lab for lab in labels if lab.startswith("pallas")] == [
        "pallas/T1/K16", "pallas/T1/K64", "pallas/T8/K16", "pallas/T8/K64"]
    assert labels[0] == "packed/T8/K16" and labels[-1] == "lax/T1/K16"
    off_card = space.TuneContext(64, 64, "c", False, device_kind="cpu")
    assert not any(c.kernel == "pallas"
                   for c in space.engine_candidates(off_card))
    assert all(c.band_bytes is None for c in space.engine_candidates(on_card))


# ---------------------------------------------------------------------------
# The plan store.


def test_fingerprint_names_torch_cuda_and_the_device():
    fp = plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")
    fields = dict(f.split("=", 1) for f in fp.split("|"))
    assert fields["torch"] and fields["cuda"] and fields["device"] == "cpu"
    assert "jax" not in fields
    assert plans.device_kind("cpu") == "cpu"
    assert plans.default_cache_path().endswith(
        os.path.join("gol_tpu_torch", "plans.json"))


def test_store_round_trip_and_version_invalidation(plan_cache, monkeypatch):
    store = plans.PlanStore(plan_cache)
    fp = plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")
    store.put(fp, {"kernel": "lax"}, measured={"tuned_vs_default": 1.5})
    assert plans.PlanStore(plan_cache).get(fp) == {"kernel": "lax"}
    assert not [f for f in os.listdir(os.path.dirname(plan_cache))
                if f.endswith(".inprogress")]
    monkeypatch.setattr(plans, "_versions",
                        lambda: {"torch": "0.0", "cuda": "none"})
    assert plans.PlanStore(plan_cache).get(
        plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")) is None
    other = plans.fingerprint("engine", 8, 8, "c", "byte", (1, 1), "cpu")
    plans.PlanStore(plan_cache).put(other, {})
    assert set(plans.PlanStore(plan_cache).entries()) == {other}  # pruned


@pytest.mark.parametrize("body", ["{", '{"plans": []}', "not json"])
def test_torn_file_falls_back_loudly(plan_cache, body, caplog):
    with open(plan_cache, "w") as f:
        f.write(body)
    with caplog.at_level(logging.WARNING, logger="gol_tpu_torch.tune.plans"):
        assert plans.PlanStore(plan_cache).entries() == {}
    assert any("unreadable" in r.message for r in caplog.records)
    assert select.engine_plan((48, 64), GameConfig()) is None


def test_a_jax_plan_file_is_a_miss_here_and_survives_our_commit(plan_cache):
    jax_fp = jax_plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")
    jax_plans.PlanStore(plan_cache).put(jax_fp, {"kernel": "lax"})
    jax_plans.PlanStore(plan_cache).put(jax_select.serve_fingerprint(),
                                        {"pad_quantum": 64,
                                         "batch_ladder": [1, 8, 64]})
    assert select.engine_plan((48, 64), GameConfig()) is None
    assert select.serve_plan() == space.DEFAULT_SERVE_PLAN
    fp = plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")
    plans.PlanStore(plan_cache).put(fp, {"kernel": "packed"})
    reread = jax_plans.PlanStore(plan_cache)
    assert reread.get(jax_fp) == {"kernel": "lax"}
    assert plans.PlanStore(plan_cache).get(fp) == {"kernel": "packed"}


def test_our_plan_file_is_a_miss_for_jax_and_survives_its_commit(plan_cache):
    fp = plans.fingerprint("engine", 48, 64, "c", "byte", (1, 1), "cpu")
    plans.PlanStore(plan_cache).put(fp, {"kernel": "lax"})
    plans.PlanStore(plan_cache).put(select.serve_fingerprint(),
                                    {"pad_quantum": 64, "batch_ladder": [1, 8, 64]})
    assert jax_select.engine_plan((48, 64), JaxConfig()) is None
    assert jax_select.serve_plan() == jax_space.DEFAULT_SERVE_PLAN
    jax_fp = jax_plans.fingerprint("engine", 8, 8, "c", "byte", (1, 1), "cpu")
    jax_plans.PlanStore(plan_cache).put(jax_fp, {})
    with open(plan_cache) as f:
        entries = json.load(f)["plans"]
    assert entries[fp]["plan"] == {"kernel": "lax"} and jax_fp in entries
    assert plans.PlanStore(plan_cache).get(fp) == {"kernel": "lax"}


# ---------------------------------------------------------------------------
# The consult.


@pytest.mark.parametrize("convention", ["c", "cuda"])
def test_no_plan_engine_and_batcher_are_the_built_in_ones(plan_cache, convention):
    config = GameConfig(gen_limit=200, convention=convention)
    assert select.engine_plan((48, 64), config) is None
    grid = _grid()
    got = engine.simulate(grid, config, device="cpu")
    exp = oracle.run(grid, config)
    assert np.array_equal(got.grid, exp.grid)
    assert got.generations == exp.generations
    assert batcher._plan() == space.DEFAULT_SERVE_PLAN
    assert (batcher.pad_dim(30), batcher.pad_batch(3)) == (32, 4)


def _put_serve(path, plan_dict, store=plans, sel=select):
    store.PlanStore(path).put(sel.serve_fingerprint(), plan_dict)
    for mod in (select, jax_select):
        mod.reset()
    for mod in (batcher, jax_batcher):
        mod._reset_plan()


def test_tuned_serve_plan_moves_the_ports_buckets(plan_cache):
    """A serve plan the port's tuner cached moves the port's buckets exactly
    as the same plan cached by JAX's tuner moves JAX's."""
    plan = {"pad_quantum": 64, "batch_ladder": [1, 8, 64], "temporal_depth": 2}
    _put_serve(plan_cache, plan)
    _put_serve(plan_cache, plan, jax_plans, jax_select)
    job = new_job(30, 30, np.zeros((30, 30), np.uint8))
    from gol_tpu.serve.jobs import new_job as jax_new_job

    jax_job = jax_new_job(30, 30, np.zeros((30, 30), np.uint8))
    assert batcher.bucket_for(job).label() == "64x64/c/masked"
    assert jax_batcher.bucket_for(jax_job).label() == "64x64/c/masked"
    for n in (1, 2, 8, 9, 64):
        assert batcher.pad_batch(n) == jax_batcher.pad_batch(n)
    assert batcher._plan() == space.ServePlan(64, (1, 8, 64), 2)
    staged = batcher.stage(batcher.bucket_for(job), [job])
    assert staged.staged.temporal_depth == 2


@pytest.mark.parametrize("bad", [
    {"pad_quantum": 48, "batch_ladder": [1, 8, 64]},
    {"pad_quantum": 32, "batch_ladder": [1, 8, 32]},
    {"pad_quantum": 32, "batch_ladder": [2, 8, 64]},
    {"pad_quantum": 32, "batch_ladder": [1, 8, 8, 64]},
])
def test_invalid_serve_plan_rejected_loudly(plan_cache, bad, caplog):
    with caplog.at_level(logging.WARNING, logger="gol_tpu_torch.tune.select"):
        _put_serve(plan_cache, bad)
        assert (batcher.pad_dim(1), batcher.pad_batch(3)) == (32, 4)
    assert any("bucket" in rec.message for rec in caplog.records)


@pytest.mark.parametrize("convention", ["c", "cuda"])
def test_tuned_engine_plan_gives_auto_jax_bytes(plan_cache, convention):
    """Block 64 and depth 1 for ``auto``: each package consults its own
    entry, and both give the oracle's bytes and generations."""
    plan = {"kernel": "packed", "temporal_depth": 1, "termination_block": 64}
    config = GameConfig(gen_limit=150, convention=convention)
    jax_config = JaxConfig(gen_limit=150, convention=convention)
    plans.PlanStore(plan_cache).put(
        select.engine_fingerprint((48, 64), config), plan)
    jax_plans.PlanStore(plan_cache).put(
        jax_select.engine_fingerprint((48, 64), jax_config),
        {**plan, "kernel": "packed-jnp"})
    select.reset()
    jax_select.reset()
    assert select.engine_plan((48, 64), config) == space.EnginePlan(
        "packed", 1, 64)
    grid = _grid()
    launches = dict(stencil_packed.LAUNCHES)
    got = engine.simulate(grid, config, device="cpu")
    want = jax_engine.simulate(grid, jax_config)
    assert np.array_equal(got.grid, np.asarray(want.grid))
    assert got.generations == want.generations
    assert stencil_packed.LAUNCHES == launches  # the CPU runs no kernel


def test_unsupported_plan_kernel_ignored_loudly(plan_cache, caplog):
    config = GameConfig(gen_limit=20)
    plans.PlanStore(plan_cache).put(
        select.engine_fingerprint((48, 40), config), {"kernel": "packed"})
    select.reset()
    with caplog.at_level(logging.WARNING, logger="gol_tpu_torch.engine"):
        got = engine.simulate(_grid(48, 40), config, device="cpu")
    assert any("does not support" in r.message for r in caplog.records)
    exp = oracle.run(_grid(48, 40), config)
    assert np.array_equal(got.grid, exp.grid)


def test_packed_state_plan_rejects_byte_kernel(plan_cache, caplog):
    config = GameConfig(gen_limit=20)
    plans.PlanStore(plan_cache).put(
        select.engine_fingerprint((48, 64), config, packed_state=True),
        {"kernel": "lax"})
    select.reset()
    with caplog.at_level(logging.WARNING, logger="gol_tpu_torch.engine"):
        engine.make_packed_runner((48, 64), config, device="cpu")
    assert any("cannot carry packed" in r.message for r in caplog.records)


@pytest.mark.parametrize("convention", ["c", "cuda"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_with_temporal_depth_bit_exact(convention, depth):
    config = GameConfig(gen_limit=100, convention=convention)
    boards = [_grid(48, 64), np.zeros((48, 64), np.uint8)]
    boards[1][10, 10:12] = 1  # dies inside the first pass
    for grid in boards:
        runner = engine._build_runner(
            (48, 64), config, "packed", "cpu", segmented=False,
            packed_state=False, plan=space.EnginePlan("packed", depth, 16))
        final, gens = runner(engine.put_grid(grid, "cpu"))
        exp = oracle.run(grid, config)
        assert np.array_equal(final.numpy(), exp.grid)
        assert gens == exp.generations


@pytest.mark.parametrize("convention", ["c", "cuda"])
@pytest.mark.parametrize("block", [8, 16, 32, 64])
def test_termination_block_bit_exact(convention, block):
    config = GameConfig(gen_limit=90, convention=convention)
    grid = _grid(32, 64, seed=5)
    runner = engine._build_runner(
        (32, 64), config, "auto", "cpu", segmented=False, packed_state=False,
        plan=space.EnginePlan(None, None, block))
    final, gens = runner(engine.put_grid(grid, "cpu"))
    exp = oracle.run(grid, config)
    assert np.array_equal(final.numpy(), exp.grid) and gens == exp.generations


def test_with_temporal_depth_validity():
    packed = get_kernel("packed")
    assert with_temporal_depth(packed, 8) is packed
    one = with_temporal_depth(packed, 1)
    assert one.fused_multi is None and one.multi_gens == 1
    assert not one.supports_multi(64, 64, None)
    two = with_temporal_depth(packed, 2)
    assert two.multi_gens == 2 and two.supports_multi(8, 32, None)
    lax = get_kernel("lax")
    assert with_temporal_depth(lax, 1) is lax
    with pytest.raises(ValueError, match="no fused pass"):
        with_temporal_depth(lax, 2)
    with pytest.raises(ValueError, match=">= 1"):
        with_temporal_depth(packed, 0)
    pallas4 = with_temporal_depth(get_kernel("pallas"), 4)
    assert pallas4.multi_gens == 4 and pallas4.fused_multi is not None


# ---------------------------------------------------------------------------
# Measurement and the CLI.


@pytest.mark.parametrize("samples", [[3.0], [1.0, 2.0], [5, 1, 100, 2, 3],
                                     [1, 2, 3, 4]])
def test_trimmed_median_matches_jax(samples):
    from gol_tpu.tune import measure as jax_measure

    assert measure.trimmed_median(samples) == jax_measure.trimmed_median(samples)


def test_engine_search_isolates_a_failing_candidate(plan_cache, monkeypatch,
                                                    caplog):
    real = engine._build_runner

    def build(shape, config, kernel, device, **kwargs):
        if kernel == "lax":
            raise RuntimeError("lax refused")
        return real(shape, config, kernel, device, **kwargs)

    monkeypatch.setattr(engine, "_build_runner", build)
    with caplog.at_level(logging.WARNING, logger="gol_tpu_torch.tune.measure"):
        res = measure.run_engine_search(32, 64, GameConfig(gen_limit=16),
                                        quick=True, iters=1, device="cpu")
    gates = {t.label: t.gate for t in res.trials}
    assert gates["lax/T1/K16"] == "error: RuntimeError"
    assert all(g == "ok" for lab, g in gates.items() if lab != "lax/T1/K16")
    assert any("excluded" in r.message for r in caplog.records)
    report = measure.render_report([res])
    assert "excluded: lax/T1/K16 (error: RuntimeError)" in report
    assert not res.to_dict()["gates_all_ok"]


def test_tune_quick_writes_a_plan_that_serve_warm_plans_uses(plan_cache,
                                                             tmp_path, capsys):
    report = str(tmp_path / "report.md")
    assert cli.main(["tune", "--shape", "64x64", "--convention", "c",
                     "--quick", "--gen-limit", "16", "--iters", "1",
                     "--serve-board", "64x64", "--report", report]) == 0
    err = capsys.readouterr().err
    assert "tune engine: 64x64/c/byte" in err and f"plans -> {plan_cache}" in err
    entries = plans.PlanStore(plan_cache).entries()
    assert select.engine_fingerprint((64, 64), GameConfig(gen_limit=16)) in entries
    assert select.warm_entries() == [{"height": 64, "width": 64,
                                      "convention": "c"}]
    assert set(select.marginal_rates()) == {"64x64_c_packed"}
    assert open(report).read().startswith("# gol tune report")

    env = {**os.environ, "GOL_TORCH_DEVICE": "cpu", "GOL_PLAN_CACHE": plan_cache}
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", "serve", "--port", "0",
         "--warm-plans", "--sample-interval", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.perf_counter() + 120
        line = proc.stdout.readline()
        assert line.startswith("serving on "), line
        assert time.perf_counter() < deadline
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    # The bucket and ladder the tuned serve plan gives a 64x64 board (the
    # search's winner varies with the host's timing noise).
    batcher._reset_plan()
    try:
        key = batcher.bucket_for(new_job(64, 64, np.zeros((64, 64), np.uint8)))
        rungs = len(batcher._plan().batch_ladder)
    finally:
        batcher._reset_plan()
    assert f"warmed bucket {key.label()} ({rungs} batch rungs)" in err


def test_warm_plans_survives_corrupt_entries(plan_cache, capsys):
    _put_serve(plan_cache, {
        "pad_quantum": 32, "batch_ladder": [1, 2, 4, 8, 16, 32, 64],
        "warm": [{"height": "big", "width": 48},
                 {"height": 48, "width": 48, "convention": "not-a-conv"},
                 {"height": 40, "width": 40, "convention": "c"}],
    })
    cli._warm_plans()
    err = capsys.readouterr().err
    assert err.count("failed") == 2 and "warmed bucket 64x64/c/masked" in err


def test_sparse_crossover_is_refused(plan_cache, capsys, tmp_path, monkeypatch):
    """``tune --sparse-crossover`` in both packages, each into its own plan
    file: exit 0 and the same crossover lines and sparse entry. The
    crossover's own samples are pinned (1, 2 and 3 s for the dense probes
    and the sparse run, in call order), so the fit is the same in both; the
    probes themselves run."""
    import gol_tpu.tune.measure as jax_measure
    from gol_tpu import cli as jax_cli

    def pinned(module):
        search = module.run_sparse_crossover_search
        calls = []

        def run(**kw):
            def samples(fn, warmup=1, iters=5):
                fn()
                calls.append(len(calls) + 1.0)
                return [calls[-1]]
            with pytest.MonkeyPatch.context() as m:
                m.setattr(module, "timed_samples", samples)
                return search(**kw)
        return run

    monkeypatch.chdir(tmp_path)
    results = []
    for mod, main, meas, store_of, sel in (
            ("jax", jax_cli.main, jax_measure, jax_plans.PlanStore, jax_select),
            ("port", cli.main, measure, plans.PlanStore, select)):
        monkeypatch.setattr(meas, "run_sparse_crossover_search", pinned(meas))
        path = str(tmp_path / f"{mod}.json")
        rc = main(["tune", "--shape", "32x32", "--convention", "c", "--quick",
                   "--iters", "1", "--sparse-crossover", "--plan-cache", path,
                   "--report", str(tmp_path / f"{mod}.md")])
        out, err = capsys.readouterr()
        lines = [ln.replace("gol_tpu_torch: ", "gol_tpu: ")
                 for ln in err.splitlines()
                 if ("crossover" in ln or "dense overtakes" in ln)
                 and " -> " not in ln]
        entry = store_of(path).get(sel.sparse_fingerprint())
        monkeypatch.setenv("GOL_PLAN_CACHE", path)
        sel.reset()
        results.append((rc, out, lines, entry, sel.sparse_auto_area(1)))
        sel.reset()
    assert results[1] == results[0]
    rc, _, lines, entry, area = results[1]
    assert rc == 0 and entry["auto_area"] == area
    assert abs(area - (7 << 20)) <= 1  # the line through (2^20, 1/12), (2^22, 2/12) meets 3/12
    assert lines[0] == "tune sparse-crossover: dense-vs-sparse per-generation cost"


@pytest.mark.parametrize("points,sparse", [
    ([(1 << 20, 0.001), (1 << 22, 0.004)], 0.003),
    ([(1 << 20, 0.001), (1 << 22, 0.004), (1 << 24, 0.016)], 0.0005),
    ([(1 << 20, 0.001), (1 << 22, 0.004)], 100.0),
    ([(1 << 20, 0.004), (1 << 22, 0.001)], 0.003),
    ([(1 << 20, 0.001), (1 << 22, 0.00101)], 0.003),
    ([(1 << 20, 0.001)], 0.003),
    ([(1 << 20, 0.001), (1 << 22, 0.004)], 0.0),
])
def test_fit_crossover_matches_jax(points, sparse):
    import gol_tpu.tune.measure as jax_measure

    try:
        want = jax_measure.fit_crossover(points, sparse)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            measure.fit_crossover(points, sparse)
        assert str(got.value) == str(err)
        return
    assert measure.fit_crossover(points, sparse) == want
    result = measure.CrossoverResult(want, points, sparse, 256)
    assert result.to_dict() == jax_measure.CrossoverResult(
        want, points, sparse, 256).to_dict()


@pytest.mark.parametrize("entry", [None, {"auto_area": 1 << 20},
                                   {"auto_area": 1 << 10}, {"auto_area": "x"},
                                   {"nope": 1}])
def test_sparse_and_macro_thresholds_match_jax(plan_cache, entry):
    """Each package's own entry (the fingerprints carry the framework's
    versions) read back by its select: the same value, the same fallback
    on an unusable entry; the tile axis and its validity as JAX's."""
    if entry is not None:
        gens = {k.replace("area", "gens"): (v >> 10 if isinstance(v, int) else v)
                for k, v in entry.items()}
        for store, sel in ((plans.PlanStore(), select),
                           (jax_plans.PlanStore(), jax_select)):
            store.put(sel.sparse_fingerprint(), entry)
            store.put(sel.macro_fingerprint(), gens)
        select.reset()
        jax_select.reset()
    assert select.sparse_auto_area(12345) == jax_select.sparse_auto_area(12345)
    assert select.macro_auto_gens(678) == jax_select.macro_auto_gens(678)
    assert space.SPARSE_TILES == jax_space.SPARSE_TILES
    for args in ((256, 512, 512), (256, 500, 512), (3, 6, 6), (4, 8, 12)):
        assert space.valid_sparse_tile(*args) == jax_space.valid_sparse_tile(*args)
