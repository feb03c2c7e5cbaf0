"""The port's resident ring (gol_tpu_torch/engine.py's ring section and
gol_tpu_torch/serve/resident.py) against the JAX package's, on the CPU.

Mirrors ``tests/test_megabatch.py``'s ``TestRingEngine`` and
``TestResidentServe``:

- per-slot results of a partial ring equal JAX's ``complete_ring``, the
  port's ``complete_batch`` and solo runs, in both conventions, in masked
  and packed buckets, with temporal depth; a re-dispatch is idempotent;
  mixed geometry and overflow raise JAX's messages;
- a drain of k filled slots runs the batched loop once over k*B boards,
  ``dispatch_ring`` returns before that loop ends, and a refill of the other
  slot storage while a drain runs leaves the drain's results unchanged;
- through the ``Scheduler`` the resident lane's results equal classic depth
  1 and JAX's resident lane; the state provider, the flight dump and the
  registry carry the ring's state and metrics; no thread outlives
  ``stop()``.

The SIGKILL drills are in ``tests/test_torch_ring_sigkill.py``. Boards are
32^2 (the packed bucket) and 30^2 or smaller (masked), made from a numpy
seed; integers and bytes are compared exactly.
"""

import signal
import threading
import time

import numpy as np
import pytest

from gol_tpu import engine as jax_engine
from gol_tpu.config import GameConfig as JaxConfig
from gol_tpu.serve import scheduler as jax_scheduler
from gol_tpu.serve.jobs import new_job as jax_new_job
from gol_tpu_torch import engine
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.obs import recorder as obs_recorder
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.ops import stencil_batch
from gol_tpu_torch.serve import batcher, scheduler
from gol_tpu_torch.serve.jobs import DONE, JobJournal, new_job
from gol_tpu_torch.serve.resident import STATE_PROVIDER, ResidentEngine
from gol_tpu_torch.serve.scheduler import Scheduler

CONVENTIONS = ["c", "cuda"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _mixed_fate_boards(side=32):
    """Boards covering every exit reason inside one batch."""
    dies = np.zeros((side, side), np.uint8)
    dies[4, 4] = 1  # lone cell: empty exit
    still = np.zeros((side, side), np.uint8)
    still[3:5, 3:5] = 1  # block still life: similarity exit
    soup = text_grid.generate(side, side, seed=7)  # runs to the limit
    soup2 = text_grid.generate(side, side, seed=8)
    return [dies, still, soup, soup2]


def _same(a, b) -> None:
    assert np.array_equal(a.grid, b.grid)
    assert (a.generations, a.exit_reason) == (b.generations, b.exit_reason)


def _serve_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("gol-serve-", "gol-ring-"))]


# ---------------------------------------------------------------------------
# The ring engine.


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_partial_ring_matches_jax_batch_and_solo(convention):
    boards = _mixed_fate_boards()
    chunks = (boards[:2], boards[2:])
    config = GameConfig(gen_limit=40, convention=convention)
    staged = [engine.stage_batch(c, config, padded_shape=(32, 32),
                                 pad_batch_to=2) for c in chunks]
    slots = engine.complete_ring(
        engine.dispatch_ring(engine.stage_ring(staged, ring=4)))
    jax_config = JaxConfig(gen_limit=40, convention=convention)
    jax_slots = jax_engine.complete_ring(jax_engine.dispatch_ring(
        jax_engine.stage_ring([
            jax_engine.stage_batch(c, jax_config, padded_shape=(32, 32),
                                   pad_batch_to=2) for c in chunks], ring=4)))
    assert len(slots) == len(jax_slots) == 2
    reasons = set()
    for slot, jax_slot, s, chunk in zip(slots, jax_slots, staged, chunks):
        batch = engine.complete_batch(engine.dispatch_batch(s, "cpu"))
        for r, j, b, board in zip(slot, jax_slot, batch, chunk):
            _same(r, j)
            _same(r, b)
            solo = engine.simulate(board, config, device="cpu")
            assert np.array_equal(r.grid, solo.grid)
            assert r.generations == solo.generations
            np.testing.assert_array_equal(r.words, b.words)
            reasons.add(r.exit_reason)
    assert reasons == {"empty", "similar", "gen_limit"}


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mode", ["masked", "packed"])
def test_bucket_with_temporal_depth_matches_jax(mode, convention):
    rng = np.random.default_rng(3)
    if mode == "masked":
        boards = [rng.integers(0, 2, (20, 24), np.uint8),
                  rng.integers(0, 2, (30, 30), np.uint8)]
    else:
        boards = _mixed_fate_boards()[:2] + [rng.integers(0, 2, (32, 32),
                                                          np.uint8)]
    config = GameConfig(gen_limit=25, convention=convention)
    staged = engine.stage_batch(boards, config, padded_shape=(32, 32),
                                pad_batch_to=4, temporal_depth=4)
    assert staged.mode == mode
    (results,) = engine.complete_ring(
        engine.dispatch_ring(engine.stage_ring([staged], ring=2)))
    jax_staged = jax_engine.stage_batch(
        boards, JaxConfig(gen_limit=25, convention=convention),
        padded_shape=(32, 32), pad_batch_to=4, temporal_depth=4)
    (jax_results,) = jax_engine.complete_ring(
        jax_engine.dispatch_ring(jax_engine.stage_ring([jax_staged], ring=2)))
    for r, j, board in zip(results, jax_results, boards):
        _same(r, j)
        solo = engine.simulate(board, config, device="cpu")
        assert (r.generations, np.array_equal(r.grid, solo.grid)) == (
            solo.generations, True)


def test_redispatch_same_ring_is_idempotent():
    """The retry path: dispatches from the retained host staging (three, so
    both slot storages are reused) give identical results and never
    re-pack."""
    boards = _mixed_fate_boards()
    staged = engine.stage_batch(boards, GameConfig(gen_limit=30),
                                padded_shape=(32, 32), pad_batch_to=4)
    packs0 = obs_registry.default().counter("engine_stage_packs_total")
    ring = engine.stage_ring([staged], ring=2)
    first = engine.complete_ring(engine.dispatch_ring(ring))
    for _ in range(3):
        again = engine.complete_ring(engine.dispatch_ring(ring))
        for a, b in zip(first[0], again[0]):
            _same(a, b)
    assert obs_registry.default().counter(
        "engine_stage_packs_total") == packs0


def _raised(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


def test_ring_rejects_mixed_geometry_and_overflow_with_jax_messages():
    def cases(eng, config_cls):
        zeros = np.zeros((32, 32), np.uint8)
        a = eng.stage_batch([zeros], config_cls(gen_limit=5),
                            padded_shape=(32, 32), pad_batch_to=1)
        b = eng.stage_batch([zeros] * 2, config_cls(gen_limit=5),
                            padded_shape=(32, 32), pad_batch_to=2)
        cuda = eng.stage_batch([zeros], config_cls(gen_limit=5, convention="cuda"),
                               padded_shape=(32, 32), pad_batch_to=1)
        return [_raised(eng.stage_ring, batches, ring=2)
                for batches in ([a, b], [a, cuda], [a, a, a], [])]

    assert cases(engine, GameConfig) == cases(jax_engine, JaxConfig)


def test_runner_refuses_a_foreign_geometry_and_a_bad_ring():
    staged = engine.stage_batch([np.zeros((32, 32), np.uint8)],
                                GameConfig(gen_limit=5), padded_shape=(32, 32),
                                pad_batch_to=1)
    other = engine.RingRunner((32, 32), 2, 2, mode="packed", device="cpu")
    with pytest.raises(ValueError, match="another bucket geometry"):
        engine.stage_ring([staged], 2, runner=other)
    with pytest.raises(ValueError, match="ring must be >= 1, got 0"):
        engine.RingRunner((32, 32), 1, 0, device="cpu")


def _gated_loop(monkeypatch):
    """Patch the batched loop the drain thread runs: each drain records its
    board count and waits for ``gate``."""
    gate, seen = threading.Event(), []
    real = engine._run_batch_loop

    def loop(boards, *args, **kwargs):
        seen.append(boards.shape[0])
        assert gate.wait(timeout=60)
        return real(boards, *args, **kwargs)

    monkeypatch.setattr(engine, "_run_batch_loop", loop)
    return gate, seen


def test_drain_returns_at_once_and_runs_one_loop_over_filled_boards(monkeypatch):
    """A drain of k = 2 filled slots of a 4-ring of B = 2: ``dispatch_ring``
    returns while its loop is held, and the loop runs once over k*B = 4
    boards, not R*B = 8."""
    gate, seen = _gated_loop(monkeypatch)
    boards = _mixed_fate_boards()
    config = GameConfig(gen_limit=20)
    staged = [engine.stage_batch(boards[i:i + 2], config, padded_shape=(32, 32),
                                 pad_batch_to=2) for i in (0, 2)]
    inflight = engine.dispatch_ring(engine.stage_ring(staged, ring=4))
    assert not inflight.done.wait(timeout=0.2)  # the loop is held
    gate.set()
    slots = engine.complete_ring(inflight)
    assert seen == [4]
    for slot, s in zip(slots, staged):
        for r, b in zip(slot, engine.complete_batch(engine.dispatch_batch(s, "cpu"))):
            _same(r, b)


def test_refill_while_a_drain_runs_leaves_its_results(monkeypatch):
    """The other slot storage is refilled and dispatched while the first
    drain's loop is held; a third refill (of the first storage) waits for
    the first drain. Every drain's results equal its batch's own."""
    gate, seen = _gated_loop(monkeypatch)
    runner = engine.RingRunner((32, 32), 2, 2, mode="packed", device="cpu")
    config = GameConfig(gen_limit=24)
    stagings = [engine.stage_batch(
        [text_grid.generate(32, 32, seed=40 + 2 * i + k) for k in range(2)],
        config, padded_shape=(32, 32), pad_batch_to=2) for i in range(3)]
    rings = [engine.stage_ring([s], 2, runner=runner) for s in stagings]
    first = engine.dispatch_ring(rings[0])
    second = engine.dispatch_ring(rings[1])  # the other storage: no wait
    third = []
    t = threading.Thread(target=lambda: third.append(engine.dispatch_ring(rings[2])))
    t.start()
    time.sleep(0.2)
    assert not third  # the first storage is still read by the held drain
    gate.set()
    t.join(timeout=60)
    slots = [engine.complete_ring(inflight)[0]
             for inflight in (first, second, third[0])]
    assert seen == [2, 2, 2]
    for slot, s in zip(slots, stagings):
        for r, b in zip(slot, engine.complete_batch(engine.dispatch_batch(s, "cpu"))):
            _same(r, b)
    runner.close()
    assert not [n for n in _serve_threads() if n == "gol-ring-drain"]


def test_a_failed_drain_raises_for_every_slot_and_frees_its_storage(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("launch failed")

    staged = engine.stage_batch([np.ones((32, 32), np.uint8)],
                                GameConfig(gen_limit=3), padded_shape=(32, 32),
                                pad_batch_to=1)
    runner = engine.RingRunner((32, 32), 1, 2, mode="packed", device="cpu")
    ring = engine.stage_ring([staged], 2, runner=runner)
    monkeypatch.setattr(engine, "_run_batch_loop", boom)
    inflight = engine.dispatch_ring(ring)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="launch failed"):
            engine.complete_ring(inflight)
    monkeypatch.undo()
    (want,) = engine.complete_batch(engine.dispatch_batch(staged, "cpu"))
    for _ in range(2):  # both storages are free again
        (slot,) = engine.complete_ring(engine.dispatch_ring(ring))
        _same(slot[0], want)


def test_the_cpu_ring_launches_no_kernel():
    before = dict(stencil_batch.LAUNCHES)
    staged = engine.stage_batch(_mixed_fate_boards(), GameConfig(gen_limit=8),
                                padded_shape=(32, 32), pad_batch_to=4)
    engine.complete_ring(engine.dispatch_ring(engine.stage_ring([staged], 2)))
    assert stencil_batch.LAUNCHES == before


# ---------------------------------------------------------------------------
# The resident serve lane.


@pytest.mark.parametrize("kwargs", [
    {"resident_ring": 1},
    {"resident_ring": 2},
    {"resident_ring": 2, "pipeline_depth": 4, "run_batch": "injected"},
    {"resident_ring": 2, "pipeline_depth": 4, "split_batch": "injected"},
], ids=["ring_1", "needs_pipeline", "injected_run", "injected_split"])
def test_validation_matches_jax(kwargs):
    def build(module):
        kw = dict(kwargs)
        if kw.get("run_batch") == "injected":
            kw["run_batch"] = lambda key, jobs: []
        if kw.get("split_batch") == "injected":
            kw["split_batch"] = (None, None, None)
        return _raised(module.Scheduler, **kw)

    assert build(scheduler) == build(jax_scheduler)


def _trio_boards():
    boards = []
    for i in range(12):
        if i % 4 == 0:
            b = np.zeros((32, 32), np.uint8)
            b[2, 2] = 1  # empty exit
        elif i % 4 == 1:
            b = np.zeros((30, 30), np.uint8)
            b[3:5, 3:5] = 1  # still life in the masked bucket
        else:
            side = 32 if i % 2 == 0 else 30
            b = text_grid.generate(side, side, seed=900 + i)
        boards.append(b)
    return boards


def _run_scheduler(sched_cls, make_job, boards, convention, **kwargs):
    sched = sched_cls(flush_age=0.01, max_batch=4, **kwargs)
    jobs = [make_job(b.shape[1], b.shape[0], b, gen_limit=18,
                     convention=convention) for b in boards]
    for job in jobs:
        sched.submit(job)
    sched.start()
    assert sched.drain(timeout=120)
    sched.stop(drain=False)
    assert all(j.state == "done" for j in jobs)
    return jobs


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_results_match_classic_depth1_and_jax(convention):
    """Resident-lane results equal the classic depth-1 worker's and JAX's
    resident lane's for mixed-fate batches across two buckets — grids,
    generation counts and exit reasons."""
    boards = _trio_boards()
    classic = _run_scheduler(Scheduler, new_job, boards, convention)
    resident = _run_scheduler(Scheduler, new_job, boards, convention,
                              pipeline_depth=8, resident_ring=4)
    jax_resident = _run_scheduler(jax_scheduler.Scheduler, jax_new_job, boards,
                                  convention, pipeline_depth=8, resident_ring=4)
    for a, b, j in zip(classic, resident, jax_resident):
        _same(a.result, b.result)
        _same(j.result, b.result)
    assert {j.result.exit_reason for j in resident} == {
        "empty", "similar", "gen_limit"}


def test_ring_and_thread_hygiene_after_drain(tmp_path):
    journal = JobJournal(str(tmp_path / "j"))
    sched = Scheduler(journal=journal, flush_age=0.0, max_batch=4,
                      pipeline_depth=4, resident_ring=2)
    jobs = [new_job(32, 32, text_grid.generate(32, 32, seed=40 + i),
                    gen_limit=8) for i in range(6)]
    for job in jobs:
        sched.submit(job)
    sched.start()
    assert "gol-serve-journal" in _serve_threads()
    assert sched.drain(timeout=120)
    rings = sched.stats()["resident_rings"]
    assert all(v == 0 for k, v in rings.items()
               if k.endswith((".open", ".unresolved_drains")))
    assert any(k.endswith(".drains_total") and v > 0 for k, v in rings.items())
    sched.stop(drain=False)
    assert _serve_threads() == []
    assert STATE_PROVIDER not in obs_recorder._state_providers
    replay = journal.replay()
    journal.close()
    assert not replay.pending
    assert set(replay.results) == {j.id for j in jobs}
    assert all("journaled" in j.timeline for j in jobs)


def test_state_provider_reports_ring_state():
    eng = ResidentEngine(ring=2)
    try:
        assert STATE_PROVIDER in obs_recorder._state_providers
        key = batcher.bucket_for(
            new_job(32, 32, np.zeros((32, 32), np.uint8), gen_limit=2))
        staged = eng.stage(key, [new_job(32, 32, text_grid.generate(
            32, 32, seed=1), gen_limit=4)])
        ticket = eng.dispatch(staged)
        state = eng.state()
        # An idle lane dispatches the slot at once.
        assert state[f"{key.label()}.open"] == 0
        assert state[f"{key.label()}.unresolved_drains"] == 1
        assert len(eng.complete(ticket)) == 1
        state = eng.state()
        assert state[f"{key.label()}.unresolved_drains"] == 0
        assert state[f"{key.label()}.drains_total"] == 1
        assert state[f"{key.label()}.ring"] == 2
    finally:
        eng.close()
    assert STATE_PROVIDER not in obs_recorder._state_providers
    with pytest.raises(ValueError, match="resident ring must be >= 2, got 1"):
        ResidentEngine(ring=1)


def test_busy_lane_accumulates_slots_and_flushes_on_demand():
    """With a drain unresolved, later slots wait (open) until the ring
    fills, the drain resolves, or a completion demands them."""
    eng = ResidentEngine(ring=4)
    try:
        jobs = [new_job(32, 32, text_grid.generate(32, 32, seed=60 + i),
                        gen_limit=6) for i in range(3)]
        key = batcher.bucket_for(jobs[0])
        tickets = [eng.dispatch(eng.stage(key, [j])) for j in jobs]
        state = eng.state()
        assert state[f"{key.label()}.open"] == 2
        assert state[f"{key.label()}.drains_total"] == 1
        results = eng.complete(tickets[2])  # completion demand flushes
        assert eng.state()[f"{key.label()}.drains_total"] == 2
        solo = engine.simulate(jobs[2].board, jobs[2].config, device="cpu")
        assert np.array_equal(results[0].grid, solo.grid)
        for t in tickets[:2]:
            eng.complete(t)
        assert eng.state()[f"{key.label()}.unresolved_drains"] == 0
    finally:
        eng.close()


def test_flight_dump_and_report_carry_ring_state(tmp_path):
    from gol_tpu_torch.obs import report as obs_report
    from gol_tpu_torch.obs import trace as obs_trace

    obs_registry.reset_default()
    obs_trace.enable()
    # The recorder takes SIGUSR1 the first time it is armed in a process;
    # hand it back, so a later test of the JAX package's recorder in this
    # process gets the signal.
    sigusr1 = signal.getsignal(signal.SIGUSR1)
    obs_recorder.install(str(tmp_path))
    try:
        sched = Scheduler(flush_age=0.0, max_batch=2, pipeline_depth=4,
                          resident_ring=2)
        jobs = [new_job(32, 32, text_grid.generate(32, 32, seed=80 + i),
                        gen_limit=6) for i in range(4)]
        for job in jobs:
            sched.submit(job)
        sched.start()
        assert sched.drain(timeout=120)
        path = obs_recorder.trigger("test")
        sched.stop(drain=False)
    finally:
        obs_recorder.uninstall()
        signal.signal(signal.SIGUSR1, sigusr1)
        obs_trace.disable()
        obs_trace.clear()
    rendered = obs_report.render(path)
    for needle in ("serve.resident_loop", "state[resident_rings]",
                   "dispatch_gap_seconds", "ring_slot_occupancy"):
        assert needle in rendered


def test_resident_metrics_land_in_registry():
    obs_registry.reset_default()
    sched = Scheduler(flush_age=0.0, max_batch=2, pipeline_depth=4,
                      resident_ring=2)
    jobs = [new_job(32, 32, text_grid.generate(32, 32, seed=70 + i),
                    gen_limit=6) for i in range(4)]
    for job in jobs:
        sched.submit(job)
    sched.start()
    assert sched.drain(timeout=120)
    sched.stop(drain=False)
    snap = obs_registry.default().snapshot()
    assert "dispatch_gap_seconds" in snap["histograms"]
    assert 0 < snap["gauges"]["ring_slot_occupancy"] <= 1
    assert all(j.state == DONE for j in jobs)
