"""The port's job model, journal, compaction and batcher
(gol_tpu_torch.serve) against the JAX package's (gol_tpu.serve), on the
CPU: bucket geometry, batch order and refusals, and journals written by
one package replayed and compacted by the other, with equal replay state.
"""

import dataclasses
import errno
import os
import shutil

import numpy as np
import pytest

from gol_tpu.serve import batcher as jax_batcher
from gol_tpu.serve import compaction as jax_compaction
from gol_tpu.serve import jobs as jax_jobs
from gol_tpu.tune import space as jax_space
from gol_tpu_torch import engine
from gol_tpu_torch.io import bitpack, text_grid
from gol_tpu_torch.resilience import faults
from gol_tpu_torch.serve import batcher, compaction, jobs

CONVENTIONS = ["c", "cuda"]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _job_pair(width, height, board=None, seed=0, job_id=None, **kw):
    """The same job in both packages (one id)."""
    if board is None:
        board = text_grid.generate(width, height, seed=seed)
    job_id = job_id or f"job-{width}x{height}-{seed}"
    return (jax_jobs.Job(id=job_id, width=width, height=height, board=board, **kw),
            jobs.Job(id=job_id, width=width, height=height, board=board, **kw))


# ---------------------------------------------------------------------------
# Bucket geometry.


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 100, 250, 256, 1000])
def test_pad_dim_matches_jax(n):
    assert batcher.pad_dim(n) == jax_batcher.pad_dim(n)


@pytest.mark.parametrize("n", range(1, 65))
def test_pad_batch_matches_jax(n):
    assert batcher.pad_batch(n) == jax_batcher.pad_batch(n)


@pytest.mark.parametrize("n", [0, 65, -3])
def test_pad_batch_refusal_matches_jax(n):
    with pytest.raises(ValueError) as jax_err:
        jax_batcher.pad_batch(n)
    with pytest.raises(ValueError) as port_err:
        batcher.pad_batch(n)
    assert str(port_err.value) == str(jax_err.value)


def test_constants_match_jax():
    assert batcher.PAD_QUANTUM == jax_batcher.PAD_QUANTUM
    assert batcher.BATCH_SIZES == jax_batcher.BATCH_SIZES
    assert batcher.MAX_BATCH == jax_batcher.MAX_BATCH
    assert batcher.SPARSE_KERNEL == jax_batcher.SPARSE_KERNEL
    d, jd = batcher.DEFAULT_SERVE_PLAN, jax_space.DEFAULT_SERVE_PLAN
    assert (d.pad_quantum, d.batch_ladder, d.temporal_depth) == (
        jd.pad_quantum, jd.batch_ladder, jd.temporal_depth)


@pytest.mark.parametrize("shape", [(32, 32), (30, 30), (256, 256), (250, 250),
                                   (20, 33), (64, 8), (1, 1)])
@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("sim", [(True, 3), (False, 3), (True, 5)],
                         ids=["sim3", "nosim", "sim5"])
def test_bucket_for_and_label_match_jax(shape, convention, sim):
    width, height = shape
    jax_job, port_job = _job_pair(width, height, convention=convention,
                                  check_similarity=sim[0],
                                  similarity_frequency=sim[1])
    jk, pk = jax_batcher.bucket_for(jax_job), batcher.bucket_for(port_job)
    assert (pk.height, pk.width, pk.convention, pk.kernel, pk.check_similarity,
            pk.similarity_frequency) == (jk.height, jk.width, jk.convention,
                                         jk.kernel, jk.check_similarity,
                                         jk.similarity_frequency)
    assert pk.label() == jk.label()


def test_tuned_plan_moves_jax_buckets_not_the_ports(monkeypatch):
    """A known difference: the port has no tuner, so a plan that ``gol
    tune`` cached moves the JAX package's buckets and never the port's."""
    monkeypatch.setattr(jax_batcher, "_PLAN", jax_space.ServePlan(
        pad_quantum=64, batch_ladder=(1, 8, 64), temporal_depth=2))
    jax_job, port_job = _job_pair(30, 30)
    assert jax_batcher.bucket_for(jax_job).label() == "64x64/c/masked"
    assert batcher.bucket_for(port_job).label() == "32x32/c/masked"
    assert (jax_batcher.pad_batch(3), batcher.pad_batch(3)) == (8, 4)
    assert batcher._plan() is batcher.DEFAULT_SERVE_PLAN


# ---------------------------------------------------------------------------
# Batches.


def _bucket_jobs(n, width=32, height=32, convention="c", gen_limit=25):
    return [_job_pair(width, height, seed=100 + i, job_id=f"j{i}",
                      convention=convention, gen_limit=gen_limit + i)
            for i in range(n)]


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("shape", [(32, 32), (30, 27)], ids=["packed", "masked"])
def test_run_batch_matches_jax_in_job_order(convention, shape):
    pairs = _bucket_jobs(5, *shape, convention=convention)
    key = batcher.bucket_for(pairs[0][1])
    jax_res = jax_batcher.run_batch(jax_batcher.bucket_for(pairs[0][0]),
                                    [j for j, _ in pairs])
    port_res = batcher.run_batch(key, [p for _, p in pairs])
    for p_job, j, p in zip([p for _, p in pairs], jax_res, port_res):
        solo = engine.simulate(p_job.board, p_job.config, device="cpu")
        np.testing.assert_array_equal(p.grid, solo.grid)
        assert p.generations == solo.generations
        np.testing.assert_array_equal(p.grid, j.grid)
        assert (p.generations, p.exit_reason) == (j.generations, j.exit_reason)
        assert (p.words is None) == (j.words is None)


def test_run_batch_refuses_a_foreign_job_as_jax_does():
    pairs = _bucket_jobs(2) + [_job_pair(64, 64, seed=9, job_id="foreign")]
    errs = []
    for tag, mod, col in (("jax", jax_batcher, 0), ("port", batcher, 1)):
        job_list = [p[col] for p in pairs]
        key = mod.bucket_for(job_list[0])
        with pytest.raises(ValueError) as err:
            mod.run_batch(key, job_list)
        errs.append(str(err.value))
        with pytest.raises(ValueError) as err:
            mod.stage(key, job_list)
        errs.append(str(err.value))
    assert errs[2:] == errs[:2]
    assert "job foreign belongs to bucket 64x64/c/packed, not 32x32/c/packed" in errs[0]


def test_oversized_and_empty_batches_match_jax():
    pairs = _bucket_jobs(65)
    key = batcher.bucket_for(pairs[0][1])
    jkey = jax_batcher.bucket_for(pairs[0][0])
    assert batcher.run_batch(key, []) == jax_batcher.run_batch(jkey, []) == []
    for call in ("run_batch", "stage"):
        for jobs_of in (lambda c: [p[c] for p in pairs], lambda c: []):
            if call == "run_batch" and not jobs_of(0):
                continue
            with pytest.raises(ValueError) as jax_err:
                getattr(jax_batcher, call)(jkey, jobs_of(0))
            with pytest.raises(ValueError) as port_err:
                getattr(batcher, call)(key, jobs_of(1))
            assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_stage_dispatch_complete_equals_run_batch(convention):
    port_jobs = [p for _, p in _bucket_jobs(3, 30, 30, convention=convention)]
    key = batcher.bucket_for(port_jobs[0])
    staged = batcher.stage(key, port_jobs)
    assert staged.staged.total == 4 and staged.staged.mode == "masked"
    first = batcher.complete(batcher.dispatch(staged))
    again = batcher.complete(batcher.dispatch(staged))  # the retry path
    want = batcher.run_batch(key, port_jobs)
    for a, b, w in zip(first, again, want):
        np.testing.assert_array_equal(a.grid, w.grid)
        np.testing.assert_array_equal(b.grid, w.grid)
        assert (a.generations, a.exit_reason) == (w.generations, w.exit_reason)


def test_staging_uses_retained_words():
    port_jobs = [p for _, p in _bucket_jobs(2, 64, 32)]
    for job in port_jobs:
        job.words = bitpack.pack_words(job.board)
    staged = batcher.stage(batcher.bucket_for(port_jobs[0]), port_jobs)
    assert staged.staged.mode == "packed"
    results = batcher.complete(batcher.dispatch(staged))
    for job, r in zip(port_jobs, results):
        solo = engine.simulate(job.board, job.config, device="cpu")
        np.testing.assert_array_equal(r.grid, solo.grid)


@pytest.mark.parametrize("label", ["32x32/c/packed", "32x32/cuda/masked"])
def test_warm_builds_the_runner(label):
    shape, convention, kernel = label.split("/")
    key = batcher.BucketKey(32, 32, convention, kernel)
    engine.make_batch_runner.cache_clear()
    batcher.warm(key, batch=3)
    assert engine.make_batch_runner.cache_info().currsize == 1


def test_sparse_jobs_are_refused_with_a_gol_error():
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        jobs.Job(id="s", width=64, height=64, board=None, rle="bo$2bo$3o!")
    key = batcher.BucketKey(64, 64, "c", batcher.SPARSE_KERNEL)
    for call in (lambda: batcher.run_batch(key, []), lambda: batcher.stage(key, [])):
        with pytest.raises(ValueError, match="Queue 1 item 7"):
            call()
    batcher.warm(key)  # nothing to build, as in JAX


# ---------------------------------------------------------------------------
# Jobs and journals across the packages.


@pytest.mark.parametrize("kw", [
    {}, {"convention": "cuda", "gen_limit": 7, "priority": 3, "deadline_s": 1.5},
    {"check_similarity": False, "similarity_frequency": 4, "no_cache": True},
])
def test_job_records_match_jax(kw):
    jax_job, port_job = _job_pair(20, 9, seed=4, **kw)
    assert port_job.to_record() == jax_job.to_record()
    back = jobs.Job.from_record(jax_job.to_record())
    np.testing.assert_array_equal(back.board, jax_job.board)
    assert back.to_record() == jax_job.to_record()
    assert (port_job.config.gen_limit, port_job.config.convention) == (
        jax_job.config.gen_limit, jax_job.config.convention)


@pytest.mark.parametrize("bad", [
    {"width": 0}, {"gen_limit": -1}, {"similarity_frequency": 0},
    {"convention": "mpi"}, {"deadline_s": -1}, {"check_similarity": "false"},
    {"no_cache": 1}, {"macro": True}, {"shard": True}, {"height": 5},
])
def test_job_validation_matches_jax(bad):
    args = {"id": "x", "width": 8, "height": 4,
            "board": np.zeros((4, 8), np.uint8), **bad}
    errors = []
    for mod in (jax_jobs, jobs):
        with pytest.raises((TypeError, ValueError)) as err:
            mod.Job(**args)
        errors.append((type(err.value), str(err.value)))
    assert errors[1] == errors[0]


def test_transitions_match_jax():
    assert jobs._TRANSITIONS == jax_jobs._TRANSITIONS
    job = jobs.Job(id="t", width=4, height=4, board=np.zeros((4, 4), np.uint8))
    job.transition(jobs.SCHEDULED)
    with pytest.raises(ValueError, match="illegal transition scheduled -> done"):
        job.transition(jobs.DONE)


def _write_journal(mod, directory, segment_bytes):
    """A journal with every event kind: submits, a batch of dones, a cached
    done, a failure, a cancel, a job left pending, and a torn tail."""
    j = mod.JobJournal(str(directory), segment_bytes=segment_bytes)
    made = []
    for i in range(6):
        job = mod.Job(id=f"job{i}", width=12, height=5 + i,
                      board=text_grid.generate(12, 5 + i, seed=i),
                      gen_limit=10 + i, priority=i - 2)
        j.record_submit(job)
        made.append(job)
    for job in made[:3]:
        job.result = mod.JobResult(grid=np.asarray(job.board)[::-1].copy(),
                                   generations=3, exit_reason="similar")
    made[2].result.cached = "memory"
    j.record_done_many(made[:2])
    j.record_done(made[2])
    made[3].error = "boom"
    j.record_failed(made[3])
    j.record_cancelled(made[4])
    j.close()
    with open(os.path.join(str(directory), mod.JobJournal.FILENAME), "ab") as f:
        f.write(b'{"event": "done", "id": "job5", "gener')  # a crash mid-append
    return made


def _replay_view(state):
    return {
        "pending": sorted((j.id, tuple(sorted(j.to_record().items())))
                          for j in state.pending),
        "results": {k: (v.grid.tobytes(), v.grid.shape, v.generations,
                        v.exit_reason, v.cached)
                    for k, v in state.results.items()},
        "failed": state.failed,
        "cancelled": state.cancelled,
        "torn": state.torn_lines,
    }


@pytest.mark.parametrize("segment_bytes", [0, 400], ids=["single", "segmented"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer, segment_bytes):
    _write_journal(jax_jobs if writer == "jax" else jobs, tmp_path, segment_bytes)
    jax_state = jax_jobs.JobJournal(str(tmp_path), segment_bytes=segment_bytes).replay()
    port_state = jobs.JobJournal(str(tmp_path), segment_bytes=segment_bytes).replay()
    assert _replay_view(port_state) == _replay_view(jax_state)
    assert [j.id for j in port_state.pending] == ["job5"]
    assert port_state.torn_lines == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_bytes_match_jax(tmp_path, writer):
    """Both packages write the same records, byte for byte."""
    for tag, mod in (("jax", jax_jobs), ("port", jobs)):
        _write_journal(mod, tmp_path / tag, 0)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("compactor", ["jax", "port"])
@pytest.mark.parametrize("retain", [None, 1])
def test_compaction_across_packages(tmp_path, compactor, retain):
    """One package compacts what the other wrote: the same report and
    snapshot bytes, and replay state equal under both."""
    writer = jobs if compactor == "jax" else jax_jobs
    _write_journal(writer, tmp_path / "src", 300)
    reports = {}
    for tag, mod in (("jax", jax_compaction), ("port", compaction)):
        shutil.copytree(tmp_path / "src", tmp_path / tag)
        reports[tag] = dataclasses.asdict(
            mod.compact(str(tmp_path / tag), retain_results=retain))
    assert reports["port"] == reports["jax"]
    assert reports["port"]["compacted"]
    assert (tmp_path / "port" / "snapshot.jsonl").read_bytes() == \
        (tmp_path / "jax" / "snapshot.jsonl").read_bytes()
    here = str(tmp_path / compactor)
    assert _replay_view(jobs.JobJournal(here).replay()) == \
        _replay_view(jax_jobs.JobJournal(here).replay())


def test_journal_append_meets_the_fault_plan(tmp_path):
    faults.install(faults.FaultPlan.parse("full_disk=1"))
    try:
        j = jobs.JobJournal(str(tmp_path))
        job = jobs.new_job(4, 4, np.zeros((4, 4), np.uint8))
        with pytest.raises(OSError) as err:
            j.record_submit(job)
        assert err.value.errno == errno.ENOSPC
    finally:
        faults.clear()


@pytest.mark.parametrize("stage", ["snapshot", "retire"])
def test_compaction_kill_replays_identically(tmp_path, stage):
    _write_journal(jobs, tmp_path, 300)
    before = _replay_view(jobs.JobJournal(str(tmp_path)).replay())
    faults.install(faults.FaultPlan.parse(f"kill_during_compaction={stage}"))
    try:
        with pytest.raises(faults.InjectedCrash):
            compaction.compact(str(tmp_path))
    finally:
        faults.clear()
    assert _replay_view(jobs.JobJournal(str(tmp_path)).replay()) == before
    assert _replay_view(jax_jobs.JobJournal(str(tmp_path)).replay()) == before
    compaction.compact(str(tmp_path))
    assert _replay_view(jobs.JobJournal(str(tmp_path)).replay()) == before
