"""The port's result cache (gol_tpu_torch/cache) against the JAX package's
(gol_tpu/cache), on the CPU.

The keys and the on-disk CAS are the state the two packages share:

- ``result_fingerprint``, ``job_fingerprint``, ``body_fingerprint`` and
  ``packed_body_fingerprint`` equal JAX's for the same job or body, on
  widths that are and are not multiples of 32 and on packed bodies;
- a ``DiskCAS`` written by one package is read by the other, for the
  ``packed`` and ``text`` payloads;
- ``gc.collect``'s report, and the ``gc`` subcommand's stdout in dry-run
  and ``--apply``, equal JAX's on copies of one directory;
- the ``ts`` payload (TensorStore) is refused at construction, and a ``ts``
  entry found on disk is evicted loudly, as JAX evicts an entry it cannot
  read;
- the scheduler's cache consult: hits byte-identical to engine results and
  journaled as DONE records, in-flight coalescing, cancel promotion,
  ``no_cache``, a corrupt entry re-run.

Inputs come from a numpy seed; comparisons are exact.
"""

import io
import contextlib
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from gol_tpu import cli as jax_cli
from gol_tpu.cache import CacheEntry as JaxEntry
from gol_tpu.cache import DiskCAS as JaxCAS
from gol_tpu.cache import ResultCache as JaxCache
from gol_tpu.cache import fingerprint as jax_fp
from gol_tpu.cache import gc as jax_gc
from gol_tpu.io import wire as jax_wire
from gol_tpu.serve import jobs as jax_jobs
from gol_tpu.serve.metrics import Metrics as JaxMetrics
from gol_tpu_torch import cli, engine
from gol_tpu_torch.cache import CacheEntry, DiskCAS, MemoryLRU, ResultCache
from gol_tpu_torch.cache import fingerprint, gc
from gol_tpu_torch.cache.store import TS_REFUSAL
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import wire
from gol_tpu_torch.serve.jobs import (
    CANCELLED, DONE, FAILED, JobJournal, new_job,
)
from gol_tpu_torch.serve.metrics import Metrics
from gol_tpu_torch.serve.scheduler import Scheduler

SHAPES = [(16, 16), (30, 45), (32, 64), (7, 33), (1, 1)]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _board(seed: int, shape=(16, 16)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.uint8)


def _wait_done(jobs, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if all(j.state in (DONE, FAILED, CANCELLED) for j in jobs):
            return
        time.sleep(0.005)
    raise AssertionError(f"jobs not terminal: {[(j.id, j.state) for j in jobs]}")


# ---------------------------------------------------------------------------
# Fingerprints


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("config", [
    {}, {"convention": "cuda", "gen_limit": 17},
    {"check_similarity": False}, {"similarity_frequency": 5, "gen_limit": 3},
], ids=["default", "cuda", "nosim", "freq"])
def test_fingerprints_equal_jax(shape, config):
    board = _board(sum(shape), shape)
    assert fingerprint.board_digest(board) == jax_fp.board_digest(board)
    assert (fingerprint.result_fingerprint(board, **config)
            == jax_fp.result_fingerprint(board, **config))
    h, w = shape
    port_job = new_job(w, h, board, **config)
    jax_job = jax_jobs.new_job(w, h, board, **config)
    assert fingerprint.job_fingerprint(port_job) == jax_fp.job_fingerprint(jax_job)
    body = {"width": w, "height": h,
            "cells": jax_jobs.text_grid.encode(board).decode("ascii"), **config}
    assert fingerprint.body_fingerprint(body) == jax_fp.body_fingerprint(body)
    assert fingerprint.body_fingerprint(body) == fingerprint.job_fingerprint(port_job)
    frame = jax_wire.encode_frame(config, grid=board)
    assert (fingerprint.packed_body_fingerprint(frame)
            == jax_fp.packed_body_fingerprint(frame))


def test_digest_is_layout_and_decomposition_independent():
    board = _board(3, (30, 45))
    want = jax_fp.board_digest(board)
    assert fingerprint.board_digest(np.asfortranarray(board)) == want
    assert fingerprint.board_digest(board[::-1][::-1]) == want
    assert fingerprint.board_digest(torch.from_numpy(board)) == want
    shards = [torch.from_numpy(board[r:r + 15, c:c + 15].copy())
              for r in (0, 15) for c in (0, 15, 30)]
    assert fingerprint.board_digest(shards, mesh_shape=(2, 3)) == want


@pytest.mark.parametrize("body", [
    {"width": 0, "height": 4, "cells": ""},
    {"width": 4, "height": 4, "cells": "0000\n" * 4, "check_similarity": "yes"},
    {"height": 4, "cells": ""},
], ids=["zero_width", "bad_check", "no_width"])
def test_body_fingerprint_refusals_match_jax(body):
    with pytest.raises((ValueError, TypeError, KeyError)) as want:
        jax_fp.body_fingerprint(body)
    with pytest.raises((ValueError, TypeError, KeyError)) as got:
        fingerprint.body_fingerprint(body)
    assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))


# ---------------------------------------------------------------------------
# The CAS, across packages


def _pair(package: str, shape, seed: int, with_words: bool):
    board = _board(seed, shape)
    words = wire.pack_grid(board) if with_words and shape[1] % 32 == 0 else None
    cls = JaxEntry if package == "jax" else CacheEntry
    return cls(grid=board, generations=seed + 1, exit_reason="similar",
               words=words)


@pytest.mark.parametrize("payload", ["packed", "text"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shape", [(30, 45), (32, 64)], ids=["30x45", "32x64"])
def test_cas_written_by_one_package_reads_in_the_other(tmp_path, payload, writer,
                                                       shape):
    entry = _pair(writer, shape, 5, with_words=True)
    fp = fingerprint.result_fingerprint(entry.grid)
    cas_cls, reader_cls = (JaxCAS, DiskCAS) if writer == "jax" else (DiskCAS, JaxCAS)
    cas_cls(str(tmp_path / "cas"), payload=payload).put(fp, entry)
    got = reader_cls(str(tmp_path / "cas")).get(fp)
    assert got is not None
    np.testing.assert_array_equal(got.grid, entry.grid)
    assert (got.generations, got.exit_reason) == (entry.generations, "similar")
    with open(DiskCAS(str(tmp_path / "cas")).meta_path(fp)) as f:
        assert json.load(f)["payload"] == payload
    if payload == "packed":
        np.testing.assert_array_equal(got.words, wire.pack_grid(entry.grid))


@pytest.mark.parametrize("payload", ["packed", "text"])
def test_cas_files_are_byte_identical_to_jax(tmp_path, payload):
    entry = _pair("port", (32, 64), 9, with_words=False)
    fp = fingerprint.result_fingerprint(entry.grid)
    port = DiskCAS(str(tmp_path / "port"), payload=payload)
    jax = JaxCAS(str(tmp_path / "jax"), payload=payload)
    port.put(fp, entry)
    jax.put(fp, _pair("jax", (32, 64), 9, with_words=False))
    for path in ("meta_path", "packed_path"):
        a, b = getattr(port, path)(fp), getattr(jax, path)(fp)
        assert os.path.exists(a) == os.path.exists(b)
        if os.path.exists(a):
            assert open(a, "rb").read() == open(b, "rb").read()


def test_corrupt_sidecar_evicts_loudly(tmp_path):
    entry = _pair("port", (32, 32), 2, with_words=True)
    fp = fingerprint.result_fingerprint(entry.grid)
    evicted = []
    cas = DiskCAS(str(tmp_path), on_evict=lambda fp, why: evicted.append(why))
    cas.put(fp, entry)
    with open(cas.packed_path(fp), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 1]))
    assert cas.get(fp) is None
    assert evicted and "CRC" in evicted[0]
    assert not os.path.exists(cas.meta_path(fp))
    assert not os.path.exists(cas.packed_path(fp))


def test_ts_payload_is_refused_at_construction(tmp_path):
    with pytest.raises(ValueError) as err:
        DiskCAS(str(tmp_path), payload="ts")
    assert str(err.value) == TS_REFUSAL
    with pytest.raises(ValueError):
        ResultCache(cas_dir=str(tmp_path), payload="ts")
    with pytest.raises(ValueError) as err:
        DiskCAS(str(tmp_path), payload="zarr")
    assert "'packed', 'text' or 'ts'" in str(err.value)


def test_a_ts_entry_on_disk_is_evicted_loudly(tmp_path, caplog):
    """A JAX server with ``--cache-payload ts`` left a TensorStore entry:
    the port cannot read it, so it is evicted (meta, zarr) and counted, as
    JAX evicts any entry it cannot read, and the engine re-runs."""
    entry = _pair("jax", (32, 64), 4, with_words=False)
    fp = fingerprint.result_fingerprint(entry.grid)
    JaxCAS(str(tmp_path), payload="ts").put(fp, entry)
    cas = DiskCAS(str(tmp_path))
    with open(cas.meta_path(fp)) as f:
        assert json.load(f)["payload"] == "ts"
    assert os.path.isdir(cas.store_path(fp))
    metrics = Metrics()
    cache = ResultCache(cas_dir=str(tmp_path), metrics=metrics)
    with caplog.at_level("WARNING"):
        assert cache.get(fp) is None
    assert "evicting corrupt entry" in caplog.text and "not ported" in caplog.text
    assert metrics.counter("cache_corrupt_evictions_total") == 1
    assert metrics.counter("cache_misses_total") == 1
    assert not os.path.exists(cas.meta_path(fp))
    assert not os.path.exists(cas.store_path(fp))


def test_result_cache_counters_equal_jax(tmp_path):
    """The same put/get sequence through both tiered caches: the same
    tiers answer and the serving counters agree."""
    seq = [("put", 1), ("get", 1), ("get", 2), ("put", 2), ("put", 3),
           ("get", 1), ("get", 3), ("get", 2)]
    snaps = []
    for tag, cache_cls, entry_cls in (("jax", JaxCache, JaxEntry),
                                      ("port", ResultCache, CacheEntry)):
        metrics = (JaxMetrics if tag == "jax" else Metrics)()
        cache = cache_cls(memory_entries=2, cas_dir=str(tmp_path / tag),
                          metrics=metrics)
        tiers = []
        for op, seed in seq:
            board = _board(seed, (8, 40))
            fp = jax_fp.result_fingerprint(board)
            if op == "put":
                cache.put(fp, entry_cls(grid=board, generations=seed,
                                        exit_reason="gen_limit"))
            else:
                hit = cache.get(fp)
                tiers.append(None if hit is None else hit[1])
        snaps.append((tiers, metrics.snapshot()["counters"]))
    assert snaps[0] == snaps[1]


def test_memory_lru_bound_and_recency():
    lru = MemoryLRU(2)
    for seed in range(3):
        lru.put(str(seed), CacheEntry(grid=_board(seed), generations=1,
                                      exit_reason="gen_limit"))
    assert lru.get("0") is None and len(lru) == 2 and lru.evictions == 1
    lru.get("1")
    lru.put("3", CacheEntry(grid=_board(3), generations=1, exit_reason="empty"))
    assert lru.get("2") is None and lru.get("1") is not None
    with pytest.raises(ValueError, match="max_entries must be >= 1"):
        MemoryLRU(0)


# ---------------------------------------------------------------------------
# GC: the report and the subcommand's lines, on copies of one directory


def _garbage_store(root) -> str:
    """A CAS with entries of both payloads and every garbage class."""
    cas = JaxCAS(str(root), payload="packed")
    for seed in range(4):
        entry = _pair("jax", (16, 32 + seed), seed, with_words=False)
        cas.put(jax_fp.result_fingerprint(entry.grid), entry)
    JaxCAS(str(root), payload="text").put(
        "v1-text", _pair("jax", (8, 8), 7, with_words=False))
    sub = os.path.join(str(root), "v1")
    with open(os.path.join(sub, "v1-orphan.golp"), "wb") as f:
        f.write(b"x" * 50)
    with open(os.path.join(sub, "v1-half.json.12.inprogress"), "wb") as f:
        f.write(b"y" * 20)
    with open(os.path.join(sub, "README"), "w") as f:
        f.write("foreign")
    with open(os.path.join(str(root), "stray.txt"), "w") as f:
        f.write("stray")
    return str(root)


@pytest.mark.parametrize("budget", [None, 0, 900])
def test_gc_collect_report_equals_jax(tmp_path, budget):
    base = _garbage_store(tmp_path / "base")
    dirs = {}
    for tag in ("jax", "port"):
        dirs[tag] = str(tmp_path / tag)
        shutil.copytree(base, dirs[tag])
    for apply in (False, True):
        want = jax_gc.collect(dirs["jax"], budget, apply=apply)
        got = gc.collect(dirs["port"], budget, apply=apply)
        want_d = {k: v for k, v in vars(want).items() if k != "orphans"}
        got_d = {k: v for k, v in vars(got).items() if k != "orphans"}
        assert got_d == want_d
        assert ([os.path.relpath(p, dirs["port"]) for p in got.orphans]
                == [os.path.relpath(p, dirs["jax"]) for p in want.orphans])
    assert gc.scan(dirs["port"])[0] == jax_gc.scan(dirs["jax"])[0]


def _gc_lines(main, args):
    """rc, stdout and stderr; the port logs as ``gol_tpu_torch:`` where JAX
    logs ``gol_tpu:`` (a known difference), so stderr reads JAX's name."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue().replace("gol_tpu_torch: ", "gol_tpu: ")


@pytest.mark.parametrize("flags", [[], ["--budget", "700"], ["--apply"],
                                   ["--budget", "700", "--apply"],
                                   ["--budget", "-1"]],
                         ids=["dry", "dry_budget", "apply", "apply_budget",
                              "bad_budget"])
def test_gc_subcommand_prints_jax_lines(tmp_path, flags):
    base = _garbage_store(tmp_path / "base")
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        target = str(tmp_path / "store")
        shutil.rmtree(target, ignore_errors=True)
        shutil.copytree(base, target)
        results.append(_gc_lines(main, ["gc", target, *flags]))
        results[-1] += (sorted(os.listdir(os.path.join(target, "v1"))),)
    assert results[1] == results[0]
    assert results[0][0] == (1 if "-1" in flags else 0)


def test_gc_refuses_a_missing_directory(tmp_path):
    args = ["gc", str(tmp_path / "nope")]
    assert _gc_lines(cli.main, args) == _gc_lines(jax_cli.main, args)


def test_put_past_the_byte_budget_collects(tmp_path):
    evicted = []
    cas = DiskCAS(str(tmp_path), max_bytes=600,
                  on_gc_evict=lambda fp, n: evicted.append(fp))
    fps = []
    for seed in range(4):
        entry = _pair("port", (16, 32), seed, with_words=True)
        fps.append(fingerprint.result_fingerprint(entry.grid))
        cas.put(fps[-1], entry)
    assert evicted and evicted[0] == fps[0]
    assert cas.usage_bytes() <= 600
    assert cas.get(fps[-1]) is not None


# ---------------------------------------------------------------------------
# The scheduler's consult (the cases of tests/test_cache.py, on the port)


def _cached_scheduler(tmp_path, **kwargs):
    metrics = Metrics()
    cache = ResultCache(memory_entries=64, cas_dir=str(tmp_path / "cas"),
                        metrics=metrics)
    journal = JobJournal(str(tmp_path / "journal"))
    return Scheduler(journal=journal, metrics=metrics, cache=cache,
                     flush_age=0.01, **kwargs), journal


def test_hit_is_byte_identical_marked_and_journaled(tmp_path):
    sched, journal = _cached_scheduler(tmp_path)
    board = _board(11, (30, 45))
    sched.start()
    try:
        first = sched.submit(new_job(45, 30, board, gen_limit=20))
        _wait_done([first])
        second = sched.submit(new_job(45, 30, board.copy(), gen_limit=20))
        assert second.state == DONE and second.result.cached == "memory"
    finally:
        sched.stop()
    want = engine.simulate(board, GameConfig(gen_limit=20))
    for job in (first, second):
        np.testing.assert_array_equal(job.result.grid, want.grid)
        assert job.result.generations == want.generations
    assert sched.metrics.counter("cache_hits_total") == 1
    assert sched.metrics.counter("batches_total") == 1
    replay = JobJournal(str(tmp_path / "journal")).replay()
    assert not replay.pending and set(replay.results) == {first.id, second.id}
    assert replay.results[second.id].cached == "memory"


def test_cas_tier_survives_a_restart_and_corrupt_entries_rerun(tmp_path):
    board = _board(12, (32, 32))
    sched, _ = _cached_scheduler(tmp_path)
    sched.start()
    try:
        job = sched.submit(new_job(32, 32, board, gen_limit=9))
        _wait_done([job])
    finally:
        sched.stop()
    sched2, _ = _cached_scheduler(tmp_path)
    hit = sched2.submit(new_job(32, 32, board, gen_limit=9))
    assert hit.state == DONE and hit.result.cached == "disk"
    np.testing.assert_array_equal(hit.result.grid, job.result.grid)
    cas = sched2.cache.cas
    fp = hit.fingerprint or fingerprint.result_fingerprint(board, gen_limit=9)
    with open(cas.meta_path(fp), "r+") as f:
        meta = json.load(f)
        meta["crc"] ^= 1
        f.seek(0)
        f.truncate()
        json.dump(meta, f)
    sched3, _ = _cached_scheduler(tmp_path)
    sched3.start()
    try:
        rerun = sched3.submit(new_job(32, 32, board, gen_limit=9))
        _wait_done([rerun])
    finally:
        sched3.stop()
    assert rerun.result.cached is None
    assert sched3.metrics.counter("cache_corrupt_evictions_total") == 1
    np.testing.assert_array_equal(rerun.result.grid, job.result.grid)


def test_inflight_duplicates_coalesce_behind_one_run(tmp_path):
    sched, _ = _cached_scheduler(tmp_path)
    board = _board(13, (32, 32))
    jobs = [sched.submit(new_job(32, 32, board, gen_limit=15)) for _ in range(4)]
    other = sched.submit(new_job(32, 32, _board(14, (32, 32)), gen_limit=15))
    assert sched.stats()["coalesced_waiting"] == 3
    sched.start()
    try:
        _wait_done(jobs + [other])
    finally:
        sched.stop()
    assert [j.result.cached for j in jobs] == [None] + ["coalesced"] * 3
    assert sched.metrics.counter("cache_inflight_coalesced_total") == 3
    assert sched.metrics.counter("boards_total") == 2
    for j in jobs[1:]:
        np.testing.assert_array_equal(j.result.grid, jobs[0].result.grid)


def test_cancel_follower_and_leader_promotion(tmp_path):
    sched, _ = _cached_scheduler(tmp_path)  # never started
    board = _board(15, (16, 16))
    leader, f1, f2 = (sched.submit(new_job(16, 16, board)) for _ in range(3))
    assert sched.cancel(f1.id) and f1.state == CANCELLED
    assert sched.cancel(leader.id) and leader.state == CANCELLED
    assert sched._inflight_fp[f2.fingerprint] is f2
    assert sched.stats()["queued"] == 1


def test_no_cache_jobs_bypass_every_tier(tmp_path):
    sched, _ = _cached_scheduler(tmp_path)
    board = _board(16, (16, 16))
    sched.start()
    try:
        jobs = [sched.submit(new_job(16, 16, board, gen_limit=4, no_cache=True))
                for _ in range(2)]
        _wait_done(jobs)
    finally:
        sched.stop()
    assert all(j.fingerprint is None and j.result.cached is None for j in jobs)
    assert sched.metrics.counter("cache_misses_total") == 0
    assert len(sched.cache.memory) == 0


def test_follower_urgency_folds_into_the_queued_leader(tmp_path):
    sched, _ = _cached_scheduler(tmp_path)
    board = _board(17, (16, 16))
    leader = sched.submit(new_job(16, 16, board, priority=0))
    sched.submit(new_job(16, 16, board, priority=7, deadline_s=0.5))
    assert leader.priority == 7 and leader.deadline_s == pytest.approx(0.5, abs=0.05)


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
def test_scheduler_cache_hits_equal_jax_fingerprints(tmp_path, convention):
    """The port's scheduler keys a job exactly as JAX's: the fingerprint it
    stores under is JAX's key for the same submission."""
    sched, _ = _cached_scheduler(tmp_path)
    board = _board(18, (30, 30))
    job = sched.submit(new_job(30, 30, board, convention=convention, gen_limit=6))
    assert job.fingerprint == jax_fp.job_fingerprint(
        jax_jobs.new_job(30, 30, board, convention=convention, gen_limit=6))
