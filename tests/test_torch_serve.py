"""The port's server lane (gol_tpu_torch/serve/scheduler.py and server.py)
against the JAX package's, on the CPU.

- The cases of ``tests/test_serve.py``'s ``TestScheduler`` and
  ``TestServer``, run against the port.
- The same jobs through both packages' schedulers give equal bytes,
  generations and exit reasons, at pipeline depth 1 and 2 and at
  ``max_inflight`` 2.
- For the same requests both servers answer the same status codes and
  error JSON (job ids masked), and the same ``/metrics`` text with the
  values masked.
- A journal written by one package's server replays in the other's,
  exactly once.
- Packed POSTs and packed results are byte-identical across the servers
  (the id in a result frame's meta aside); a repeat submit with the cache
  mounted answers ``"cached": "memory"`` in both.

Boards are 32^2 (the packed bucket) and 30^2 (the masked one), made from a
numpy seed, so the JAX package builds few batch programs.
"""

import json
import re
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from gol_tpu.io import wire as jax_wire
from gol_tpu.serve import jobs as jax_jobs
from gol_tpu.serve import scheduler as jax_scheduler
from gol_tpu.serve import server as jax_server
from gol_tpu_torch import oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid, wire
from gol_tpu_torch.resilience.retry import RetryPolicy
from gol_tpu_torch.serve import batcher, compaction, jobs, server
from gol_tpu_torch.serve.jobs import (
    CANCELLED, DONE, FAILED, QUEUED, JobJournal, new_job,
)
from gol_tpu_torch.serve.scheduler import Draining, QueueFull, Scheduler
from gol_tpu_torch.serve.server import GolServer

PACKAGES = {
    "jax": (jax_server.GolServer, jax_scheduler.Scheduler, jax_jobs),
    "port": (GolServer, Scheduler, jobs),
}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _wait(predicate, timeout=60.0, interval=0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _http(method, url, body=None, raw=None, content_type=None, headers=None,
          timeout=60):
    """(status, content type, body bytes)."""
    data = json.dumps(body).encode() if body is not None else raw
    hdrs = dict(headers or {})
    if data is not None:
        hdrs["Content-Type"] = content_type or "application/json"
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(method, url, body=None, **kw):
    status, _, raw = _http(method, url, body, **kw)
    return status, json.loads(raw)


def _cells(board) -> str:
    return text_grid.encode(board).decode("ascii")


# ---------------------------------------------------------------------------
# tests/test_serve.py's TestScheduler, on the port


class TestScheduler:
    def test_end_to_end_mixed_buckets(self, tmp_path):
        journal = JobJournal(str(tmp_path))
        sched = Scheduler(journal=journal, flush_age=0.01)
        boards = [text_grid.generate(32, 32, seed=1),
                  text_grid.generate(30, 30, seed=2),
                  text_grid.generate(32, 32, seed=3)]
        js = [new_job(b.shape[1], b.shape[0], b, gen_limit=15) for b in boards]
        sched.start()
        try:
            for j in js:
                sched.submit(j)
            assert _wait(lambda: all(j.state == DONE for j in js))
        finally:
            sched.stop()
        for board, j in zip(boards, js):
            want = oracle.run(board, GameConfig(gen_limit=15))
            assert np.array_equal(j.result.grid, want.grid)
            assert j.result.generations == want.generations
        assert sched.metrics.counter("jobs_completed_total") == 3
        replay = JobJournal(str(tmp_path)).replay()
        assert not replay.pending
        assert set(replay.results) == {j.id for j in js}

    def test_queue_full_rejects(self):
        sched = Scheduler(max_queue_depth=2)
        for seed in (1, 2):
            sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=seed)))
        with pytest.raises(QueueFull, match="queue at max depth 2"):
            sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=3)))
        assert sched.metrics.counter("jobs_rejected_total") == 1

    def test_replay_bypasses_admission_cap(self, tmp_path):
        journal = JobJournal(str(tmp_path))
        for seed in range(3):
            journal.record_submit(new_job(8, 8, text_grid.generate(8, 8, seed=seed)))
        journal.close()
        replay = JobJournal(str(tmp_path)).replay()
        sched = Scheduler(max_queue_depth=1)
        assert sched.resubmit_replayed(replay.pending) == 3
        assert sched.stats()["queued"] == 3
        with pytest.raises(QueueFull):
            sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=9)))

    def test_draining_rejects(self):
        sched = Scheduler()
        sched.drain(timeout=0.1)
        with pytest.raises(Draining, match="server is draining"):
            sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))

    def test_cancel_queued_job(self):
        sched = Scheduler()
        job = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        assert sched.cancel(job.id) is True
        assert job.state == CANCELLED
        assert sched.cancel(job.id) is False
        assert sched.stats()["queued"] == 0

    def test_priority_and_deadline_order_dispatch(self):
        sched = Scheduler(max_batch=2, flush_age=0.0)
        low = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8), priority=0))
        high = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8), priority=5))
        mid = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8), priority=0,
                                   deadline_s=0.5))
        with sched._cv:
            _key, take = sched._claim_locked(time.perf_counter() + 1)
        assert [j.id for j in take] == [high.id, mid.id]
        assert low.state == QUEUED

    @pytest.mark.parametrize("pipeline_depth", [1, 2])
    def test_transient_dispatch_error_retries(self, pipeline_depth):
        calls = {"n": 0}

        def flaky(key, js):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("UNAVAILABLE: injected transient hiccup")
            return batcher.run_batch(key, js)

        sched = Scheduler(flush_age=0.0, pipeline_depth=pipeline_depth,
                          retry=RetryPolicy(attempts=3, base_delay=0.0),
                          run_batch=flaky)
        job = sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=4),
                                   gen_limit=5))
        sched.start()
        try:
            assert _wait(lambda: job.state == DONE), job.state
        finally:
            sched.stop()
        assert calls["n"] == 3
        assert sched.metrics.counter("batch_retries_total") == 2
        want = oracle.run(job.board, GameConfig(gen_limit=5))
        assert np.array_equal(job.result.grid, want.grid)

    def test_persistent_dispatch_error_fails_jobs(self, tmp_path):
        def broken(key, js):
            raise ValueError("bad batch")

        journal = JobJournal(str(tmp_path))
        sched = Scheduler(journal=journal, flush_age=0.0, run_batch=broken)
        job = sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=4)))
        sched.start()
        try:
            assert _wait(lambda: job.state == FAILED), job.state
        finally:
            sched.stop()
        assert job.error == "ValueError: bad batch"
        assert JobJournal(str(tmp_path)).replay().failed.keys() == {job.id}

    def test_retry_budget_caps_retries(self):
        from gol_tpu_torch.resilience.retry import RetryBudget

        def always(key, js):
            raise RuntimeError("UNAVAILABLE: down")

        budget = RetryBudget(capacity=1, refill_per_s=0.0)
        sched = Scheduler(flush_age=0.0, run_batch=always, retry_budget=budget,
                          retry=RetryPolicy(attempts=5, base_delay=0.0))
        job = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        sched.start()
        try:
            assert _wait(lambda: job.state == FAILED)
        finally:
            sched.stop()
        assert sched.metrics.counter("batch_retries_total") == 1
        assert sched.metrics.snapshot()["gauges"]["retry_budget_remaining"] == 0

    def test_expired_deadline_fails_at_dispatch(self, tmp_path):
        sched = Scheduler(journal=JobJournal(str(tmp_path)), flush_age=0.0)
        job = sched.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        job.expires_at = sched.now() - 1
        sched.start()
        try:
            assert _wait(lambda: job.state == FAILED)
        finally:
            sched.stop()
        assert job.error.startswith("DeadlineExceeded:")
        assert sched.metrics.counter("deadline_expired_total") == 1

    @pytest.mark.parametrize("value, message", [
        (-1, "resident_ring must be 0 (off) or >= 2, got -1"),
        (1, "resident_ring must be 0 (off) or >= 2, got 1"),
        (2, None),
    ])
    def test_resident_ring(self, value, message):
        """Out-of-range values raise JAX's message; R >= 2 mounts the
        resident ring lanes (tests/test_torch_ring.py runs them)."""
        if message is None:
            sched = Scheduler(resident_ring=value, pipeline_depth=2)
            assert sched.resident_ring == value
            sched.stop(drain=False)
            return
        with pytest.raises(ValueError) as err:
            Scheduler(resident_ring=value, pipeline_depth=2)
        assert str(err.value) == message
        with pytest.raises(ValueError) as want:
            jax_scheduler.Scheduler(resident_ring=value, pipeline_depth=2)
        assert str(want.value) == message

    @pytest.mark.parametrize("kwargs", [
        {"max_queue_depth": 0}, {"max_batch": 65}, {"max_inflight": 0},
        {"pipeline_depth": 0}, {"pipeline_depth": 2, "max_inflight": 2},
    ], ids=["depth", "batch", "inflight", "pipeline", "both"])
    def test_constructor_refusals_match_jax(self, kwargs):
        with pytest.raises(ValueError) as want:
            jax_scheduler.Scheduler(**kwargs)
        with pytest.raises(ValueError) as got:
            Scheduler(**kwargs)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# tests/test_serve.py's TestServer, on the port


class TestServer:
    @pytest.fixture
    def srv(self, tmp_path):
        s = GolServer(port=0, journal_dir=str(tmp_path / "journal"),
                      flush_age=0.01)
        s.start()
        yield s
        s.shutdown()

    def test_submit_poll_result_metrics_drain(self, srv):
        base = srv.url
        boards = {"a": text_grid.generate(32, 32, seed=11),
                  "b": text_grid.generate(30, 30, seed=12)}
        ids = {}
        for name, board in boards.items():
            status, payload = _json("POST", f"{base}/jobs", {
                "width": board.shape[1], "height": board.shape[0],
                "cells": _cells(board), "gen_limit": 12})
            assert status == 202, payload
            ids[name] = payload["id"]
        for name, board in boards.items():
            jid = ids[name]
            assert _wait(lambda: _json("GET", f"{base}/jobs/{jid}")[1]["state"] == DONE)
            status, payload = _json("GET", f"{base}/result/{jid}")
            assert status == 200
            want = oracle.run(board, GameConfig(gen_limit=12))
            got = text_grid.decode(payload["grid"].encode("ascii"),
                                   payload["width"], payload["height"])
            np.testing.assert_array_equal(got, want.grid)
            assert payload["generations"] == want.generations
        _, snap = _json("GET", f"{base}/metrics?format=json")
        assert snap["counters"]["jobs_completed_total"] == 2
        assert "queue_latency_seconds" in snap["histograms"]
        assert "run_latency_seconds" in snap["histograms"]
        assert "process" in snap
        text = _http("GET", f"{base}/metrics")[2].decode()
        assert "gol_serve_jobs_completed_total 2" in text
        assert 'gol_serve_run_latency_seconds{quantile="0.99"}' in text
        status, payload = _json("POST", f"{base}/drain", {})
        assert status == 200 and payload["drained"] is True
        status, _ = _json("POST", f"{base}/jobs", {
            "width": 8, "height": 8, "cells": _cells(np.zeros((8, 8), np.uint8))})
        assert status == 429

    def test_bad_requests(self, srv):
        base = srv.url
        assert _http("POST", f"{base}/jobs", {"width": 8})[0] == 400
        assert _http("GET", f"{base}/jobs/nope")[0] == 404
        assert _http("GET", f"{base}/result/nope")[0] == 404
        assert _http("POST", f"{base}/nope", {})[0] == 404

    def test_bad_field_types_rejected_not_queued(self, srv):
        base = srv.url
        cells = _cells(text_grid.generate(8, 8, seed=1))
        for bad in ({"priority": None}, {"priority": "high"}, {"gen_limit": "x"},
                    {"similarity_frequency": None}, {"deadline_s": "soon"},
                    {"check_similarity": "false"}):
            status, raw = _http("POST", f"{base}/jobs",
                                {"width": 8, "height": 8, "cells": cells, **bad})[::2]
            assert status == 400, (bad, raw)
        status, payload = _json("POST", f"{base}/jobs", {
            "width": 8, "height": 8, "cells": cells, "gen_limit": 5})
        assert status == 202
        assert _wait(lambda: _json("GET", f"{base}/jobs/{payload['id']}")[1]["state"]
                     == DONE)

    def test_cancel_endpoint(self):
        s = GolServer(port=0, flush_age=10.0)
        s.start()
        try:
            job = s.scheduler.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
            status, payload = _json("DELETE", f"{s.url}/jobs/{job.id}")
            assert status == 200 and payload["state"] == CANCELLED
            assert job.state == CANCELLED
            assert _http("DELETE", f"{s.url}/jobs/{job.id}")[0] == 409
            assert _http("DELETE", f"{s.url}/jobs/unknown")[0] == 404
        finally:
            s.shutdown()

    def test_worker_survives_journal_append_failure(self, tmp_path, monkeypatch):
        journal = JobJournal(str(tmp_path))
        real_done = JobJournal.record_done
        fail = {"armed": True}

        def flaky_done(self_j, job):
            if fail.pop("armed", False):
                raise OSError(28, "No space left on device")
            return real_done(self_j, job)

        monkeypatch.setattr(JobJournal, "record_done", flaky_done)
        sched = Scheduler(journal=journal, flush_age=0.0)
        sched.start()
        try:
            j1 = sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=1),
                                      gen_limit=3))
            assert _wait(lambda: j1.state == DONE)
            j2 = sched.submit(new_job(8, 8, text_grid.generate(8, 8, seed=2),
                                      gen_limit=3))
            assert _wait(lambda: j2.state == DONE)
        finally:
            sched.stop()
        assert sched.metrics.counter("journal_errors_total") == 1
        replay = JobJournal(str(tmp_path)).replay()
        assert j2.id in replay.results
        assert j1.id in {j.id for j in replay.pending}

    def test_result_not_ready_conflict(self):
        s = GolServer(port=0, flush_age=10.0)
        s.httpd.server_close()
        job = s.scheduler.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        code, payload = s.result_json(job.id)
        assert code == 409 and payload["state"] == QUEUED

    def test_restart_replays_journal_exactly_once(self, tmp_path):
        journal_dir = str(tmp_path / "journal")
        board = text_grid.generate(32, 32, seed=21)
        srv1 = GolServer(port=0, journal_dir=journal_dir, flush_age=0.01)
        srv1.httpd.server_close()
        job = srv1.scheduler.submit(new_job(32, 32, board, gen_limit=18))
        srv1.scheduler.journal.close()
        srv2 = GolServer(port=0, journal_dir=journal_dir, flush_age=0.01)
        assert srv2.replayed == 1
        srv2.start()
        try:
            assert _wait(lambda: (j := srv2.scheduler.job(job.id)) is not None
                         and j.state == DONE)
        finally:
            srv2.shutdown()
        want = oracle.run(board, GameConfig(gen_limit=18))
        replayed = srv2.scheduler.job(job.id)
        assert np.array_equal(replayed.result.grid, want.grid)
        assert replayed.result.generations == want.generations
        assert _ledger(journal_dir, job.id) == (1, 1)
        srv3 = GolServer(port=0, journal_dir=journal_dir, flush_age=0.01)
        assert srv3.replayed == 0
        code, payload = srv3.result_json(job.id)
        assert code == 200 and payload["generations"] == want.generations
        srv3.httpd.server_close()
        srv3.scheduler.journal.close()

    def test_cancelled_job_survives_restart_as_410(self, tmp_path):
        journal_dir = str(tmp_path / "journal")
        srv1 = GolServer(port=0, journal_dir=journal_dir)
        srv1.httpd.server_close()
        job = srv1.scheduler.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        assert srv1.scheduler.cancel(job.id) is True
        srv1.scheduler.journal.close()
        srv2 = GolServer(port=0, journal_dir=journal_dir)
        assert srv2.replayed == 0
        assert srv2.job_json(job.id)["state"] == CANCELLED
        code, payload = srv2.result_json(job.id)
        assert code == 410 and payload["state"] == CANCELLED
        srv2.httpd.server_close()
        srv2.scheduler.journal.close()

    def test_port_only_refusals(self, srv, tmp_path):
        """The port refuses nothing JAX's server takes: a sparse body and
        the sharded lane's ``POST /shard/<leg>`` RPCs answer as JAX's
        server does (here 400s with JAX's errors for an RLE without its
        header, malformed shard legs and an unknown job; 404 for an
        unknown leg)."""
        base = srv.url
        body = {"width": 64, "height": 64, "rle": "bo$2bo$3o!"}
        status, payload = _json("POST", f"{base}/jobs", body)
        jax_srv = jax_server.GolServer(port=0, sample_interval=0)
        jax_srv.httpd.server_close()
        with pytest.raises(ValueError) as want:
            jax_srv.submit_json(dict(body))
        assert (status, payload) == (400, {"error": str(want.value)})
        jax_srv = jax_server.GolServer(port=0, sample_interval=0)
        jax_srv.start()
        try:
            for leg, shard_body in (("init", {"job": "x"}),
                                    ("step", {"job": "x", "step": 0}),
                                    ("status", {"job": "x"}),
                                    ("nope", {"job": "x"}),
                                    ("halo", None)):
                got, want = (_http("POST", f"{url}/shard/{leg}", shard_body,
                                   raw=b"not a frame")
                             for url in (base, jax_srv.url))
                assert got == want and got[0] in (200, 400, 404), leg
        finally:
            jax_srv.shutdown()
        assert server._tuned_marginal_rates() == {}
        assert "weight" not in _json("GET", f"{base}/healthz")[1]

    def test_timeline_slo_debug_trace_and_healthz(self, srv):
        base = srv.url
        board = text_grid.generate(32, 32, seed=5)
        _, payload = _json("POST", f"{base}/jobs", {
            "width": 32, "height": 32, "cells": _cells(board), "gen_limit": 4})
        jid = payload["id"]
        assert _wait(lambda: _json("GET", f"{base}/jobs/{jid}")[1]["state"] == DONE)
        status, tl = _json("GET", f"{base}/jobs/{jid}/timeline")
        assert status == 200 and tl["state"] == DONE
        assert list(tl["milestones"]) == ["accepted", "claimed", "stage_start",
                                          "staged", "dispatched", "readback_start",
                                          "completed", "done", "journaled"]
        assert tl["total_seconds"] == pytest.approx(sum(
            v for k, v in tl["segments"].items() if k != "journal"))
        assert _http("GET", f"{base}/jobs/nope/timeline")[0] == 404
        status, slo = _json("GET", f"{base}/slo")
        assert status == 200 and "objectives" in slo
        status, dbg = _json("GET", f"{base}/debug/trace")
        assert status == 200 and set(dbg) == {"enabled", "meta", "spans", "registry"}
        status, health = _json("GET", f"{base}/healthz")
        assert status == 200 and health["ok"] is True and health["stats"]["jobs"] == 1

    def test_slo_shed_answers_429_with_retry_after(self, tmp_path):
        s = GolServer(port=0, slo_shed=True, sample_interval=0)
        s.start()
        try:
            s.slo.should_shed = lambda: (True, 7.0)
            status, ctype, raw = _http("POST", f"{s.url}/jobs", {"width": 8})
            assert status == 429
            assert json.loads(raw) == {"error": "shedding load: SLO burn is critical",
                                       "retry_after_s": 7.0}
            assert s.metrics.counter("jobs_shed_total") == 1
        finally:
            s.shutdown()

    def test_disk_guard_refuses_admission_with_507(self, tmp_path):
        journal_dir = str(tmp_path / "journal")
        s = GolServer(port=0, journal_dir=journal_dir, disk_reserve=1 << 20,
                      sample_interval=0)
        s.disk_guard.refuse_admission = lambda: True
        s.start()
        try:
            status, payload = _json("POST", f"{s.url}/jobs", {"width": 8})
            assert status == 507
            assert payload["partition"] == journal_dir
            assert payload["error"].startswith("insufficient storage")
        finally:
            s.shutdown()

    def test_history_ring_records_sampler_ticks(self, tmp_path):
        from gol_tpu_torch.obs import history

        s = GolServer(port=0, history_dir=str(tmp_path / "hist"),
                      journal_dir=str(tmp_path / "journal"), sample_interval=0)
        s.httpd.server_close()
        s.scheduler.submit(new_job(8, 8, np.zeros((8, 8), np.uint8)))
        s.sampler.tick()
        s.sampler.tick()
        s.history.close()
        s.scheduler.journal.close()
        records = history.read_records(str(tmp_path / "hist"))
        assert len(records) >= 2
        assert records[-1]["counters"]["jobs_accepted_total"] == 1
        assert records[-1]["gauges"]["journal_bytes"] > 0


def _ledger(journal_dir: str, job_id: str) -> tuple[int, int]:
    """(submit records, done records) of one job id in a journal."""
    events = list(compaction.iter_records(journal_dir))
    return (sum(e["event"] == "submit" and e["job"]["id"] == job_id for e in events),
            sum(e["event"] == "done" and e["id"] == job_id for e in events))


# ---------------------------------------------------------------------------
# Both packages on the same jobs


def _load():
    """Boards of the packed (32^2) and masked (30^2) buckets, with the
    mixed-fate trio's early exits, under both conventions."""
    dies = np.zeros((32, 32), np.uint8)
    dies[4, 4] = 1
    still = np.zeros((32, 32), np.uint8)
    still[3:5, 3:5] = 1
    boards = [dies, still] + [text_grid.generate(s, s, seed=40 + s + i)
                              for i, s in enumerate((32, 32, 30, 30, 30))]
    return [(b, conv, lim) for conv in (Convention.C, Convention.CUDA)
            for b, lim in zip(boards, (60, 60, 25, 9, 25, 40, 3))]


@pytest.mark.parametrize("kwargs", [{}, {"pipeline_depth": 2}, {"max_inflight": 2}],
                         ids=["depth1", "depth2", "inflight2"])
def test_schedulers_give_jax_results(tmp_path, kwargs):
    results = {}
    for tag, (_, sched_cls, mod) in PACKAGES.items():
        sched = sched_cls(journal=mod.JobJournal(str(tmp_path / tag)),
                          flush_age=0.0, **kwargs)
        js = [sched.submit(mod.new_job(b.shape[1], b.shape[0], b,
                                       convention=conv, gen_limit=lim))
              for b, conv, lim in _load()]
        sched.start()
        try:
            assert _wait(lambda: all(j.state == DONE for j in js))
        finally:
            sched.stop()
        results[tag] = [(j.result.grid.tobytes(), j.result.generations,
                         j.result.exit_reason) for j in js]
        replay = mod.JobJournal(str(tmp_path / tag)).replay()
        assert not replay.pending and len(replay.results) == len(js)
    assert results["port"] == results["jax"]


def _servers(tmp_path, **kwargs):
    out = {}
    for tag, (srv_cls, _, _) in PACKAGES.items():
        s = srv_cls(port=0, journal_dir=str(tmp_path / f"journal_{tag}"),
                    sample_interval=0, **kwargs)
        s.start()
        out[tag] = s
    return out


def _shutdown(servers):
    for s in servers.values():
        s.shutdown()


def _masked(payload, ids: dict):
    """A JSON answer with each job id replaced by its position in ``ids``
    (both packages mint random ids) and timings dropped."""
    text = json.dumps(payload, sort_keys=True)
    for i, jid in enumerate(ids):
        text = text.replace(jid, f"<job {i}>")
    out = json.loads(text)
    if isinstance(out, dict):
        for key in ("milestones", "segments", "total_seconds",
                    "queue_seconds", "run_seconds"):
            out.pop(key, None)
    return out


def _frame(board, meta=None, version=None):
    data = bytearray(wire.encode_frame(meta or {"gen_limit": 5}, grid=board))
    if version is not None:
        data[4:6] = version.to_bytes(2, "little")
    return bytes(data)


def test_servers_answer_the_same_statuses_and_error_json(tmp_path):
    board = text_grid.generate(32, 32, seed=3)
    cells = _cells(board)
    requests = [
        ("POST", "/jobs", {"width": 8}, {}),
        ("POST", "/jobs", {"width": 8, "height": 8, "cells": "0101"}, {}),
        ("POST", "/jobs", {"width": 8, "height": 8, "cells": 5}, {}),
        ("POST", "/jobs", {"width": 8, "height": 8, "cells": "é" * 72}, {}),
        ("POST", "/jobs", {"width": 0, "height": 8, "cells": ""}, {}),
        ("POST", "/jobs", {"width": 32, "height": 32, "cells": cells,
                           "priority": None}, {}),
        ("POST", "/jobs", {"width": 32, "height": 32, "cells": cells,
                           "gen_limit": "x"}, {}),
        ("POST", "/jobs", {"width": 32, "height": 32, "cells": cells,
                           "no_cache": "yes"}, {}),
        ("POST", "/jobs", {"width": 32, "height": 32, "cells": cells,
                           "shard": True}, {}),
        ("POST", "/jobs", [1, 2], {}),
        ("POST", "/jobs", b"{not json", {"raw": True}),
        ("POST", "/jobs", _frame(board, version=2),
         {"content_type": wire.CONTENT_TYPE}),
        ("POST", "/jobs", _frame(board)[:-4], {"content_type": wire.CONTENT_TYPE}),
        ("POST", "/jobs", _frame(board, {"width": 3}),
         {"content_type": wire.CONTENT_TYPE}),
        ("POST", "/jobs", b"x", {"content_type": "application/x-gol-v9"}),
        ("POST", "/jobs", {"width": 32, "height": 32, "cells": cells},
         {"headers": {"X-Gol-Deadline": "0"}}),
        ("GET", "/jobs/nope", None, {}),
        ("GET", "/jobs/nope/timeline", None, {}),
        ("GET", "/result/nope", None, {}),
        ("GET", "/nope", None, {}),
        ("POST", "/nope", {}, {}),
        ("DELETE", "/nope", None, {}),
        ("DELETE", "/jobs/unknown", None, {}),
    ]
    servers = _servers(tmp_path, flush_age=30.0)
    try:
        answers = {}
        for tag, s in servers.items():
            answers[tag] = []
            for method, path, body, opts in requests:
                kw = dict(opts)
                if kw.pop("raw", False) or isinstance(body, bytes):
                    status, _, raw = _http(method, s.url + path, raw=body, **kw)
                else:
                    status, _, raw = _http(method, s.url + path, body, **kw)
                answers[tag].append((status, json.loads(raw)))
            # A queued job: 409 on its result, cancel once, then 409.
            job_id = _json("POST", f"{s.url}/jobs", {
                "width": 32, "height": 32, "cells": cells})[1]["id"]
            ids = [job_id]
            for method, path in (("GET", f"/result/{job_id}"),
                                 ("GET", f"/jobs/{job_id}"),
                                 ("DELETE", f"/jobs/{job_id}"),
                                 ("DELETE", f"/jobs/{job_id}"),
                                 ("GET", f"/result/{job_id}"),
                                 ("POST", "/drain")):
                status, payload = _json(method, s.url + path,
                                        {} if method == "POST" else None)
                answers[tag].append((status, _masked(payload, ids)))
            answers[tag].append(_json("POST", f"{s.url}/jobs", {
                "width": 32, "height": 32, "cells": cells}))
    finally:
        _shutdown(servers)
    for i, (got, want) in enumerate(zip(answers["port"], answers["jax"])):
        assert got == want, (i, requests[i] if i < len(requests) else None)
    assert len(answers["port"]) == len(answers["jax"])


_NUMBER = re.compile(r" -?[0-9.e+-]+$|(?<=\{quantile=\")[0-9.]+(?=\"\})")


def test_metrics_text_matches_jax_with_values_masked(tmp_path):
    boards = [text_grid.generate(32, 32, seed=1), text_grid.generate(30, 30, seed=2)]
    servers = _servers(tmp_path, flush_age=0.0, result_cache=True)
    texts, names = {}, {}
    try:
        for tag, s in servers.items():
            ids = []
            for board in boards + boards[:1]:
                ids.append(_json("POST", f"{s.url}/jobs", {
                    "width": board.shape[1], "height": board.shape[0],
                    "cells": _cells(board), "gen_limit": 7})[1]["id"])
                assert _wait(lambda: _json("GET", f"{s.url}/jobs/{ids[-1]}")[1]
                             ["state"] == DONE)
            s.sampler.tick()
            raw = _http("GET", f"{s.url}/metrics")[2].decode()
            texts[tag] = [_NUMBER.sub(" X", line) for line in raw.splitlines()]
            snap = _json("GET", f"{s.url}/metrics?format=json")[1]
            names[tag] = {k: sorted(snap[k]) for k in ("counters", "gauges",
                                                       "histograms")}
    finally:
        _shutdown(servers)
    assert texts["port"] == texts["jax"]
    assert names["port"] == names["jax"]
    assert "# TYPE gol_serve_cache_hits_total_memory counter" in texts["port"]


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_in_the_other_package_exactly_once(tmp_path, writer,
                                                           reader):
    journal_dir = str(tmp_path / "journal")
    w_srv, _, w_mod = PACKAGES[writer]
    r_srv, _, _ = PACKAGES[reader]
    boards = [text_grid.generate(32, 32, seed=61), text_grid.generate(30, 30, seed=62)]
    first = w_srv(port=0, journal_dir=journal_dir, flush_age=0.0, sample_interval=0)
    first.httpd.server_close()  # the crash: accepted, never run
    accepted = [first.scheduler.submit(w_mod.new_job(30, 30, boards[1], gen_limit=11))]
    first.scheduler.start()
    done = first.scheduler.submit(w_mod.new_job(32, 32, boards[0], gen_limit=11))
    assert _wait(lambda: done.state == DONE and accepted[0].state == DONE)
    first.scheduler.stop()
    queued = w_srv(port=0, journal_dir=journal_dir, flush_age=0.0, sample_interval=0)
    queued.httpd.server_close()
    queued.scheduler.journal.close()
    # One more accepted-never-run job, from a server whose worker never starts.
    ghost = w_srv(port=0, journal_dir=str(tmp_path / "other"), sample_interval=0)
    ghost.httpd.server_close()
    ghost.scheduler.journal.close()
    journal = w_mod.JobJournal(journal_dir)
    pending = w_mod.new_job(32, 32, boards[0], gen_limit=13)
    journal.record_submit(pending)
    journal.close()

    second = r_srv(port=0, journal_dir=journal_dir, flush_age=0.0, sample_interval=0)
    assert second.replayed == 1
    second.start()
    try:
        assert _wait(lambda: (j := second.scheduler.job(pending.id)) is not None
                     and j.state == DONE)
        for job in (accepted[0], done):
            status, payload = _json("GET", f"{second.url}/result/{job.id}")
            assert status == 200
            assert payload["generations"] == job.result.generations
            assert payload["grid"] == _cells(job.result.grid)
        status, payload = _json("GET", f"{second.url}/jobs/{done.id}")
        assert payload == {"id": done.id, "state": DONE, "restored": True}
    finally:
        second.shutdown()
    want = oracle.run(boards[0], GameConfig(gen_limit=13))
    assert np.array_equal(second.scheduler.job(pending.id).result.grid, want.grid)
    for job in (accepted[0], done, pending):
        assert _ledger(journal_dir, job.id) == (1, 1)


def test_packed_posts_and_results_are_byte_identical_across_servers(tmp_path):
    boards = [text_grid.generate(32, 32, seed=71), text_grid.generate(30, 30, seed=72),
              text_grid.generate(32, 64, seed=73)[:, :32]]
    servers = _servers(tmp_path, flush_age=0.0)
    frames = {}
    try:
        for tag, s in servers.items():
            frames[tag] = []
            for board in boards:
                meta = {"gen_limit": 21, "convention": "cuda"}
                status, _, raw = _http("POST", f"{s.url}/jobs",
                                       raw=jax_wire.encode_frame(meta, grid=board),
                                       content_type=wire.CONTENT_TYPE)
                assert status == 202
                jid = json.loads(raw)["id"]
                assert _wait(lambda: _json("GET", f"{s.url}/jobs/{jid}")[1]["state"]
                             == DONE)
                status, ctype, raw = _http("GET", f"{s.url}/result/{jid}",
                                           headers={"Accept": wire.CONTENT_TYPE})
                assert status == 200 and ctype == wire.CONTENT_TYPE
                frame = wire.decode_frame(raw)
                assert frame.meta.pop("id") == jid
                # Re-encoded with the id out of the meta: the whole frame.
                frames[tag].append(wire.encode_frame(frame.meta, words=frame.words,
                                                     width=frame.width,
                                                     height=frame.height))
                assert raw[-frame.words.nbytes:] == frame.words.tobytes()
            assert s.metrics.counter("wire_packed_submits_total") == len(boards)
            assert s.metrics.counter("wire_packed_results_total") == len(boards)
    finally:
        _shutdown(servers)
    assert frames["port"] == frames["jax"]
    for board, frame in zip(boards, frames["port"]):
        want = oracle.run(board, GameConfig(gen_limit=21, convention="cuda"))
        np.testing.assert_array_equal(wire.decode_frame(frame).grid(), want.grid)


def test_a_repeat_submit_with_the_cache_comes_back_cached(tmp_path):
    board = text_grid.generate(30, 30, seed=81)
    body = {"width": 30, "height": 30, "cells": _cells(board), "gen_limit": 9}
    servers = _servers(tmp_path, flush_age=0.0, result_cache=True)
    answers = {}
    try:
        for tag, s in servers.items():
            answers[tag] = []
            for _ in range(2):
                jid = _json("POST", f"{s.url}/jobs", body)[1]["id"]
                assert _wait(lambda: _json("GET", f"{s.url}/jobs/{jid}")[1]["state"]
                             == DONE)
                answers[tag].append(_masked(_json("GET", f"{s.url}/result/{jid}")[1],
                                            [jid]))
    finally:
        _shutdown(servers)
    assert answers["port"] == answers["jax"]
    assert "cached" not in answers["port"][0]
    assert answers["port"][1]["cached"] == "memory"


# ---------------------------------------------------------------------------
# Sparse and macro jobs (the body's ``rle`` form) through both servers


PATTERNS_DIR = Path(__file__).resolve().parent.parent / "patterns"
GUN_RLE = (PATTERNS_DIR / "gosper_gun.rle").read_text()
SPARSE_BODIES = [
    {"width": 256, "height": 256, "rle": GUN_RLE, "x": 100, "y": 100,
     "tile": 16, "gen_limit": 90},
    {"width": 256, "height": 256, "rle": GUN_RLE, "x": 100, "y": 100,
     "tile": 16, "gen_limit": 90, "macro": True},
    {"width": 64, "height": 64, "rle": "x = 2, y = 2\n2o$ob!", "x": 20,
     "y": 20, "tile": 8, "gen_limit": 40, "convention": "cuda"},
    {"width": 64, "height": 64, "rle": "x = 3, y = 1\n3o!", "x": 60,
     "y": 10, "tile": 8, "macro": True},
    {"width": 64, "height": 64, "rle": "x = 3, y = 1\n3o!", "tile": 9},
    {"width": 64, "height": 64, "rle": "x = 3, y = 1\n3o!", "tile": 8,
     "cells": "0"},
    {"width": 64, "height": 64, "tile": 8, "rle": "x = 3, y = 1\n3o!",
     "macro": 1},
]


def _result_fields(payload):
    return {k: payload.get(k) for k in ("generations", "exit_reason", "rle",
                                        "population", "universe", "grid")}


def test_sparse_and_macro_jobs_answer_as_jax_across_servers(tmp_path):
    """The same sparse and macro bodies to both servers: the same statuses
    and errors, the same results (RLE, generations, exit reason,
    population), and the serving registry's sparse series by JAX's names."""
    servers = _servers(tmp_path, flush_age=0.0)
    answers, names = {}, {}
    try:
        for tag, s in servers.items():
            answers[tag] = []
            ids = []
            for body in SPARSE_BODIES:
                status, payload = _json("POST", f"{s.url}/jobs", body)
                answers[tag].append((status, payload.get("error")))
                if status == 202:
                    ids.append(payload["id"])
            for jid in ids:
                assert _wait(lambda: _json("GET", f"{s.url}/jobs/{jid}")[1]
                             ["state"] in (DONE, FAILED))
                status, payload = _json("GET", f"{s.url}/result/{jid}")
                answers[tag].append((status, _result_fields(payload)))
            snap = _json("GET", f"{s.url}/metrics?format=json")[1]
            names[tag] = {k: sorted(snap[k]) for k in ("counters", "gauges")}
            counters = snap["counters"]
            assert counters["sparse_submits_total"] == 4
            assert counters["macro_submits_total"] == 2
            assert counters["sparse_tiles_simulated_total"] > 0
    finally:
        _shutdown(servers)
    assert answers["port"] == answers["jax"]
    assert [a[0] for a in answers["port"][:len(SPARSE_BODIES)]] == \
        [202, 202, 202, 202, 400, 400, 400]
    assert names["port"] == names["jax"]
    assert "sparse_occupancy" in names["port"]["gauges"]


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_sparse_and_macro_journal_records_replay_in_the_other_package(
        tmp_path, writer, reader):
    """Accepted-never-run sparse and macro jobs journaled by one package
    replay as jobs in the other, and run to the writer's answer."""
    journal_dir = str(tmp_path / "journal")
    w_mod = PACKAGES[writer][2]
    r_srv = PACKAGES[reader][0]
    journal = w_mod.JobJournal(journal_dir)
    specs = [dict(rle=GUN_RLE, place_x=100, place_y=100, tile=16, gen_limit=70),
             dict(rle=GUN_RLE, place_x=100, place_y=100, tile=16, gen_limit=70,
                  macro=True)]
    pending = [w_mod.new_job(256, 256, None, **kw) for kw in specs]
    for job in pending:
        journal.record_submit(job)
    journal.close()
    second = r_srv(port=0, journal_dir=journal_dir, flush_age=0.0,
                   sample_interval=0)
    assert second.replayed == 2
    second.start()
    try:
        got = []
        for job in pending:
            assert _wait(lambda: (j := second.scheduler.job(job.id)) is not None
                         and j.state == DONE)
            replayed = second.scheduler.job(job.id)
            assert replayed.macro == job.macro and replayed.tile == 16
            got.append(replayed.result.rle)
    finally:
        second.shutdown()
    assert got[0] == got[1]
    from gol_tpu.sparse import SparseBoard as JaxBoard
    from gol_tpu.sparse import simulate_sparse as jax_simulate_sparse
    from gol_tpu.config import GameConfig as JaxGameConfig

    want = jax_simulate_sparse(JaxBoard.from_rle(GUN_RLE, 256, 256, 16, x=100,
                                                 y=100), JaxGameConfig(gen_limit=70))
    assert got[0] == want.board.to_rle()
    for job in pending:
        assert _ledger(journal_dir, job.id) == (1, 1)


@pytest.mark.parametrize("kwargs", [{}, {"pipeline_depth": 2},
                                    {"pipeline_depth": 8, "resident_ring": 4}],
                         ids=["depth1", "depth2", "resident"])
def test_sparse_and_macro_jobs_ride_every_scheduler_lane_as_jax(tmp_path, kwargs):
    """A sparse job, a macro job and a dense job through each scheduler
    lane, the resident ring's included (sparse buckets take the plain
    batcher split there): the same results in both packages, and the
    sparse series by JAX's names on the serving registry."""
    results = {}
    for tag, (_, sched_cls, mod) in PACKAGES.items():
        sched = sched_cls(journal=mod.JobJournal(str(tmp_path / tag)),
                          flush_age=0.0, **kwargs)
        js = [sched.submit(mod.new_job(256, 256, None, rle=GUN_RLE, place_x=100,
                                       place_y=100, tile=16, gen_limit=60,
                                       **extra))
              for extra in ({}, {"macro": True})]
        js.append(sched.submit(mod.new_job(32, 32, text_grid.generate(32, 32, seed=7),
                                           gen_limit=20)))
        sched.start()
        try:
            assert _wait(lambda: all(j.state == DONE for j in js))
        finally:
            sched.stop()
        counters = sched.metrics.snapshot()["counters"]
        assert counters["sparse_tiles_simulated_total"] > 0
        results[tag] = [(j.result.rle, None if j.result.grid is None
                         else j.result.grid.tobytes(), j.result.generations,
                         j.result.exit_reason, j.result.population)
                        for j in js]
    assert results["port"] == results["jax"]
    assert results["port"][0][0] == results["port"][1][0]
