"""The port's router (gol_tpu_torch/fleet/router.py) against the JAX
package's, on the CPU, over real in-process workers.

- Rigs of two in-process ``GolServer`` workers attached by URL behind a
  ``RouterServer`` (tests/test_fleet.py's ``_Rig``), in all four
  combinations of router and worker package: the port over the port, the
  JAX package over the JAX package, and the two mixed rigs (a JAX router
  over port workers, a port router over JAX workers). The same requests
  answer the same status codes and JSON bodies in every rig (job ids and
  times masked), each job lands on the same worker, and results equal the
  oracle byte for byte.
- The router's own paths: merged ``/metrics``, ``/slo``, ``/fleet``,
  ``/healthz``, 404s and 400s, the cascaded drain.
- A sharded job through each rig (``"shard": true``): the halo frames
  cross between the worker processes of either package, and the result
  equals the port's ``LocalCluster`` run.
- Spillover, the big lane and the retry walk over stub workers: for the
  same worker answers both routers give the same answer, visit the same
  workers in the same order and count the same.
"""

import json
import re
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gol_tpu.fleet import router as jax_router
from gol_tpu.fleet import workers as jax_workers
from gol_tpu.serve import server as jax_server
from gol_tpu_torch import oracle
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.fleet import placement, router, workers
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.serve import server
from gol_tpu_torch.shard.coordinator import LocalCluster, ShardCoordinator

ROUTERS = {"port": (router.RouterServer, workers.Fleet),
           "jax": (jax_router.RouterServer, jax_workers.Fleet)}
SERVERS = {"port": server.GolServer, "jax": jax_server.GolServer}
RIGS = [("port", "port"), ("jax", "port"), ("port", "jax"), ("jax", "jax")]
RIG_IDS = [f"{r}_router_{w}_workers" for r, w in RIGS]

_HEX = re.compile(r"\b[0-9a-f]{32}\b")
_TIME_KEY = re.compile(r"(seconds|_s|_at|_ms|_unix)$")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _http(method, url, body=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(predicate, timeout=120.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _mask(obj):
    """Job ids, URLs and times out of a JSON body; everything else kept."""
    if isinstance(obj, dict):
        return {k: ("T" if _TIME_KEY.search(k) else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"http://127\.0\.0\.1:\d+", "URL", _HEX.sub("ID", obj))
    return obj


class Rig:
    """Two workers of one package attached by URL behind a router of one
    package."""

    def __init__(self, tmp_path, router_pkg, worker_pkg, **router_kwargs):
        self.workers = {}
        for wid in ("w0", "w1"):
            srv = SERVERS[worker_pkg](port=0, journal_dir=str(tmp_path / wid),
                                      flush_age=0.01, sample_interval=0)
            srv.start()
            self.workers[wid] = srv
        router_cls, fleet_cls = ROUTERS[router_pkg]
        self.fleet = fleet_cls(str(tmp_path / "fleet"))
        for wid, srv in self.workers.items():
            self.fleet.attach(srv.url, wid)
        self.router = router_cls(self.fleet, port=0, **router_kwargs)
        self.router.start()
        self.base = self.router.url

    def close(self):
        self.router.shutdown(cascade=False)
        for srv in self.workers.values():
            srv.shutdown()


@pytest.fixture(params=RIGS, ids=RIG_IDS)
def rig(request, tmp_path):
    r = Rig(tmp_path, *request.param)
    yield r
    r.close()


BOARDS = [(32 if i % 2 == 0 else 30, 500 + i) for i in range(6)]


def _submit(base, side, seed, gen_limit=12):
    board = text_grid.generate(side, side, seed=seed)
    return board, _http("POST", f"{base}/jobs", {
        "width": side, "height": side, "gen_limit": gen_limit,
        "cells": text_grid.encode(board).decode("ascii")})


def _routed(rig):
    """Submit BOARDS through the rig's router; wait until done. Returns
    every answer masked, for comparison across rigs, after checking the
    results against the oracle."""
    base, answers, jobs = rig.base, [], []
    for side, seed in BOARDS:
        board, (status, payload) = _submit(base, side, seed)
        answers.append((status, _mask(payload)))
        jobs.append((payload["id"], board))
    assert _wait(lambda: all(
        _http("GET", f"{base}/jobs/{j}")[1].get("state") == "done"
        for j, _ in jobs))
    for job_id, board in jobs:
        status, result = _http("GET", f"{base}/result/{job_id}")
        want = oracle.run(board, GameConfig(gen_limit=12))
        got = text_grid.decode(result["grid"].encode("ascii"),
                               result["width"], result["height"])
        assert status == 200 and np.array_equal(got, want.grid)
        assert result["generations"] == want.generations
        job = _http("GET", f"{base}/jobs/{job_id}")
        timeline = _http("GET", f"{base}/jobs/{job_id}/timeline")
        assert timeline[0] == 200 and timeline[1]["segments"]
        answers.append((status, _mask({k: v for k, v in result.items()
                                       if k != "timeline"})))
        answers.append((job[0], _mask({k: v for k, v in job[1].items()
                                       if k not in ("timeline", "events")})))
    return answers


_EXPECTED: dict = {}


def _same_as_jax_rig(name, got, tmp_path):
    """``got`` equals what the JAX router over JAX workers answers for the
    same calls (computed once per test)."""
    if name not in _EXPECTED:
        jax_rig = Rig(tmp_path / "jax_rig", "jax", "jax")
        try:
            _EXPECTED[name] = CALLS[name](jax_rig)
        finally:
            jax_rig.close()
    assert got == _EXPECTED[name]


def _errors(rig):
    base = rig.base
    calls = [("GET", "/jobs/nope", None), ("GET", "/result/nope", None),
             ("DELETE", "/jobs/nope", None), ("POST", "/jobs", {"width": 8}),
             ("POST", "/jobs", {"width": 0, "height": 8, "cells": ""}),
             ("GET", "/nope", None),
             ("POST", "/jobs", {"width": 8, "height": 8, "cells": "01" * 32,
                                "convention": "nope"})]
    return [(m, p, *_http(m, f"{base}{p}", b)) for m, p, b in calls]


def _observability(rig):
    base = rig.base
    _, (status, payload) = _submit(base, 32, 1)
    job_id = payload["id"]
    assert _wait(lambda: _http("GET", f"{base}/jobs/{job_id}")[1]
                 .get("state") == "done")
    _, snap = _http("GET", f"{base}/metrics?format=json")
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    names = sorted({line.split()[2] for line in text.splitlines()
                    if line.startswith("# TYPE gol_fleet")})
    _, slo = _http("GET", f"{base}/slo")
    _, fleet = _http("GET", f"{base}/fleet")
    _, hz = _http("GET", f"{base}/healthz")
    return {
        "completed": snap["counters"]["jobs_completed_total"],
        "workers": sorted(snap["workers"]),
        "fleet": _mask(snap["fleet"]),
        "fleet_series": names,
        "slo": (slo["status"] in ("ok", "warning", "critical"),
                sorted({o["name"].split(":")[0] for o in slo["objectives"]})),
        "membership": sorted((w["id"], w["attached"], w["big"])
                             for w in fleet["workers"]),
        "healthz": (hz["router"], hz["fleet"]["workers"]),
    }


def _drain(rig):
    status, payload = _http("POST", f"{rig.base}/drain", {})
    drained = {w: bool(r.get("drained")) for w, r in payload["workers"].items()}
    _, (status2, refused) = _submit(rig.base, 32, 2)
    assert all(srv.scheduler.draining for srv in rig.workers.values())
    return status, payload["drained"], drained, status2, refused


GLIDER = "x = 3, y = 3, rule = B3/S23\nbob$2bo$3o!"


def _shard(rig):
    body = {"shard": True, "rle": GLIDER, "x": 250, "y": 250, "width": 768,
            "height": 768, "tile": 256, "convention": "c", "gen_limit": 24,
            "check_similarity": True, "similarity_frequency": 1,
            "checkpoint_every": 8}
    status, payload = _http("POST", f"{rig.base}/jobs", body)
    assert status == 202, payload
    job_id = payload["id"]
    assert _wait(lambda: _http("GET", f"{rig.base}/jobs/{job_id}")[1]
                 .get("state") == "done")
    _, job = _http("GET", f"{rig.base}/jobs/{job_id}")
    status, result = _http("GET", f"{rig.base}/result/{job_id}")
    return _mask(payload), _mask(job), status, _mask(result)


CALLS = {"routed": _routed, "errors": _errors, "observability": _observability,
         "drain": _drain, "shard": _shard}


@pytest.mark.parametrize("name", list(CALLS))
def test_rigs_answer_as_the_jax_rig(name, rig, tmp_path):
    _same_as_jax_rig(name, CALLS[name](rig), tmp_path)


def test_routed_jobs_keep_their_bucket(tmp_path):
    rig = Rig(tmp_path, "port", "port")
    try:
        owners = {}
        for side, seed in BOARDS:
            _, (status, payload) = _submit(rig.base, side, seed)
            owners.setdefault(side, set()).add(payload["worker"])
        assert all(len(who) == 1 for who in owners.values()), owners
        for side, who in owners.items():
            key = placement.key_for({"width": side, "height": side})
            assert who == {placement.rank(key.label(), ["w0", "w1"])[0]}
    finally:
        rig.close()


def test_shard_job_equals_the_local_cluster(tmp_path):
    spec = {"rle": GLIDER, "x": 250, "y": 250, "width": 768, "height": 768,
            "tile": 256, "convention": "c", "gen_limit": 24,
            "check_similarity": True, "similarity_frequency": 1}
    want = ShardCoordinator("job", spec, LocalCluster(
        ["w0", "w1"], journal_root=str(tmp_path / "local")).participants(),
        checkpoint_every=8).run()
    for pkgs in (("port", "port"), ("port", "jax")):
        rig = Rig(tmp_path / "_".join(pkgs), *pkgs)
        try:
            _, _, status, result = _shard(rig)
        finally:
            rig.close()
        assert status == 200
        assert (result["rle"], result["generations"], result["exit_reason"],
                result["ownership"]) == (want["rle"], want["generations"],
                                         want["exit_reason"], want["ownership"])


# ---------------------------------------------------------------------------
# Spillover, the big lane and the retry walk over stub workers


def _refused(*_):
    raise ConnectionRefusedError("down")


def _timeout(*_):
    raise TimeoutError("timed out mid-exchange")


def _dns(*_):
    raise urllib.error.URLError(socket.gaierror(-2, "Name or service not known"))


SHED = (429, {"error": "shedding load", "retry_after_s": 5})
ACCEPT = (202, {"id": "j1", "state": "queued"})
# (ids, big ids, body, {worker: answer}, default answer)
SPILLS = {
    "first_sheds": (("wa", "wb"), (), {"width": 32, "height": 32},
                    {0: SHED}, ACCEPT),
    "first_refuses": (("wa", "wb"), (), {"width": 32, "height": 32},
                      {0: _refused}, ACCEPT),
    "ambiguous_timeout": (("wa", "wb"), (), {"width": 32, "height": 32},
                          {}, _timeout),
    "dns_failure_spills": (("wa", "wb"), (), {"width": 32, "height": 32},
                           {0: _dns}, ACCEPT),
    "all_shed": (("wa", "wb"), (), {"width": 32, "height": 32}, {}, SHED),
    "shedding_normals_with_big_lane": (("wa", "wb", "big0"), ("big0",),
                                       {"width": 32, "height": 32}, {0: SHED,
                                       1: SHED}, ACCEPT),
    "unreachable_normals_reach_big_lane": (("wa", "wb", "big0"), ("big0",),
                                           {"width": 32, "height": 32},
                                           {0: _refused, 1: _refused}, ACCEPT),
    "oversized_to_big_lane": (("wa", "wb", "big0", "big1"), ("big0", "big1"),
                              {"width": 2048, "height": 2048}, {}, ACCEPT),
    "big_lane_sheds": (("wa", "big0", "big1"), ("big0", "big1"),
                       {"width": 2048, "height": 2048}, {0: SHED}, ACCEPT),
    "everything_down": (("wa", "wb"), (), {"width": 32, "height": 32}, {},
                        _refused),
}


def _spill(pkg, tmp_path, case):
    ids, big, body, answers, default = SPILLS[case]
    router_cls, fleet_cls = ROUTERS[pkg]
    fleet = fleet_cls(str(tmp_path / pkg), probe=lambda *a, **k: None)
    for wid in ids:
        fleet.attach(f"http://{wid}.invalid", wid, big=wid in big)
    normals = [w for w in ids if w not in big]
    key = placement.key_for(body)
    order = placement.rank(key.label(), normals)
    by_worker = {order[i]: a for i, a in answers.items()}
    calls = []

    def stub_http(method, url, body=None, raw=None, timeout=0, **_):
        wid = url.split("//")[1].split(".")[0]
        calls.append(wid)
        answer = by_worker.get(wid, default)
        return answer() if callable(answer) else json.loads(json.dumps(answer))

    r = router_cls(fleet, port=0, http=stub_http, big_edge=1024)
    try:
        status, payload = r.route_submit(json.dumps(body).encode())
        counters = {k: v for k, v in r.registry.snapshot()["counters"].items()
                    if k.startswith("route")}
        backpressure = sorted(w.id for w in fleet.workers() if w.backpressure)
    finally:
        r.httpd.server_close()
    return status, payload, calls, counters, backpressure


@pytest.mark.parametrize("case", list(SPILLS))
def test_spillover_matches_jax(case, tmp_path):
    assert _spill("port", tmp_path, case) == _spill("jax", tmp_path, case)
