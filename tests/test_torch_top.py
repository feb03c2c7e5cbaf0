"""The port's live readers (gol_tpu_torch/obs/top.py with ``top``,
gol_tpu_torch/obs/fleettrace.py with ``fleet-trace``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_fleettrace.py``'s ``TestStitch`` and
``tests/test_slo.py``'s ``TestTop``:

- ``render_frame`` is byte-identical to JAX's for the same payloads,
  a ring section included, in plain and ANSI modes;
- ``stitch`` equals JAX's for the same payloads (clock skew, pid
  collisions, unreachable and disabled processes);
- ``fleet-trace`` and ``top --iterations 1 --no-ansi`` of either package
  against a port server and against a JAX server, both running the resident
  ring: the same stitched trace (the server's lane, ``serve.resident_loop``
  spans) and the same frame (the ring row present).
"""

import json

import pytest

from gol_tpu import cli as jax_cli
from gol_tpu.obs import fleettrace as jax_fleettrace
from gol_tpu.obs import top as jax_top
from gol_tpu.obs import trace as jax_trace
from gol_tpu.serve.jobs import new_job as jax_new_job
from gol_tpu_torch import cli
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.obs import fleettrace, top
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.serve.jobs import new_job

METRICS = {
    "counters": {"jobs_accepted_total": 10, "jobs_completed_total": 9,
                 "jobs_failed_total": 1, "batches_total": 3},
    "gauges": {"queue_depth": 2, "inflight_batches": 1,
               "dispatch_gap_ratio": 0.62,
               "serve_cell_updates_per_sec": 1.5e9,
               "bucket_cell_updates_per_sec_256x256_c_packed": 1.5e9,
               "dispatch_gap_ratio_256x256_c_packed": 0.62,
               "journal_queue_depth": 3},
    "histograms": {"job_latency_seconds": {
        "count": 9, "sum": 1.0, "p50": 0.1, "p95": 0.2, "p99": 0.3}},
    "process": {"gauges": {"ring_slot_occupancy": 0.75},
                "histograms": {"dispatch_gap_seconds": {
                    "count": 4, "sum": 0.1, "p50": 0.01,
                    "p95": 0.02, "p99": 0.03}}},
}
SLO = {"status": "warning", "windows_s": [60, 300],
       "objectives": [{"name": "error_rate", "status": "warning",
                       "windows": {"60s": {"burn": 1.2},
                                   "300s": {"burn": 1.1}}}]}


@pytest.mark.parametrize("metrics, slo", [
    (METRICS, SLO), ({}, None), (METRICS, None), ({}, SLO),
    ({**METRICS, "process": {}}, SLO),
], ids=["ring", "unreachable", "no_slo", "no_metrics", "no_ring"])
@pytest.mark.parametrize("ansi", [False, True], ids=["plain", "ansi"])
def test_render_frame_is_jaxs(metrics, slo, ansi):
    kwargs = {"ansi": ansi, "title": "gol top — http://x"}
    assert top.render_frame(metrics, slo, **kwargs) == \
        jax_top.render_frame(metrics, slo, **kwargs)
    if metrics is METRICS:
        assert "ring occupancy" in top.render_frame(metrics, slo, ansi=False)


def _payload(pid, anchor_ns, spans, anchor_perf=100.0, enabled=True):
    return {"enabled": enabled,
            "meta": {"pid": pid, "anchor_perf_s": anchor_perf,
                     "anchor_unix_ns": anchor_ns, "dropped_spans": 0},
            "spans": spans}


def _span(name, start, **attrs):
    return {"name": name, "start_s": start, "duration_s": 0.01, "tid": 7,
            "thread_name": "t", "depth": 0, "attrs": attrs or None}


@pytest.mark.parametrize("processes", [
    [{"name": "router", "payload": _payload(10, 1_000_000_000, [
        _span("fleet.submit", 100.5),
        _span("job", 100.5, flow_phase="s", flow_id="abc")])},
     {"name": "w0", "payload": _payload(20, 1_000_500_000, [
         _span("serve.resident_loop", 100.2, bucket="32x32/c/packed"),
         _span("job", 100.2, flow_phase="t", flow_id="abc", state="claimed")])}],
    [{"name": "router", "payload": _payload(42, 1_000_000_000, [_span("x", 100.1)])},
     {"name": "w0", "payload": _payload(42, 1_000_000_000, [_span("y", 100.1)])}],
    [{"name": "router", "payload": _payload(1_001_234, 1_000_000_000,
                                            [_span("x", 100.1)])},
     {"name": "w0", "payload": _payload(1_001_234, 1_000_000_000,
                                        [_span("y", 100.1)])}],
    [{"name": "router", "payload": _payload(10, 1_000_000_000, [_span("x", 100.1)])},
     {"name": "w0", "payload": None, "error": "unreachable"},
     {"name": "w1", "payload": _payload(11, 0, [], anchor_perf=0.0, enabled=False)}],
], ids=["skew", "pid_collision", "pid_in_synthetic_block", "skipped"])
def test_stitch_is_jaxs(processes):
    assert fleettrace.stitch(processes) == jax_fleettrace.stitch(processes)


@pytest.fixture
def ring_servers(tmp_path, monkeypatch):
    """A JAX and a port server, each with the resident ring and tracing on,
    each having answered jobs of both buckets."""
    from gol_tpu.serve.server import GolServer as JaxServer
    from gol_tpu_torch.serve.server import GolServer

    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    obs_trace.enable()
    jax_trace.enable()
    servers = {}
    try:
        for name, cls in (("jax", JaxServer), ("port", GolServer)):
            srv = servers[name] = cls(
                port=0, journal_dir=str(tmp_path / f"j_{name}"),
                flush_age=0.01, sample_interval=0, pipeline_depth=4,
                resident_ring=2)
            srv.start()
            make_job = jax_new_job if name == "jax" else new_job
            for i, side in enumerate((32, 32, 30)):
                board = text_grid.generate(side, side, seed=300 + i)
                srv.scheduler.submit(make_job(side, side, board, gen_limit=12))
            assert srv.scheduler.drain(timeout=60)
        yield servers
    finally:
        for srv in servers.values():
            srv.shutdown()
        obs_trace.disable()
        obs_trace.clear()
        jax_trace.disable()
        jax_trace.clear()


def test_fleet_trace_against_port_and_jax_servers(ring_servers, tmp_path, capsys):
    docs = {}
    for target, srv in ring_servers.items():
        for client, main in (("jax", jax_cli.main), ("port", cli.main)):
            out = tmp_path / f"{client}_{target}.json"
            assert main(["fleet-trace", "--server", srv.url, "-o", str(out)]) == 0
            err = capsys.readouterr().err
            assert err.startswith(f"fleet-trace -> {out}: 1 process(es) [router]")
            docs[(client, target)] = json.loads(out.read_text())
    for target in ring_servers:
        port_doc, jax_doc = docs[("port", target)], docs[("jax", target)]
        assert port_doc["otherData"]["processes"].keys() == {"router"}
        names = {e["name"] for e in port_doc["traceEvents"]}
        assert {"serve.resident_loop", "process_name"} <= names
        assert names == {e["name"] for e in jax_doc["traceEvents"]}
        loops = [e for e in port_doc["traceEvents"]
                 if e["name"] == "serve.resident_loop"]
        assert {e["args"]["ring"] for e in loops} == {2}


def test_top_frames_against_port_and_jax_servers(ring_servers, capsys):
    frames = {}
    for target, srv in ring_servers.items():
        for client, main in (("jax", jax_cli.main), ("port", cli.main)):
            assert main(["top", "--server", srv.url, "--iterations", "1",
                         "--no-ansi"]) == 0
            frames[(client, target)] = capsys.readouterr().out
    for target in ring_servers:
        frame = frames[("port", target)]
        assert frame.startswith(f"gol top — {ring_servers[target].url}")
        assert "ring occupancy" in frame
        assert "jobs: accepted 3  done 3" in frame
        assert frame == frames[("jax", target)]


def test_top_refuses_a_bad_interval(capsys):
    assert cli.main(["top", "--interval", "0"]) == 1
    assert capsys.readouterr().err == "gol: --interval must be > 0, got 0.0\n"
    assert jax_cli.main(["top", "--interval", "0"]) == 1
    assert capsys.readouterr().err == "gol: --interval must be > 0, got 0.0\n"


def test_fleet_trace_of_an_unreachable_server_matches_jax(capsys, tmp_path):
    """Nothing answers: both CLIs write the same empty stitched trace and
    exit 1 with the same lines."""
    runs = []
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = tmp_path / f"{name}.json"
        rc = main(["fleet-trace", "--server", "http://127.0.0.1:9", "-o", str(out)])
        err = capsys.readouterr().err.replace(str(out), "OUT")
        runs.append((rc, err, json.loads(out.read_text())))
    assert runs[0] == runs[1]
    assert runs[0][0] == 1 and "no process had tracing enabled" in runs[0][1]
