"""The port's observability (gol_tpu_torch/obs, the CLI's --trace, --profile
and --compile-cache, and the trace-report, history-report and slo-report
subcommands) against the JAX package's, on the CPU lane.

Both CLIs run in this process on the same seeded inputs; the comparison is
exact on exit codes, output bytes and text, with milliseconds and the pid
masked. The span ring of each package's ``obs/trace`` outlives a run, so
every traced argv starts from a cleared ring and the spans it added are
compared as a multiset of names.
"""

import collections
import contextlib
import http.server
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from gol_tpu import cli as jax_cli
from gol_tpu import engine as jax_engine
from gol_tpu.config import GameConfig as JaxGameConfig
from gol_tpu.obs import history as jax_history
from gol_tpu.obs import recorder as jax_recorder
from gol_tpu.obs import registry as jax_registry
from gol_tpu.obs import slo as jax_slo
from gol_tpu.obs import trace as jax_trace
from gol_tpu_torch import cli, engine
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.obs import profiler, recorder, registry, trace
from gol_tpu_torch.ops import _build
from gol_tpu_torch.resilience import faults
from gol_tpu_torch.resilience.faults import InjectedCrash

REPO = Path(__file__).resolve().parent.parent
_MS = re.compile(r"\d+\.\d+ msecs")
_PACKAGES = {"jax": (jax_cli.main, jax_trace, jax_recorder),
             "port": (cli.main, trace, recorder)}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("GOL_FAULTS", raising=False)
    # --compile-cache changes the build directory of the process: restore it.
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    yield
    for _, tracer, rec in _PACKAGES.values():
        tracer.disable()
        tracer.clear()
        rec.uninstall()
    faults.clear()


def _input(tmp_path, width=64, height=64, seed=5) -> str:
    path = tmp_path / f"in_{width}x{height}_{seed}.txt"
    text_grid.write_grid(str(path), text_grid.generate(width, height, seed=seed))
    return str(path)


def _call(main, args, capsys):
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, _MS.sub("X msecs", out), err.replace(str(os.getpid()), "PID")


def _traced(tag, args, tmp_path, capsys):
    """One package's traced run: ``(rc, stdout, stderr, output bytes, span
    names added)``. Both packages write the same trace path, read and
    removed after each run."""
    main, tracer, _ = _PACKAGES[tag]
    tracer.clear()
    tdir, out = tmp_path / "tr", tmp_path / "out.txt"
    rc, stdout, stderr = _call(main, [*args, "--trace", str(tdir),
                                      "--output", str(out)], capsys)
    exported = tdir / f"trace-{os.getpid()}.json"
    events = json.loads(exported.read_text())["traceEvents"]
    exported.unlink()
    data = out.read_bytes() if out.exists() else None
    if out.exists():
        out.unlink()
    spans = collections.Counter(e["name"] for e in events if e.get("ph") == "X")
    return rc, stdout, stderr, data, spans


LANES = {
    "plain": ["--variant", "game"],
    "cuda": ["--variant", "cuda"],
    "packed_io": ["--variant", "game", "--packed-io"],
    "snapshot_every": ["--variant", "game", "--snapshot-every", "16",
                       "--snapshot-dir", "SNAPS"],
    "checkpoint_every": ["--variant", "game", "--checkpoint-every", "16",
                         "--checkpoint-dir", "CKPT"],
    "mesh_2x2": ["--variant", "tpu", "--mesh", "2x2"],
}
# The spans each lane adds, as the JAX CLI emits them for 40 generations.
LANE_SPANS = {
    "plain": {"cli.read_phase": 1, "engine.compile": 1, "cli.execution": 1,
              "cli.write_phase": 1},
    "snapshot_every": {"cli.read_phase": 1, "cli.execution": 1,
                       "engine.segment": 3, "cli.write_phase": 1},
    "checkpoint_every": {"cli.read_phase": 1, "cli.execution": 1,
                         "engine.segment": 3, "pipeline.stage": 2,
                         "pipeline.write": 2, "pipeline.drain": 2,
                         "cli.write_phase": 1},
}


@pytest.mark.parametrize("lane", LANES)
def test_trace_matches_jax(lane, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    path = _input(tmp_path)
    results = {}
    for tag in _PACKAGES:
        args = [a.replace("SNAPS", str(tmp_path / f"snaps_{tag}"))
                .replace("CKPT", str(tmp_path / f"ckpt_{tag}"))
                for a in LANES[lane]]
        results[tag] = _traced(tag, ["64", "64", path, *args, "--gen-limit", "40"],
                               tmp_path, capsys)
    assert results["port"] == results["jax"]
    rc, _, stderr, data, spans = results["port"]
    assert rc == 0 and data
    assert stderr == f"trace -> {tmp_path / 'tr'}/trace-PID.json\n"
    want = LANE_SPANS.get(lane, LANE_SPANS["plain"])
    assert dict(spans) == want
    if lane == "snapshot_every":
        snaps = [sorted(p.name for p in (tmp_path / f"snaps_{t}").iterdir())
                 for t in _PACKAGES]
        assert snaps[0] == snaps[1] == ["gen_000016.out", "gen_000032.out",
                                        "gen_000040.out"]


def test_trace_spans_carry_jax_attributes(tmp_path, capsys):
    path = _input(tmp_path)
    trace.clear()
    assert cli.main(["64", "64", path, "--variant", "game", "--gen-limit", "40",
                     "--snapshot-every", "16", "--snapshot-dir",
                     str(tmp_path / "s"), "--trace", str(tmp_path / "tr"),
                     "--output", str(tmp_path / "o.out")]) == 0
    capsys.readouterr()
    spans = trace.snapshot()
    read = [s for s in spans if s["name"] == "cli.read_phase"]
    assert [s["attrs"] for s in read] == [{"file": path}]
    segments = [s for s in spans if s["name"] == "engine.segment"]
    assert [(s["attrs"]["gen0"], s["attrs"]["seg_end"]) for s in segments] == [
        (1, 16), (17, 32), (33, 48)]
    # The segments run inside the timed region, one level down.
    execution = next(s for s in spans if s["name"] == "cli.execution")
    end = execution["start_s"] + execution["duration_s"]
    for s in segments:
        assert s["depth"] == execution["depth"] + 1
        assert execution["start_s"] <= s["start_s"] <= s["start_s"] + s["duration_s"] <= end


def test_trace_ring_outlives_a_run_in_both_packages(tmp_path, capsys):
    path = _input(tmp_path)
    counts = {}
    for tag, (main, tracer, _) in _PACKAGES.items():
        tracer.clear()
        for _ in range(2):
            assert main(["64", "64", path, "--variant", "game", "--gen-limit", "8",
                         "--trace", str(tmp_path / tag),
                         "--output", str(tmp_path / "o.out")]) == 0
        names = [s["name"] for s in tracer.snapshot()]
        counts[tag] = names.count("cli.read_phase")
    capsys.readouterr()
    assert counts == {"jax": 2, "port": 2}


def test_trace_dir_that_is_a_file_matches_jax(tmp_path, capsys):
    not_a_dir = tmp_path / "occupied"
    not_a_dir.write_text("file, not a directory")
    path = _input(tmp_path, 8, 8, seed=1)
    results = [_call(main, ["8", "8", path, "--variant", "game", "--gen-limit", "2",
                            "--trace", str(not_a_dir),
                            "--output", str(tmp_path / "o.out")], capsys)
               for main, _, _ in _PACKAGES.values()]
    assert results[1] == results[0]
    rc, out, err = results[1]
    assert rc == 1 and out == "" and err.startswith("gol: ")


def test_trace_export_failure_keeps_the_runs_rc(tmp_path, capsys, monkeypatch):
    """A trace export that fails at the end warns on stderr with JAX's line
    and keeps the lane's rc 0."""
    import shutil

    real_export = trace.export_chrome

    def deleted_then_export(path):
        shutil.rmtree(os.path.dirname(path))
        return real_export(path)

    monkeypatch.setattr(trace, "export_chrome", deleted_then_export)
    path = _input(tmp_path, 8, 8, seed=2)
    assert cli.main(["8", "8", path, "--variant", "game", "--gen-limit", "2",
                     "--trace", str(tmp_path / "tr"),
                     "--output", str(tmp_path / "o.out")]) == 0
    err = capsys.readouterr().err
    assert err.startswith("gol: trace export failed: ")


def test_a_crash_under_trace_dumps_the_flight_recorder(tmp_path, capsys):
    """An injected crash mid-run leaves the flight recorder's dump in the
    trace directory, as under JAX, and trace-report renders it through
    both CLIs alike."""
    path = _input(tmp_path, 16, 16, seed=9)
    dumps = {}
    for tag, (main, _, _) in _PACKAGES.items():
        tdir = tmp_path / f"tr_{tag}"
        with pytest.raises(BaseException) as exc:
            main(["16", "16", path, "--variant", "game", "--gen-limit", "10",
                  "--checkpoint-every", "1", "--checkpoint-dir",
                  str(tmp_path / f"ck_{tag}"), "--fault-plan", "kill_at_gen=2",
                  "--trace", str(tdir), "--output", str(tmp_path / "o.out")])
        assert type(exc.value).__name__ == "InjectedCrash"
        faults.clear()
        dumps[tag] = sorted(tdir.glob("flight-*.jsonl"))
        assert len(dumps[tag]) == 1
    capsys.readouterr()
    for dump in (dumps["jax"][0], dumps["port"][0]):
        results = [_call(main, ["trace-report", str(dump)], capsys)
                   for main, _, _ in _PACKAGES.values()]
        assert results[1] == results[0] and results[1][0] == 0
        assert "engine.segment" in results[1][1]


# ---------------------------------------------------------------------------
# --profile: the guarded capture (TestProfileGuard of the JAX CLI's tests).


def _empty_grid(tmp_path) -> str:
    path = tmp_path / "empty.txt"
    text_grid.write_grid(str(path), np.zeros((8, 8), np.uint8))
    return str(path)


def test_profile_with_gen0_empty_input_matches_jax(tmp_path, capsys, monkeypatch):
    """An all-dead grid exits on generation 0: rc 0 and the JAX CLI's lines
    and bytes; JAX's capture is refused as in its own test, the port's runs
    and writes a trace."""
    import jax

    def refuse(*a, **k):
        raise RuntimeError("profiler had nothing to capture")

    monkeypatch.setattr(jax.profiler, "start_trace", refuse)
    path = _empty_grid(tmp_path)
    results = []
    for tag, (main, _, _) in _PACKAGES.items():
        args = ["8", "8", path, "--variant", "cuda", "--profile",
                str(tmp_path / f"prof_{tag}"), "--output", str(tmp_path / f"{tag}.out")]
        rc, out, _ = _call(main, args, capsys)
        results.append((rc, out, (tmp_path / f"{tag}.out").read_bytes()))
    assert results[1] == results[0]
    assert results[1][0] == 0 and "Generations:\t0" in results[1][1]
    json.loads((tmp_path / "prof_port" / "trace.json").read_text())


def _refuse_start(monkeypatch):
    import torch.profiler

    def refuse(self):
        raise RuntimeError("profiler had nothing to capture")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)


def test_profile_start_failure_runs_unprofiled(tmp_path, capsys, monkeypatch):
    _refuse_start(monkeypatch)
    path = _input(tmp_path, 16, 16, seed=3)
    prof = tmp_path / "prof"
    rc, out, err = _call(cli.main, ["16", "16", path, "--variant", "game",
                                    "--profile", str(prof),
                                    "--output", str(tmp_path / "o.out")], capsys)
    want = _call(jax_cli.main, ["16", "16", path, "--variant", "game",
                                "--output", str(tmp_path / "j.out")], capsys)
    assert (rc, out) == want[:2] and rc == 0
    assert (tmp_path / "o.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    assert err == (f"gol_tpu_torch: profiler capture into {prof} failed to start "
                   "(RuntimeError: profiler had nothing to capture); running "
                   "unprofiled\n")
    assert not prof.exists()


def _tearing_start(monkeypatch, prof: Path):
    """The profiler starts for real and leaves a partial file behind, as
    JAX's backend leaves its plugins/profile directory."""
    import torch.profiler

    real_start = torch.profiler.profile.start

    def start(self):
        real_start(self)
        prof.mkdir(exist_ok=True)
        (prof / "partial.json").write_text('{"traceEvents": [')

    monkeypatch.setattr(torch.profiler.profile, "start", start)


def _crash_under_profile(tmp_path, prof, monkeypatch):
    monkeypatch.setenv("GOL_FAULTS", "kill_at_gen=2")
    path = _input(tmp_path, 16, 16, seed=9)
    with pytest.raises(InjectedCrash):
        cli.main(["16", "16", path, "--variant", "tpu", "--gen-limit", "10",
                  "--checkpoint-every", "1", "--checkpoint-dir",
                  str(tmp_path / "ckpt"), "--profile", str(prof),
                  "--output", str(tmp_path / "o.out")])


def test_profile_crashed_run_leaves_no_torn_capture(tmp_path, capsys, monkeypatch):
    prof = tmp_path / "prof"
    _tearing_start(monkeypatch, prof)
    _crash_under_profile(tmp_path, prof, monkeypatch)
    assert not prof.exists() or list(prof.iterdir()) == []
    assert "swept torn capture" in capsys.readouterr().err


def test_profile_sweep_keeps_preexisting_entries(tmp_path, capsys, monkeypatch):
    prof = tmp_path / "prof"
    prof.mkdir()
    (prof / "keep.txt").write_text("an earlier run's notes")
    (prof / "earlier").mkdir()
    _tearing_start(monkeypatch, prof)
    _crash_under_profile(tmp_path, prof, monkeypatch)
    assert sorted(p.name for p in prof.iterdir()) == ["earlier", "keep.txt"]
    capsys.readouterr()


def test_profile_on_the_cpu_lane_writes_a_chrome_trace(tmp_path, capsys):
    path = _input(tmp_path, 64, 64, seed=4)
    prof = tmp_path / "prof"
    rc, out, _ = _call(cli.main, ["64", "64", path, "--variant", "game",
                                  "--gen-limit", "16", "--profile", str(prof),
                                  "--output", str(tmp_path / "o.out")], capsys)
    assert rc == 0 and "Generations:\t16" in out
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in events)
    assert cats["cpu_op"] > 0 and cats["kernel"] == 0


def test_capture_is_a_noop_without_a_directory():
    with profiler.capture(None, "cpu") as prof:
        assert prof is None
    with profiler.capture("", "cpu") as prof:
        assert prof is None


def test_capture_stops_once_when_the_body_raises(tmp_path, monkeypatch):
    import torch.profiler

    stops = []
    real_stop = torch.profiler.profile.stop

    def stop(self):
        stops.append(1)
        real_stop(self)

    monkeypatch.setattr(torch.profiler.profile, "stop", stop)
    with pytest.raises(KeyError):
        with profiler.capture(str(tmp_path / "p"), "cpu"):
            raise KeyError("body")
    assert stops == [1] and not (tmp_path / "p").exists()
    with profiler.capture(str(tmp_path / "q"), "cpu"):
        pass
    assert stops == [1, 1] and (tmp_path / "q" / "trace.json").exists()


@pytest.mark.parametrize("device,want", [("cpu", ["CPU"]), ("cuda", ["CPU", "CUDA"])])
def test_capture_activities_follow_the_device(device, want, tmp_path, monkeypatch):
    """CUDA activity is recorded where the run's device is a card, decided
    from that device and not from what torch sees."""
    import torch

    seen = []

    class FakeProfile:
        def __init__(self, activities):
            seen.append(sorted(a.name for a in activities))

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with profiler.capture(str(tmp_path / "p"), torch.device(device)):
        pass
    assert seen == [want]


# ---------------------------------------------------------------------------
# --compile-cache: the build directory of the kernels and the codec.


def _codec_libs(directory: Path) -> list:
    return sorted(p.name for p in directory.glob("codec-*.so"))


def test_compile_cache_builds_the_codec_into_dir(tmp_path, capsys):
    path = _input(tmp_path)
    cache = tmp_path / "made" / "cache"  # a missing directory is created
    rc, out, _ = _call(cli.main, ["64", "64", path, "--variant", "game",
                                  "--packed-io", "--gen-limit", "40",
                                  "--compile-cache", str(cache),
                                  "--output", str(tmp_path / "o.out")], capsys)
    assert rc == 0 and len(_codec_libs(cache)) == 1
    assert _build.BUILD_DIR == cache.resolve()
    lib = cache / _codec_libs(cache)[0]
    mtime = lib.stat().st_mtime_ns
    assert _call(cli.main, ["64", "64", path, "--variant", "game", "--packed-io",
                            "--gen-limit", "40", "--compile-cache", str(cache),
                            "--output", str(tmp_path / "o2.out")], capsys)[:2] == (rc, out)
    assert lib.stat().st_mtime_ns == mtime  # nothing rebuilt
    assert (tmp_path / "o.out").read_bytes() == (tmp_path / "o2.out").read_bytes()


def test_two_compile_caches_in_one_process_each_get_their_own_build(tmp_path,
                                                                    capsys):
    from gol_tpu_torch import native

    path = _input(tmp_path)
    libs = []
    for name in ("a", "b"):
        cache = tmp_path / name
        assert cli.main(["64", "64", path, "--variant", "game", "--packed-io",
                         "--gen-limit", "8", "--compile-cache", str(cache),
                         "--output", str(tmp_path / f"{name}.out")]) == 0
        assert len(_codec_libs(cache)) == 1
        libs.append(native._lib())
        assert Path(libs[-1]._name).parent == cache.resolve()
    capsys.readouterr()
    assert libs[0] is not libs[1]
    assert (tmp_path / "a.out").read_bytes() == (tmp_path / "b.out").read_bytes()


@pytest.mark.parametrize("attempt", range(3))
def test_concurrent_first_loads_build_one_library(tmp_path, attempt):
    """8 threads load the codec into a fresh build directory at once: each
    gets the same working library and no staging file is left behind."""
    from gol_tpu_torch import native

    _build.enable_compile_cache(str(tmp_path / "cache"))
    start = threading.Barrier(8)
    libs, errors = [], []

    def load():
        try:
            start.wait()
            libs.append(native._lib())
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
    cache = tmp_path / "cache"
    assert len(_codec_libs(cache)) == 1 and list(cache.glob(".*.tmp")) == []
    text = np.frombuffer(b"01" * 32, np.uint8).reshape(1, 64)
    np.testing.assert_array_equal(native.pack_text(text, 64),
                                  native.pack_text_plain(text, 64))


def test_compile_cache_run_matches_jax(tmp_path):
    """Both CLIs with --compile-cache, each in a process of its own (JAX's
    cache setting is global to its process): the same rc, lines and bytes."""
    path = _input(tmp_path)
    env = {**os.environ, "GOL_TORCH_DEVICE": "cpu", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO)] + ([os.environ["PYTHONPATH"]]
                              if os.environ.get("PYTHONPATH") else []))}
    results = []
    for tag, module in (("jax", "gol_tpu"), ("port", "gol_tpu_torch")):
        proc = subprocess.run(
            [sys.executable, "-m", module, "64", "64", path, "--variant", "game",
             "--packed-io", "--gen-limit", "40", "--compile-cache",
             str(tmp_path / f"cache_{tag}"), "--output", str(tmp_path / f"{tag}.out")],
            capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
        results.append((proc.returncode, _MS.sub("X msecs", proc.stdout),
                        (tmp_path / f"{tag}.out").read_bytes()))
        assert (tmp_path / f"cache_{tag}").is_dir()
    assert results[1] == results[0] and results[1][0] == 0
    assert len(_codec_libs(tmp_path / "cache_port")) == 1


# ---------------------------------------------------------------------------
# The offline readers: trace-report, history-report, slo-report.


def _both_report(args, capsys):
    capsys.readouterr()  # what making the artifact logged
    return [_call(main, args, capsys) for main, _, _ in _PACKAGES.values()]


def test_trace_report_renders_both_packages_exports_alike(tmp_path, capsys):
    path = _input(tmp_path)
    exports = {}
    for tag, (main, tracer, _) in _PACKAGES.items():
        tracer.clear()
        assert main(["64", "64", path, "--variant", "game", "--gen-limit", "40",
                     "--trace", str(tmp_path / f"tr_{tag}"),
                     "--output", str(tmp_path / "o.out")]) == 0
        exports[tag] = next((tmp_path / f"tr_{tag}").glob("trace-*.json"))
    capsys.readouterr()
    for tag, export in exports.items():
        jax_res, port_res = _both_report(["trace-report", str(export)], capsys)
        assert port_res == jax_res
        rc, out, err = port_res
        assert rc == 0 and err == ""
        for name in ("cli.read_phase", "engine.compile", "cli.execution",
                     "cli.write_phase"):
            assert name in out, (tag, name)


def _history_ring(directory: Path) -> None:
    t = [100.0]

    def clock():
        t[0] += 1.5
        return t[0]

    writer = jax_history.HistoryWriter(str(directory), source="test",
                                       segment_bytes=600, clock=clock)
    for i in range(12):
        writer.append({"counters": {"jobs_completed_total": 3 * i,
                                    "jobs_failed_total": i // 4},
                       "gauges": {"queue_depth": i % 3},
                       "histograms": {"job_latency_seconds": {
                           "count": i, "p50": 0.01 * i, "p95": 0.02 * i,
                           "p99": 0.03 * i}}})
    writer.close()


def test_history_report_matches_jax(tmp_path, capsys):
    ring = tmp_path / "history"
    _history_ring(ring)
    assert len(list(ring.glob("seg-*.jsonl"))) > 1
    jax_res, port_res = _both_report(["history-report", str(ring)], capsys)
    assert port_res == jax_res
    assert port_res[0] == 0 and "jobs_completed_total" in port_res[1]


@pytest.mark.parametrize("what", ["file", "missing"])
def test_history_report_of_a_non_directory_matches_jax(what, tmp_path, capsys):
    target = tmp_path / "ring"
    if what == "file":
        target.write_text("not a ring")
    jax_res, port_res = _both_report(["history-report", str(target)], capsys)
    assert port_res == jax_res
    assert port_res == (1, "", f"gol: {target} is not a directory (pass the ring "
                        "a --metrics-history run wrote)\n")


def test_port_history_writer_ring_renders_as_jax(tmp_path, capsys):
    """The port's copy of HistoryWriter writes a ring JAX reads alike."""
    from gol_tpu_torch.obs import history

    t = [0.0]

    def clock():
        t[0] += 2.0
        return t[0]

    writer = history.HistoryWriter(str(tmp_path / "h"), source="port", clock=clock)
    for i in range(5):
        writer.append({"counters": {"engine_runs_total": i}})
    writer.close()
    assert history.render_report(str(tmp_path / "h")) == \
        jax_history.render_report(str(tmp_path / "h"))


def _slo_state(shed: bool) -> dict:
    reg = jax_registry.Registry()
    t = [1000.0]
    eng = jax_slo.SloEngine(jax_slo.default_objectives(100, latency_target_s=1.0),
                            registry=reg, clock=lambda: t[0], windows=(10.0, 60.0),
                            shed=shed)
    eng.sample()
    reg.inc("jobs_accepted_total", 10)
    reg.inc("jobs_failed_total", 10)
    t[0] += 5
    return eng


def _flight_dump(tmp_path, with_slo: bool) -> str:
    eng = _slo_state(shed=True)
    eng.evaluate()
    if with_slo:
        jax_recorder.add_state_provider(jax_slo.STATE_PROVIDER, eng.state)
    try:
        jax_recorder.install(str(tmp_path / "dumps"))
        dump = jax_recorder.trigger("test dump")
    finally:
        jax_recorder.uninstall()
        jax_recorder.remove_state_provider(jax_slo.STATE_PROVIDER)
    assert dump is not None
    return dump


def test_slo_report_of_a_flight_dump_matches_jax(tmp_path, capsys):
    dump = _flight_dump(tmp_path, with_slo=True)
    jax_res, port_res = _both_report(["slo-report", dump], capsys)
    assert port_res == jax_res
    rc, out, _ = port_res
    assert rc == 0 and "SLO status: critical" in out
    assert "shedding: enabled (ACTIVE)" in out


def test_slo_report_of_a_dump_without_slo_matches_jax(tmp_path, capsys):
    dump = _flight_dump(tmp_path, with_slo=False)
    jax_res, port_res = _both_report(["slo-report", dump], capsys)
    assert port_res == jax_res
    dump = dump.replace(str(os.getpid()), "PID")
    assert port_res == (1, "", f"gol: {dump} holds no SLO state record (was the "
                        "dumping process a server? pre-SLO dumps have none)\n")


@contextlib.contextmanager
def _slo_endpoint(body: bytes, status: int = 200):
    """A stub ``GET /slo`` server on localhost."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            code = status if self.path == "/slo" else 404
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_slo_report_of_a_live_endpoint_matches_jax(capsys):
    eng = _slo_state(shed=False)
    body = json.dumps(eng.evaluate()).encode()
    with _slo_endpoint(body) as url:
        jax_res, port_res = _both_report(["slo-report", url + "/"], capsys)
    assert port_res == jax_res
    rc, out, _ = port_res
    assert rc == 0 and "SLO status: critical" in out and "observe-only" in out


@pytest.mark.parametrize("answer", ["refused", "not_json", "http_500"])
def test_slo_report_without_an_answer_matches_jax(answer, capsys):
    if answer == "refused":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            url = f"http://127.0.0.1:{s.getsockname()[1]}"
        jax_res, port_res = _both_report(["slo-report", url], capsys)
    else:
        body, status = (b"not json", 200) if answer == "not_json" else (b"{}", 500)
        with _slo_endpoint(body, status) as url:
            jax_res, port_res = _both_report(["slo-report", url], capsys)
    assert port_res == jax_res
    if answer == "not_json":
        # A 200 that is not JSON reads as {"error": ...} in both CLIs.
        assert port_res[0] == 0
    else:
        assert port_res == (1, "", f"gol: no SLO status from {url} (is the server "
                            "up, and does it have /slo?)\n")


# ---------------------------------------------------------------------------
# The engine's spans and counters, against JAX's.


def _delta(reg, before: dict) -> dict:
    return {k: reg.counter(k) - v for k, v in before.items()}


def test_engine_simulate_spans_and_counters_match_jax():
    grid = text_grid.generate(32, 32, seed=11)
    names = ("engine_runs_total", "engine_generations_total",
             "engine_segments_total")
    seen = {}
    for tag, tracer, reg, run in (
            ("jax", jax_trace, jax_registry.default(),
             lambda: jax_engine.simulate(grid, JaxGameConfig(gen_limit=50))),
            ("port", trace, registry.default(),
             lambda: engine.simulate(grid, GameConfig(gen_limit=50), device="cpu"))):
        tracer.enable()
        tracer.clear()
        before = {k: reg.counter(k) for k in names}
        result = run()
        spans = [(s["name"], s["attrs"]) for s in tracer.snapshot()]
        seen[tag] = (np.asarray(result.grid), result.generations, spans,
                     _delta(reg, before))
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    assert seen["port"][1:] == seen["jax"][1:]
    assert [n for n, _ in seen["port"][2]] == ["engine.simulate"]
    assert seen["port"][3]["engine_runs_total"] == 1


def test_engine_segment_counters_match_jax():
    grid = text_grid.generate(32, 32, seed=12)
    names = ("engine_segments_total", "engine_generations_total")
    seen = {}
    for tag, reg, segments in (
            ("jax", jax_registry.default(),
             lambda: jax_engine.simulate_segments(grid, JaxGameConfig(gen_limit=45),
                                                  segment=20)),
            ("port", registry.default(),
             lambda: engine.simulate_segments(grid, GameConfig(gen_limit=45),
                                              segment=20, device="cpu"))):
        before = {k: reg.counter(k) for k in names}
        gens = [g for g, _, _ in segments()]
        seen[tag] = (gens, _delta(reg, before))
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["engine_segments_total"] == len(seen["port"][0])
