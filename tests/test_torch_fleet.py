"""The port's fleet tier (gol_tpu_torch/fleet) against the JAX package's
(gol_tpu/fleet), on the CPU: the pieces a router computes without a
worker.

- Placement: the same keys, labels and rendezvous ranks (plain and
  weighted) for the same bodies and worker ids, the same refusals, and
  the placement quantum equal to the port's batcher quantum.
- Affinity weights and the taskset core slices equal JAX's.
- Worker recognition: a recorded pid counts as a worker only when its
  argv runs ``-m gol_tpu_torch`` (a JAX package worker, ``-m gol_tpu``,
  is not one, though the JAX package's own test is a substring match).
- The manifest: each package loads the other's, with the same records,
  config block and file bytes; the router-replica state (floors, adverts,
  the breaker ring) read back the same.
- The merged ``/metrics`` (JSON and Prometheus text) and ``/slo`` and the
  respawn floors equal JAX's for the same worker snapshots.
"""

import json
import subprocess
import sys

import pytest

from gol_tpu.fleet import affinity as jax_affinity
from gol_tpu.fleet import placement as jax_placement
from gol_tpu.fleet import replicate as jax_replicate
from gol_tpu.fleet import router as jax_router
from gol_tpu.fleet import workers as jax_workers
from gol_tpu_torch.fleet import affinity, placement, replicate, router, workers
from gol_tpu_torch.obs.history import HistoryWriter
from gol_tpu_torch.serve import batcher

PACKAGES = {"port": (placement, affinity, router, workers, replicate),
            "jax": (jax_placement, jax_affinity, jax_router, jax_workers,
                    jax_replicate)}


def _both(fn):
    """``fn(*modules)`` for each package: (port's, JAX's)."""
    return fn(*PACKAGES["port"]), fn(*PACKAGES["jax"])


# ---------------------------------------------------------------------------
# Placement


def test_quantum_matches_the_ports_batcher():
    assert placement.PLACEMENT_QUANTUM == batcher.PAD_QUANTUM \
        == jax_placement.PLACEMENT_QUANTUM


BODIES = [
    {"width": 30, "height": 30},
    {"width": 33, "height": 65, "convention": "cuda"},
    {"width": 8, "height": 8, "check_similarity": False},
    {"width": 160, "height": 160, "similarity_frequency": 7},
    {"width": 4096, "height": 1000, "gen_limit": 10},
    {"width": 250, "height": 250, "convention": "c",
     "similarity_frequency": 3, "check_similarity": True},
]


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_placement_keys_match_jax(body):
    port, jax = _both(lambda p, *_: p.key_for(dict(body)))
    assert (port.label(), port.max_edge, port.height, port.width) == \
        (jax.label(), jax.max_edge, jax.height, jax.width)


@pytest.mark.parametrize("body, exc", [
    ({"width": 0, "height": 8}, ValueError),
    ({"width": "x", "height": 8}, ValueError),
    ({"width": 8, "height": 8, "check_similarity": "false"}, TypeError),
    ({"height": 8}, KeyError),
], ids=["zero", "text", "flag_text", "no_width"])
def test_placement_refusals_match_jax(body, exc):
    errors = []
    for mods in PACKAGES.values():
        with pytest.raises(exc) as err:
            mods[0].key_for(dict(body))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_ranks_match_jax(n):
    ids = [f"w{i}" for i in range(n)]
    labels = [f"{32 * i}x{32 * i}/c" for i in range(1, 40)] + \
        [f"fp:{i:064x}" for i in range(20)] + ["tile:3:17", "160x160/c/sim27"]
    weights = {w: float(1 + i % 3) for i, w in enumerate(ids)}
    for label in labels:
        port, jax = _both(lambda p, *_: (p.rank(label, ids),
                                         p.rank_weighted(label, weights)))
        assert port == jax


def test_affinity_weights_match_jax():
    def pool(mod):
        return [mod.Worker(id="w0", weight=4.0),
                mod.Worker(id="w1", advertised_weight=2.5e9),
                mod.Worker(id="w2"),
                mod.Worker(id="w3", weight=-1.0, advertised_weight=0.0)]
    port, jax = _both(lambda p, a, r, w, _: a.weights_for(pool(w)))
    assert port == jax


@pytest.mark.parametrize("width, ncores", [(1, 8), (2, 8), (3, 8), (6, 32),
                                           (8, 8)])
def test_core_slices_match_jax(width, ncores):
    port, jax = _both(lambda *m: m[3].core_slice_prefix(width, ncores))
    for wid in ("w0", "w1", "w2", "w3", "w7", "big0", "w12"):
        worker = workers.Worker(id=wid)
        assert port(worker) == jax(worker)


@pytest.mark.parametrize("width, ncores", [(0, 8), (9, 8)])
def test_core_slice_refusals_match_jax(width, ncores):
    errors = []
    for mods in PACKAGES.values():
        with pytest.raises(ValueError) as err:
            mods[3].core_slice_prefix(width, ncores)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Worker recognition


@pytest.fixture
def sleepers():
    """Processes whose argv reads like each package's worker (python -c
    sleep, with ``-m <package> serve`` as its arguments)."""
    procs = {}
    for name in ("gol_tpu_torch", "gol_tpu"):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)", "-m", name,
             "serve", "--port", "0"])
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


def test_only_the_ports_workers_are_recognised(sleepers):
    assert workers.Fleet._looks_like_worker(sleepers["gol_tpu_torch"].pid)
    assert not workers.Fleet._looks_like_worker(sleepers["gol_tpu"].pid)
    # The JAX package matches a substring, which names both.
    assert jax_workers.Fleet._looks_like_worker(sleepers["gol_tpu"].pid)
    assert jax_workers.Fleet._looks_like_worker(sleepers["gol_tpu_torch"].pid)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    assert not workers.Fleet._looks_like_worker(dead.pid)


def test_ensure_dead_spares_a_jax_worker(sleepers):
    workers.Fleet._ensure_dead(sleepers["gol_tpu"].pid, timeout=1)
    assert sleepers["gol_tpu"].poll() is None
    workers.Fleet._ensure_dead(sleepers["gol_tpu_torch"].pid, timeout=10)
    assert sleepers["gol_tpu_torch"].wait(timeout=10) == -9


def test_spawn_command_runs_the_port(tmp_path, monkeypatch):
    seen = {}

    class FakePopen:
        def __init__(self, cmd, env=None, **kw):
            seen["cmd"], seen["env"] = cmd, env
            self.pid = 4242

    monkeypatch.setattr(workers.subprocess, "Popen", FakePopen)
    fleet = workers.Fleet(str(tmp_path), serve_args=["--max-batch", "8"],
                          spawn_prefix=workers.core_slice_prefix(1, 8))
    fleet._launch(workers.Worker(id="w1"))
    assert seen["cmd"][:3] == ["taskset", "-c", "1-1"]
    assert seen["cmd"][3:7] == [sys.executable, "-m", "gol_tpu_torch", "serve"]
    assert seen["cmd"][-2:] == ["--max-batch", "8"]
    assert seen["env"]["PYTHONPATH"].split(":")[0] == str(
        workers.os.path.dirname(workers.os.path.dirname(
            workers.os.path.abspath(sys.modules["gol_tpu_torch"].__file__))))


# ---------------------------------------------------------------------------
# The manifest and the replicas' shared state


def _write_manifest(mod, fleet_dir):
    fleet = mod.Fleet(str(fleet_dir), probe=lambda *a, **k: None)
    fleet.attach("http://127.0.0.1:9", "w0")
    fleet.attach("http://127.0.0.1:10", "w1")
    local = mod.Worker(id="w2", url="http://127.0.0.1:11", pid=999999,
                       journal_dir=str(fleet_dir / "w2"), weight=2.0)
    fleet._add(local)
    fleet.manifest_config = {"serve_args": ["--max-batch", "8"],
                             "health_interval": 1.0, "big_edge": 1024,
                             "cores_per_worker": 2, "autoscale": None}
    fleet.write_manifest()
    return (fleet_dir / "manifest.json").read_bytes()


def _load(mod, fleet_dir):
    # A replica adopts a dead local partition without respawning it.
    fleet = mod.Fleet(str(fleet_dir), probe=lambda *a, **k: None, replica=True)
    n = fleet.load()
    return n, fleet.manifest_config, sorted(
        (w.id, w.url, w.attached, w.pid, w.weight, w.big, w.healthy)
        for w in fleet.workers())


def test_manifests_move_between_the_packages(tmp_path):
    port_bytes = _write_manifest(workers, tmp_path / "port")
    jax_bytes = _write_manifest(jax_workers, tmp_path / "jax")
    assert port_bytes.replace(b"/port/", b"/jax/") == jax_bytes
    for directory in ("port", "jax"):
        loaded = [_load(mod, tmp_path / directory)
                  for mod in (workers, jax_workers)]
        assert loaded[0] == loaded[1]
        assert loaded[0][1]["serve_args"] == ["--max-batch", "8"]


def test_replica_state_reads_the_same(tmp_path):
    """Two replicas' floors, adverts and breaker rings, written by the
    port: each package reads the same merged floors, warm breaker states
    and roster."""
    fleet_dir = str(tmp_path)
    for k, rid in enumerate(("r0", "r1")):
        replicate.advertise(fleet_dir, rid, f"http://127.0.0.1:{5 + k}")
        floors = router.MonotonicCounters()
        floors.adjust({"w0": {"counters": {"jobs_completed_total": 3 + k}}})
        floors.adjust({"w0": {"counters": {"jobs_completed_total": 1}}})
        replicate.FloorsStore(replicate.state_dir(fleet_dir, rid)).save(
            floors.state())
        ring = HistoryWriter(str(tmp_path / "routers" / rid
                                 / replicate.BREAKER_RING), source="breaker")
        ring.append({"breaker": {"worker": f"w{k}", "from": "closed",
                                 "to": "open"}})
        ring.close()
    for fn in ("load_merged_floors", "warm_breaker_states", "list_routers"):
        assert getattr(replicate, fn)(fleet_dir) == \
            getattr(jax_replicate, fn)(fleet_dir)
    assert replicate.warm_breaker_states(fleet_dir) == {"w0": "open",
                                                        "w1": "open"}


# ---------------------------------------------------------------------------
# Merged metrics and SLO


SNAPSHOTS = [
    {"w0": {"counters": {"jobs_completed_total": 3},
            "gauges": {"queue_depth": 2},
            "histograms": {"run_latency_seconds":
                           {"count": 3, "sum": 1.5, "p50": 0.5, "p99": 2.0}}},
     "w1": {"counters": {"jobs_completed_total": 4, "jobs_failed_total": 1},
            "gauges": {"queue_depth": 5},
            "histograms": {"run_latency_seconds":
                           {"count": 1, "sum": 9.0, "p50": 1.5, "p99": 1.0}}}},
    {"w0": {"gauges": {"dispatch_gap_ratio": 0.9, "ring_slot_occupancy": 0.5,
                       "boards_per_sec": 10.0}},
     "w1": {"gauges": {"dispatch_gap_ratio": 0.4, "ring_slot_occupancy": 0.75,
                       "boards_per_sec": 20.0}}},
    {"w0": {"counters": {"jobs_accepted_total": 2}, "gauges": {},
            "histograms": {}}},
]


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=range(len(SNAPSHOTS)))
def test_merged_metrics_match_jax(snap):
    def merged(p, a, r, *_):
        m = r.merge_metrics(json.loads(json.dumps(snap)))
        return m, r.merged_prometheus(m, {"workers": 3},
                                      {"jobs_routed_total": 5})
    port, jax = _both(merged)
    assert port == jax


def test_respawn_floors_match_jax():
    scrapes = [
        ({"w0": {"counters": {"jobs_completed_total": 10},
                 "histograms": {"lat": {"count": 3, "sum": 1.5, "p50": 0.5}}},
          "w1": {"counters": {"jobs_completed_total": 5}}}, None),
        ({"w0": {"counters": {"jobs_completed_total": 11}},
          "w1": {"counters": {"jobs_completed_total": 0}}}, None),
        ({"w1": {"counters": {"jobs_completed_total": 2}}}, None),
        ({"w0": {"counters": {}, "histograms": {}},
          "w1": {"counters": {"jobs_completed_total": 120}}}, {"w1": 1}),
        ({"w0": {"counters": {"jobs_completed_total": 1},
                 "histograms": {"lat": {"count": 1, "sum": 0.25}}},
          "w1": {"counters": {"jobs_completed_total": 125}}}, {"w1": 1}),
    ]

    def run(p, a, r, *_):
        floors = r.MonotonicCounters()
        out = []
        for snap, inc in scrapes:
            kwargs = {"incarnations": inc} if inc is not None else {}
            out.append(r.merge_metrics(floors.adjust(
                json.loads(json.dumps(snap)), **kwargs)))
        return out, floors.state()

    port, jax = _both(run)
    assert port == jax


SLOS = [
    {"w0": {"status": "ok", "windows_s": [60, 300],
            "shed": {"enabled": False, "active": False},
            "objectives": [{"name": "latency_p99_high", "status": "ok",
                            "burn": 0.1}]},
     "w1": {"status": "critical", "windows_s": [60, 300],
            "shed": {"enabled": True, "active": True},
            "objectives": [{"name": "error_rate", "status": "critical",
                            "burn": 4.0}]},
     "w2": None},
    {"w0": None, "w1": None},
    {"w0": {"status": "ok", "windows_s": [60], "objectives": [],
            "shed": {"enabled": False, "active": False}}, "w1": None},
    {"w0": {"status": "warning", "windows_s": [60], "objectives": [],
            "shed": {"enabled": False, "active": False}},
     "w1": {"status": "ok", "windows_s": [60], "objectives": [],
            "shed": {"enabled": False, "active": False}}},
]


@pytest.mark.parametrize("slo", SLOS, ids=range(len(SLOS)))
def test_merged_slo_matches_jax(slo):
    port, jax = _both(lambda p, a, r, *_: r.merge_slo(json.loads(json.dumps(slo))))
    assert port == jax


def test_a_worker_without_a_card_fails_its_boot_loudly(tmp_path, monkeypatch):
    """A spawned worker asks for the card unless GOL_TORCH_DEVICE=cpu is
    set; without one it dies on boot, and the fleet raises with its log's
    tail instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would boot on it")
    monkeypatch.delenv("GOL_TORCH_DEVICE", raising=False)
    fleet = workers.Fleet(str(tmp_path), boot_timeout=120)
    with pytest.raises(RuntimeError) as err:
        fleet.spawn_fleet(1)
    assert "worker w0 died on boot (rc=1)" in str(err.value)
    assert "torch sees no CUDA card" in str(err.value)
