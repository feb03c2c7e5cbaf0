"""The fleet router: one HTTP front-end over N serving workers.

Exposes the single-server job API **unchanged** — clients built against
``gol serve`` (``gol submit``, ``gol top``, curl loops) talk to a router
without modification — and adds the fleet surfaces:

- ``POST /jobs``      — placed by padding bucket (``fleet/placement``:
  rendezvous-hashed, so a bucket's compiled programs and resident rings
  stay hot on ONE worker), forwarded verbatim. With ``--cache-route`` the
  HRW key is the job's result FINGERPRINT instead (``cache/``), so
  repeats land on the worker whose cache tiers hold the answer. A worker that 429s or is
  unreachable spills to the next-ranked worker before the client sees an
  error; oversized boards (padded edge > ``big_edge``) go to the dedicated
  big-lane worker when the fleet has one. The 202 payload gains a
  ``worker`` field. Packed wire bodies (``Content-Type:
  application/x-gol-packed``, io/wire.py) are placed from the frame
  header + meta alone — no payload read, no unpack — and the raw buffer
  is forwarded under the same content type: the router's cost per packed
  submit is independent of board size.
- ``GET /result/<id>`` with ``Accept: application/x-gol-packed`` relays
  the worker's packed frame bytes verbatim (text/JSON results and every
  error stay parsed-JSON, byte-identical to pre-wire routing).
- ``GET /jobs/<id>``, ``/jobs/<id>/timeline``, ``GET /result/<id>``,
  ``DELETE /jobs/<id>`` — forwarded to the owning worker (an in-memory
  id->worker map, rebuilt lazily by broadcast after a router restart: the
  workers' journals are the durable truth, the router keeps none).
- ``GET /metrics``    — fleet-merged: counters and gauges sum across
  workers, histogram quantiles take the worst worker (a conservative
  upper bound — true fleet quantiles would need raw samples);
  ``?format=json`` carries the merged view top-level (same schema as one
  worker, so dashboards work unchanged) plus per-worker snapshots under
  ``workers`` and membership under ``fleet``.
- ``GET /slo``        — overall status is the worst worker's; objectives
  are every worker's, names prefixed ``<worker>:``.
- ``GET /fleet``      — membership: per-worker id/url/pid/health (what
  ``gol submit --shard-across`` and ``gol top`` read).
- ``POST /drain``     — fleet-wide cascade: admission stops here first,
  then every worker drains concurrently; responds when all are quiescent.
- ``GET /healthz``    — router liveness + fleet stats.

The router owns no device and no journal: exactly-once is the sum of the
partitions' journals (see ``fleet/workers``), which is why killing the
router loses nothing — restart, ``Fleet.load()``, keep serving.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import time

from gol_tpu_torch.fleet import affinity, client, placement
from gol_tpu_torch.fleet.breaker import (
    BreakerConfig, CircuitBreaker, STATE_VALUE,
)
from gol_tpu_torch.fleet.workers import Fleet, Worker
from gol_tpu_torch.io import wire
from gol_tpu_torch.obs import propagate, registry as obs_registry, trace as obs_trace
from gol_tpu_torch.obs.registry import Registry, _fmt
from gol_tpu_torch.resilience import retry as _retry_mod

logger = logging.getLogger(__name__)

# Body caps ride io/wire.py (wire.max_body_bytes — numpy-only, torch-free,
# importable here), the same constants the workers enforce: the router
# must never be tighter than a worker, and the packed cap bounds the same
# board-area universe as the text cap rather than the same byte count.

# SLO status ordering for the fleet-wide worst-of merge.
_SLO_RANK = {"ok": 0, "warning": 1, "critical": 2}


# Spill safety: only failures that guarantee the worker never saw the
# request may move a submit to another worker (shared with `gol submit`'s
# POST auto-retry — both re-sends have the same double-run hazard).
_delivery_impossible = _retry_mod.delivery_impossible


# -- pure merge helpers (unit-tested without HTTP) --------------------------

class MonotonicCounters:
    """Per-worker high-water offsets so fleet-merged cumulative series —
    counters AND histogram ``count``/``sum`` — never go backwards across
    worker respawns.

    A respawned worker restarts its cumulative series at zero, so summing
    raw per-worker values makes the fleet-merged "counter" DECREASE
    exactly during the restart windows operators are watching — Prometheus
    ``rate()``/``increase()`` then report spurious resets and spikes. The
    router banks, per (worker, series), the total a previous incarnation
    reached (a value going backwards — or a lazily-created key vanishing —
    is the respawn signal) and adds it back before merging, keeping the
    merged series monotonic — including through the outage window itself,
    when the dead worker answers no scrape at all and its last-known
    totals stand in. Gauges and histogram quantiles are instantaneous and
    pass through untouched: only LIVE workers contribute those."""

    def __init__(self):
        self._lock = threading.Lock()
        # (worker id, series key) -> float; a series key is ("c", name)
        # for a counter or ("h", name, "count"|"sum") for a histogram.
        self._last: dict[tuple, float] = {}
        self._base: dict[tuple, float] = {}
        self._incarnation: dict[str, int] = {}  # worker id -> restarts seen

    @staticmethod
    def _series(snap: dict) -> dict[tuple, float]:
        series: dict[tuple, float] = {}
        for name, value in (snap.get("counters") or {}).items():
            series[("c", name)] = float(value)
        for name, summary in (snap.get("histograms") or {}).items():
            for field in ("count", "sum"):
                series[("h", name, field)] = float(summary.get(field) or 0)
        return series

    def _floor(self, wid: str, series: dict[tuple, float]) -> dict:
        """Bank resets and return every known-or-present series floored.
        A known key absent from this scrape reads as zero — registries
        create series lazily, so a fresh incarnation that has not counted
        an event yet omits the key entirely: the same reset signal."""
        known = {skey for (w, skey) in self._last if w == wid}
        floored = {}
        for skey in known | set(series):
            value = series.get(skey, 0.0)
            key = (wid, skey)
            last = self._last.get(key, 0.0)
            if value < last:  # the worker respawned: bank its old run
                self._base[key] = self._base.get(key, 0.0) + last
            self._last[key] = value
            floored[skey] = self._base.get(key, 0.0) + value
        return floored

    @staticmethod
    def _rebuild(snap: dict, floored: dict[tuple, float]) -> dict:
        counters: dict[str, float] = {}
        hists = {name: dict(summary)
                 for name, summary in (snap.get("histograms") or {}).items()}
        for skey, value in floored.items():
            if skey[0] == "c":
                counters[skey[1]] = value
            else:
                hists.setdefault(skey[1], {})[skey[2]] = value
        return {**snap, "counters": counters, "histograms": hists}

    def adjust(self, snapshots: dict[str, dict],
               incarnations: dict[str, int] | None = None) -> dict[str, dict]:
        out: dict[str, dict] = {}
        with self._lock:
            # Bank on KNOWN respawns first (the fleet's restart
            # generation): a new incarnation that already overtook the
            # old total by the next scrape shows no value regression,
            # and inferring resets from value order alone would silently
            # drop the old run from the merge. Attached workers (the
            # fleet never respawns them) still rely on the value-
            # regression fallback below.
            for wid, gen in (incarnations or {}).items():
                seen = self._incarnation.get(wid)
                self._incarnation[wid] = gen
                if seen is None or gen == seen:
                    continue
                for (w, skey), last in list(self._last.items()):
                    if w == wid and last > 0:
                        self._base[(w, skey)] = (
                            self._base.get((w, skey), 0.0) + last
                        )
                        self._last[(w, skey)] = 0.0
            for wid, snap in snapshots.items():
                out[wid] = self._rebuild(snap, self._floor(wid,
                                                           self._series(snap)))
            # A worker missing from this scrape ENTIRELY (dead, mid-
            # respawn, network blip) still contributes its last-known
            # totals: the events it counted happened, and dropping them
            # dips the merged series for the whole outage window. No
            # banking here — a worker back from a blip with its series
            # intact just continues them.
            known_wids = {w for (w, _) in self._last}
            for wid in known_wids - set(snapshots):
                floored = {
                    skey: self._base.get((w, skey), 0.0) + last
                    for (w, skey), last in self._last.items() if w == wid
                }
                out[wid] = self._rebuild({}, floored)
        return out

    def state(self) -> dict:
        """JSON-round-trippable floors (``fleet/replicate.FloorsStore``
        persists it after every fresh scrape): the banked bases, the
        last-seen values — without which a dead worker's stand-in totals
        and the regression fallback vanish on router restart — and the
        incarnation generations."""
        with self._lock:
            return {
                "version": 1,
                "last": [[wid, list(skey), value]
                         for (wid, skey), value in self._last.items()],
                "base": [[wid, list(skey), value]
                         for (wid, skey), value in self._base.items()],
                "incarnations": dict(self._incarnation),
            }

    def seed(self, state: dict | None) -> None:
        """Adopt floors a previous router incarnation persisted. Only a
        fresh instance seeds (floors already in motion outrank any file).
        Live workers then simply continue their series (value >= seeded
        last: no bank); a worker that restarted while no router watched
        shows value < seeded last and banks the lost run — the merged
        series stays monotonic through the ROUTER's own outage window."""
        if not state:
            return
        with self._lock:
            if self._last or self._base:
                return
            for wid, skey, value in state.get("last") or []:
                self._last[(wid, tuple(skey))] = float(value)
            for wid, skey, value in state.get("base") or []:
                self._base[(wid, tuple(skey))] = float(value)
            for wid, gen in (state.get("incarnations") or {}).items():
                self._incarnation[wid] = int(gen)


def merge_metrics(snapshots: dict[str, dict]) -> dict:
    """Merge per-worker /metrics JSON snapshots into one fleet view.

    Counters and extensive gauges SUM (fleet queue depth is the sum of
    worker queues; fleet boards/sec is the sum of worker rates). INTENSIVE
    gauges — ratios and occupancies, which live in [0, 1] per worker — take
    the MAX (summing four workers' 0.9 dispatch-gap ratios into 3.6 would
    be nonsense; the worst worker is the figure an operator acts on).
    Disk-pressure gauges are intensive too, with their own directions:
    ``disk_free_bytes`` merges by MIN (the binding constraint — the fleet
    is as full as its fullest partition) and ``disk_pressure_level`` by
    MAX (the deepest degradation any partition is in). Histogram
    ``count``/``sum`` sum; quantiles take the MAX across workers — the
    honest aggregate without raw samples is "no worker is worse than
    this", which is the bound an operator alerts on anyway."""
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict] = {}
    for snap in snapshots.values():
        for name, value in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + value
        for name, value in (snap.get("gauges") or {}).items():
            prev = gauges.get(name)
            if name == "disk_free_bytes":
                gauges[name] = value if prev is None else min(prev, value)
            elif name == "disk_pressure_level" or any(
                hint in name for hint in ("ratio", "occupancy")
            ):
                gauges[name] = value if prev is None else max(prev, value)
            else:
                gauges[name] = (prev or 0) + value
        for name, summary in (snap.get("histograms") or {}).items():
            out = hists.setdefault(name, {"count": 0, "sum": 0.0})
            out["count"] += summary.get("count") or 0
            out["sum"] += summary.get("sum") or 0.0
            for key, value in summary.items():
                if key.startswith("p") and value is not None:
                    prev = out.get(key)
                    out[key] = value if prev is None else max(prev, value)
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def merged_prometheus(merged: dict, fleet_gauges: dict,
                      fleet_counters: dict | None = None) -> str:
    """Prometheus text for the merged snapshot, in the worker registry's
    exposition shape (same ``gol_serve_`` series names, sum semantics) plus
    ``gol_fleet_*`` membership gauges and router counters."""
    lines: list[str] = []
    for name, value in sorted(merged.get("counters", {}).items()):
        lines.append(f"# TYPE gol_serve_{name} counter")
        lines.append(f"gol_serve_{name} {_fmt(value)}")
    for name, value in sorted(merged.get("gauges", {}).items()):
        lines.append(f"# TYPE gol_serve_{name} gauge")
        lines.append(f"gol_serve_{name} {_fmt(value)}")
    for name, summary in sorted(merged.get("histograms", {}).items()):
        lines.append(f"# TYPE gol_serve_{name} summary")
        for q in (0.5, 0.95, 0.99):
            v = summary.get(f"p{int(q * 100)}")
            if v is not None:
                lines.append(f'gol_serve_{name}{{quantile="{q}"}} {_fmt(v)}')
        lines.append(f"gol_serve_{name}_sum {_fmt(summary['sum'])}")
        lines.append(f"gol_serve_{name}_count {_fmt(summary['count'])}")
    for name, value in sorted((fleet_counters or {}).items()):
        lines.append(f"# TYPE gol_fleet_{name} counter")
        lines.append(f"gol_fleet_{name} {_fmt(value)}")
    for name, value in sorted(fleet_gauges.items()):
        lines.append(f"# TYPE gol_fleet_{name} gauge")
        lines.append(f"gol_fleet_{name} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def merge_slo(statuses: dict[str, dict | None]) -> dict:
    """Merge per-worker /slo payloads: worst status wins, every objective
    is listed under ``<worker>:<name>``, shedding is any-worker. An
    unreachable worker degrades the headline — at least ``warning``, and
    ``critical`` when NO worker answered: a fleet serving nothing must
    never show a green status to the surface that exists to catch it."""
    overall = "ok"
    objectives = []
    windows = None
    shed_enabled = shed_active = False
    unreachable = []
    for worker_id, status in sorted(statuses.items()):
        if not status:
            unreachable.append(worker_id)
            continue
        if _SLO_RANK.get(status.get("status"), 0) > _SLO_RANK[overall]:
            overall = status["status"]
        if windows is None:
            windows = status.get("windows_s")
        shed = status.get("shed") or {}
        shed_enabled = shed_enabled or bool(shed.get("enabled"))
        shed_active = shed_active or bool(shed.get("active"))
        for obj in status.get("objectives") or []:
            objectives.append({**obj, "name": f"{worker_id}:{obj['name']}"})
    if unreachable:
        floor = "critical" if len(unreachable) == len(statuses) else "warning"
        if _SLO_RANK[floor] > _SLO_RANK[overall]:
            overall = floor
    return {
        "status": overall,
        "windows_s": windows or [],
        "shed": {"enabled": shed_enabled, "active": shed_active},
        "objectives": objectives,
        "unreachable": unreachable,
        "workers": {
            wid: (status if status else {"status": "unreachable"})
            for wid, status in statuses.items()
        },
    }


class RouterServer:
    """The routing process: membership + placement + HTTP front end."""

    def __init__(
        self,
        fleet: Fleet,
        host: str = "127.0.0.1",
        port: int = 0,
        big_edge: int = 1024,
        http=client.http_json,
        http_exchange=client.http_exchange,
        submit_timeout: float = 120.0,
        cache_route: bool = False,
        affinity_route: bool = False,
        breakers: bool = False,
        breaker_config: BreakerConfig | None = None,
        breaker_history=None,
        chaos=None,
        router_id: str = "r0",
        state_dir: str | None = None,
    ):
        if big_edge < placement.PLACEMENT_QUANTUM:
            raise ValueError(
                f"big_edge must be >= {placement.PLACEMENT_QUANTUM}, "
                f"got {big_edge}"
            )
        self.fleet = fleet
        self.big_edge = big_edge
        self.http = http
        # The byte-level exchange (packed wire result relay): separate
        # injectable so tests stubbing the JSON client keep working
        # unchanged — only Accept-packed result fetches ride this one.
        self.http_exchange = http_exchange
        self.submit_timeout = submit_timeout
        # The fleet cache tier (cache/): rank workers by the job's
        # RESULT FINGERPRINT instead of its padding bucket, so every repeat
        # of a board lands on the one worker whose cache tiers hold its
        # answer — the cache shard for a fingerprint lives on its HRW
        # owner, deterministically across router restarts, and hot patterns
        # spread across the fleet by fingerprint instead of hammering one
        # bucket owner. The trade (documented in README): one padding
        # bucket's boards may now compile on several workers — a one-time
        # cost per (bucket, worker), bought back by every repeat that
        # skips its engine run. ``no_cache`` submissions keep bucket
        # routing; spillover/health/big-lane ordering is identical.
        self.cache_route = cache_route
        # Affinity-aware placement (fleet/affinity.py): rank by weighted
        # HRW over per-worker capacity weights instead of the raw hash.
        # Default OFF, and OFF is byte-identical plain HRW (test-pinned);
        # ON with no weights configured delegates back to plain HRW, so
        # the flag is safe before any weight exists.
        self.affinity_route = affinity_route
        # The autoscaler (fleet/autoscale.py), attached by the CLI after
        # construction (it needs this router's merged scrape): surfaces
        # in /metrics, /fleet, and `gol top` when present.
        self.autoscaler = None
        # Per-worker circuit breakers (fleet/breaker.py). Default OFF and
        # byte-identical to the pre-breaker router (test-pinned: ranking,
        # bodies, call shapes); `gol fleet` turns them on unless
        # --no-breakers. Breakers re-RANK (open workers last), never
        # remove: HRW affinity survives recovery untouched.
        self.breakers_enabled = bool(breakers)
        self._breaker_config = breaker_config or BreakerConfig()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        # Durable breaker transition ring (obs/history.HistoryWriter or
        # None): every open/half-open/close lands beside the autoscaler's
        # decisions, so "when did we rank w1 out and back in" is
        # answerable after the fact.
        self._breaker_history = breaker_history
        # The chaos mount (chaos.ProxyPool or None): when present,
        # every DATA-path forward (submits, per-job GET/DELETE, result
        # relays) resolves its target through ``chaos.url_for`` — one
        # faulty hop per worker. Health probes and metrics scrapes stay
        # direct: chaos tests the data plane's defenses, not the
        # supervisor's eyesight.
        self.chaos = chaos
        # Replica identity: which router THIS process is ("r0" is the
        # `gol fleet` primary; `gol router` replicas pick their own).
        # Stamped on /healthz and /fleet so clients and smokes can tell
        # which replica answered.
        self.router_id = router_id
        self.registry = Registry(prefix="gol_fleet")
        self._counter_floors = MonotonicCounters()
        # Durable coordination state (fleet/replicate.py): with a state
        # dir mounted, the counter floors persist after every fresh
        # scrape and re-seed on boot (merged across ALL replicas' dirs),
        # and breakers some incarnation left open re-arm warm. Without
        # one, behavior is byte-identical to the in-memory-only router.
        self._floors_store = None
        self._state_dir = state_dir
        if state_dir is not None:
            from gol_tpu_torch.fleet import replicate as _replicate

            self._floors_store = _replicate.FloorsStore(state_dir)
            self._counter_floors.seed(
                _replicate.load_merged_floors(fleet.fleet_dir)
            )
            if self.breakers_enabled:
                # Re-arm, don't re-learn: every worker some replica's
                # durable ring last recorded open/half-open starts OPEN
                # here, with a fresh cooldown — first contact is one
                # half-open probe, not fail_threshold real jobs.
                for wid in sorted(_replicate.warm_breaker_states(
                        fleet.fleet_dir)):
                    br = self.breaker(wid)
                    if br is not None:
                        br.reopen()
                        logger.warning(
                            "router %s: breaker for %s restored OPEN from "
                            "the durable ring", self.router_id, wid)
        # Single-flight scrape state (all guarded by the condition).
        self._scrape_done = threading.Condition()
        self._scrape_busy = False
        self._scrape_epoch = 0
        self._scrape_cache: tuple[dict, dict] | None = None
        self._scrape_cache_epoch = 0  # epoch that produced the cache
        # job id -> worker id, memory only (the partitions are the truth;
        # a miss rebuilds by broadcast). Bounded: entries evict when their
        # result/cancellation is fetched, with a FIFO cap as the backstop
        # for jobs whose results nobody ever collects — a router fronting
        # millions of jobs must not grow a dict forever.
        self._jobs: dict[str, str] = {}
        self._jobs_cap = 65536
        self._jobs_lock = threading.Lock()
        self._draining = False
        # The sharded single-job lane (shard/): job id -> entry
        # {state, workers, result, error, coordinator}. Coordinators run
        # on daemon threads in THIS process, leader-only (a follower
        # answers 409 and the client resubmits at the leader after
        # failover — the flock lease guarantees one driver per job).
        self._shard_jobs: dict[str, dict] = {}
        self._shard_lock = threading.Lock()
        # Durable metrics history (obs/history.py), mounted by
        # start_history: one tick thread appending the FLOORED merged
        # snapshot — the MonotonicCounters pass above is exactly what
        # makes the durable record monotonic through worker respawns.
        self._history = None
        self._history_stop = threading.Event()
        self._history_thread: threading.Thread | None = None
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def _advertise(self) -> None:
        if self._state_dir is not None:
            from gol_tpu_torch.fleet import replicate as _replicate

            _replicate.advertise(self.fleet.fleet_dir, self.router_id,
                                 self.url)

    def start(self) -> None:
        self._advertise()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="gol-fleet-http", daemon=True
        )
        self._thread.start()
        logger.info("fleet router listening on %s", self.url)

    def serve_forever(self) -> None:
        self._advertise()
        logger.info("fleet router listening on %s", self.url)
        self.httpd.serve_forever()

    def drain(self, timeout: float = 600.0) -> dict:
        """Fleet-wide graceful drain: stop admission HERE first (new jobs
        get 429 at the front door), then cascade to every worker."""
        self._draining = True
        results = self.fleet.drain_all(timeout=timeout)
        return {
            "drained": bool(results) and all(
                r.get("drained") for r in results.values()
            ),
            "workers": results,
        }

    def start_history(self, directory: str, interval: float = 1.0,
                      total_bytes: int | None = None) -> None:
        """Mount the router-side durable metrics history: every
        ``interval`` seconds one fleet-merged (and respawn-floored)
        snapshot appends to the ring in ``directory``. Default OFF — a
        router without the flag ticks nothing and allocates nothing."""
        from gol_tpu_torch.obs import history as obs_history

        if interval <= 0:
            raise ValueError(f"history interval must be > 0, got {interval}")
        if self._history is not None:
            return
        kwargs = {}
        if total_bytes is not None:
            kwargs["total_bytes"] = total_bytes
            kwargs["segment_bytes"] = min(
                obs_history.DEFAULT_SEGMENT_BYTES, max(1, total_bytes // 4)
            )
        self._history = obs_history.HistoryWriter(
            directory, source="router", **kwargs
        )
        self._history_stop.clear()

        def loop():
            while not self._history_stop.wait(interval):
                try:
                    self.history_tick()
                except Exception:  # noqa: BLE001 - telemetry must survive
                    logger.exception("router history tick failed")

        self._history_thread = threading.Thread(
            target=loop, name="gol-fleet-history", daemon=True
        )
        self._history_thread.start()

    def history_tick(self) -> None:
        """One history sample (public so tests drive it deterministically):
        the merged view the operators' dashboards read, plus the fleet
        membership gauges — the durable record answers "what was the fleet
        doing" without a second artifact."""
        if self._history is None:
            return
        _, merged = self._merged_snapshot()
        stats = self.fleet.stats()
        sample = {
            "counters": dict(merged.get("counters") or {}),
            "gauges": {
                **(merged.get("gauges") or {}),
                "fleet_workers": stats["workers"],
                "fleet_workers_healthy": stats["healthy"],
                "fleet_worker_restarts": stats["restarts"],
            },
            "histograms": dict(merged.get("histograms") or {}),
        }
        self._history.append(sample)

    def shutdown(self, cascade: bool = True) -> None:
        """Stop serving; with ``cascade`` (the SIGTERM path) drain the
        whole fleet and SIGTERM local workers first. ``cascade=False``
        abandons the workers untouched — the router-restart lane."""
        if self.autoscaler is not None:
            # Before anything else: an in-flight scale action must resolve
            # (a spawn the shutdown's kill sweep never saw would outlive
            # the fleet), and a closed autoscaler makes no new decisions.
            self.autoscaler.close()
        if self._history_thread is not None:
            self._history_stop.set()
            self._history_thread.join(timeout=5)
            self._history_thread = None
        if self._history is not None:
            self._history.close()
            self._history = None
        if self._breaker_history is not None:
            self._breaker_history.close()
            self._breaker_history = None
        if self.chaos is not None:
            self.chaos.close()
        if cascade:
            self.drain()
            self.fleet.stop_health()
            self.fleet.terminate()
        else:
            self.fleet.stop_health()
        # Voluntary lease hand-off: a surviving replica should win on its
        # very next tick, not wait for the kernel to reap this process.
        self.fleet.release_leadership()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- circuit breakers ---------------------------------------------------

    def breaker(self, worker_id: str) -> CircuitBreaker | None:
        """The worker's breaker (created lazily), or None when disabled."""
        if not self.breakers_enabled:
            return None
        with self._breakers_lock:
            br = self._breakers.get(worker_id)
            if br is None:
                br = CircuitBreaker(
                    self._breaker_config,
                    on_transition=self._on_breaker_transition,
                    label=worker_id,
                )
                self._breakers[worker_id] = br
            return br

    def breaker_states(self) -> dict[str, str]:
        """{worker id: state} for every breaker that exists ({} when the
        feature is off) — what /fleet, metrics_json, and `gol top` show."""
        if not self.breakers_enabled:
            return {}
        with self._breakers_lock:
            return {wid: br.state for wid, br in self._breakers.items()}

    def prune_breakers(self) -> None:
        """Membership-driven breaker cleanup (the chaos-proxy prune's
        sibling, same health-tick cadence): a RETIRED worker's breaker
        must not haunt /fleet, the state gauges, and the ranking forever
        — especially since scale-up reuses the lowest free partition id,
        which would hand a brand-new worker the dead one's open breaker
        and half-open trickle. Supervised respawns keep their id and so
        their breaker history ON PURPOSE: the single half-open probe is
        exactly the right first contact with a fresh process."""
        if not self.breakers_enabled:
            return
        live = {w.id for w in self.fleet.workers()}
        with self._breakers_lock:
            dead = [wid for wid in self._breakers if wid not in live]
            for wid in dead:
                del self._breakers[wid]
        for wid in dead:
            self.registry.remove_gauge("breaker_state_" + wid)

    def _on_breaker_transition(self, worker_id: str, old: str,
                               new: str) -> None:
        self.registry.set_gauge("breaker_state_" + worker_id,
                                STATE_VALUE[new])
        if new == "open":
            self.registry.inc("breaker_opens_total")
        elif new == "closed":
            self.registry.inc("breaker_closes_total")
        if self._breaker_history is not None:
            try:
                self._breaker_history.append({"breaker": {
                    "worker": worker_id, "from": old, "to": new,
                }})
            except Exception:  # noqa: BLE001 - telemetry must not break routing
                logger.exception("breaker history append failed")

    def _breaker_order(self, pool: list[Worker]) -> list[Worker]:
        """Stable-sort one already-ranked tier so open-breaker workers sink
        to ITS tail: the breaker refines the order inside each
        health/backpressure tier, it never promotes a worker past one."""
        if not self.breakers_enabled:
            return pool
        return sorted(pool, key=lambda w: (
            br.penalty() if (br := self.breaker(w.id)) is not None else 0
        ))

    def _data_url(self, worker: Worker) -> str:
        """The worker's data-path URL — through the chaos hop when one is
        mounted (`gol fleet --chaos`), direct otherwise."""
        if self.chaos is not None:
            return self.chaos.url_for(worker.url)
        return worker.url

    # -- placement + forwarding --------------------------------------------

    def candidates(self, key: placement.PlacementKey,
                   rank_label: str | None = None) -> list[Worker]:
        """Ranked forwarding order for one bucket: the rendezvous owner
        first, spillover next; workers the health loop marked unhealthy or
        backpressured sink to the tail (tried only when nothing better is
        left — routing around a worker must not turn into rejecting jobs
        the moment the last healthy worker wobbles). ``rank_label``
        overrides the HRW key (the cache tier ranks by fingerprint; the
        health/big-lane ordering is identical either way)."""
        label = rank_label if rank_label is not None else key.label()
        # Retiring workers are mid-drain (fleet/autoscale.py): they finish
        # what they hold but take NOTHING new — excluded from the walk
        # entirely, unlike backpressured workers, which tail it.
        workers = {w.id: w for w in self.fleet.workers()
                   if w.url and not w.retiring}
        if not workers:
            return []
        normal = [w for w in workers.values() if not w.big]
        bigs = [w for w in workers.values() if w.big]
        pool = normal or list(workers.values())
        ranked = [workers[wid] for wid in self._rank(label, pool)]
        if bigs and key.max_edge > self.big_edge:
            big_ranked = [workers[wid] for wid in self._rank(label, bigs)]
            ranked = big_ranked + [w for w in ranked if not w.big]
        order = self._breaker_order(
            [w for w in ranked if w.healthy and not w.backpressure]
        )
        order += self._breaker_order(
            [w for w in ranked if w.healthy and w.backpressure]
        )
        order += [w for w in ranked if not w.healthy]
        # Small jobs normally never touch the big lane (its compile budget
        # and rings are reserved for mesh-sharded boards), but a healthy
        # big worker beats a fleet-wide 503 when every normal worker is
        # unreachable — workers re-bucket jobs themselves, so spillover
        # there is correctness-safe. Tail it as the true last resort.
        in_order = {w.id for w in order}
        order += [w for w in bigs if w.healthy and w.id not in in_order]
        return order

    def _rank(self, label: str, pool: list[Worker]) -> list[str]:
        """One pool's HRW order: plain rank, or — with ``--affinity`` —
        weighted rank over the pool's capacity weights. The weighted path
        with all-equal weights delegates to plain rank inside placement,
        so affinity-on-with-no-weights is byte-identical to off."""
        if self.affinity_route:
            return placement.rank_weighted(label, affinity.weights_for(pool))
        return placement.rank(label, [w.id for w in pool])

    # -- the sharded single-job lane (shard/) -------------------------------

    def _shard_participant(self, worker_id: str):
        """An HttpParticipant whose URL is re-read from the fleet record
        on EVERY call (a respawned partition answers on a new port) and
        resolved through the chaos hop when one is mounted — halo peers
        and coordinator RPCs ride the same faulty data path as submits."""
        from gol_tpu_torch.shard.coordinator import HttpParticipant

        def url():
            worker = self.fleet.worker(worker_id)
            if worker is None or not worker.url:
                return None
            return self._data_url(worker)

        return HttpParticipant(worker_id, url)

    def _shard_membership(self, initial_ids):
        """The coordinator's elastic-membership hook: consulted at
        checkpoint barriers, reporting a change only when the eligible
        pool GREW (the autoscaler added workers — HRW moves only the
        tiles the new workers win). Shrinks are deliberately ignored: a
        dead worker is a RECOVERY (its journal replays), not a
        membership change, and a retiring one finishes its shard."""
        state = {"ids": set(initial_ids)}

        def hook():
            pool = self.fleet.shard_pool()
            ids = {w.id for w in pool}
            if not ids > state["ids"]:
                return None
            merged = sorted(state["ids"] | ids)
            state["ids"] = set(merged)
            return [self._shard_participant(wid) for wid in merged]

        return hook

    def _submit_shard(self, body: dict):
        """``POST /jobs`` with ``"shard": true`` — one giant universe
        spanning the worker set. 202 with the job id; progress and the
        merged result come from the usual GET endpoints."""
        if not self.fleet.leading:
            return 409, {
                "error": "shard jobs run on the leader router; this "
                         "replica holds no flock lease",
            }
        missing = [k for k in ("rle", "width", "height") if k not in body]
        if missing:
            raise ValueError(
                f"missing required field(s) for a shard job: {missing}"
            )
        pool = self.fleet.shard_pool()
        if not pool:
            return 503, {"error": "fleet has no routable workers"}
        from gol_tpu_torch.shard.coordinator import ShardCoordinator

        job_id = uuid.uuid4().hex
        spec = {
            k: body[k] for k in (
                "rle", "x", "y", "width", "height", "tile", "convention",
                "gen_limit", "check_similarity", "similarity_frequency",
            ) if k in body
        }
        ids = [w.id for w in pool]
        coordinator = ShardCoordinator(
            job_id, spec,
            [self._shard_participant(wid) for wid in ids],
            checkpoint_every=int(body.get("checkpoint_every", 0) or 8),
            registry=self.registry,
            membership=self._shard_membership(ids),
        )
        entry = {
            "id": job_id, "state": "running", "workers": ids,
            "result": None, "error": None, "coordinator": coordinator,
        }
        with self._shard_lock:
            self._shard_jobs[job_id] = entry
        thread = threading.Thread(
            target=self._run_shard, args=(job_id, coordinator),
            name=f"gol-shard-{job_id[:8]}", daemon=True,
        )
        thread.start()
        return 202, {"id": job_id, "state": "running", "shard": True,
                     "workers": ids}

    def _run_shard(self, job_id: str, coordinator) -> None:
        try:
            result = coordinator.run()
        except Exception as e:  # noqa: BLE001 — the job must reach a
            # terminal state whatever the coordinator died of; the error
            # is surfaced verbatim on GET.
            logger.error("shard job %s failed: %s", job_id, e)
            with self._shard_lock:
                entry = self._shard_jobs[job_id]
                entry["state"] = "failed"
                entry["error"] = str(e)
            self.registry.inc("shard_jobs_failed_total")
            return
        with self._shard_lock:
            entry = self._shard_jobs[job_id]
            entry["state"] = "done"
            entry["result"] = result
        self.registry.inc("shard_jobs_done_total")

    def shard_job_json(self, job_id: str) -> dict | None:
        """GET /jobs/<id> for a shard job (None: not a shard job — the
        caller falls through to the forwarding path)."""
        with self._shard_lock:
            entry = self._shard_jobs.get(job_id)
            if entry is None:
                return None
            out = {"id": job_id, "state": entry["state"], "shard": True,
                   "workers": list(entry["workers"])}
            coordinator = entry["coordinator"]
            out["superstep"] = coordinator.k
            out["durable_superstep"] = coordinator.durable
            out["recoveries"] = coordinator.recoveries
            if entry["error"]:
                out["error"] = entry["error"]
            if entry["state"] == "done":
                result = dict(entry["result"])
                result.pop("rle", None)  # the board rides /result/<id>
                out["result"] = result
            return out

    def shard_result(self, job_id: str):
        """GET /result/<id> for a shard job: (status, payload), or None
        to fall through to the forwarding path."""
        with self._shard_lock:
            entry = self._shard_jobs.get(job_id)
            if entry is None:
                return None
            if entry["state"] == "failed":
                return 410, {"id": job_id, "state": "failed",
                             "error": entry["error"]}
            if entry["state"] != "done":
                return 409, {"id": job_id, "state": entry["state"],
                             "error": "shard job is still running"}
            return 200, {"id": job_id, "state": "done",
                         **entry["result"]}

    def shard_cancel(self, job_id: str):
        """DELETE /jobs/<id> for a shard job: running super-steps are not
        cancellable mid-barrier (the answer the single-server scheduler
        gives for claimed jobs)."""
        with self._shard_lock:
            entry = self._shard_jobs.get(job_id)
            if entry is None:
                return None
            return 409, {
                "id": job_id, "state": entry["state"],
                "error": "shard jobs are not cancellable",
            }

    def route_submit(self, raw: bytes, content_type: str | None = None,
                     deadline_header: str | None = None):
        """(status, payload) for POST /jobs: place, forward, spill.

        A PACKED body (``Content-Type: application/x-gol-packed``) is
        placed from its frame header + meta alone (``wire.peek``: ~24
        bytes plus the meta JSON — no payload read, no CRC pass, no board
        unpack) and forwarded as the SAME raw buffer under the same
        content type: the router touches a few dozen bytes of a multi-MB
        submit instead of JSON-parsing all of it. The text path is
        byte-identical to pre-wire routing (test-pinned).

        ``deadline_header`` is the client's ``X-Gol-Deadline`` remaining
        budget: enforced here (a spent budget answers 504 without any
        forward) and DECREMENTED by the router's own elapsed time before
        every hop of the spillover walk — each worker sees only what is
        genuinely left. Absent (every old client), nothing changes
        (pinned); malformed values drop silently."""
        if self._draining:
            self.registry.inc("jobs_rejected_total")
            return 429, {"error": "fleet is draining; not accepting jobs"}
        deadline = None
        budget = propagate.decode_deadline(deadline_header)
        if budget is not None:
            if budget <= 0:
                self.registry.inc("deadline_expired_total")
                return 504, {
                    "error": f"deadline budget spent before the router "
                             f"could place the job ({budget:.3f}s "
                             "remaining)",
                }
            deadline = (budget, time.perf_counter())
        ctype = wire.content_type_of(content_type)
        packed = ctype == wire.CONTENT_TYPE
        if not packed and ctype.startswith(wire.CONTENT_TYPE_FAMILY):
            # A gol wire revision this router does not speak: 415 without
            # forwarding (the router could not even place it), the same
            # retry-as-text signal the workers emit.
            return 415, {
                "error": f"unsupported content type {ctype}; this router "
                         f"speaks {wire.CONTENT_TYPE} and application/json",
            }
        if packed:
            width, height, meta = wire.peek(raw)  # UnsupportedWire -> 415
            body = {**meta, "width": width, "height": height}
        else:
            body = json.loads(raw.decode("utf-8"))
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        if body.get("shard"):
            # The sharded single-job lane: this router COORDINATES the
            # job across its workers instead of forwarding it to one.
            if packed:
                return 400, {
                    "error": "shard jobs take the text form (rle field); "
                             "the packed frame cannot be re-sliced here",
                }
            return self._submit_shard(body)
        key = placement.key_for(body)  # raises -> handler's 400
        rank_label = None
        if self.cache_route and not body.get("no_cache"):
            # Fleet cache tier: repeats of a board must land where its
            # answer is cached, so the HRW key is the result fingerprint
            # (cache/fingerprint.py). Packed bodies key
            # through the frame's own payload CRC (packed_body_fingerprint
            # — no unpack; format-scoped, so packed repeats of a board
            # deterministically share an owner). A body the fingerprinter
            # rejects falls back to bucket routing — the worker's full
            # validation still answers the client.
            from gol_tpu_torch.cache import fingerprint as fp_mod

            try:
                if packed:
                    rank_label = "fp:" + fp_mod.packed_body_fingerprint(raw)
                else:
                    rank_label = "fp:" + fp_mod.body_fingerprint(body)
                self.registry.inc("jobs_cache_routed_total")
            except (ValueError, TypeError, KeyError):
                rank_label = None
        order = self.candidates(key, rank_label=rank_label)
        if not order:
            return 503, {"error": "fleet has no routable workers"}
        # Trace-context propagation (obs/propagate.py), ONLY while tracing
        # is enabled (`gol fleet --trace`): one fleet-wide trace id per
        # submit — spillover hops re-send the SAME id, so however many
        # workers the walk visits, the job is one flow chain. The flow
        # START is stamped at forward time; the adopting worker's claim
        # point closes the router→worker fleet-queueing gap that
        # `gol trace-report` measures. Disabled (the default), this block
        # allocates nothing and the forwarded request is byte-identical
        # to the headerless wire format (test-pinned).
        wire_ct = wire.CONTENT_TYPE if packed else None
        if not obs_trace.enabled():
            # The disabled path builds NOTHING extra — no header, no span
            # attributes, no candidate-ranking string: byte-identical
            # requests and no extra work per submit (test-pinned).
            return self._forward_submit(raw, key, order, None, wire_ct,
                                        deadline)
        trace_id = propagate.new_trace_id()
        headers = {propagate.TRACE_HEADER: propagate.encode(
            trace_id, propagate.sender_label()
        )}
        obs_trace.flow("job", trace_id, "s", bucket=key.label())
        with obs_trace.span(
            "fleet.submit", bucket=key.label(),
            candidates=",".join(w.id for w in order),
            cache_route=bool(rank_label),
        ):
            return self._forward_submit(raw, key, order, headers, wire_ct,
                                        deadline)

    def _forward_submit(self, raw: bytes, key: placement.PlacementKey,
                        order: list[Worker], headers: dict | None,
                        content_type: str | None = None,
                        deadline: tuple[float, float] | None = None):
        """The spillover walk: try workers in ranked order; spans/events
        record each hop without ever changing a status code. ``raw`` is
        forwarded verbatim under ``content_type`` (the zero-copy contract:
        a packed frame leaves this process as the byte buffer it arrived
        in; the kwarg is omitted entirely for text, keeping the pre-wire
        call shape byte-identical).

        With breakers on, every hop's outcome feeds the worker's breaker
        (an HTTP answer of any status is a live worker; connection-level
        failures are not). With a ``deadline`` (budget, received_at), each
        hop re-derives the remaining budget, stamps it on the forwarded
        header, and caps the hop's timeout by it — a walk never spends
        more wall clock than the client has left."""
        last = (503, {"error": "no worker accepted the job"})
        small = key.max_edge <= self.big_edge
        shed_seen = False  # any 429: keep it as the client's answer
        normal_shed = False  # a NORMAL worker shed: skip big-lane tails
        http_kwargs = {"headers": headers} if headers else {}
        if content_type is not None:
            http_kwargs["content_type"] = content_type
        # Two-pass walk: a worker whose breaker answers on_attempt()=False
        # at forward time (another caller's half-open probe is in flight,
        # or the ranking raced the breaker opening) is DEFERRED, not
        # forwarded — the single-probe contract holds under concurrency —
        # and retried only after every normally-ranked candidate failed:
        # an open worker stays the last resort, never removed.
        queue = list(order)
        deferred: list[Worker] = []
        while queue or deferred:
            if queue:
                worker = queue.pop(0)
                last_resort = False
            else:
                worker = deferred.pop(0)
                last_resort = True
            if worker.big and small and normal_shed:
                # The big lane is the last resort for small jobs ONLY
                # against unreachable normals. A normal worker's 429
                # means the fleet is alive and load-shedding on purpose:
                # the client must see that backpressure, not have its
                # overflow silently compiled onto the lane reserved for
                # mesh-sharded boards. (A 429 from a BIG worker sets no
                # such signal — when bigs are the pool, or the tail is
                # mid-walk, the next big still gets its try.)
                continue
            br = self.breaker(worker.id)
            if br is not None and not br.on_attempt() and not last_resort:
                deferred.append(worker)
                continue
            crc_retried = False
            while True:
                # Stamped PER ATTEMPT: the CRC re-forward below must
                # re-derive the remaining budget (and re-check expiry) —
                # reusing the first attempt's header would hand the
                # worker the time a slow corrupted hop already spent.
                hop_kwargs = dict(http_kwargs)
                timeout = self.submit_timeout
                if deadline is not None:
                    budget, received = deadline
                    remaining = budget - (time.perf_counter() - received)
                    if remaining <= 0:
                        # The walk itself spent the budget (slow earlier
                        # hops): stop forwarding — the client is gone.
                        self.registry.inc("deadline_expired_total")
                        return 504, {
                            "error": "deadline budget spent during the "
                                     f"spillover walk ({budget:.3f}s "
                                     "granted)",
                        }
                    hdrs = dict(hop_kwargs.get("headers") or {})
                    hdrs[propagate.DEADLINE_HEADER] = (
                        propagate.encode_deadline(remaining)
                    )
                    hop_kwargs["headers"] = hdrs
                    timeout = min(self.submit_timeout, max(0.05, remaining))
                hop_started = time.perf_counter()
                try:
                    with obs_trace.span("fleet.forward", worker=worker.id,
                                        big=worker.big):
                        status, payload = self.http(
                            "POST", self._data_url(worker) + "/jobs",
                            raw=raw, timeout=timeout,
                            **hop_kwargs,
                        )
                except (urllib.error.URLError, ConnectionError,
                        OSError) as err:
                    self.registry.inc("route_errors_total")
                    if br is not None:
                        br.on_failure()
                    if not _delivery_impossible(err):
                        # A timeout/reset AFTER the bytes went out is
                        # ambiguous — the worker may have accepted and
                        # journaled the job (first-dispatch compiles can
                        # outlive submit_timeout). Spilling here would run
                        # the board twice under two ids; surface the
                        # ambiguity — naming WHERE the outcome is unknown
                        # and that worker's breaker state, so the client
                        # (and the operator reading its stderr) knows which
                        # partition to audit — and let the client decide
                        # (poll /fleet, resubmit knowingly).
                        obs_trace.event("fleet.ambiguous", worker=worker.id,
                                        error=type(err).__name__)
                        return 504, {
                            "error": f"worker {worker.id} did not answer "
                                     "the submit in time; outcome unknown "
                                     "— the job may have been accepted "
                                     "there",
                            "worker": worker.id,
                            **({"breaker": br.state} if br is not None
                               else {}),
                        }
                    # Nothing was delivered: spilling is safe. A 429
                    # already seen stays the answer — Retry-After is
                    # actionable, "unreachable" is not.
                    obs_trace.event("fleet.spill", worker=worker.id,
                                    reason="unreachable")
                    if not shed_seen:
                        last = (503, {
                            "error": f"worker {worker.id} unreachable: "
                                     f"{err}",
                        })
                    status = None  # spill to the next-ranked worker
                    break
                if br is not None:
                    br.on_success(time.perf_counter() - hop_started)
                if (status == 400 and not crc_retried
                        and wire.is_crc_error(payload)):
                    # The worker's CRC gate caught a frame corrupted ON
                    # THIS HOP (the router placed the frame from a
                    # well-formed header, and a 400 created no job, so a
                    # re-send is unconditionally safe): one retry of the
                    # same buffer turns a transit bit-flip into a
                    # transparent recovery instead of a client-visible
                    # 400. A second CRC failure returns — the corruption
                    # is then upstream of this router.
                    self.registry.inc("wire_crc_retries_total")
                    obs_trace.event("fleet.crc_retry", worker=worker.id)
                    crc_retried = True
                    continue
                break
            if status is None:
                continue  # unreachable: next candidate
            if status == 429:
                # The worker is shedding (SLO burn) or full: drain it of
                # new work and spill to the next-ranked worker — the
                # client only sees a 429 when the WHOLE fleet sheds.
                self.fleet.note_shed(worker.id)
                self.registry.inc("route_sheds_total")
                obs_trace.event("fleet.spill", worker=worker.id,
                                reason="shed")
                shed_seen = True
                normal_shed = normal_shed or not worker.big
                last = (status, payload)
                continue
            if status == 202 and isinstance(payload, dict) and "id" in payload:
                with self._jobs_lock:
                    self._jobs[payload["id"]] = worker.id
                    while len(self._jobs) > self._jobs_cap:
                        # FIFO: dict order is insertion order; a dropped
                        # mapping costs one broadcast on the next lookup.
                        self._jobs.pop(next(iter(self._jobs)))
                self.registry.inc("jobs_routed_total")
                self.registry.inc(
                    "jobs_routed_total_" + ("big" if worker.big else worker.id)
                )
                payload = {**payload, "worker": worker.id}
            # Client errors (400) return from the first worker verbatim:
            # a malformed job is malformed everywhere.
            return status, payload
        return last

    def forward_job(self, method: str, job_id: str, suffix: str = "",
                    accept: str | None = None):
        """(status, payload) for the per-job endpoints: the mapped worker
        first, then broadcast (the map is memory-only; after a router
        restart the workers' journals are the only truth and whoever
        answers non-404 owns the job).

        ``accept`` forwards the client's Accept header (the packed wire
        result fetch): when the worker answers in the packed content type,
        ``payload`` comes back as the raw frame BYTES — relayed verbatim,
        never decoded here — and the handler writes them out under the
        worker's content type. Every other response (and every error)
        stays the parsed-JSON contract."""
        path = ("/result/" if suffix == "result" else "/jobs/") + job_id
        if suffix not in ("", "result"):
            path = f"/jobs/{job_id}/{suffix}"
        with self._jobs_lock:
            owner = self._jobs.get(job_id)
        workers = self.fleet.workers()
        ordered = sorted(
            [w for w in workers if w.url],
            key=lambda w: w.id != owner,  # mapped owner first
        )
        # A worker mid-(re)boot has no URL yet; the job may be in its
        # partition (replaying right now), so "not found" would be a lie —
        # it counts as unreachable, which clients treat as transient.
        unreachable = sum(1 for w in workers if not w.url)
        for worker in ordered:
            try:
                if accept is not None:
                    status, ctype, body = self.http_exchange(
                        method, self._data_url(worker) + path, timeout=30,
                        headers={"Accept": accept},
                    )
                    if wire.is_packed(ctype):
                        payload = body  # relay the frame bytes untouched
                    else:
                        payload = client._parse(body)
                else:
                    status, payload = self.http(
                        method, self._data_url(worker) + path, timeout=30
                    )
            except (urllib.error.URLError, ConnectionError, OSError):
                unreachable += 1
                continue
            if status == 404:
                continue
            # The mapping's useful life ends when the client collects the
            # terminal answer: a fetched result (200) or tombstone (410 =
            # failed/cancelled), or a successful DELETE. Evict then — the
            # rare re-fetch pays one broadcast; the map stays bounded.
            terminal = (
                (suffix == "result" and status in (200, 410))
                or (method == "DELETE" and status == 200)
            )
            with self._jobs_lock:
                if terminal:
                    self._jobs.pop(job_id, None)
                elif owner is None:
                    self._jobs.setdefault(job_id, worker.id)
                    while len(self._jobs) > self._jobs_cap:
                        self._jobs.pop(next(iter(self._jobs)))
            return status, payload
        if unreachable:
            # The job may live on the unreachable worker(s): "not found"
            # would be a lie, and clients treat 5xx as transient (the
            # worker-respawn window) — exactly the semantics wanted here.
            return 503, {"error": f"job {job_id} not found on reachable "
                                  f"workers; {unreachable} worker(s) "
                                  "unreachable"}
        return 404, {"error": f"unknown job {job_id}"}

    # -- merged observability ----------------------------------------------

    def _collect(self, path: str) -> dict[str, dict | None]:
        """Fetch one path from every worker CONCURRENTLY: with a serial
        sweep, each unreachable worker would add its full connect timeout
        to every /metrics and /slo response — freezing `gol top` and
        blowing scrape deadlines exactly during the outage the operator
        is debugging."""
        workers = self.fleet.workers()
        out: dict[str, dict | None] = {w.id: None for w in workers}
        lock = threading.Lock()

        def fetch(worker: Worker):
            payload = None
            if worker.url is not None:
                try:
                    status, body = self.http("GET", worker.url + path,
                                             timeout=5)
                    if status == 200 and isinstance(body, dict):
                        payload = body
                except (urllib.error.URLError, ConnectionError, OSError):
                    payload = None
            with lock:
                out[worker.id] = payload

        threads = [threading.Thread(target=fetch, args=(w,), daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        # Copy under the lock: a straggler fetch outliving its join
        # timeout still writes to `out` — the caller's dict (cached and
        # shared across scraper threads) must never mutate underfoot.
        with lock:
            return dict(out)

    def _merged_snapshot(self) -> tuple[dict, dict]:
        """Collect + floor + merge, SINGLE-FLIGHT: concurrent scrapes
        (gol top's JSON view and the Prometheus text view run on separate
        HTTP threads) must not feed MonotonicCounters out of snapshot
        order — a pre-respawn snapshot adjusted AFTER a newer post-respawn
        one would bank the old incarnation's total twice and inflate the
        merged series forever. Scrapes therefore never overlap, but a
        late arrival does not queue its OWN full fan-out behind the
        in-flight one (which lasts up to a dead worker's connect timeout
        — exactly the frozen-`gol top`-mid-outage latency the concurrent
        _collect exists to avoid): it waits for the in-flight scrape and
        shares its result."""
        with self._scrape_done:
            while self._scrape_busy:
                epoch = self._scrape_epoch
                self._scrape_done.wait(timeout=30)
                # Share a result only if the scrape we waited on SET it:
                # a scrape that raised bumps the epoch without updating
                # the cache, and serving an arbitrarily old snapshot as
                # if fresh would silently freeze /metrics — fall through
                # and scrape (and likely surface the same error).
                if (self._scrape_epoch != epoch
                        and self._scrape_cache_epoch == self._scrape_epoch
                        and self._scrape_cache is not None):
                    return self._scrape_cache
            # not busy (anymore): this thread does the scrape
            self._scrape_busy = True
        result = None
        try:
            # Restart generations are read BEFORE collecting: a respawn
            # completing in between yields (old generation, fresh
            # snapshot) — the value-regression fallback banks it. The
            # reverse pairing (new generation, stale snapshot) would
            # bank the old run twice.
            incarnations = {w.id: w.restarts for w in self.fleet.workers()}
            snaps = self._collect("/metrics?format=json")
            merged = merge_metrics(self._counter_floors.adjust(
                {k: v for k, v in snaps.items() if v}, incarnations
            ))
            if self._floors_store is not None:
                # Persist what this scrape banked (no-op when unmoved):
                # the merged series' monotonicity now survives THIS
                # router dying, not just the workers.
                self._floors_store.save(self._counter_floors.state())
            result = (snaps, merged)
            return result
        finally:
            with self._scrape_done:
                self._scrape_busy = False
                self._scrape_epoch += 1
                if result is not None:
                    self._scrape_cache = result
                    self._scrape_cache_epoch = self._scrape_epoch
                self._scrape_done.notify_all()

    def metrics_json(self) -> dict:
        self.registry.set_gauge("router_leader",
                                1 if self.fleet.leading else 0)
        snaps, merged = self._merged_snapshot()
        # The snapshot may be shared with concurrent scrapers: never
        # mutate it in place.
        merged = dict(merged)
        health = {w.id: w.public() for w in self.fleet.workers()}
        workers = {}
        for wid, snap in snaps.items():
            entry = dict(snap) if snap else {"unreachable": True}
            entry["health"] = health.get(wid, {})
            workers[wid] = entry
        merged["workers"] = workers
        routers = []
        if self._state_dir is not None:
            from gol_tpu_torch.fleet import replicate as _replicate

            routers = _replicate.list_routers(self.fleet.fleet_dir)
        merged["fleet"] = {
            **self.fleet.stats(),
            # Which replica answered this scrape, whether it leads, and
            # the advertised replica roster — `gol top`'s control-plane
            # panel (absent for embedded routers with no state dir, so
            # their payloads stay byte-identical).
            "router_id": self.router_id,
            "leader": self.fleet.leading,
            **({"routers": routers} if routers else {}),
            "draining": self._draining,
            "router": self.registry.snapshot(),
            **({"breakers": self.breaker_states()}
               if self.breakers_enabled else {}),
            **({"autoscaler": self.autoscaler.public()}
               if self.autoscaler is not None else {}),
        }
        return merged

    def metrics_prometheus(self) -> str:
        _, merged = self._merged_snapshot()
        stats = self.fleet.stats()
        fleet_gauges = {
            "workers": stats["workers"],
            "workers_healthy": stats["healthy"],
            "workers_backpressured": stats["backpressured"],
            # 1 on the replica that holds the leader lease (or on any
            # lease-less single-router fleet) — sum across replicas on a
            # dashboard and alert on != 1.
            "router_leader": 1 if self.fleet.leading else 0,
        }
        fleet_counters = {
            "worker_restarts": stats["restarts"],
            "jobs_routed_total": self.registry.counter("jobs_routed_total"),
            "route_sheds_total": self.registry.counter("route_sheds_total"),
            "route_errors_total": self.registry.counter("route_errors_total"),
        }
        # Deadline enforcement and the CRC-retry lane run whether or not
        # breakers are mounted — their counters export unconditionally
        # (a --no-breakers fleet 504ing on spent deadlines must not show
        # zero expiries on the dashboard).
        for name in ("deadline_expired_total", "wire_crc_retries_total"):
            fleet_counters[name] = self.registry.counter(name)
        if self.breakers_enabled:
            # The breaker series (same flat-name convention as the
            # per-worker jobs_routed_total_<wid> counters): per-worker
            # state gauges plus the open/close transition counters.
            for name in ("breaker_opens_total", "breaker_closes_total"):
                fleet_counters[name] = self.registry.counter(name)
            for wid, state in sorted(self.breaker_states().items()):
                fleet_gauges["breaker_state_" + wid] = STATE_VALUE[state]
        if self.autoscaler is not None:
            snap = self.registry.snapshot()
            for name, value in (snap.get("gauges") or {}).items():
                if name.startswith("autoscaler_"):
                    fleet_gauges[name] = value
            for name, value in (snap.get("counters") or {}).items():
                if name.startswith("autoscaler_"):
                    fleet_counters[name] = value
        return merged_prometheus(merged, fleet_gauges, fleet_counters)

    def slo_json(self) -> dict:
        return merge_slo(self._collect("/slo"))

    def fleet_json(self) -> dict:
        routers = []
        if self._state_dir is not None:
            from gol_tpu_torch.fleet import replicate as _replicate

            routers = _replicate.list_routers(self.fleet.fleet_dir)
        return {
            "fleet_dir": self.fleet.fleet_dir,
            "router_id": self.router_id,
            "leader": self.fleet.leading,
            **({"routers": routers} if routers else {}),
            "draining": self._draining,
            "big_edge": self.big_edge,
            "cache_route": self.cache_route,
            "affinity": self.affinity_route,
            **({"breakers": self.breaker_states()}
               if self.breakers_enabled else {}),
            **({"chaos": self.chaos.stats()}
               if self.chaos is not None else {}),
            **({"autoscaler": self.autoscaler.public()}
               if self.autoscaler is not None else {}),
            "workers": [w.public() for w in self.fleet.workers()],
        }


def _make_handler(router: RouterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 120  # a submit forward can sit behind a worker compile

        def log_message(self, format, *args):  # noqa: A002 - stdlib signature
            logger.debug("%s - %s", self.address_string(), format % args)

        def _reply(self, code: int, payload, content_type="application/json",
                   headers=None):
            if isinstance(payload, (bytes, bytearray)):
                body = bytes(payload)  # packed wire frames relay verbatim
            elif content_type == "application/json":
                body = json.dumps(payload).encode("utf-8")
            else:
                body = payload.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            if code >= 400:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _read_raw(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            cap = wire.max_body_bytes(self.headers.get("Content-Type"))
            if length > cap:
                raise ValueError(f"body of {length} bytes exceeds {cap}")
            return self.rfile.read(length) if length else b"{}"

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                if path == "/jobs":
                    status, payload = router.route_submit(
                        self._read_raw(),
                        content_type=self.headers.get("Content-Type"),
                        deadline_header=self.headers.get(
                            propagate.DEADLINE_HEADER
                        ),
                    )
                    headers = None
                    if status == 429 and "retry_after_s" in (payload or {}):
                        headers = {"Retry-After":
                                   str(int(payload["retry_after_s"]))}
                    self._reply(status, payload, headers=headers)
                elif path == "/drain":
                    self._read_raw()
                    self._reply(200, router.drain())
                else:
                    self._read_raw()
                    self._reply(404, {"error": f"no such endpoint {path}"})
            except wire.UnsupportedWire as e:
                # A newer wire revision than this router speaks: 415, the
                # client's retry-as-text signal (same as the workers).
                self._reply(415, {"error": str(e)})
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})

        def do_DELETE(self):
            path = urlparse(self.path).path
            if not path.startswith("/jobs/"):
                self._reply(404, {"error": f"no such endpoint {path}"})
                return
            job_id = path[len("/jobs/"):]
            shard = router.shard_cancel(job_id)
            if shard is not None:
                self._reply(*shard)
                return
            self._reply(*router.forward_job("DELETE", job_id))

        def do_GET(self):
            parsed = urlparse(self.path)
            path = parsed.path
            if path.startswith("/jobs/"):
                rest = path[len("/jobs/"):]
                if rest.endswith("/timeline"):
                    self._reply(*router.forward_job(
                        "GET", rest[: -len("/timeline")], "timeline"
                    ))
                else:
                    shard = router.shard_job_json(rest)
                    if shard is not None:
                        self._reply(200, shard)
                    else:
                        self._reply(*router.forward_job("GET", rest))
            elif path.startswith("/result/"):
                shard = router.shard_result(path[len("/result/"):])
                if shard is not None:
                    self._reply(*shard)
                    return
                accept = self.headers.get("Accept")
                if wire.accepts_packed(accept):
                    status, payload = router.forward_job(
                        "GET", path[len("/result/"):], "result",
                        accept=wire.CONTENT_TYPE,
                    )
                    self._reply(
                        status, payload,
                        content_type=(
                            wire.CONTENT_TYPE
                            if isinstance(payload, (bytes, bytearray))
                            else "application/json"
                        ),
                    )
                else:
                    self._reply(*router.forward_job(
                        "GET", path[len("/result/"):], "result"
                    ))
            elif path == "/metrics":
                fmt = parse_qs(parsed.query).get("format", ["prometheus"])[0]
                if fmt == "json":
                    self._reply(200, router.metrics_json())
                else:
                    self._reply(200, router.metrics_prometheus(),
                                content_type="text/plain; version=0.0.4")
            elif path == "/slo":
                self._reply(200, router.slo_json())
            elif path == "/debug/trace":
                # The router's span ring, same shape as the worker
                # endpoint — what `gol fleet-trace` stitches per process.
                tracer = obs_trace.tracer()
                self._reply(200, {
                    "enabled": tracer.enabled,
                    "meta": tracer.metadata(),
                    "spans": tracer.snapshot(),
                    "registry": obs_registry.default().snapshot(),
                })
            elif path == "/fleet":
                self._reply(200, router.fleet_json())
            elif path == "/healthz":
                self._reply(200, {
                    "ok": True,
                    "router": True,
                    "id": router.router_id,
                    "leader": router.fleet.leading,
                    "draining": router._draining,
                    "fleet": router.fleet.stats(),
                })
            else:
                self._reply(404, {"error": f"no such endpoint {path}"})

    return Handler
