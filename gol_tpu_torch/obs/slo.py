"""Service-level objectives over rolling registry windows.

The port's copy of ``gol_tpu/obs/slo.py``: the same objectives, burn-rate
rules and rendering, so ``gol slo-report`` summarizes a ``/slo`` payload or
a flight dump's ``slo`` state record as the JAX package does.

- An ``Objective`` declares a target over a registry series: per-priority
  p99 latency, error rate (counter deltas) or saturation (gauge over
  capacity).
- ``SloEngine`` keeps a rolling deque of timestamped registry snapshots
  (``time.perf_counter()`` only) and evaluates every objective over several
  windows (default 60 s and 300 s) as a burn rate, observed / target.
- An objective is ``warning`` when its burn clears ``warn_burn`` on every
  window and ``critical`` when it clears ``critical_burn`` on every window;
  the overall status is the worst objective's (``render_status``).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time

logger = logging.getLogger(__name__)

OK = "ok"
WARNING = "warning"
CRITICAL = "critical"
_RANK = {OK: 0, WARNING: 1, CRITICAL: 2}

DEFAULT_WINDOWS = (60.0, 300.0)
STATE_PROVIDER = "slo"


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective over a registry series.

    ``kind`` selects the evaluation rule:

    - ``latency``    — ``source`` is a histogram; observed = its
      ``quantile`` (p99 by default); burn = observed / target seconds.
    - ``error_rate`` — ``source`` is the bad-event counter, ``total`` the
      traffic counter; observed = bad delta / total delta over the window;
      burn = observed / target ratio.
    - ``saturation`` — ``source`` is a gauge; observed = max(gauge) /
      ``capacity`` over the window; burn = observed / target fraction.
    """

    name: str
    kind: str  # "latency" | "error_rate" | "saturation"
    target: float
    source: str
    total: str = ""  # error_rate denominator counter
    capacity: float = 1.0  # saturation denominator
    quantile: float = 0.99

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate", "saturation"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.target <= 0:
            raise ValueError(f"objective {self.name}: target must be > 0")
        if self.kind == "error_rate" and not self.total:
            raise ValueError(
                f"objective {self.name}: error_rate needs a total counter"
            )
        if self.kind == "saturation" and self.capacity <= 0:
            raise ValueError(
                f"objective {self.name}: saturation needs capacity > 0"
            )


def default_objectives(
    max_queue_depth: int,
    latency_target_s: float = 60.0,
    error_budget: float = 0.01,
    queue_target: float = 0.8,
) -> list[Objective]:
    """The serving defaults: p99 end-to-end latency per priority class,
    failed-over-accepted error rate, and queue-depth saturation — every
    series the scheduler already feeds its Metrics registry."""
    objectives = [
        Objective(
            name=f"latency_p99_{cls}",
            kind="latency",
            target=latency_target_s,
            source=f"job_latency_seconds_{cls}",
        )
        for cls in ("high", "normal", "low")
    ]
    objectives.append(Objective(
        name="error_rate",
        kind="error_rate",
        target=error_budget,
        source="jobs_failed_total",
        total="jobs_accepted_total",
    ))
    objectives.append(Objective(
        name="queue_saturation",
        kind="saturation",
        target=queue_target,
        source="queue_depth",
        capacity=float(max_queue_depth),
    ))
    return objectives


class SloEngine:
    """Rolling-window evaluation of objectives over one registry."""

    def __init__(
        self,
        objectives,
        registry,
        windows=DEFAULT_WINDOWS,
        warn_burn: float = 1.0,
        critical_burn: float = 2.0,
        shed: bool = False,
        retry_after_s: float = 5.0,
        clock=time.perf_counter,
    ):
        if not objectives:
            raise ValueError("need at least one objective")
        self.objectives = list(objectives)
        self.registry = registry
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows or self.windows[0] <= 0:
            raise ValueError(f"windows must be positive, got {windows}")
        self.warn_burn = warn_burn
        self.critical_burn = critical_burn
        self.shed = shed
        self.retry_after_s = retry_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque()  # (t, snap)
        self._last: dict | None = None
        self._last_at: float | None = None
        self._was_critical: set[str] = set()

    # -- sampling ----------------------------------------------------------

    def sample(self) -> None:
        """Append a timestamped registry snapshot and prune beyond the
        longest window (keeping one older sample as the window baseline)."""
        now = self._clock()
        snap = self.registry.snapshot()
        horizon = now - self.windows[-1]
        with self._lock:
            self._samples.append((now, snap))
            # Keep exactly one sample at-or-older than the horizon: it is
            # the baseline of the longest window's delta.
            while (len(self._samples) >= 2
                   and self._samples[1][0] <= horizon):
                self._samples.popleft()

    def _window_bounds(self, samples, now: float, window: float):
        """(baseline, newest) snapshots for one window: the newest sample at
        least ``window`` old, or the oldest available while the engine is
        younger than the window."""
        target = now - window
        baseline = samples[0]
        for t, snap in samples:
            if t <= target:
                baseline = (t, snap)
            else:
                break
        return baseline, samples[-1]

    # -- evaluation --------------------------------------------------------

    def _eval_objective(self, obj: Objective, samples, now: float) -> dict:
        windows = {}
        burns = []
        for window in self.windows:
            (t0, base), (t1, newest) = self._window_bounds(
                samples, now, window
            )
            in_window = [s for s in samples if s[0] >= t0]
            observed, burn = self._observe(obj, base, newest, in_window)
            burns.append(burn)
            windows[f"{int(window)}s"] = {
                "observed": observed,
                "burn": round(burn, 4),
                "span_s": round(t1 - t0, 3),
            }
        # Multi-window rule: alert only when EVERY window burns past the
        # threshold (min across windows is the binding burn).
        binding = min(burns) if burns else 0.0
        if binding >= self.critical_burn:
            status = CRITICAL
        elif binding >= self.warn_burn:
            status = WARNING
        else:
            status = OK
        return {
            "name": obj.name,
            "kind": obj.kind,
            "target": obj.target,
            "status": status,
            "burn": round(binding, 4),
            "windows": windows,
        }

    def _observe(self, obj: Objective, base: dict, newest: dict, in_window):
        """(observed, burn) of one objective over one window's snapshots."""
        if obj.kind == "error_rate":
            bad = (newest["counters"].get(obj.source, 0)
                   - base["counters"].get(obj.source, 0))
            total = (newest["counters"].get(obj.total, 0)
                     - base["counters"].get(obj.total, 0))
            if total <= 0:
                return None, 0.0
            ratio = max(0.0, bad) / total
            return round(ratio, 6), ratio / obj.target
        if obj.kind == "saturation":
            # Max over the window's samples, not just the endpoints: a
            # queue that spiked and drained still burned budget.
            frac = newest["gauges"].get(obj.source, 0.0) / obj.capacity
            for t, snap in in_window:
                g = snap["gauges"].get(obj.source)
                if g is not None:
                    frac = max(frac, g / obj.capacity)
            return round(frac, 6), frac / obj.target
        # latency: the reservoir is the rolling sample set; no NEW
        # observations in this window means nothing recent to judge.
        hist = newest["histograms"].get(obj.source)
        if not hist or not hist.get("count"):
            return None, 0.0
        base_hist = base["histograms"].get(obj.source) or {}
        if hist["count"] - base_hist.get("count", 0) <= 0:
            return None, 0.0
        q = hist.get(f"p{int(obj.quantile * 100)}")
        if q is None:
            return None, 0.0
        return q, q / obj.target

    def evaluate(self) -> dict:
        """Sample now and evaluate every objective; caches the result."""
        self.sample()
        now = self._clock()
        with self._lock:
            samples = list(self._samples)
        results = [
            self._eval_objective(obj, samples, now) for obj in self.objectives
        ]
        overall = OK
        for r in results:
            if _RANK[r["status"]] > _RANK[overall]:
                overall = r["status"]
        out = {
            "status": overall,
            "windows_s": [int(w) for w in self.windows],
            "warn_burn": self.warn_burn,
            "critical_burn": self.critical_burn,
            "shed": {
                "enabled": self.shed,
                "active": self.shed and overall == CRITICAL,
                "retry_after_s": self.retry_after_s,
            },
            "objectives": results,
        }
        critical_now = {r["name"] for r in results if r["status"] == CRITICAL}
        # Log on EDGES only (an alert that fires once per tick is noise):
        # observe-only mode's entire output is these two lines.
        for name in sorted(critical_now - self._was_critical):
            logger.warning(
                "SLO %s burn is CRITICAL%s", name,
                " — shedding new jobs" if self.shed else " (observe-only)",
            )
        for name in sorted(self._was_critical - critical_now):
            logger.warning("SLO %s recovered", name)
        self._was_critical = critical_now
        with self._lock:
            self._last = out
            self._last_at = now
        return out

    def status(self, max_age: float = 1.0) -> dict:
        """The last evaluation, re-evaluated when older than ``max_age``
        seconds (the sampler thread keeps it fresh; callers without one —
        tests, a sampler-less embedder — transparently evaluate inline)."""
        with self._lock:
            last, last_at = self._last, self._last_at
        if last is not None and self._clock() - last_at <= max_age:
            return last
        return self.evaluate()

    def should_shed(self) -> tuple[bool, float]:
        """(shed?, Retry-After seconds) for the admission path. Never
        evaluates inline with a cold cache older than 2 s — admission
        latency must not pay an SLO evaluation per request."""
        if not self.shed:
            return False, 0.0
        status = self.status(max_age=2.0)
        return status["shed"]["active"], self.retry_after_s

    # -- flight-recorder state provider ------------------------------------

    def state(self) -> dict:
        """Compact snapshot for flight dumps: overall status plus each
        objective's binding burn — what was the service's health the moment
        it died."""
        status = self._last
        if status is None:
            return {"status": "never-evaluated"}
        return {
            "status": status["status"],
            "shed_enabled": status["shed"]["enabled"],
            "shed_active": status["shed"]["active"],
            **{f"burn.{r['name']}": r["burn"]
               for r in status["objectives"]},
        }


def render_status(status: dict) -> str:
    """``gol slo-report``: one table from a ``GET /slo`` payload (or the
    ``slo`` state record of a flight dump rendered via ``state`` keys)."""
    lines = [f"SLO status: {status.get('status', '?')}"]
    objectives = status.get("objectives")
    if not objectives:
        # A flight-dump state record: shedding is flattened into
        # shed_enabled/shed_active (see ``SloEngine.state``) and burns into
        # burn.* keys — a post-mortem must still answer "was the server
        # rejecting traffic when it died".
        lines.append(
            "shedding: "
            + ("enabled" if status.get("shed_enabled") else "observe-only")
            + (" (ACTIVE)" if status.get("shed_active") else "")
        )
        for key in sorted(k for k in status if k.startswith("burn.")):
            lines.append(f"  {key[5:]}: burn {status[key]}")
        return "\n".join(lines) + "\n"
    shed = status.get("shed") or {}
    lines.append(
        f"shedding: {'enabled' if shed.get('enabled') else 'observe-only'}"
        + (" (ACTIVE)" if shed.get("active") else "")
    )
    windows = [f"{w}s" for w in status.get("windows_s", [])]
    header = f"{'objective':<24} {'kind':<11} {'target':>10} {'status':>9}"
    for w in windows:
        header += f" {'burn@' + w:>11}"
    lines += ["", header, "-" * len(header)]
    for r in objectives:
        row = (f"{r['name']:<24} {r['kind']:<11} {r['target']:>10g} "
               f"{r['status']:>9}")
        for w in windows:
            win = (r.get("windows") or {}).get(w) or {}
            row += f" {win.get('burn', 0.0):>11.3f}"
        lines.append(row)
    return "\n".join(lines) + "\n"


__all__ = [
    "CRITICAL", "OK", "WARNING", "DEFAULT_WINDOWS", "STATE_PROVIDER",
    "Objective", "SloEngine", "default_objectives", "render_status",
]
