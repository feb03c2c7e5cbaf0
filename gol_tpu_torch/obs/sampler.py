"""The serve-side background sampler: SLO ticks + the dispatch-gap monitor.

The port's copy of ``gol_tpu/obs/sampler.py`` (stdlib only), with the
JAX package's metric names. It decomposes serve throughput into "what the
kernels can do" (the marginal kernel rate) vs "what the service achieves",
continuously:
one thread (``gol-serve-sampler``) ticks every ``interval`` seconds and

1. **evaluates the SLO engine** (obs/slo.py) so ``GET /slo`` and the
   shedding decision read a fresh cache instead of evaluating inline;
2. **monitors the dispatch gap**: the scheduler feeds per-bucket
   ``serve_cell_updates_total_<bucket>`` counters (actual board cells times
   generations really run); the sampler differentiates them per tick into
   achieved cell-updates/s and — when a marginal kernel rate is known for
   the bucket (``tune`` records one with the serve plan) — exports the
   live gap ratio as gauges:

   - ``bucket_cell_updates_per_sec_<bucket>``   achieved, per bucket
   - ``dispatch_gap_ratio_<bucket>``            achieved / marginal
   - ``serve_cell_updates_per_sec``             achieved, whole service
   - ``dispatch_gap_ratio``                     achieved / roofline, where
     the roofline is the work-weighted combination of the known marginal
     rates, applied to the last tick's work mix

   Gauges update only on ticks that saw new work — an idle service keeps
   its last ratio instead of decaying to a meaningless 0.

Clock discipline: ``time.perf_counter()`` only (wall clocks step under
NTP); bucket names ride through the one
``registry.metric_label`` sanitizer so writer and reader agree.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)

THREAD_NAME = "gol-serve-sampler"
_BUCKET_PREFIX = "serve_cell_updates_total_"
_TOTAL_COUNTER = "serve_cell_updates_total"


class ServeSampler:
    """Periodic SLO evaluation + dispatch-gap gauges over one registry.

    ``slo`` may be None (gap monitoring only). ``marginal_rates`` maps
    sanitized bucket labels to tuned marginal kernel cell-updates/s; absent
    or empty, achieved-rate gauges still export and the gap ratios simply
    don't. ``start()`` spawns the daemon thread; ``tick()`` is public so
    tests (and embedders without a thread) can drive it deterministically.
    """

    def __init__(
        self,
        registry,
        slo=None,
        interval: float = 1.0,
        marginal_rates: dict[str, float] | None = None,
        history=None,
        clock=time.perf_counter,
    ):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.registry = registry
        self.slo = slo
        self.interval = interval
        self.marginal_rates = dict(marginal_rates or {})
        # Durable metrics history (obs/history.py HistoryWriter) or None
        # (the default — no history object means zero per-tick cost).
        self.history = history
        # Per-tick hooks (the storage-lifecycle tick rides here: disk-guard
        # watermarks, journal-bytes gauges, idle-time compaction). Run
        # after the gap sample and BEFORE the history append, so gauges a
        # hook sets land in the same durable record; a raising hook is
        # logged and skipped, never kills the sampler thread.
        self._hooks: list = []
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last: dict[str, tuple[float, float]] = {}  # counter -> (t, v)

    def add_hook(self, hook) -> None:
        """Register a zero-arg callable to run every tick."""
        self._hooks.append(hook)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=THREAD_NAME, daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                logger.warning("%s did not stop within %.1fs",
                               THREAD_NAME, timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - a bad tick must not kill it
                logger.exception("serve sampler tick failed")

    # -- one tick ----------------------------------------------------------

    def tick(self) -> None:
        if self.slo is not None:
            self.slo.evaluate()
        self._sample_gap()
        for hook in self._hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 - a bad hook must not kill it
                logger.exception("serve sampler hook failed")
        if self.history is not None:
            # One snapshot per tick into the durable ring: taken AFTER the
            # gap sample (and the hooks) so the freshly-set gauges ride
            # the same record.
            self.history.append(self.registry.snapshot())

    def _sample_gap(self) -> None:
        now = self._clock()
        counters = self.registry.snapshot()["counters"]
        ideal_seconds = 0.0  # marginal-known work at the tuned rates
        unknown_cells = 0.0  # this tick's work in buckets with NO marginal
        for name, value in counters.items():
            if not name.startswith(_BUCKET_PREFIX):
                continue
            bucket = name[len(_BUCKET_PREFIX):]
            delta, dt = self._delta(name, now, value)
            if delta is None or delta <= 0:
                continue
            rate = delta / dt
            self.registry.set_gauge(
                f"bucket_cell_updates_per_sec_{bucket}", rate
            )
            marginal = self.marginal_rates.get(bucket)
            if marginal and marginal > 0:
                self.registry.set_gauge(
                    f"dispatch_gap_ratio_{bucket}", rate / marginal
                )
                ideal_seconds += delta / marginal
            else:
                unknown_cells += delta
        total = counters.get(_TOTAL_COUNTER)
        if total is not None:
            delta, dt = self._delta(_TOTAL_COUNTER, now, total)
            if delta is not None and delta > 0:
                self.registry.set_gauge(
                    "serve_cell_updates_per_sec", delta / dt
                )
                if ideal_seconds > 0 and unknown_cells == 0:
                    # achieved/roofline over the tick: the work took dt of
                    # wall time that the marginal kernels would have done in
                    # ideal_seconds (the combined-rate rule, live).
                    # Only when EVERY bucket that produced work this tick
                    # has a tuned marginal: with unknown-bucket work in dt
                    # but not in ideal_seconds the ratio would sag on a
                    # perfectly healthy service — a standing false alarm.
                    # Per-bucket ratios above still export regardless.
                    self.registry.set_gauge(
                        "dispatch_gap_ratio", ideal_seconds / dt
                    )

    def _delta(self, name: str, now: float, value: float):
        """(delta, dt) since this counter's previous tick, None first time."""
        prev = self._last.get(name)
        self._last[name] = (now, value)
        if prev is None:
            return None, 0.0
        dt = now - prev[0]
        if dt <= 0:
            return None, 0.0
        return value - prev[1], dt


__all__ = ["ServeSampler", "THREAD_NAME"]
