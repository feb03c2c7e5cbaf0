"""General counter/gauge/histogram registry: the port's one metrics core.

The port's copy of ``gol_tpu/obs/registry.py`` (the port imports nothing of
the JAX package), with the same names and rules:

- ``Registry``: named counters, gauges, and bounded-reservoir histograms,
  thread-safe, exportable as a JSON snapshot or Prometheus text.
- ``default()``: the process-global registry. The checkpoint protocol
  (``checkpoint_saves_total``, ``checkpoint_save_failures_total``,
  ``checkpoint_restores_total``, ...), the async writer
  (``pipeline_stalls_total``, ``checkpoint_write_hidden_seconds``, the
  ``ckpt_writer_queue_depth`` gauge) and the retry policy record here; the
  flight recorder (obs/recorder.py) snapshots it, so a post-mortem dump
  carries the process's counters beside its spans.
- ``quantile`` / ``median``: the nearest-rank percentile math.

Latency sources are ``time.perf_counter()`` only: a wall clock that steps
under NTP turns a p99 into fiction.

Stdlib-only: ``resilience/retry.py`` records retry attempts here at module
load, before torch is imported.
"""

from __future__ import annotations

import collections
import re
import threading

# Quantiles exported for every histogram (the serving contract).
QUANTILES = (0.5, 0.95, 0.99)

_RESERVOIR = 2048  # samples kept per histogram (most recent)


def quantile(samples, q: float) -> float | None:
    """Nearest-rank quantile over ``samples`` (round-based, the JAX
    package's serving histograms' rule, kept byte for byte). Returns None on
    an empty sample set."""
    return _quantile_sorted(sorted(samples), q)


def _quantile_sorted(ordered, q: float) -> float | None:
    """``quantile`` over an ALREADY-sorted list — the shared rank rule,
    split out so ``Histogram.summary`` pays one sort for all three
    quantiles (it runs on every registry snapshot, which the SLO sampler
    takes once per tick)."""
    if not ordered:
        return None
    idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
    return ordered[idx]


def median(samples) -> float:
    """The measurement protocol's median: ``sorted(v)[len(v) // 2]`` — the
    upper median on even counts, exactly what tools/measure.py has published
    since r4 (artifact byte-stability pins the rule; ``quantile(v, 0.5)``
    differs on counts ≡ 2 mod 4 because ``round`` banker's-rounds)."""
    ordered = sorted(samples)
    if not ordered:
        raise ValueError("no samples")
    return ordered[len(ordered) // 2]


class Histogram:
    __slots__ = ("samples", "count", "total")

    def __init__(self):
        self.samples = collections.deque(maxlen=_RESERVOIR)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.samples.append(float(value))
        self.count += 1
        self.total += float(value)

    def quantile(self, q: float) -> float | None:
        # Nearest-rank on the recent reservoir (the shared rule above).
        return quantile(self.samples, q)

    def summary(self) -> dict:
        ordered = sorted(self.samples)  # one sort serves all three ranks
        out = {"count": self.count, "sum": self.total}
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = _quantile_sorted(ordered, q)
        return out


class Registry:
    """Named counters, gauges, and histograms; thread-safe."""

    def __init__(self, prefix: str = "gol"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def inc(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def remove_gauge(self, name: str) -> None:
        """Drop a gauge whose subject is gone (a retired worker's
        breaker-state series): a stale last value on a per-entity gauge
        reads as a live report, unlike a counter, which merges."""
        with self._lock:
            self._gauges.pop(name, None)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, Histogram()).observe(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """Point-in-time JSON-able view of everything."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._hists.items()},
            }

    def prometheus(self) -> str:
        """Prometheus text exposition format (quantiles as summary series)."""
        snap = self.snapshot()
        p = self.prefix
        lines: list[str] = []
        for name, value in sorted(snap["counters"].items()):
            lines.append(f"# TYPE {p}_{name} counter")
            lines.append(f"{p}_{name} {_fmt(value)}")
        for name, value in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {p}_{name} gauge")
            lines.append(f"{p}_{name} {_fmt(value)}")
        for name, summary in sorted(snap["histograms"].items()):
            lines.append(f"# TYPE {p}_{name} summary")
            for q in QUANTILES:
                v = summary.get(f"p{int(q * 100)}")
                if v is not None:
                    lines.append(f'{p}_{name}{{quantile="{q}"}} {_fmt(v)}')
            lines.append(f"{p}_{name}_sum {_fmt(summary['sum'])}")
            lines.append(f"{p}_{name}_count {_fmt(summary['count'])}")
        return "\n".join(lines) + "\n"


def metric_label(label: str) -> str:
    """Sanitize a free-form label (a bucket name like ``256x256/c/packed``)
    into a Prometheus-legal metric-name suffix. The registry has no label
    dimension on purpose (a counter is one dict slot); per-bucket series
    mangle the bucket into the name instead, through this ONE rule so the
    writer (scheduler) and the readers (sampler, tune marginal records)
    can never disagree on the spelling."""
    return re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")


def _fmt(v: float) -> str:
    # Prometheus wants plain decimal/scientific; repr of a float is both.
    return repr(float(v)) if isinstance(v, float) and not v.is_integer() else str(int(v))


# The process-global registry. A plain module singleton (no lazy factory):
# recording a counter must never be more than a dict update behind a lock,
# and every layer — engine, resilience, tune, parallel — shares this one.
_DEFAULT = Registry(prefix="gol")


def default() -> Registry:
    """The process-global registry library layers record into."""
    return _DEFAULT


def reset_default() -> None:
    """Fresh global registry (tests; never called by library code)."""
    global _DEFAULT
    _DEFAULT = Registry(prefix="gol")
