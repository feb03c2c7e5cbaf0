"""Durable metrics history: an append-only, size-capped snapshot log.

The port's copy of ``gol_tpu/obs/history.py``: the same disk format, so
``gol history-report`` renders a ring either package wrote.

- A history directory holds numbered JSONL **segments**
  (``seg-00000042.jsonl``); every line is one JSON record, appended whole,
  so a crash tears at most the final line and the reader drops it.
- Each segment opens with a ``{"record": "header"}`` line carrying the
  writer's pid, a free-form ``source`` label and the process's clock
  anchors; every sample line after it is ``{"record": "sample", "seq": N,
  "t": <perf_counter>, ...snapshot}``.
- Segments rotate at ``segment_bytes`` and the directory is a **ring**:
  once the total exceeds ``total_bytes``, the oldest whole segments are
  deleted.
- A respawned process reopening the directory continues the numbering and
  writes a fresh header, so readers see the pid change.

Samples are stamped with ``time.perf_counter()`` only; each header carries
one wall-clock anchor pair that never enters any rate or window arithmetic
and only places samples from several processes on one axis.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time

logger = logging.getLogger(__name__)

_SEGMENT_RE = re.compile(r"seg-(\d{8})\.jsonl$")

DEFAULT_SEGMENT_BYTES = 1 << 20  # rotate at 1 MiB
DEFAULT_TOTAL_BYTES = 16 << 20  # ring-cap the directory at 16 MiB


def _segment_name(index: int) -> str:
    return f"seg-{index:08d}.jsonl"


def _segments(directory: str) -> list[tuple[int, str]]:
    """(index, path) for every segment file, oldest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _SEGMENT_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


class HistoryWriter:
    """Appends windowed snapshots to a size-capped segment ring.

    ``append`` never raises on I/O trouble: history is telemetry, and a
    full disk must degrade it (loudly, counted) — never take the serving
    path down with it. Thread-safe; one writer per directory by contract
    (the fleet gives each process its own partition/subdir, exactly like
    the journal).
    """

    def __init__(
        self,
        directory: str,
        source: str = "",
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        total_bytes: int = DEFAULT_TOTAL_BYTES,
        clock=time.perf_counter,
    ):
        if segment_bytes < 1:
            raise ValueError(f"segment_bytes must be >= 1, got {segment_bytes}")
        if total_bytes < segment_bytes:
            raise ValueError(
                f"total_bytes ({total_bytes}) must be >= segment_bytes "
                f"({segment_bytes})"
            )
        self.directory = directory
        self.source = source
        self.segment_bytes = segment_bytes
        self.total_bytes = total_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._errors = 0
        os.makedirs(directory, exist_ok=True)
        existing = _segments(directory)
        # Continue the ring a previous incarnation left: numbering never
        # reuses an index, so "oldest" stays well-defined across respawns.
        self._index = (existing[-1][0] + 1) if existing else 0

    @property
    def errors(self) -> int:
        return self._errors

    def _open_segment(self) -> None:
        path = os.path.join(self.directory, _segment_name(self._index))
        self._fh = open(path, "a", encoding="utf-8")
        header = {
            "record": "header",
            "schema": 1,
            "pid": os.getpid(),
            "source": self.source,
            # The one wall-clock read (alignment metadata ONLY — see the
            # module docstring; time.time_ns like the tracer's anchor).
            "anchor_perf_s": self._clock(),
            "anchor_unix_ns": time.time_ns(),
        }
        self._fh.write(json.dumps(header, separators=(",", ":")) + "\n")
        self._fh.flush()

    def append(self, snapshot: dict) -> None:
        """Append one sample (a registry-style snapshot dict). Rotates and
        compacts as needed; I/O failure logs + counts, never raises."""
        with self._lock:
            if self._fh is None and self._errors == 0:
                try:
                    self._open_segment()
                except OSError as err:
                    self._errors += 1
                    logger.error("metrics history: cannot open segment in "
                                 "%s: %s", self.directory, err)
                    return
            if self._fh is None:
                # A previous failure closed us; retry a fresh segment so a
                # transient ENOSPC does not end the history forever.
                try:
                    self._index += 1
                    self._open_segment()
                except OSError:
                    self._errors += 1
                    return
            self._seq += 1
            record = {
                "record": "sample",
                "seq": self._seq,
                "t": self._clock(),
                **snapshot,
            }
            try:
                self._fh.write(
                    json.dumps(record, separators=(",", ":")) + "\n"
                )
                self._fh.flush()
                if self._fh.tell() >= self.segment_bytes:
                    self._fh.close()
                    self._index += 1
                    self._open_segment()
                    self._compact()
            except (OSError, ValueError) as err:
                self._errors += 1
                logger.error("metrics history append failed (%s); samples "
                             "will be dropped until it recovers", err)
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def _compact(self) -> None:
        """Delete the oldest whole segments past the ring cap (the current
        segment is never a deletion candidate)."""
        segments = _segments(self.directory)
        sizes = {}
        for index, path in segments:
            try:
                sizes[index] = os.path.getsize(path)
            except OSError:
                sizes[index] = 0
        total = sum(sizes.values())
        for index, path in segments:
            if total <= self.total_bytes or index == self._index:
                break
            try:
                os.unlink(path)
                total -= sizes[index]
            except OSError as err:
                logger.warning("metrics history: could not compact %s: %s",
                               path, err)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_records(directory: str) -> list[dict]:
    """Every parseable record across the ring, segment order (oldest
    first), torn/garbage lines dropped — the journal's replay leniency."""
    records: list[dict] = []
    for _index, path in _segments(directory):
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                records.append(json.loads(line.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue
    return records


def runs(directory: str) -> list[dict]:
    """Group the ring's samples into contiguous writer RUNS.

    A run is one (header, samples) stretch — one process incarnation's
    window. perf_counter values are only comparable within a run; the
    reader is where that rule is enforced, so every consumer (the report,
    the bench gate) inherits it. Each run:
    ``{"header": {...}, "samples": [sample, ...]}``.
    """
    out: list[dict] = []
    current: dict | None = None
    for rec in read_records(directory):
        kind = rec.get("record")
        if kind == "header":
            # Consecutive headers from ONE incarnation (segment rotation)
            # continue the same run: perf_counter stays comparable within
            # a pid, and seq numbering is writer-global.
            if current is not None and current["header"].get("pid") == rec.get("pid"):
                continue
            current = {"header": rec, "samples": []}
            out.append(current)
        elif kind == "sample":
            if current is None:  # compaction ate the header: synthesize
                current = {"header": {"record": "header"}, "samples": []}
                out.append(current)
            current["samples"].append(rec)
    return out


def counter_series(directory: str, name: str) -> list[list[tuple[float, float]]]:
    """Per-run [(t, value), ...] series for one cumulative counter —
    the shape both the rate math below and tests consume."""
    series = []
    for run in runs(directory):
        points = [
            (float(s["t"]), float(s["counters"][name]))
            for s in run["samples"]
            if isinstance(s.get("counters"), dict) and name in s["counters"]
        ]
        if points:
            series.append(points)
    return series


def window_rate(directory: str, name: str) -> tuple[float, float] | None:
    """(rate_per_sec, window_seconds) for a cumulative counter over the
    WHOLE retained history: per-run deltas over per-run durations, summed —
    a respawn boundary (new run, counter back at zero) contributes its own
    delta instead of a bogus negative one. None when the counter never
    moved across a measurable window (the bench gate treats that as a
    shape error, not a zero rate)."""
    delta = 0.0
    seconds = 0.0
    for points in counter_series(directory, name):
        if len(points) < 2:
            continue
        t0, v0 = points[0]
        t1, v1 = points[-1]
        if t1 > t0:
            delta += v1 - v0
            seconds += t1 - t0
    if seconds <= 0:
        return None
    return delta / seconds, seconds


# -- gol history-report ------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: list[float]) -> str:
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / (hi - lo) * (len(_SPARK) - 1)))]
        for v in values
    )


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.4g}"


def render_report(directory: str, width: int = 48) -> str:
    """The ``gol history-report`` text: per-series rate/value/percentile
    timelines over the retained window, respawn boundaries called out.

    Counters render as per-interval RATES (the derivative an operator
    thinks in); gauges as raw values; histograms as their p99 track. Long
    series are downsampled to ``width`` buckets (max-preserving: a spike
    an incident review is looking for must not average away).
    """
    all_runs = runs(directory)
    lines = [f"# metrics history: {directory}", ""]
    if not all_runs:
        lines.append("(no history records)")
        return "\n".join(lines) + "\n"
    nsamples = sum(len(r["samples"]) for r in all_runs)
    boots = []
    for run in all_runs:
        h = run["header"]
        boots.append(f"pid {h.get('pid', '?')}"
                     + (f" [{h['source']}]" if h.get("source") else "")
                     + f" x{len(run['samples'])}")
    lines.append(f"{nsamples} sample(s) across {len(all_runs)} writer "
                 f"run(s): " + ", ".join(boots))
    if len(all_runs) > 1:
        lines.append("respawn boundaries between runs are marked '|' in "
                     "the timelines; cumulative counters restart per run "
                     "unless the feeder floors them (the router's merged "
                     "history does)")
    lines.append("")

    counters: set[str] = set()
    gauges: set[str] = set()
    hists: set[str] = set()
    for run in all_runs:
        for s in run["samples"]:
            counters.update((s.get("counters") or {}))
            gauges.update((s.get("gauges") or {}))
            hists.update((s.get("histograms") or {}))

    def downsample(values: list[float]) -> list[float]:
        if len(values) <= width:
            return values
        out = []
        for i in range(width):
            lo = i * len(values) // width
            hi = max(lo + 1, (i + 1) * len(values) // width)
            out.append(max(values[lo:hi]))
        return out

    def emit(title: str, names: set[str], per_run_values) -> None:
        if not names:
            return
        lines.append(f"## {title}")
        for name in sorted(names):
            chunks: list[str] = []
            lasts: list[float] = []
            flat: list[float] = []
            for run in all_runs:
                vals = per_run_values(run, name)
                if vals:
                    chunks.append(_sparkline(downsample(vals)))
                    lasts.append(vals[-1])
                    flat.extend(vals)
                else:
                    chunks.append("")
            track = "|".join(chunks)
            if not flat:
                continue
            lines.append(
                f"  {name:<44} {track}  "
                f"last={_fmt(lasts[-1])} max={_fmt(max(flat))}"
            )
        lines.append("")

    def counter_rates(run: dict, name: str) -> list[float]:
        rates = []
        prev = None
        for s in run["samples"]:
            c = s.get("counters") or {}
            if name not in c:
                continue
            point = (float(s["t"]), float(c[name]))
            if prev is not None and point[0] > prev[0]:
                rates.append((point[1] - prev[1]) / (point[0] - prev[0]))
            prev = point
        return rates

    def gauge_values(run: dict, name: str) -> list[float]:
        return [float((s.get("gauges") or {})[name])
                for s in run["samples"]
                if name in (s.get("gauges") or {})
                and (s["gauges"][name]) is not None]

    def hist_p99(run: dict, name: str) -> list[float]:
        out = []
        for s in run["samples"]:
            summary = (s.get("histograms") or {}).get(name) or {}
            v = summary.get("p99")
            if v is not None:
                out.append(float(v))
        return out

    emit("counter rates (per second, per sampling interval)", counters,
         counter_rates)
    emit("gauges", gauges, gauge_values)
    emit("histogram p99", hists, hist_p99)

    totals = []
    for name in sorted(counters):
        wr = window_rate(directory, name)
        if wr is not None:
            rate, seconds = wr
            totals.append(f"  {name:<44} {rate:10.3f}/s over {seconds:.1f}s")
    if totals:
        lines.append("## whole-window rates (per-run deltas summed)")
        lines.extend(totals)
        lines.append("")
    return "\n".join(lines) + "\n"


__all__ = [
    "DEFAULT_SEGMENT_BYTES", "DEFAULT_TOTAL_BYTES", "HistoryWriter",
    "counter_series", "read_records", "render_report", "runs",
    "window_rate",
]
