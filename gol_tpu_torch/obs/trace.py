"""Span-based structured tracing over ``perf_counter``.

The port's copy of ``gol_tpu/obs/trace.py``. Any layer wraps a region in

    with trace.span("checkpoint.save", generation=g):
        ...

and the finished span (name, start, duration, thread, nesting depth,
attributes) lands in a bounded thread-safe ring buffer, exportable as
Chrome trace-event JSON (loadable in Perfetto / chrome://tracing) and
dumpable post-mortem by the flight recorder (obs/recorder.py).

Cost discipline: the checkpoint lane calls ``span`` unconditionally.

- **Off by default, zero-allocation when disabled**: ``span()`` returns a
  module-level no-op singleton after one module-attribute check.
- Enabled, a span costs two ``perf_counter`` calls, one small object, and
  one deque append under a lock.

Clock discipline: every duration and ordering decision uses
``time.perf_counter()``. The one exception is a single per-process
wall-clock **anchor** (``time.time_ns()``, captured once at ``enable()``),
exported as trace metadata so traces from several processes can be
aligned after the fact; it never enters any duration inside the process.
"""

from __future__ import annotations

import json
import threading
import time

_DEFAULT_RING = 4096  # finished spans retained (most recent)


class Span:
    """One finished (or in-flight) traced region."""

    __slots__ = ("name", "start", "duration", "tid", "thread_name", "depth",
                 "attrs")

    def __init__(self, name, start, tid, thread_name, depth, attrs):
        self.name = name
        self.start = start  # perf_counter seconds
        self.duration = 0.0  # filled at __exit__
        self.tid = tid
        self.thread_name = thread_name
        self.depth = depth
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_s": self.start,
            "duration_s": self.duration,
            "tid": self.tid,
            "thread": self.thread_name,
            "depth": self.depth,
            "attrs": self.attrs,
        }


class _SpanContext:
    """Context manager recording one span into the tracer's ring."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer, span):
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        self._span.start = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        span.duration = time.perf_counter() - span.start
        if exc_type is not None:
            span.attrs = dict(span.attrs or ())
            span.attrs["error"] = exc_type.__name__
        self._tracer._record(span)
        return False


class _NoopSpan:
    """The disabled-path singleton: entering yields None, exiting records
    nothing. One instance serves every call site — ``span()`` while disabled
    allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


class Tracer:
    """Ring buffer of finished spans + per-thread nesting state."""

    def __init__(self, ring_size: int = _DEFAULT_RING):
        import collections

        self.enabled = False
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=ring_size)
        self._local = threading.local()
        self._dropped = 0
        # Anchors are set at enable(); zero until then.
        self.anchor_perf = 0.0
        self.anchor_unix_ns = 0

    # -- lifecycle ---------------------------------------------------------

    def enable(self, ring_size: int | None = None) -> None:
        import collections

        with self._lock:
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=ring_size)
            if not self.enabled:
                # The single wall-clock read in the package (see module
                # docstring): a cross-process alignment anchor, exported as
                # metadata, never used in timestamp/duration arithmetic.
                self.anchor_perf = time.perf_counter()
                self.anchor_unix_ns = time.time_ns()
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs):
        """A context manager tracing ``name``; no-op singleton when disabled."""
        if not self.enabled:
            return _NOOP
        thread = threading.current_thread()
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return _SpanContext(
            self, Span(name, 0.0, thread.ident, thread.name, depth,
                       attrs or None)
        )

    def event(self, name: str, **attrs) -> None:
        """An instant (zero-duration) event; dropped when disabled."""
        if not self.enabled:
            return
        thread = threading.current_thread()
        span = Span(name, time.perf_counter(), thread.ident, thread.name,
                    getattr(self._local, "depth", 0), attrs or None)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(span)

    def flow(self, name: str, flow_id, phase: str, **attrs) -> None:
        """A Chrome *flow* point: ``phase`` is ``"s"`` (start), ``"t"``
        (step), or ``"f"`` (finish). Flows with one id draw an arrow chain
        across threads in Perfetto, e.g. to tie a job's lifecycle (submit ->
        claim -> finish) to the spans it rode through. Dropped (no
        allocation past the enabled check) while tracing is disabled."""
        if not self.enabled:
            return
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        self.event(name, flow_phase=phase, flow_id=str(flow_id), **attrs)

    def _record(self, span: Span) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(span)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """The retained spans, oldest first, as JSON-able dicts."""
        with self._lock:
            spans = list(self._ring)
        return [s.to_dict() for s in spans]

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def metadata(self) -> dict:
        import os

        return {
            "pid": os.getpid(),
            "anchor_perf_s": self.anchor_perf,
            "anchor_unix_ns": self.anchor_unix_ns,
            "dropped_spans": self.dropped(),
        }

    def chrome_events(self) -> list[dict]:
        """The ring as Chrome trace events: ``ph:"X"`` complete events for
        spans, plus ``ph:"s"/"t"/"f"`` flow events for ``flow()`` points
        (the arrow chains tying job lifecycles to batch spans in Perfetto).

        Timestamps are microseconds since the process anchor — relative, as
        the trace-event format allows; the absolute anchor rides in the
        ``otherData`` metadata of ``export_chrome``. Sorted by ``ts`` so
        consumers (and tests/test_obs.py) see monotonic timestamps.
        """
        import os

        pid = os.getpid()
        events = []
        for s in self.snapshot():
            attrs = dict(s["attrs"] or {})
            phase = attrs.pop("flow_phase", None)
            ts = (s["start_s"] - self.anchor_perf) * 1e6
            if phase in ("s", "t", "f"):
                ev = {
                    "name": s["name"],
                    "cat": "flow",
                    "ph": phase,
                    "id": attrs.pop("flow_id", "0"),
                    "ts": ts,
                    "pid": pid,
                    "tid": s["tid"],
                }
                if phase == "f":
                    # Bind the finish to the enclosing slice, the Chrome
                    # trace format's rule for flows that END inside a span.
                    ev["bp"] = "e"
                if attrs:
                    ev["args"] = attrs
                events.append(ev)
                continue
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": ts,
                "dur": s["duration_s"] * 1e6,
                "pid": pid,
                "tid": s["tid"],
                "args": dict(attrs, depth=s["depth"]),
            })
        events.sort(key=lambda e: e["ts"])
        return events

    def export_chrome(self, path: str) -> str:
        """Write the ring as a Chrome trace JSON object to ``path``."""
        payload = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": self.metadata(),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.write("\n")
        return path


# The process-global tracer every library call site records into. Like the
# registry singleton, a plain module global: `trace.span(...)` in a hot loop
# must be one attribute load + one bool check when disabled.
_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def enable(ring_size: int | None = None) -> None:
    _TRACER.enable(ring_size)


def disable() -> None:
    _TRACER.disable()


def clear() -> None:
    _TRACER.clear()


def span(name: str, **attrs):
    """``with trace.span("halo_exchange", gen=g): ...`` — the library-wide
    tracing entry point (no-op singleton while tracing is disabled)."""
    if not _TRACER.enabled:
        return _NOOP
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    _TRACER.event(name, **attrs)


def flow(name: str, flow_id, phase: str, **attrs) -> None:
    """Record a flow point (``phase`` in s/t/f); no-op while disabled."""
    if not _TRACER.enabled:
        return
    _TRACER.flow(name, flow_id, phase, **attrs)


def snapshot() -> list[dict]:
    return _TRACER.snapshot()


def export_chrome(path: str) -> str:
    return _TRACER.export_chrome(path)
