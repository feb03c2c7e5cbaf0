"""``gol fleet-trace``: one stitched timeline for the whole fleet.

A copy of ``gol_tpu/obs/fleettrace.py``, collecting over the port's
``fleet/client.http_json``. Against a plain ``serve`` (no ``/fleet``) it
traces that one process.

Each process in a fleet (the router, every worker) keeps its own span ring
over its own ``perf_counter`` — a clock that is monotonic but has an
arbitrary, per-process zero. This module collects every live ring
(``GET /debug/trace``, the payload every server answers) and
stitches ONE Chrome/Perfetto trace out of them:

- **clock normalization**: each payload's metadata carries the process's
  anchor pair (``anchor_perf_s`` from ``perf_counter``, ``anchor_unix_ns``
  from the one sanctioned wall read at ``trace.enable()``). Every event's
  timestamp becomes *wall microseconds since the earliest anchor in the
  fleet*:

      ts_us = (start_s - anchor_perf_s) * 1e6
              + (anchor_unix_ns - min_anchor_unix_ns) / 1e3

  which applies each process's router-relative clock skew as measured by
  its own anchor (test-pinned on injected skew). Wall time is metadata
  here exactly as in ``trace.py``: it aligns axes across processes and
  never enters any within-process duration.
- **process lanes**: every process keeps its pid (plus a
  ``process_name`` metadata event with its fleet id — ``router``, ``w0``,
  ...), so Perfetto renders one lane group per process. In-process test
  fleets where several "processes" share one pid get synthetic pids (the
  real pid stays in the process table) — lanes must not merge.
- **cross-process flows**: the router's flow *start* and the owning
  worker's *step/finish* points carry the same propagated trace id
  (obs/propagate.py), so Perfetto draws the router→worker arrow per job —
  the fleet-queueing hop ``gol trace-report`` also measures.

Collection degrades per process: an unreachable worker (mid-respawn,
crashed) is skipped with a note in the output's ``otherData`` — a fleet
trace of the survivors beats no trace during exactly the incident that
killed a worker.
"""

from __future__ import annotations

import json
import urllib.error


def collect(base_url: str, http=None, timeout: float = 10.0) -> list[dict]:
    """Fetch ``/debug/trace`` from the router at ``base_url`` and from
    every worker its ``GET /fleet`` lists. Against a plain ``gol serve``
    (no /fleet endpoint) the result is that one process alone.

    Returns ``[{"name", "url", "payload"|None, "error"?}, ...]`` — one
    entry per process, unreachable ones with ``payload=None``.
    """
    if http is None:
        from gol_tpu_torch.fleet.client import http_json as http
    base = base_url.rstrip("/")
    targets = [("router", base)]
    try:
        status, membership = http("GET", base + "/fleet", timeout=timeout)
        if status == 200 and isinstance(membership, dict):
            for w in membership.get("workers", []):
                if w.get("url"):
                    targets.append((str(w.get("id", w["url"])),
                                    str(w["url"]).rstrip("/")))
    except (urllib.error.URLError, ConnectionError, OSError, ValueError):
        pass  # a single server: no membership, trace it alone

    import threading

    out = [{"name": name, "url": url, "payload": None}
           for name, url in targets]
    lock = threading.Lock()

    def fetch(entry: dict) -> None:
        try:
            status, payload = http("GET", entry["url"] + "/debug/trace",
                                   timeout=timeout)
            with lock:
                if status == 200 and isinstance(payload, dict):
                    entry["payload"] = payload
                else:
                    entry["error"] = f"HTTP {status}"
        except (urllib.error.URLError, ConnectionError, OSError,
                ValueError) as err:
            with lock:
                entry["error"] = f"{type(err).__name__}: {err}"

    threads = [threading.Thread(target=fetch, args=(e,), daemon=True)
               for e in out]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 5)
    return out


def stitch(processes: list[dict]) -> dict:
    """Merge per-process ``/debug/trace`` payloads into one Chrome trace.

    ``processes``: the ``collect`` shape — entries whose ``payload`` is
    None (unreachable) or whose tracer never enabled (anchor 0: nothing to
    align) are recorded in ``otherData.skipped`` and contribute no events.
    """
    live = []
    skipped = []
    for entry in processes:
        payload = entry.get("payload")
        meta = (payload or {}).get("meta") or {}
        if payload is None:
            skipped.append({"name": entry.get("name", "?"),
                            "reason": entry.get("error", "unreachable")})
        elif not meta.get("anchor_unix_ns"):
            skipped.append({"name": entry.get("name", "?"),
                            "reason": "tracing disabled (no anchor)"})
        else:
            live.append((entry.get("name", "?"), payload, meta))
    if not live:
        return {
            "traceEvents": [],
            "displayTimeUnit": "ms",
            "otherData": {"processes": {}, "skipped": skipped},
        }

    # The fleet's wall origin: the earliest anchor. Every process's events
    # shift by its OWN (anchor_unix_ns - origin) — the per-process skew
    # adjustment (two processes enabled at different wall moments land on
    # one axis; an injected skew shifts exactly its process, test-pinned).
    origin_ns = min(meta["anchor_unix_ns"] for _, _, meta in live)

    events: list[dict] = []
    process_table: dict[str, dict] = {}
    used_pids: set[int] = set()
    for index, (name, payload, meta) in enumerate(live):
        real_pid = int(meta.get("pid") or 0)
        pid = real_pid
        # In-process fleets (tests) report one pid for every lane; a pid
        # collision would weld lanes, so collide into a synthetic pid and
        # keep the real one in the process table. The probe INCREMENTS
        # until free: a recomputed hash of the colliding pid can be its
        # own fixed point (a real pid inside the synthetic block), and a
        # non-advancing loop would hang the stitch.
        if pid == 0 or pid in used_pids:
            pid = 1_000_000 + index * 1_000 + (real_pid % 1_000)
            while pid in used_pids:
                pid += 1
        used_pids.add(pid)
        anchor_perf = float(meta.get("anchor_perf_s") or 0.0)
        offset_us = (meta["anchor_unix_ns"] - origin_ns) / 1e3
        process_table[name] = {
            "pid": pid,
            "real_pid": real_pid,
            "anchor_unix_ns": meta["anchor_unix_ns"],
            "skew_us_vs_origin": offset_us,
            "dropped_spans": meta.get("dropped_spans", 0),
        }
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{name} (pid {real_pid})"},
        })
        for span in payload.get("spans") or []:
            attrs = dict(span.get("attrs") or {})
            phase = attrs.pop("flow_phase", None)
            ts = (float(span.get("start_s", 0.0)) - anchor_perf) * 1e6 \
                + offset_us
            if phase in ("s", "t", "f"):
                ev = {
                    "name": span.get("name", "?"),
                    "cat": "flow",
                    "ph": phase,
                    "id": attrs.pop("flow_id", "0"),
                    "ts": ts,
                    "pid": pid,
                    "tid": span.get("tid", 0),
                }
                if phase == "f":
                    ev["bp"] = "e"
                if attrs:
                    ev["args"] = attrs
                events.append(ev)
                continue
            events.append({
                "name": span.get("name", "?"),
                "ph": "X",
                "ts": ts,
                "dur": float(span.get("duration_s", 0.0)) * 1e6,
                "pid": pid,
                "tid": span.get("tid", 0),
                "args": dict(attrs, depth=span.get("depth", 0)),
            })
    # Metadata events first, then time order — the chrome_events rule.
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "origin_unix_ns": origin_ns,
            "processes": process_table,
            "skipped": skipped,
        },
    }


def export(base_url: str, path: str, http=None) -> dict:
    """collect + stitch + write: the ``gol fleet-trace`` body. Returns the
    stitched document (the CLI prints its summary)."""
    doc = stitch(collect(base_url, http=http))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


__all__ = ["collect", "export", "stitch"]
