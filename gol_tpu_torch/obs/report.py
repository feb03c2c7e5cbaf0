"""``gol trace-report``: summarize a trace file on the terminal.

The port's copy of ``gol_tpu/obs/report.py``, with the same output byte for
byte. It accepts both artifacts the obs subsystem writes:

- Chrome trace JSON (``trace.export_chrome``, a ``--trace DIR`` export):
  an object with ``traceEvents`` of ``ph:"X"`` complete events;
- flight-recorder JSONL (``obs/recorder.py`` dumps): header / span /
  registry records, one JSON object per line.

Three views, built from the same normalized span list: per-phase stats
(count, total, p50, p95 per span name, through ``obs.registry.quantile``),
the span tree of the most recent top-level span per thread, and the gap
analysis (per thread, untraced wall time between consecutive top-level
spans). A stitched trace of several processes (a ``gol fleet-trace``
export of the JAX package) also renders per-process phase tables and the
cross-process gap between a flow's forward and claim points.
"""

from __future__ import annotations

import json

from gol_tpu_torch.obs import registry


def load_spans(path: str) -> tuple[list[dict], dict]:
    """Normalize a trace file into (spans, metadata).

    Each span: ``{"name", "start_us", "dur_us", "tid", "depth", "attrs"}``.
    Format is sniffed from content, not the filename: a JSON object with
    ``traceEvents`` is a Chrome trace; otherwise the file is read as
    flight-recorder JSONL (torn lines dropped).
    """
    with open(path, "rb") as f:
        raw = f.read()
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans = [
            {
                "name": e.get("name", "?"),
                "start_us": float(e.get("ts", 0.0)),
                "dur_us": float(e.get("dur", 0.0)),
                "tid": e.get("tid", 0),
                "pid": e.get("pid", 0),
                "depth": (e.get("args") or {}).get("depth", 0),
                "attrs": {k: v for k, v in (e.get("args") or {}).items()
                          if k != "depth"},
            }
            for e in doc["traceEvents"]
            if e.get("ph") == "X"
        ]
        meta = dict(doc.get("otherData") or {})
        flow_events = [
            {
                "id": str(e.get("id", "0")),
                "ph": e["ph"],
                "ts_us": float(e.get("ts", 0.0)),
                "pid": e.get("pid", 0),
                "attrs": dict(e.get("args") or {}),
            }
            for e in doc["traceEvents"]
            if e.get("ph") in ("s", "t", "f")
        ]
        flows = _flow_counts(e["ph"] for e in flow_events)
        if flows:
            meta["flows"] = flows
        if flow_events:
            # The stitched-fleet lane: points keep ts/pid so the
            # cross-process gap analysis below can measure the hop.
            meta["flow_points"] = flow_events
        return spans, meta
    # Flight-recorder JSONL.
    spans, meta, flow_phases = [], {}, []
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            rec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue
        kind = rec.get("record")
        if kind == "header":
            flows = meta.get("flows")
            meta = {k: v for k, v in rec.items() if k != "record"}
            if flows:
                meta["flows"] = flows
        elif kind == "span":
            phase = (rec.get("attrs") or {}).get("flow_phase")
            if phase in ("s", "t", "f"):
                # Flow points ride the span ring but are arrows, not
                # durations — count them instead of polluting the tables.
                flow_phases.append(phase)
                continue
            spans.append({
                "name": rec.get("name", "?"),
                "start_us": float(rec.get("start_s", 0.0)) * 1e6,
                "dur_us": float(rec.get("duration_s", 0.0)) * 1e6,
                "tid": rec.get("tid", 0),
                "pid": 0,  # a flight dump is one process by construction
                "depth": rec.get("depth", 0),
                "attrs": rec.get("attrs") or {},
            })
        elif kind == "registry":
            meta["registry"] = {k: v for k, v in rec.items() if k != "record"}
        elif kind == "state":
            # Live subsystem snapshots (e.g. the async checkpoint writer's
            # queue): folded into the header block so "what was in flight
            # when it died" renders next to the crash reason.
            meta.setdefault("state", {})[rec.get("name", "?")] = {
                k: v for k, v in rec.items() if k not in ("record", "name")
            }
    flows = _flow_counts(flow_phases)
    if flows:
        meta["flows"] = flows
    spans.sort(key=lambda s: s["start_us"])
    return spans, meta


def _flow_counts(phases) -> dict:
    counts = {"s": 0, "t": 0, "f": 0}
    for p in phases:
        counts[p] += 1
    return {k: v for k, v in counts.items() if v}


def _fmt_ms(us: float) -> str:
    return f"{us / 1000:.3f}"


def phase_table(spans: list[dict]) -> list[str]:
    by_name: dict[str, list[float]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["dur_us"])
    lines = ["phase                        count   total_ms      p50_ms      p95_ms",
             "-" * 68]
    for name in sorted(by_name, key=lambda n: -sum(by_name[n])):
        durs = by_name[name]
        lines.append(
            f"{name:<28} {len(durs):>5} {_fmt_ms(sum(durs)):>10} "
            f"{_fmt_ms(registry.quantile(durs, 0.5)):>11} "
            f"{_fmt_ms(registry.quantile(durs, 0.95)):>11}"
        )
    return lines


def span_tree(spans: list[dict], max_roots: int = 5) -> list[str]:
    """The newest ``max_roots`` depth-0 spans per thread, with children
    indented under them (a child = a deeper span starting within the
    parent's [start, start+dur) window on the same thread)."""
    lines = []
    by_tid: dict[int, list[dict]] = {}
    for s in spans:
        by_tid.setdefault(s["tid"], []).append(s)
    for tid, tspans in sorted(by_tid.items(), key=lambda kv: str(kv[0])):
        tspans.sort(key=lambda s: s["start_us"])
        roots = [s for s in tspans if s["depth"] == 0][-max_roots:]
        if not roots:
            continue
        lines.append(f"thread {tid}:")
        for root in roots:
            end = root["start_us"] + root["dur_us"]
            members = [
                s for s in tspans
                if root["start_us"] <= s["start_us"] < max(end, root["start_us"] + 1)
                and s["depth"] >= 0 and (s is root or s["depth"] > 0)
            ]
            for s in members:
                attrs = ""
                if s["attrs"]:
                    attrs = "  " + ", ".join(
                        f"{k}={v}" for k, v in sorted(s["attrs"].items())
                    )
                lines.append(
                    f"  {'  ' * s['depth']}{s['name']} "
                    f"{_fmt_ms(s['dur_us'])} ms{attrs}"
                )
    return lines


def gap_analysis(spans: list[dict]) -> list[str]:
    """Per thread: total traced vs untraced time between top-level spans."""
    lines = []
    by_tid: dict[int, list[dict]] = {}
    for s in spans:
        if s["depth"] == 0:
            by_tid.setdefault(s["tid"], []).append(s)
    for tid, roots in sorted(by_tid.items(), key=lambda kv: str(kv[0])):
        roots.sort(key=lambda s: s["start_us"])
        traced = sum(s["dur_us"] for s in roots)
        gaps = []
        for prev, cur in zip(roots, roots[1:]):
            gap = cur["start_us"] - (prev["start_us"] + prev["dur_us"])
            if gap > 0:
                gaps.append(gap)
        span_wall = (
            roots[-1]["start_us"] + roots[-1]["dur_us"] - roots[0]["start_us"]
        )
        biggest = max(gaps) if gaps else 0.0
        lines.append(
            f"thread {tid}: {len(roots)} top-level span(s), traced "
            f"{_fmt_ms(traced)} ms of {_fmt_ms(span_wall)} ms wall; "
            f"untraced gaps {_fmt_ms(sum(gaps))} ms "
            f"(largest {_fmt_ms(biggest)} ms)"
        )
    return lines


def cross_process_gaps(flow_points: list[dict]) -> dict[str, list[float]]:
    """Per flow id, the router-forward -> worker-claim hop in microseconds.

    A gap exists when a flow id has an ``s`` point in one pid and a ``t``
    point in a DIFFERENT pid (the propagated id's contract: the router
    stamps ``s`` at forward time, the adopting worker steps ``t`` at
    accept/claim). The claim point — ``attrs.state == "claimed"`` — is
    preferred; the first foreign ``t`` (admission) is the fallback, so
    partially-adopted traces still measure the hop. Returns
    ``{"fleet_queueing": [gap_us, ...]}`` (empty when the trace is
    single-process)."""
    by_id: dict[str, list[dict]] = {}
    for p in flow_points:
        by_id.setdefault(p["id"], []).append(p)
    gaps: list[float] = []
    for points in by_id.values():
        starts = [p for p in points if p["ph"] == "s"]
        if not starts:
            continue
        start = min(starts, key=lambda p: p["ts_us"])
        foreign = [p for p in points
                   if p["ph"] == "t" and p["pid"] != start["pid"]]
        if not foreign:
            continue
        claimed = [p for p in foreign
                   if p["attrs"].get("state") == "claimed"]
        target = min(claimed or foreign, key=lambda p: p["ts_us"])
        gaps.append(target["ts_us"] - start["ts_us"])
    return {"fleet_queueing": gaps} if gaps else {}


def render(path: str) -> str:
    spans, meta = load_spans(path)
    lines = [f"# trace report: {path}", ""]
    if meta:
        keys = ("reason", "pid", "anchor_unix_ns", "dropped_spans")
        shown = {k: meta[k] for k in keys if k in meta}
        if shown:
            lines.append("meta: " + ", ".join(f"{k}={v}" for k, v in shown.items()))
            lines.append("")
        for name, state in sorted((meta.get("state") or {}).items()):
            lines.append(
                f"state[{name}]: "
                + ", ".join(f"{k}={v}" for k, v in sorted(state.items()))
            )
            lines.append("")
        flows = meta.get("flows")
        if flows:
            # Job-lifecycle flow arrows (obs.trace.flow): how many jobs the
            # trace saw start / step / finish.
            lines.append(
                "job flows: "
                f"{flows.get('s', 0)} started, {flows.get('t', 0)} step(s), "
                f"{flows.get('f', 0)} finished"
            )
            lines.append("")
    if not spans:
        lines.append("(no spans recorded)")
        return "\n".join(lines) + "\n"
    lines.append(f"{len(spans)} span(s)")
    lines.append("")
    pids = sorted({s["pid"] for s in spans})
    if len(pids) > 1:
        # A stitched fleet trace: one phase table per process lane, the
        # lane labeled from the stitcher's process table when present.
        labels = {}
        for name, info in (meta.get("processes") or {}).items():
            labels[info.get("pid")] = name
        for pid in pids:
            label = labels.get(pid)
            lines.append(f"## per-phase — process {pid}"
                         + (f" ({label})" if label else ""))
            lines.extend(phase_table([s for s in spans if s["pid"] == pid]))
            lines.append("")
    else:
        lines.append("## per-phase")
        lines.extend(phase_table(spans))
        lines.append("")
    gaps = cross_process_gaps(meta.get("flow_points") or [])
    for name, values in sorted(gaps.items()):
        lines.append(f"## cross-process gaps — {name} "
                     "(router forward -> worker claim)")
        lines.append(
            f"  {len(values)} hop(s): p50 "
            f"{_fmt_ms(registry.quantile(values, 0.5))} ms, p95 "
            f"{_fmt_ms(registry.quantile(values, 0.95))} ms, max "
            f"{_fmt_ms(max(values))} ms"
        )
        lines.append("")
    lines.append("## span tree (newest top-level spans)")
    lines.extend(span_tree(spans))
    lines.append("")
    lines.append("## gaps (untraced time between top-level spans)")
    lines.extend(gap_analysis(spans))
    reg = meta.get("registry") or {}
    counters = reg.get("counters")
    if counters:
        lines.append("")
        lines.append("## registry counters at dump time")
        for name in sorted(counters):
            lines.append(f"  {name} = {counters[name]}")
    gauges = reg.get("gauges")
    if gauges:
        lines.append("")
        lines.append("## registry gauges at dump time")
        for name in sorted(gauges):
            lines.append(f"  {name} = {gauges[name]}")
    hists = reg.get("histograms")
    if hists:
        # The serving latency/gap distributions (dispatch_gap_seconds,
        # queue/run latency): the same nearest-rank summaries /metrics
        # exports, rendered so a flight dump answers "was the device
        # idling between drains" on its own.
        lines.append("")
        lines.append("## registry histograms at dump time")
        for name in sorted(hists):
            s = hists[name] or {}
            stats = ", ".join(
                f"{k}={s[k]}" for k in ("count", "sum", "p50", "p95", "p99")
                if k in s
            )
            lines.append(f"  {name}: {stats}")
    return "\n".join(lines) + "\n"
