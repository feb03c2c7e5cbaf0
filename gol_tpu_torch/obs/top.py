"""``gol top``: a live ANSI terminal dashboard over /metrics + /slo.

A copy of ``gol_tpu/obs/top.py`` (pure rendering; its frames are
byte-identical to the JAX package's for the same payloads). One screen,
refreshed in place, answering the operator's standing questions
without curl loops: is the queue backing up, are the rings full, where are
the latency percentiles, is any SLO burning, and how close to the tuned
roofline is the service running (the live dispatch-gap ratio).

Pure rendering here — ``render_frame`` maps the two JSON payloads (the
``/metrics?format=json`` snapshot, whose ``process`` section carries the
process-global registry, and the ``/slo`` status) to one string; the CLI
owns polling and the terminal. Keeping it pure keeps it testable and keeps
this package free of HTTP concerns.
"""

from __future__ import annotations

CLEAR = "\x1b[2J\x1b[H"  # clear screen + cursor home
_RESET = "\x1b[0m"
_COLORS = {"ok": "\x1b[32m", "warning": "\x1b[33m", "critical": "\x1b[31m"}


def _color(status: str, text: str, ansi: bool) -> str:
    if not ansi:
        return text
    return _COLORS.get(status, "") + text + _RESET


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != 0 and (abs(v) >= 1e5 or abs(v) < 1e-3):
            return f"{v:.3e}"
        return f"{v:.3f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def _bytes_h(v) -> str:
    """Human byte figure for the storage row (None renders as '-')."""
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return (f"{v:.0f}{unit}" if unit == "B"
                    else f"{v:.1f}{unit}")
        v /= 1024
    return f"{v:.1f}TiB"


def _bar(frac: float, width: int = 20) -> str:
    frac = max(0.0, min(1.0, frac))
    filled = round(frac * width)
    return "[" + "#" * filled + "." * (width - filled) + "]"


def render_frame(metrics: dict, slo: dict | None, *, ansi: bool = True,
                 title: str = "gol top") -> str:
    """One dashboard frame from the two polled payloads (either may be an
    empty dict when its endpoint was unreachable — the frame says so
    instead of dying, because `gol top` outliving a crashing server is the
    point of a dashboard)."""
    counters = metrics.get("counters") or {}
    gauges = metrics.get("gauges") or {}
    hists = metrics.get("histograms") or {}
    process = metrics.get("process") or {}
    pgauges = process.get("gauges") or {}
    phists = process.get("histograms") or {}

    overall = (slo or {}).get("status", "?")
    fleet = metrics.get("fleet") or {}
    lines = [
        f"{title} — SLO {_color(overall, overall.upper(), ansi)}"
        + ("" if metrics else "   [/metrics unreachable]")
        + ("" if slo else "   [/slo unreachable]"),
    ]
    if fleet:
        # A fleet router's payload: the merged series render below exactly
        # as a single worker's would; this line says what they sum over.
        lines.append(
            f"fleet: {int(fleet.get('workers', 0))} workers, "
            f"{int(fleet.get('healthy', 0))} healthy, "
            f"{int(fleet.get('backpressured', 0))} backpressured, "
            f"{int(fleet.get('restarts', 0))} restart(s)"
            + (f", {int(fleet['retiring'])} retiring"
               if fleet.get("retiring") else "")
            + ("   DRAINING" if fleet.get("draining") else "")
        )
    autoscaler = (fleet or {}).get("autoscaler") or {}
    if autoscaler.get("enabled"):
        # The elastic-fleet panel: target vs actual N inside the
        # [min..max] band, plus the signal behind the last decision — the
        # one-line answer to "why is the fleet this size right now".
        last = autoscaler.get("last_decision") or {}
        target = autoscaler.get("target")
        action = last.get("action", "-")
        status = ("warning" if autoscaler.get("scaling")
                  else "ok" if action == "hold" else "warning")
        line = (
            f"autoscale: {int(autoscaler.get('workers', 0))} workers"
            f" (target {int(target) if target is not None else '-'},"
            f" min {int(autoscaler.get('min', 0))}"
            f" max {int(autoscaler.get('max', 0))})"
            + ("   SCALING" if autoscaler.get("scaling") else "")
        )
        if last:
            line += (
                f"   sat {_fmt(last.get('saturation'))}"
                f" occ {_fmt(last.get('occupancy'))}"
                f" burn {_fmt(last.get('burn'))}"
            )
            if last.get("action") not in (None, "hold") or last.get("reason"):
                line += f"   last: {action}"
                if last.get("reason"):
                    line += f" ({last['reason']})"
        lines.append(_color(status, line, ansi) if action != "hold"
                     else line)
    router_reg = (fleet or {}).get("router") or {}
    rcounters = router_reg.get("counters") or {}
    rgauges = router_reg.get("gauges") or {}
    rhists = router_reg.get("histograms") or {}
    owned = {k[len("shard_tiles_owned_"):]: v for k, v in rgauges.items()
             if k.startswith("shard_tiles_owned_")}
    if rcounters.get("shard_jobs_total") or owned:
        # The sharded-universe panel: one giant board split across the
        # fleet. The durable super-step is the replay floor — a SIGKILLed
        # worker rewinds to it, nobody else moves past it un-checkpointed.
        ss = rhists.get("shard_superstep_seconds") or {}
        lines.append(
            f"shard: jobs {int(rcounters.get('shard_jobs_total', 0))}"
            f"  done {int(rcounters.get('shard_jobs_done_total', 0))}"
            f"  failed {int(rcounters.get('shard_jobs_failed_total', 0))}"
            f"   durable step {int(rgauges.get('shard_durable_step', 0))}"
            f"   recoveries {int(rcounters.get('shard_recoveries_total', 0))}"
            f"   superstep p50 {_fmt(ss.get('p50'))}s"
            f" p95 {_fmt(ss.get('p95'))}s"
        )
        if owned:
            lines.append("  tiles: " + "  ".join(
                f"{wid} {int(n)}" for wid, n in sorted(owned.items())))
    lines.append("")

    # -- queue / flow -------------------------------------------------------
    lines.append("queue")
    depth = gauges.get("queue_depth", 0)
    lines.append(
        f"  depth {int(depth):>6}   inflight {int(gauges.get('inflight_batches', 0)):>3}"
        f"   journal-q {int(gauges.get('journal_queue_depth', 0)):>3}"
        f"   boards/s {_fmt(gauges.get('boards_per_sec'))}"
    )
    lines.append(
        f"  jobs: accepted {int(counters.get('jobs_accepted_total', 0))}"
        f"  done {int(counters.get('jobs_completed_total', 0))}"
        f"  failed {int(counters.get('jobs_failed_total', 0))}"
        f"  rejected {int(counters.get('jobs_rejected_total', 0))}"
        f"  shed {int(counters.get('jobs_shed_total', 0))}"
        f"  batches {int(counters.get('batches_total', 0))}"
    )
    # Result cache (only when a cache is mounted — the counters exist then).
    # The ratio is "consults that avoided an engine run": coalesced
    # submissions are counted inside misses (every tier missed) AND here,
    # so (hits + coalesced) / (hits + misses) is well-formed.
    hits = counters.get("cache_hits_total")
    misses = counters.get("cache_misses_total")
    if hits is not None or misses is not None:
        hits, misses = hits or 0, misses or 0
        coalesced = counters.get("cache_inflight_coalesced_total", 0)
        consults = hits + misses
        ratio = (hits + coalesced) / consults if consults else 0.0
        lines.append(
            f"  cache: hit ratio {_bar(ratio)} {ratio:.2f}"
            f"   hits {int(hits)} (mem {int(counters.get('cache_hits_total_memory', 0))}"
            f"/disk {int(counters.get('cache_hits_total_disk', 0))})"
            f"  coalesced {int(coalesced)}  misses {int(misses)}"
        )
    # Storage lifecycle (only when a journal/guard exports the gauges):
    # durable footprint, compaction count, and the watchdog's pressure
    # level — the answer to "is any partition about to fill".
    jbytes = gauges.get("journal_bytes")
    free = gauges.get("disk_free_bytes")
    if jbytes is not None or free is not None:
        level = int(gauges.get("disk_pressure_level", 0))
        level_names = ("ok", "shed-cas", "shed-ckpt", "REFUSING")
        level_name = (level_names[level] if 0 <= level < len(level_names)
                      else str(level))
        status = "ok" if level == 0 else ("critical" if level >= 3
                                          else "warning")
        line = (
            f"  storage: journal {_bytes_h(jbytes)}"
            f" (segs {int(gauges.get('journal_segments', 0))},"
            f" compactions {int(counters.get('compactions_total', 0))})"
            f"   cas {_bytes_h(gauges.get('cas_bytes'))}"
            f"   free {_bytes_h(free)}   guard {level_name}"
        )
        shed = counters.get("cas_writes_shed_total", 0)
        refused = counters.get("jobs_refused_disk_total", 0)
        if shed or refused:
            line += (f"   (shed {int(shed)} cas write(s),"
                     f" refused {int(refused)} job(s))")
        lines.append(_color(status, line, ansi) if level else line)
    # Sparse lane (only when sparse jobs have run — the counters exist
    # then): tile-steps executed and the last universe's live-tile
    # occupancy, the numbers that say how much dead area was elided.
    sparse_tiles = counters.get("sparse_tiles_simulated_total")
    if sparse_tiles is not None:
        occ = gauges.get("sparse_occupancy", 0.0)
        lines.append(
            f"  sparse: tiles {int(sparse_tiles)}"
            f"   occupancy {_bar(occ)} {occ:.4f}"
        )

    # -- rings / dispatch gap ----------------------------------------------
    ring_occ = pgauges.get("ring_slot_occupancy")
    gap = gauges.get("dispatch_gap_ratio")
    if ring_occ is not None or gap is not None:
        lines.append("")
        lines.append("device")
        if ring_occ is not None:
            lines.append(f"  ring occupancy {_bar(ring_occ)} {_fmt(ring_occ)}")
        if gap is not None:
            lines.append(
                f"  dispatch gap   {_bar(gap)} {_fmt(gap)} of tuned roofline"
                f"   ({_fmt(gauges.get('serve_cell_updates_per_sec'))} cells/s)"
            )
        gap_hist = phists.get("dispatch_gap_seconds")
        if gap_hist:
            lines.append(
                f"  device idle between drains: p50 {_fmt(gap_hist.get('p50'))}s"
                f"  p99 {_fmt(gap_hist.get('p99'))}s"
                f"  (n={gap_hist.get('count')})"
            )

    # -- latency percentiles ------------------------------------------------
    rows = [
        (name, hists[name]) for name in (
            "queue_latency_seconds", "run_latency_seconds",
            "job_latency_seconds", "job_latency_seconds_high",
            "job_latency_seconds_normal", "job_latency_seconds_low",
        ) if name in hists
    ]
    if rows:
        lines.append("")
        lines.append(f"  {'latency (s)':<28} {'p50':>10} {'p95':>10} "
                     f"{'p99':>10} {'count':>8}")
        for name, h in rows:
            lines.append(
                f"  {name:<28} {_fmt(h.get('p50')):>10} "
                f"{_fmt(h.get('p95')):>10} {_fmt(h.get('p99')):>10} "
                f"{h.get('count', 0):>8}"
            )

    # -- SLO burn rates -----------------------------------------------------
    objectives = (slo or {}).get("objectives") or []
    if objectives:
        windows = [f"{w}s" for w in (slo.get("windows_s") or [])]
        lines.append("")
        header = f"  {'objective':<24} {'status':>9}"
        for w in windows:
            header += f" {'burn@' + w:>11}"
        lines.append(header)
        for r in objectives:
            row = f"  {r['name']:<24} " + _color(
                r["status"], f"{r['status']:>9}", ansi
            )
            for w in windows:
                win = (r.get("windows") or {}).get(w) or {}
                row += f" {win.get('burn', 0.0):>11.3f}"
            lines.append(row)

    # -- per-bucket achieved rates -----------------------------------------
    buckets = sorted(
        (name[len("bucket_cell_updates_per_sec_"):], value)
        for name, value in gauges.items()
        if name.startswith("bucket_cell_updates_per_sec_")
    )
    if buckets:
        lines.append("")
        lines.append("  bucket throughput (cell-updates/s)")
        for bucket, rate in buckets:
            ratio = gauges.get(f"dispatch_gap_ratio_{bucket}")
            extra = f"   gap {_fmt(ratio)}" if ratio is not None else ""
            lines.append(f"    {bucket:<28} {_fmt(rate):>12}{extra}")

    # -- per-worker columns (fleet router payloads only) --------------------
    workers = metrics.get("workers") or {}
    if workers:
        slo_workers = (slo or {}).get("workers") or {}
        # Circuit-breaker column: present only when the router
        # runs breakers — the header stays byte-identical otherwise.
        breakers = (fleet or {}).get("breakers")
        brk_head = f" {'brk':>9}" if breakers is not None else ""
        lines.append("")
        lines.append(
            f"  {'worker':<8} {'state':<13}{brk_head} {'queue':>6} "
            f"{'inflight':>8} "
            f"{'done':>9} {'failed':>7} {'boards/s':>10} {'slo':>12}"
        )
        for wid in sorted(workers):
            snap = workers[wid] or {}
            health = snap.get("health") or {}
            if snap.get("unreachable"):
                state, state_status = "unreachable", "critical"
            elif not health.get("healthy", True):
                state, state_status = "unhealthy", "critical"
            elif health.get("backpressure"):
                state, state_status = "backpressured", "warning"
            else:
                state, state_status = "ok", "ok"
            brk_cell = ""
            if breakers is not None:
                brk = breakers.get(wid, "closed")
                brk_status = {"closed": "ok", "half-open": "warning",
                              "open": "critical"}.get(brk, "warning")
                brk_cell = " " + _color(brk_status, f"{brk:>9}", ansi)
            wg = snap.get("gauges") or {}
            wc = snap.get("counters") or {}
            wslo = (slo_workers.get(wid) or {}).get("status", "-")
            lines.append(
                f"  {wid:<8} "
                + _color(state_status, f"{state:<13}", ansi)
                + brk_cell
                + f" {int(wg.get('queue_depth', 0)):>6}"
                f" {int(wg.get('inflight_batches', 0)):>8}"
                f" {int(wc.get('jobs_completed_total', 0)):>9}"
                f" {int(wc.get('jobs_failed_total', 0)):>7}"
                f" {_fmt(wg.get('boards_per_sec')):>10} "
                + _color(wslo, f"{wslo:>12}", ansi)
            )

    # -- router replicas (the horizontal control plane) ---------------------
    # Present only when the answering router advertises a replica roster;
    # every older payload skips the panel byte-identically. "(this view)"
    # names the replica whose scrape built THIS frame — under --servers
    # failover the dashboard may follow a different replica next frame.
    routers = (fleet or {}).get("routers") or []
    if routers:
        me = (fleet or {}).get("router_id")
        lines.append("")
        lines.append(f"  {'router':<8} {'state':<8} {'pid':>7}  url")
        for r in routers:
            alive = bool(r.get("alive"))
            state = "alive" if alive else "gone"
            marker = ""
            if r.get("id") == me:
                marker = (" (this view, leader)" if (fleet or {}).get("leader")
                          else " (this view)")
            lines.append(
                f"  {str(r.get('id', '?')):<8} "
                + _color("ok" if alive else "critical", f"{state:<8}", ansi)
                + f" {int(r.get('pid') or 0):>7}  {r.get('url', '')}"
                f"{marker}"
            )

    return "\n".join(lines) + "\n"


__all__ = ["CLEAR", "render_frame"]
