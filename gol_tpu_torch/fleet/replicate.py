"""Durable per-router coordination state: what a respawn must not forget.

The router is stateless-by-construction for the DATA plane (the manifest
plus deterministic HRW placement rebuild everything a replica needs to
route), but two pieces of coordination state used to live only in process
memory, and a router respawn silently reset both:

- **MonotonicCounters floors** — the banked per-(worker, series) totals
  that keep the fleet-merged cumulative series monotonic through WORKER
  respawns. Lose them and the merged counters drop by every banked run at
  once: exactly the spurious reset the floors exist to prevent, now
  triggered by a *router* restart.
- **Breaker states** — a breaker that was OPEN when the router died
  protected the fleet from a worker it had evidence against. A successor
  that starts every breaker CLOSED re-learns that evidence the expensive
  way: ``fail_threshold`` real jobs sent into a known-bad hop.

Each router replica owns one state directory, ``<fleet_dir>/routers/<id>/``
(single writer per directory — the obs/history ring's own discipline), and
*merges across all of them on load*: a replacement router under a fresh id
still inherits every sibling's floors and breaker evidence.

Formats, chosen per access pattern:

- floors are a bounded SNAPSHOT (``floors.json``, atomic tmp+fsync+
  replace): the state is a small dict that supersedes itself wholesale,
  so a ring would only defer the fold to every reader;
- breaker transitions stay an append-only RING (``breaker-history/``, the
  ``obs/history.HistoryWriter``) because the sequence itself is the
  operator's audit trail; warm-start folds it to last-state-per-worker.

Merge rules are deliberately conservative: floors take the LARGER banked
total per series (floors only ever grow; the bigger one has seen more),
and a worker reads as warm-OPEN if ANY replica's last word on it was
open/half-open — the cost of being wrong is one cooldown plus one
half-open probe, the cost of the liberal rule is a storm of real jobs
into a dead worker.

Clocks: none here either (the lint pin covers this file) — persisted
state carries no timestamps, because perf_counter anchors do not compare
across processes and wall clocks step.
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger(__name__)

ROUTERS_SUBDIR = "routers"
FLOORS_FILENAME = "floors.json"
BREAKER_RING = "breaker-history"
ADVERT_FILENAME = "advert.json"


def routers_root(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, ROUTERS_SUBDIR)


def state_dir(fleet_dir: str, router_id: str) -> str:
    """One replica's durable-state home: floors, breaker ring, and the
    advertisement file live under it; nothing else ever writes there."""
    return os.path.join(routers_root(fleet_dir), router_id)


class FloorsStore:
    """Atomic snapshot persistence for ``MonotonicCounters.state()``.

    ``save`` never raises (coordination durability must not take down the
    scrape path that feeds it) and skips the write entirely when the
    state has not moved — an idle fleet costs zero I/O. ``load`` is
    torn-tolerant: the write is atomic, so a parse failure means external
    damage, and the honest response is to start floors empty (the
    value-regression fallback still catches future worker respawns)."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, FLOORS_FILENAME)
        self._last_saved: dict | None = None

    def load(self) -> dict | None:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                state = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(state, dict):
            return None
        self._last_saved = state
        return state

    def save(self, state: dict) -> None:
        if state == self._last_saved:
            return
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f, separators=(",", ":"))
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._last_saved = state
        except OSError as err:
            logger.error("router floors save failed (%s); merged counters "
                         "would reset if this router dies before it "
                         "recovers", err)


def _floor_pairs(state: dict) -> dict[tuple, tuple[float, float]]:
    """{(worker, series-key): (base, last)} from one persisted state."""
    pairs: dict[tuple, tuple[float, float]] = {}
    for kind, slot in (("base", 0), ("last", 1)):
        for entry in state.get(kind) or []:
            try:
                wid, skey, value = entry
                key = (str(wid), tuple(skey))
            except (TypeError, ValueError):
                continue
            base, last = pairs.get(key, (0.0, 0.0))
            pairs[key] = ((float(value), last) if slot == 0
                          else (base, float(value)))
    return pairs


def load_merged_floors(fleet_dir: str) -> dict | None:
    """The union of every replica's persisted floors, larger-total-wins
    per (worker, series) — what a (re)starting router seeds its
    ``MonotonicCounters`` with. None when no replica ever persisted."""
    root = routers_root(fleet_dir)
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return None
    merged: dict[tuple, tuple[float, float]] = {}
    incarnations: dict[str, int] = {}
    found = False
    for name in entries:
        state = FloorsStore(os.path.join(root, name)).load()
        if state is None:
            continue
        found = True
        for key, (base, last) in _floor_pairs(state).items():
            prev = merged.get(key)
            if prev is None or base + last > prev[0] + prev[1]:
                merged[key] = (base, last)
        for wid, gen in (state.get("incarnations") or {}).items():
            try:
                incarnations[wid] = max(incarnations.get(wid, 0), int(gen))
            except (TypeError, ValueError):
                continue
    if not found:
        return None
    return {
        "version": 1,
        "base": [[wid, list(skey), base]
                 for (wid, skey), (base, _) in merged.items() if base],
        "last": [[wid, list(skey), last]
                 for (wid, skey), (_, last) in merged.items()],
        "incarnations": incarnations,
    }


def advertise(fleet_dir: str, router_id: str, url: str) -> None:
    """Publish this replica's URL + pid into its state dir (atomic, best
    effort): the operator-facing replica roster behind ``GET /fleet`` and
    ``gol top``. Display only, like the lease file's stamp — routing
    authority is the manifest, leadership authority is the flock."""
    directory = state_dir(fleet_dir, router_id)
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, ADVERT_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"id": router_id, "url": url, "pid": os.getpid()}, f)
            f.write("\n")
        os.replace(tmp, path)
    except OSError as err:
        logger.warning("router advert write failed (%s)", err)


def list_routers(fleet_dir: str) -> list[dict]:
    """Every replica that ever advertised, with a best-effort ``alive``
    bit (pid still exists — pid reuse can lie, which is why nothing but
    dashboards reads it; a dead replica's advert lingering is normal)."""
    root = routers_root(fleet_dir)
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    out = []
    for name in entries:
        path = os.path.join(root, name, ADVERT_FILENAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                advert = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(advert, dict):
            continue
        pid = advert.get("pid")
        alive = False
        if isinstance(pid, int):
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except OSError:
                alive = True  # EPERM: the pid exists, just not ours
        out.append({**advert, "alive": alive})
    return out


def warm_breaker_states(fleet_dir: str) -> dict[str, str]:
    """{worker id: "open"} for every worker some replica's durable breaker
    ring last recorded as open or half-open — the evidence a fresh router
    re-arms instead of re-learning. Half-open folds to open: the probe
    that was in flight died with the old router, and re-arming OPEN hands
    the successor a fresh cooldown before ITS single probe."""
    root = routers_root(fleet_dir)
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return {}
    from gol_tpu_torch.obs import history as obs_history

    warm: dict[str, str] = {}
    for name in entries:
        ring = os.path.join(root, name, BREAKER_RING)
        if not os.path.isdir(ring):
            continue
        last: dict[str, str] = {}
        for record in obs_history.read_records(ring):
            event = record.get("breaker")
            if isinstance(event, dict) and event.get("worker"):
                last[str(event["worker"])] = str(event.get("to") or "")
        for wid, to_state in last.items():
            if to_state in ("open", "half-open"):
                warm[wid] = "open"
    return warm
