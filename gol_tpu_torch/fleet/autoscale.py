"""SLO-driven autoscaling: the loop that closes sensors onto actuators.

``gol fleet --workers N`` is static: a human picks N at boot and the
fleet holds it through traffic spikes and dead air alike. Every signal
needed to do better already exists — the multi-window SLO burn rates,
the queue-saturation gauges, the per-bucket dispatch-gap ratios — and so
does every actuator: the fleet's supervised spawn/respawn, cascaded drain, and
HRW's test-pinned minimal-disruption placement. This module is only the
loop between them:

- **scale up** when the fleet is provably behind: a worker's SLO engine
  reports an objective CRITICAL (by construction that means burn >=
  ``critical_burn`` on EVERY window — the multi-window rule, so one slow
  batch cannot trigger a spawn) or merged queue depth climbs past
  ``up_saturation`` of the fleet-wide admission cap, sustained for
  ``up_sustain`` consecutive ticks. The new worker lands on the lowest
  free partition id (reusing retired partitions, whose journals hold
  only terminal records) and — under ``--cores-per-worker`` pinning — on
  its own core slice. HRW hands it ONLY the buckets it now owns; nothing
  else moves.
- **scale down** when capacity is provably idle: fleet occupancy (queued
  + in-flight over the admission cap) below ``down_occupancy`` with no
  SLO burn, sustained for ``down_sustain`` ticks. The emptiest worker is
  drained (every accepted job finishes and journals its done record),
  then stopped and removed — ``Fleet.retire``'s ordering guarantees the
  partition is never orphaned mid-job, and HRW moves only the retiree's
  buckets back. A drain that fails aborts the retire: capacity is
  cheaper than a job.
- **hysteresis + cooldown** prevent flapping: the up and down conditions
  are separated by a wide dead band (0.8 of cap vs 0.05 of cap by
  default), each needs its sustain streak, and after any scale event no
  new decision fires for ``cooldown_s``.

The tick rides the fleet health loop (``Fleet.add_tick_hook``) — one
cadence, one thread, and the worker /slo payloads the loop already
fetched per tick are the burn signal (no second probe fan-out). Actions
run on a background thread (a spawn blocks in ``_await_ready`` for a
worker boot; the health loop must keep probing meanwhile); one action in
flight at a time.

Every decision is observable three ways (the "why did the fleet grow"
contract): ``fleet.scale`` spans + ``autoscaler_*`` series on the
router registry (merged /metrics, ``gol top``), and a decision record
per tick appended to a durable history ring
(``<fleet-dir>/autoscaler-history``) that ``gol history-report`` and the
bench suite replay.

Clocks: ``time.perf_counter`` only (the package-wide wall-clock ban).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

from gol_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger(__name__)

UP = "up"
DOWN = "down"
HOLD = "hold"


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The policy knobs (CLI: ``gol fleet --autoscale ...``)."""

    min_workers: int = 1
    max_workers: int = 4
    up_saturation: float = 0.8  # queued / (per-worker cap * workers)
    up_sustain: int = 2  # consecutive ticks the up condition must hold
    down_occupancy: float = 0.05  # (queued + inflight) / cap
    down_sustain: int = 10
    cooldown_s: float = 30.0
    drain_timeout: float = 600.0

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}"
            )
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})"
            )
        if not 0.0 < self.up_saturation <= 1.0:
            raise ValueError(
                f"up_saturation must be in (0, 1], got {self.up_saturation}"
            )
        if not 0.0 <= self.down_occupancy < self.up_saturation:
            raise ValueError(
                f"down_occupancy ({self.down_occupancy}) must be >= 0 and "
                f"below up_saturation ({self.up_saturation}) — the dead "
                "band IS the flap protection"
            )
        if self.up_sustain < 1 or self.down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")


class Autoscaler:
    """One autoscaling loop over one fleet + router pair.

    ``queue_capacity`` is the PER-WORKER admission cap (the workers'
    ``--max-queue-depth``): saturation and occupancy normalize against
    ``cap * live_normal_workers``, so the thresholds mean the same thing
    at every fleet size. ``tick()`` is public and synchronous-decision /
    asynchronous-action; tests drive it deterministically with an
    injected clock and stub fleet/router."""

    def __init__(
        self,
        fleet,
        router,
        config: AutoscaleConfig | None = None,
        queue_capacity: int = 1024,
        history=None,
        clock=time.perf_counter,
        sync_actions: bool = False,
    ):
        self.fleet = fleet
        self.router = router
        self.config = config or AutoscaleConfig()
        self.queue_capacity = max(1, int(queue_capacity))
        self.history = history  # obs/history.HistoryWriter or None
        self._clock = clock
        self._sync_actions = sync_actions  # tests: act inline, no thread
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_event_at: float | None = None
        self._action_thread: threading.Thread | None = None
        self._acting = False
        self._closed = False
        self._ticks = 0
        self._last_decision: dict | None = None
        self._last_scale: dict | None = None
        self._target: int | None = None

    # -- signals -----------------------------------------------------------

    def _normals(self) -> list:
        """The scalable pool: local, non-big, non-retiring workers (the
        big lane and attached workers are not the autoscaler's to move)."""
        return [w for w in self.fleet.workers()
                if not w.big and not w.attached and not w.retiring]

    def signals(self) -> dict:
        """One tick's sensor read, scoped to the pool a scale event can
        actually help: queue/inflight summed over the NORMAL-bucket
        workers (big-lane queues are a separate pool — spawning a normal
        worker cannot absorb them; retiring workers take nothing new and
        their stored /slo is frozen), burn/criticality from the same
        pool (attached normals share the bucket load, so their burn IS a
        legitimate scale-up signal even though only local workers can be
        spawned/retired), per-bucket dispatch-gap ratios as context.
        Saturation/occupancy normalize by the serving pool's aggregate
        admission cap; the min/max clamps in ``decide`` count only the
        SCALABLE (local) workers."""
        snaps, merged = self.router._merged_snapshot()
        gauges = merged.get("gauges") or {}
        # pool = everyone absorbing normal-bucket load; scalable = the
        # subset the actuators can add/remove.
        pool = [w for w in self.fleet.workers()
                if not w.big and not w.retiring]
        pool_ids = {w.id for w in pool}
        cap = float(self.queue_capacity * max(1, len(pool)))
        queued = inflight = 0.0
        per_worker = {}
        for wid, snap in snaps.items():
            wg = (snap or {}).get("gauges") or {}
            load_q = float(wg.get("queue_depth") or 0.0)
            load_i = float(wg.get("inflight_batches") or 0.0)
            per_worker[wid] = load_q + load_i
            if wid in pool_ids:
                queued += load_q
                inflight += load_i
        burn = 0.0
        critical = []
        for worker in pool:
            if not worker.healthy or worker.respawning:
                # check_worker only refreshes .slo on a successful probe:
                # an unreachable attached worker (never respawned) or a
                # local worker stuck in a respawn loop carries a payload
                # frozen at its last good tick, and a frozen CRITICAL
                # would pin the up-condition true on dead data.
                continue
            slo = worker.slo
            if not slo:
                continue
            for obj in slo.get("objectives") or []:
                burn = max(burn, float(obj.get("burn") or 0.0))
                if obj.get("status") == "critical":
                    critical.append(f"{worker.id}:{obj.get('name')}")
        gaps = {
            name[len("dispatch_gap_ratio_"):]: round(float(value), 4)
            for name, value in gauges.items()
            if name.startswith("dispatch_gap_ratio_")
        }
        return {
            "workers": len(self._normals()),
            "pool": len(pool),
            "queued": queued,
            "inflight": inflight,
            "saturation": queued / cap,
            "occupancy": (queued + inflight) / cap,
            "burn": round(burn, 4),
            "critical": critical,
            "gap_ratios": gaps,
            "per_worker_load": per_worker,
        }

    # -- decision ----------------------------------------------------------

    def decide(self, signals: dict) -> dict:
        """Pure-ish policy: fold one tick's signals into the streaks and
        return the decision record (``action`` in {up, down, hold} plus
        the triggering signal). Mutates only the hysteresis state."""
        cfg = self.config
        n = signals["workers"]
        up_condition = bool(signals["critical"]) or (
            signals["saturation"] >= cfg.up_saturation
        )
        down_condition = (
            not signals["critical"]
            and signals["burn"] < 1.0
            and signals["occupancy"] <= cfg.down_occupancy
        )
        self._up_streak = self._up_streak + 1 if up_condition else 0
        self._down_streak = self._down_streak + 1 if down_condition else 0
        now = self._clock()
        cooling = (self._last_event_at is not None
                   and now - self._last_event_at < cfg.cooldown_s)
        action, reason = HOLD, ""
        if self._acting:
            reason = "action in flight"
        elif cooling:
            reason = "cooldown"
        elif (up_condition and self._up_streak >= cfg.up_sustain
                and n < cfg.max_workers):
            action = UP
            reason = ("slo critical: " + ",".join(signals["critical"])
                      if signals["critical"] else
                      f"queue saturation {signals['saturation']:.2f} >= "
                      f"{cfg.up_saturation:.2f}")
        elif up_condition and self._up_streak >= cfg.up_sustain:
            reason = f"at max_workers {cfg.max_workers}"
        elif (down_condition and self._down_streak >= cfg.down_sustain
                and n > cfg.min_workers):
            action = DOWN
            reason = (f"occupancy {signals['occupancy']:.3f} <= "
                      f"{cfg.down_occupancy:.3f} for {self._down_streak} "
                      "ticks")
        elif down_condition and self._down_streak >= cfg.down_sustain:
            reason = f"at min_workers {cfg.min_workers}"
        target = n + (1 if action == UP else -1 if action == DOWN else 0)
        return {
            "action": action,
            "reason": reason,
            "target": target,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            **{k: v for k, v in signals.items() if k != "per_worker_load"},
        }

    # -- the tick ----------------------------------------------------------

    def tick(self) -> dict | None:
        """One autoscaler evaluation (rides ``Fleet.health_tick``)."""
        if self._closed or getattr(self.router, "_draining", False):
            return None
        if not getattr(self.fleet, "supervise", True):
            # Leader-gated (fleet/lease.py): only the lease holder makes
            # scale decisions — two replicas double-counting one queue
            # spike would spawn twice the workers. A follower also skips
            # the streak/cooldown bookkeeping on purpose: when it takes
            # over, it starts from clean hysteresis instead of streaks
            # accumulated while powerless to act.
            return None
        signals = self.signals()
        decision = self.decide(signals)
        victim = None
        if decision["action"] == DOWN:
            # Resolved BEFORE the decision is exported/recorded: a DOWN
            # with no retireable worker demotes to HOLD everywhere —
            # gauges, the `gol top` panel, and the durable ring must
            # never disagree about what this tick decided.
            victim = self._pick_victim(signals)
            if victim is None:
                decision["action"] = HOLD
                decision["reason"] = "no retireable worker"
                decision["target"] = signals["workers"]
            else:
                decision["victim"] = victim
        self._ticks += 1
        self._last_decision = decision
        self._target = decision["target"]
        self._export(decision)
        if decision["action"] == UP:
            self._launch_action(UP, None, decision)
        elif decision["action"] == DOWN:
            self._launch_action(DOWN, victim, decision)
        self._record(decision)
        return decision

    def _pick_victim(self, signals: dict) -> str | None:
        """The emptiest retireable worker (least queued + in-flight per
        this tick's scrape; drain finishes whatever it does hold)."""
        load = signals.get("per_worker_load") or {}
        normals = self._normals()
        if len(normals) <= self.config.min_workers:
            return None
        return min(normals, key=lambda w: (load.get(w.id, 0.0), w.id)).id

    # -- actuation ---------------------------------------------------------

    def _launch_action(self, action: str, victim: str | None,
                       decision: dict) -> None:
        with self._lock:
            # _closed is re-checked HERE, under the lock close() takes to
            # set it: a tick already past its entry check when shutdown
            # begins must not launch a spawn that close() never joins
            # (an orphaned serve process after `gol fleet` exits).
            if self._acting or self._closed:
                return
            self._acting = True

        def run():
            try:
                with obs_trace.span("fleet.scale", action=action,
                                    worker=victim or "",
                                    reason=decision["reason"],
                                    target=decision["target"]):
                    ok = (self._scale_up() if action == UP
                          else self._scale_down(victim))
                outcome = {
                    "action": action, "ok": ok,
                    "worker": victim, "reason": decision["reason"],
                    "target": decision["target"],
                }
                self._last_scale = outcome
                self._record({"record_kind": "scale", **outcome})
            finally:
                with self._lock:
                    self._acting = False
                    self._last_event_at = self._clock()
                    self._up_streak = 0
                    self._down_streak = 0

        if self._sync_actions:
            run()
            return
        with self._lock:
            if self._closed:
                self._acting = False
                return
            # Assigned AND started under the lock: close() reads
            # _action_thread under the same lock, so any launched action
            # is always alive by the time close() decides whether to join.
            thread = threading.Thread(
                target=run, name="gol-fleet-autoscale", daemon=True
            )
            self._action_thread = thread
            thread.start()

    def _scale_up(self) -> bool:
        try:
            worker = self.fleet.spawn()
        except (RuntimeError, OSError) as err:
            logger.error("autoscaler: scale-up spawn failed (%s); will "
                         "retry after cooldown", err)
            self.router.registry.inc("autoscaler_scale_failures_total")
            return False
        self.router.registry.inc("autoscaler_scale_ups_total")
        logger.warning("autoscaler: scaled UP to %d workers (+%s)",
                       len(self._normals()), worker.id)
        return True

    def _scale_down(self, victim: str) -> bool:
        ok = self.fleet.retire(victim,
                               drain_timeout=self.config.drain_timeout)
        if ok:
            self.router.registry.inc("autoscaler_scale_downs_total")
            logger.warning("autoscaler: scaled DOWN to %d workers (-%s)",
                           len(self._normals()), victim)
        else:
            self.router.registry.inc("autoscaler_scale_failures_total")
        return ok

    # -- observability -----------------------------------------------------

    def _export(self, decision: dict) -> None:
        reg = self.router.registry
        reg.set_gauge("autoscaler_workers", decision["workers"])
        reg.set_gauge("autoscaler_target_workers", decision["target"])
        reg.set_gauge("autoscaler_queue_saturation",
                      round(decision["saturation"], 4))
        reg.set_gauge("autoscaler_occupancy",
                      round(decision["occupancy"], 4))
        reg.inc("autoscaler_ticks_total")

    def _record(self, decision: dict) -> None:
        if self.history is None:
            return
        self.history.append({"autoscaler": decision})

    def public(self) -> dict:
        """The ``gol top`` / merged-metrics panel payload."""
        cfg = self.config
        return {
            "enabled": True,
            "min": cfg.min_workers,
            "max": cfg.max_workers,
            "workers": len(self._normals()),
            "target": self._target,
            "scaling": self._acting,
            "ticks": self._ticks,
            "last_decision": self._last_decision,
            "last_scale": self._last_scale,
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop deciding and join any in-flight action (shutdown must not
        race a spawn it will never supervise)."""
        with self._lock:
            self._closed = True
            thread = self._action_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)
        if self.history is not None:
            self.history.close()


__all__ = ["AutoscaleConfig", "Autoscaler", "DOWN", "HOLD", "UP"]
