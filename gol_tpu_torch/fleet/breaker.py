"""Per-worker circuit breakers: stop hammering a failing backend.

The router's spillover walk reacts to each failure AFTER paying for
it — every submit to a down or brownout worker costs a connect timeout or
an ambiguous 504 before the next candidate gets a try. A breaker moves
that cost off the hot path: consecutive failures (a hard-down worker) or a
degraded fraction of recent calls (a brownout: slow answers and resets
mixed into successes) flip the worker's breaker OPEN, and the router ranks
open workers LAST — not removed, so the HRW bucket affinity is intact the
moment the worker recovers, and an open worker is still the last resort
when everything better is gone.

State machine (the textbook shape, perf_counter-clocked)::

    CLOSED --consecutive failures >= fail_threshold,
             or degraded fraction of the last `window` calls
             >= degraded_rate (with min_volume)-->        OPEN
    OPEN   --cooldown_s elapsed, next ranked attempt-->   HALF_OPEN
    HALF_OPEN --probe succeeds--> CLOSED
    HALF_OPEN --probe fails-->    OPEN (cooldown re-arms)

HALF_OPEN admits ONE probe: the first attempt after the cooldown runs at
normal rank; while that probe is in flight the worker ranks last again, so
a recovering worker sees a trickle, not a stampede ("thundering herd" is
the failure mode half-open exists to prevent). "Degraded" counts failures
AND slow calls (latency above ``slow_s``): a worker answering everything
200-in-4-seconds is as routable-around as one refusing connections.

The breaker holds NO HTTP knowledge: the router records outcomes
(``on_success(latency)``/``on_failure()``) and reads ``penalty()`` when
ranking. Transitions fire an optional callback — the router's hook into
metrics gauges and the durable breaker ring.

Clocks: ``time.perf_counter`` only (the fleet package's wall-clock ban).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# Gauge encoding (gol_fleet_breaker_state): closed=0, half-open=1, open=2.
STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """The thresholds (CLI: ``gol fleet`` defaults; bench A/Bs them)."""

    fail_threshold: int = 3  # consecutive failures -> OPEN
    window: int = 20  # recent-call ring for the degraded-rate trip
    degraded_rate: float = 0.5  # degraded fraction of the window -> OPEN
    min_volume: int = 10  # window calls required before the rate can trip
    slow_s: float | None = 1.0  # latency above this counts as degraded
    cooldown_s: float = 5.0  # OPEN holds this long before a probe

    def __post_init__(self):
        if self.fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {self.fail_threshold}"
            )
        if self.window < 1 or self.min_volume < 1:
            raise ValueError("window/min_volume must be >= 1")
        if not 0.0 < self.degraded_rate <= 1.0:
            raise ValueError(
                f"degraded_rate must be in (0, 1], got {self.degraded_rate}"
            )
        if self.slow_s is not None and self.slow_s <= 0:
            raise ValueError(f"slow_s must be > 0, got {self.slow_s}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")


class CircuitBreaker:
    """One worker's breaker. Thread-safe; every router thread records
    outcomes and reads penalties concurrently."""

    def __init__(self, config: BreakerConfig | None = None,
                 clock=time.perf_counter, on_transition=None,
                 label: str = ""):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._on_transition = on_transition  # fn(label, old, new) or None
        self.label = label
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._recent: collections.deque = collections.deque(
            maxlen=self.config.window
        )
        self._opened_at: float | None = None
        self._probing = False
        self.opens = 0  # cumulative transitions into OPEN

    # -- reads --------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def penalty(self) -> int:
        """Ranking penalty for the router's candidate order: 0 = route
        normally (CLOSED, or OPEN-past-cooldown — the would-be probe must
        rank normally or recovery never gets traffic), 1 = rank last."""
        with self._lock:
            if self._state == CLOSED:
                return 0
            if self._state == OPEN and self._cooldown_over_locked():
                return 0
            return 1  # OPEN inside cooldown, or HALF_OPEN probe in flight

    def _cooldown_over_locked(self) -> bool:
        return (self._opened_at is None
                or self._clock() - self._opened_at >= self.config.cooldown_s)

    # -- outcome recording --------------------------------------------------

    def on_attempt(self) -> bool:
        """The router is about to use this worker. An OPEN breaker past
        its cooldown becomes HALF_OPEN with THIS call as its single
        probe. Returns whether the caller holds a normal-rank slot:
        True = proceed (CLOSED, or this call just claimed the probe);
        False = the worker is penalized RIGHT NOW (OPEN inside cooldown,
        or another caller's probe is in flight) — ``penalty()`` may have
        said 0 when the candidates were ranked, but a concurrent caller
        claimed the probe first, and forwarding anyway would stampede the
        recovering worker. The router defers False-answered workers to
        the end of its walk (still the last resort, never skipped)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if (self._state == OPEN and self._cooldown_over_locked()
                    and not self._probing):
                self._transition_locked(HALF_OPEN)
                self._probing = True
                return True
            return False

    def on_success(self, latency_s: float = 0.0) -> None:
        slow = (self.config.slow_s is not None
                and latency_s > self.config.slow_s)
        with self._lock:
            if self._state == HALF_OPEN:
                # The probe answered: a fast answer closes; a degraded one
                # is not recovery — re-open and wait out another cooldown.
                self._probing = False
                if slow:
                    self._open_locked()
                else:
                    self._transition_locked(CLOSED)
                    self._consecutive = 0
                    self._recent.clear()
                return
            self._consecutive = 0
            self._recent.append(bool(slow))
            self._maybe_trip_locked()

    def reopen(self) -> None:
        """Warm-start restore (fleet/replicate.py): re-arm the OPEN a
        previous router incarnation's durable ring recorded, with a fresh
        cooldown from NOW — the successor then makes first contact the
        way every open breaker does, via one half-open probe after the
        cooldown, instead of re-learning the failure on real traffic.
        Fires ``on_transition`` like any trip, so the restore itself
        lands in the ring (keeping warm-start idempotent across
        successive router respawns). No-op unless CLOSED."""
        with self._lock:
            if self._state == CLOSED:
                self._open_locked()

    def on_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probing = False
                self._open_locked()
                return
            if self._state == OPEN:
                # A last-resort call failed while already open: re-arm the
                # cooldown so the probe clock starts from the fresh evidence.
                self._opened_at = self._clock()
                return
            self._consecutive += 1
            self._recent.append(True)
            if self._consecutive >= self.config.fail_threshold:
                self._open_locked()
                return
            self._maybe_trip_locked()

    def _maybe_trip_locked(self) -> None:
        cfg = self.config
        if len(self._recent) < cfg.min_volume:
            return
        degraded = sum(self._recent) / len(self._recent)
        if degraded >= cfg.degraded_rate:
            self._open_locked()

    def _open_locked(self) -> None:
        self._transition_locked(OPEN)
        self._opened_at = self._clock()
        self._consecutive = 0
        self._recent.clear()
        self._probing = False

    def _transition_locked(self, new: str) -> None:
        old, self._state = self._state, new
        if new == OPEN and old != OPEN:
            self.opens += 1
        if old != new:
            logger.warning("breaker %s: %s -> %s", self.label or "?",
                           old, new)
            if self._on_transition is not None:
                # Fired under the lock on purpose: transitions are rare,
                # and an out-of-order gauge write (open after the re-close
                # that followed it) would be worse than the contention.
                self._on_transition(self.label, old, new)

    def public(self) -> dict:
        """What /fleet and the durable ring record."""
        with self._lock:
            return {
                "state": self._state,
                "opens": self.opens,
                "consecutive_failures": self._consecutive,
                "window": len(self._recent),
                "degraded": (sum(self._recent) / len(self._recent)
                             if self._recent else 0.0),
            }


__all__ = ["BreakerConfig", "CircuitBreaker", "CLOSED", "HALF_OPEN",
           "OPEN", "STATE_VALUE"]
