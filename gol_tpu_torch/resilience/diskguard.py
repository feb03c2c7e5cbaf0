"""Disk-pressure watchdog: tiered degradation instead of shared-fate death.

The port's copy of ``gol_tpu/resilience/diskguard.py``, same levels and
names. ``DiskGuard`` watches free bytes (one ``statvfs`` per tick,
injected-fault-aware via ``fsio.free_bytes``) and degrades in the order
that sheds the most re-creatable state first:

- **level 1** (free < ``cas_bytes``): shed result-cache writes;
- **level 2** (free < ``checkpoint_bytes``): also shed checkpoint saves;
  checkpoints only buy restart time, the run still completes, and
  auto-resume falls back to the previous committed checkpoint
  (``--disk-reserve``: the CLI's checkpoint lane ticks the guard at every
  save boundary);
- **level 3** (free < ``admission_bytes``): also refuse new job admission.

Recovery is automatic and hysteretic: a level is left only once free
bytes clear its watermark by ``hysteresis`` (default 25%), so a partition
oscillating at a watermark does not flap.

Observability: ``disk_free_bytes`` / ``disk_pressure_level`` gauges and a
``disk_guard_transitions_total`` counter on the given registry, one record
per transition in an optional history ring, and an edge-triggered log
line.

Clock discipline: ``time.perf_counter`` only (the injectable default),
used solely to timestamp transition records, never in a threshold
decision, which are pure byte comparisons.
"""

from __future__ import annotations

import logging
import time

from gol_tpu_torch.resilience import fsio

logger = logging.getLogger(__name__)

# Degradation levels, in order. The NAME is what logs/rings/`gol top` show.
LEVEL_NAMES = ("ok", "shed-cas", "shed-checkpoints", "refuse-admission")
OK, SHED_CAS, SHED_CHECKPOINTS, REFUSE_ADMISSION = range(4)

STATE_PROVIDER = "disk_guard"


class DiskGuard:
    """Watermark state machine over one partition's free bytes.

    ``admission_bytes`` is the floor (refuse new work below it);
    ``checkpoint_bytes`` and ``cas_bytes`` default to 2x and 4x it, the
    shed-earlier tiers. ``free_fn`` injects the reading (tests pin it;
    the default consults the fault plan, then ``statvfs``)."""

    def __init__(
        self,
        path: str,
        admission_bytes: int,
        checkpoint_bytes: int | None = None,
        cas_bytes: int | None = None,
        *,
        hysteresis: float = 0.25,
        registry=None,
        history=None,
        free_fn=None,
        clock=time.perf_counter,
        partition: str | None = None,
    ):
        if admission_bytes < 1:
            raise ValueError(
                f"admission watermark must be >= 1 byte, got {admission_bytes}"
            )
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.path = path
        self.partition = partition or path
        self.admission_bytes = int(admission_bytes)
        self.checkpoint_bytes = int(
            checkpoint_bytes if checkpoint_bytes is not None
            else 2 * admission_bytes
        )
        self.cas_bytes = int(
            cas_bytes if cas_bytes is not None else 4 * admission_bytes
        )
        if not (self.cas_bytes >= self.checkpoint_bytes
                >= self.admission_bytes):
            raise ValueError(
                "watermarks must degrade in order: cas_bytes "
                f"({self.cas_bytes}) >= checkpoint_bytes "
                f"({self.checkpoint_bytes}) >= admission_bytes "
                f"({self.admission_bytes})"
            )
        self.hysteresis = hysteresis
        self.registry = registry
        self.history = history
        self._free_fn = free_fn or (lambda: fsio.free_bytes(self.path))
        self._clock = clock
        self._level = OK
        self._free: int | None = None
        self.transitions = 0

    # -- the tick (a sampler's, or any caller's loop) -----------------------

    def _watermark(self, level: int) -> int:
        return (self.cas_bytes, self.checkpoint_bytes,
                self.admission_bytes)[level - 1]

    def _deepest(self, free: int, scale: float) -> int:
        """The deepest level whose (scaled) watermark ``free`` is below."""
        for level in (REFUSE_ADMISSION, SHED_CHECKPOINTS, SHED_CAS):
            if free < self._watermark(level) * scale:
                return level
        return OK

    def tick(self) -> int:
        """Read free bytes, move the level, export, record transitions.
        Returns the (possibly new) level. A failing read holds the current
        level — a broken statvfs must not flap admission."""
        try:
            free = int(self._free_fn())
        except OSError as err:
            logger.warning("disk guard: free-bytes read failed on %s: %s",
                           self.path, err)
            return self._level
        self._free = free
        enter = self._deepest(free, 1.0)
        leave = self._deepest(free, 1.0 + self.hysteresis)
        if enter > self._level:
            new = enter  # degrade immediately: pressure is now
        elif leave < self._level:
            new = leave  # recover only past the hysteresis band
        else:
            new = self._level
        if new != self._level:
            self._transition(new, free)
        if self.registry is not None:
            self.registry.set_gauge("disk_free_bytes", free)
            self.registry.set_gauge("disk_pressure_level", self._level)
        return self._level

    def _transition(self, new: int, free: int) -> None:
        old, self._level = self._level, new
        self.transitions += 1
        log = logger.warning if new > old else logger.info
        log(
            "disk guard on %s: %s -> %s (%d bytes free; watermarks "
            "cas=%d ckpt=%d admission=%d)",
            self.partition, LEVEL_NAMES[old], LEVEL_NAMES[new], free,
            self.cas_bytes, self.checkpoint_bytes, self.admission_bytes,
        )
        if self.registry is not None:
            self.registry.inc("disk_guard_transitions_total")
        if self.history is not None:
            # The durable decision ring (obs/history.py) — the same record
            # shape the autoscaler journals its decisions with, so
            # `gol history-report` renders both.
            self.history.append({"diskguard": {
                "partition": self.partition,
                "from": LEVEL_NAMES[old],
                "to": LEVEL_NAMES[new],
                "free_bytes": free,
                "t": self._clock(),
            }})

    # -- the consumers' predicates -----------------------------------------

    @property
    def level(self) -> int:
        return self._level

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self._level]

    @property
    def free_bytes(self) -> int | None:
        """The last tick's reading (None before the first tick)."""
        return self._free

    def allow_cas_writes(self) -> bool:
        return self._level < SHED_CAS

    def allow_checkpoints(self) -> bool:
        return self._level < SHED_CHECKPOINTS

    def refuse_admission(self) -> bool:
        return self._level >= REFUSE_ADMISSION

    def state(self) -> dict:
        """Flight-recorder state provider payload."""
        return {
            "partition": self.partition,
            "level": self._level,
            "level_name": self.level_name,
            "free_bytes": self._free,
            "transitions": self.transitions,
        }


__all__ = [
    "LEVEL_NAMES", "OK", "REFUSE_ADMISSION", "SHED_CAS", "SHED_CHECKPOINTS",
    "STATE_PROVIDER", "DiskGuard",
]
