"""Declarative, seeded network-fault schedules (the ``--chaos`` grammar).

A ``ChaosPlan`` is the network counterpart of ``resilience/faults.FaultPlan``
and speaks the same ``k=v,k=v`` spec grammar (unknown keys are loud errors —
a typo'd injection must never silently test nothing). Where a FaultPlan
counts discrete events ("fail the Nth write"), network faults are
probabilistic by nature: each key below is the per-exchange probability of
one fault class, and the whole schedule is driven by ONE seeded
``random.Random`` so a plan replays identically run to run — the chaos
matrix and the smoke assert against deterministic fault sequences.

Fault classes (checked in this fixed order per exchange; the first that
fires wins — every class is rolled every exchange so the decision sequence
depends only on the seed, never on which classes happened to fire):

- ``refuse=P``    the connection is reset before the request is read: the
                  closest an accepting proxy can get to a refused/killed
                  backend (the client sees a reset/disconnect with zero
                  response bytes).
- ``reset=P``     reset MID-exchange: the request is delivered whole, half
                  the response is relayed, then a hard RST — the ambiguous
                  failure (the worker may have accepted and journaled).
- ``truncate=P``  the response is cleanly closed after half its body — a
                  torn payload with a well-formed start.
- ``slowloris=P`` the response body trickles out in ``slow_chunk``-byte
                  pieces with ``slow_ms`` between them.
- ``bitflip=P``   one payload bit of the exchange flips in transit (request
                  or response body, alternating): for ``GOLP`` frames the
                  flip lands INSIDE the CRC-covered words payload, so the
                  frame's CRC gate must catch every one (pinned by tests). The
                  TEXT wire has no integrity field — a flip there is only
                  caught when it breaks structure; one that lands on a
                  cell byte ('0' <-> '1') is a well-formed wrong board no
                  layer can detect, which is why the chaos matrix pins
                  this class on the packed lane and the README tells
                  operators to run ``--wire packed`` on lossy links.
- ``latency=P``   ``latency_ms`` of added delay before the response relays.

Parameters: ``seed=N`` (default 0), ``latency_ms=N`` (default 100),
``slow_ms=N`` (per-chunk delay, default 20), ``slow_chunk=N`` (default 256).

Clocks: none here (the proxy owns timing); the module is import-light so
the torch-free router can parse a plan in microseconds.
"""

from __future__ import annotations

import dataclasses
import random
import threading

# The fixed roll order (and the vocabulary of fault names the proxy's
# stats counters use). "none" is the no-fault outcome.
FAULT_KINDS = ("refuse", "reset", "truncate", "slowloris", "bitflip",
               "latency")

_PROB_KEYS = set(FAULT_KINDS)
_INT_KEYS = {"seed", "latency_ms", "slow_ms", "slow_chunk"}


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """One declarative fault mix. Frozen: schedules carry the mutable RNG."""

    seed: int = 0
    refuse: float = 0.0
    reset: float = 0.0
    truncate: float = 0.0
    slowloris: float = 0.0
    bitflip: float = 0.0
    latency: float = 0.0
    latency_ms: int = 100
    slow_ms: int = 20
    slow_chunk: int = 256

    def __post_init__(self):
        for key in _PROB_KEYS:
            p = getattr(self, key)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"chaos plan {key} must be a probability in [0, 1], "
                    f"got {p}"
                )
        if self.latency_ms < 0 or self.slow_ms < 0:
            raise ValueError("chaos plan delays must be >= 0 ms")
        if self.slow_chunk < 1:
            raise ValueError(
                f"chaos plan slow_chunk must be >= 1, got {self.slow_chunk}"
            )

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """``k=v,k=v`` spec -> plan; unknown keys are loud errors (the
        FaultPlan.parse contract)."""
        kwargs: dict = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, value = part.partition("=")
            if not sep:
                raise ValueError(f"chaos plan entry {part!r} is not k=v")
            if key in _PROB_KEYS:
                kwargs[key] = float(value)
            elif key in _INT_KEYS:
                kwargs[key] = int(value)
            else:
                raise ValueError(f"unknown chaos plan key {key!r}")
        return cls(**kwargs)

    def any_faults(self) -> bool:
        return any(getattr(self, key) > 0.0 for key in _PROB_KEYS)

    def schedule(self, salt: int = 0) -> "ChaosSchedule":
        """A fresh deterministic decision stream for this plan. ``salt``
        derives independent-but-reproducible streams for multiple proxies
        sharing one plan (ProxyPool salts by creation index — worker
        boot ORDER is deterministic even when ports are not)."""
        return ChaosSchedule(self, salt=salt)


class ChaosSchedule:
    """The mutable half: one seeded RNG rolling the plan, thread-safe
    (proxy connection threads share it). Every exchange consumes exactly
    ``len(FAULT_KINDS)`` + 2 rolls (the per-fault coin plus the bit-flip
    position/direction draws), so the Nth exchange's decision is a pure
    function of (seed, salt, N) regardless of which faults fired before."""

    def __init__(self, plan: ChaosPlan, salt: int = 0):
        self.plan = plan
        # One stable int per (seed, salt): tuple seeding is hash-based
        # (deprecated) and an odd-constant mix keeps salted streams
        # independent without it.
        self._rng = random.Random(plan.seed * 1_000_003 + salt)
        self._lock = threading.Lock()
        self.exchanges = 0

    def next_fault(self) -> tuple[str | None, float, bool]:
        """Roll one exchange -> (fault kind or None, bit position draw in
        [0, 1), flip-the-request flag). The two extra draws are consumed
        every exchange (alignment), used only by the bitflip class."""
        with self._lock:
            self.exchanges += 1
            fired = None
            for kind in FAULT_KINDS:
                roll = self._rng.random()
                if fired is None and roll < getattr(self.plan, kind):
                    fired = kind
            bit_draw = self._rng.random()
            flip_request = self._rng.random() < 0.5
            return fired, bit_draw, flip_request


__all__ = ["ChaosPlan", "ChaosSchedule", "FAULT_KINDS"]
