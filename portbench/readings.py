"""What a driver hands the per-layer readers (``portbench/metrics/``).

A reader is a module with ``read(readings) -> float | None``; it returns
None when the run holds nothing for it to read, and the harness then
leaves its metric out of the result line.
"""

from __future__ import annotations

import dataclasses

from portbench.devtrace import DeviceTrace


@dataclasses.dataclass
class Readings:
    height: int
    width: int
    generations: list    # each window simulation's reported generation count
    sim_s: list          # each window simulation's host time, call to fence
    launches: dict       # the program's kernel-launch counters, window deltas
    counters: dict       # the program's registry counters, window deltas
    spans: list          # the program's spans (obs.trace), set-up and window
    trace: DeviceTrace | None  # the profiled head of a traced window
    traced_sims: int = 0  # how many of ``sim_s`` (the first) were profiled

    def untraced_sim_s(self) -> list:
        """The host times of the window's simulations that ran without the
        profiler, whose own host work would inflate them."""
        return self.sim_s[self.traced_sims:]
