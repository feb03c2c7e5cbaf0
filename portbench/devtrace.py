"""Reduce a ``torch.profiler`` Chrome trace of the traced part of a window
to what the per-layer readers need.

The device's work is every event of category ``kernel``, ``gpu_memcpy``
or ``gpu_memset``; their union is the time the device was busy. Each
simulation is the harness's ``portbench.sim`` range on the host, so the
device time inside a simulation is the busy time that falls inside that
range. A gap in the union is labelled by the innermost host event (an
operator, a runtime call or one of the harness's ranges) open at the gap's
midpoint: what the host was doing while the device waited. A gap inside a
simulation with no operator or runtime call open is Python in the runner,
labelled ``portbench.sim: python``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SIM_RANGE = "portbench.sim"
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float               # first traced simulation's start to last's end
    busy_s: float                 # union of device work inside the window
    sim_s: list                   # each traced simulation's host time
    sim_device_s: list            # the device's busy time inside each
    device_events: int            # device events inside the window
    device_ops: list              # [[name, seconds], ...], most time first
    idle_gaps: list               # [[host activity, seconds], ...]


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def _union(intervals):
    """Sorted, merged ``[start, end]`` lists of ``(start, end)`` pairs."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _covered(merged, starts, lo, hi) -> float:
    """How much of ``[lo, hi]`` the merged intervals cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(merged) and merged[i][0] < hi:
        total += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
        i += 1
    return total


def _label(host, host_starts, mid: float) -> str:
    """The innermost host event open at ``mid``: of the events that hold
    it, the one that began last (host events nest)."""
    i = bisect.bisect_right(host_starts, mid) - 1
    while i >= 0:
        start, end, name = host[i]
        if end >= mid:
            return f"{name}: python" if name == SIM_RANGE else name
        i -= 1
    return "outside the harness's ranges"


def reduce(events: list) -> DeviceTrace | None:
    """The reduction of a Chrome trace's ``traceEvents``; None when it holds
    no simulation range or no device event inside one."""
    sims = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") == SIM_RANGE)
    if not sims:
        return None
    lo, hi = sims[0][0], sims[-1][1]
    device = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
              and lo <= e["ts"] < hi]
    if not device:
        return None
    merged = _union((max(s, lo), min(t, hi)) for s, t, _ in device)
    starts = [m[0] for m in merged]
    by_name = collections.Counter()
    for s, t, name in device:
        by_name[short_name(name)] += (t - s) / 1e6
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES)
    host_starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [lo] + [x for m in merged for x in m] + [hi]
    for gap_lo, gap_hi in zip(edges[0::2], edges[1::2]):
        if gap_hi > gap_lo:
            label = _label(host, host_starts, (gap_lo + gap_hi) / 2)
            gaps[label] += (gap_hi - gap_lo) / 1e6
    return DeviceTrace(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(t - s for s, t in merged) / 1e6,
        sim_s=[(t - s) / 1e6 for s, t in sims],
        sim_device_s=[_covered(merged, starts, s, t) / 1e6 for s, t in sims],
        device_events=len(device),
        device_ops=[[n, v] for n, v in by_name.most_common(TOP)],
        idle_gaps=[[n, v] for n, v in gaps.most_common(TOP)],
    )


def load(path: str) -> DeviceTrace | None:
    """``reduce`` of the Chrome trace file at ``path``."""
    with open(path) as f:
        return reduce(json.load(f).get("traceEvents", []))
