"""Find a cell's pieces by name, run it, and shape its result line.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json``: the deployment as it is run;
- ``portbench/traffic/<traffic>.json``: the mix, which names its driver;
- ``portbench/drivers/<driver>.py``: ``run(config, traffic, ...)``, which
  sets up, measures the window, checks the answers and returns an
  ``Outcome``;
- ``portbench/metrics/<metric>.py``: ``read(readings) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# Top-level module names that may not be loaded in a benchmark process:
# the JAX package and JAX itself. Compared whole, so ``gol_tpu_torch``
# (the program) is not ``gol_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "gol_tpu")


class NoCards(RuntimeError):
    """The machine has fewer CUDA cards than the cell asks for."""


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives the harness."""

    end_to_end: dict     # metric name -> value, for the untraced line
    readings: object     # handed to the per-layer readers
    check: dict          # name -> {"value": v, "limit": l}; correct iff v <= l
    attempted: int
    failed: int
    device: dict
    breakdown: dict | None = None

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.check.values())


def load_benchmark(checkout: Path = CHECKOUT) -> dict:
    with open(checkout / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[c['name'] for c in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(CHECKOUT / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py`` (a
    metric's name may hold dots, so the file is loaded by its path)."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if _in_cell(m, cell)]


def per_layer(bench: dict, cell: str) -> list:
    """The cell's per-layer metrics: those whose ``workloads`` list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCards("torch sees no CUDA card")
    if torch.cuda.device_count() < count:
        raise NoCards(f"the cell needs {count} CUDA cards; torch sees "
                      f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """Forbidden top-level names among the loaded modules."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; 10 ms steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda", make_runner=None) -> dict:
    """Run ``cell`` through its driver and return the result line's
    object. ``make_runner`` stands in for the program's runner factory
    (the control, and the tests' planted faults)."""
    cfg = config(bench, cell["config"])
    mix = traffic(cell["traffic"])
    outcome = driver(mix["driver"]).run(
        cfg, mix, seed=seed, seconds=seconds, trace=trace, device=device,
        make_runner=make_runner)
    metrics = {}
    if trace:
        for m in per_layer(bench, cell["name"]):
            value = reader(m["name"])(outcome.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": outcome.device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["check"] = outcome.check
    return line


def check_lines(check: dict) -> list:
    """One line per number compared, beside its limit."""
    return [f"check {name}: {c['value']} (limit {c['limit']})"
            for name, c in check.items()]
