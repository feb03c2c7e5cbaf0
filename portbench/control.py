"""The check's control: a run in which the plain reference, with the torus
dropped (every cell past an edge dead), stands in the program's place.
The configuration states a torus, so the check has to call every such run
wrong; the numbers it reads set the upper end of each limit.

    python3 portbench/control.py --workload NAME --seeds 11,12,13 --seconds 20

``--runner no_similarity`` runs the program instead with its similarity
test switched off, a fault at the exits that the window's soups, which
run to the limit, cannot show: only the settling grids can.

It needs a card, as a benchmark run does, and runs the cell at its own
size. Each seed prints one JSON line: the seed, ``correct`` and the check.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.reference import life  # noqa: E402


def control_runner(shape, config, kernel="auto", device=None):
    """A runner with the program's signature that runs the reference on a
    plane with dead edges and returns uint8 cells, as the program does."""
    height, width = shape

    def run(grid):
        final, gens = life.run(grid, config.gen_limit,
                               config.similarity_frequency,
                               config.check_similarity, config.convention,
                               torus=False)
        return (final if final.dtype == grid.dtype else life.unpack(final)), gens

    return run


def no_similarity_runner(shape, config, kernel="auto", device=None):
    """The program's runner with its similarity test switched off."""
    from gol_tpu_torch import engine

    return engine.make_runner(
        shape, dataclasses.replace(config, check_similarity=False), kernel,
        device=device)


RUNNERS = {"reference": control_runner, "no_similarity": no_similarity_runner}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--runner", choices=sorted(RUNNERS), default="reference")
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    try:
        harness.require_cards(cell["chips"])
    except harness.NoCards as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run_cell(bench, cell, seed=seed, seconds=args.seconds,
                                trace=False, make_runner=RUNNERS[args.runner])
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "check": line["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
