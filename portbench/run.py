"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``gol_tpu_torch/``). The last line of standard output is
the result, one JSON object; the last lines of standard error are the
numbers the check compared, each beside its limit. Exits 2 without a
result when the machine has fewer CUDA cards than the cell asks for, and 3
when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    try:
        harness.require_cards(cell["chips"])
    except harness.NoCards as err:
        print(f"portbench: {err}; no result", file=sys.stderr)
        return 2
    line = harness.run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}; "
              "no result", file=sys.stderr)
        return 3
    for text in harness.check_lines(line["check"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
