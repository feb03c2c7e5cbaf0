"""CLI entry point of the PyTorch port — ``python -m gol_tpu_torch <width>
<height> <input_file>``, the reference's ``./a.out`` contract on one CUDA card.

The port of the single-device ``run`` lane of ``gol_tpu/cli.py``:

- ``width = atoi(argv[1])``, ``height = atoi(argv[2])`` — C atoi semantics,
  non-numeric parses to 0; non-positive dimensions default to 30x30;
- with no input file the simulation is skipped and only ``Finished`` prints
  (src/game.c:238-241);
- ``--variant`` picks the reference program reproduced (output filename,
  printed lines, loop accounting): ``game``, ``cuda``, or ``tpu`` (the
  default; on one device a whole-file read and write with I/O timing lines);
- timings print as ``<Phase>:\\t<ms> msecs``. Execution time excludes set-up
  — the kernels' build and load, and the optional ``--warmup`` run happen
  before the timer starts — and ends in a device sync.

It runs on the card; ``GOL_TORCH_DEVICE=cpu`` runs it on the CPU through the
kernels' plain torch versions. Errors print as ``gol: <error>`` with exit
code 1.

Subcommand ``generate <width> <height>`` emits a random grid (generate.sh).
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import torch

from gol_tpu_torch import engine
from gol_tpu_torch.config import DEFAULT_HEIGHT, DEFAULT_WIDTH, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.platform_env import NoDeviceError, resolve_device
from gol_tpu_torch.variants import VARIANTS, Variant, get_variant

# Dense-materialization ceiling (cells): 2^30 cells is a 1 GB uint8 canvas
# on the host, and the engine carries the grid plus its packed buffers.
MAX_DENSE_CELLS = 1 << 30


def atoi(s: str | None) -> int:
    """C atoi: optional sign + leading digits, anything else is 0."""
    if not s:
        return 0
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def dense_cells_guard(height: int, width: int) -> None:
    """Raise the CLI-contract error for a dense grid that cannot fit, before
    anything allocates it."""
    cells = height * width
    if cells > MAX_DENSE_CELLS:
        raise ValueError(
            f"a {height}x{width} board is {cells} cells "
            f"({cells / (1 << 30):.1f} GB as bytes), above the dense "
            f"engine's {MAX_DENSE_CELLS}-cell ceiling"
        )


def _read_phase(path: str, width: int, height: int, device) -> torch.Tensor:
    return engine.put_grid(text_grid.read_grid(path, width, height), device)


def _write_phase(path: str, grid: torch.Tensor) -> None:
    text_grid.write_grid(path, grid.cpu().numpy())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(args) -> int:
    if args.gens is not None:
        if args.gens < 0:
            raise ValueError(f"--gens must be >= 0, got {args.gens}")
        args.gen_limit = args.gens
    variant = get_variant(args.variant)
    width, height = atoi(args.width), atoi(args.height)
    if width <= 0:
        width = DEFAULT_WIDTH
    if height <= 0:
        height = DEFAULT_HEIGHT

    if args.input_file is None:
        # Simulation skipped entirely (src/game.c:238-241).
        if variant.final_finished:
            print("Finished")
        return 0

    config = GameConfig(
        gen_limit=args.gen_limit,
        check_similarity=not args.no_check_similarity,
        similarity_frequency=args.similarity_frequency,
        convention=variant.convention,
    )
    output_path = args.output or f"./{variant.output_file}"
    dense_cells_guard(height, width)
    device = resolve_device()

    t0 = time.perf_counter()
    device_grid = _read_phase(args.input_file, width, height, device)
    read_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")

    runner = engine.make_runner((height, width), config, args.kernel, device)
    if args.warmup:
        runner(device_grid)
        _sync(device)

    t0 = time.perf_counter()
    final, generations = runner(device_grid)
    _sync(device)
    exec_ms = (time.perf_counter() - t0) * 1000

    return _report_and_write(
        variant, generations, exec_ms, lambda: _write_phase(output_path, final)
    )


def _report_and_write(variant: Variant, generations, exec_ms, write_fn) -> int:
    """The reference's printed-output contract (src/game.c:201-206,
    src/game_mpi_collective.c:367-450)."""
    if variant.serial_header:
        print("Finished.\n")
    print(f"Generations:\t{generations}")
    print(f"Execution time:\t{exec_ms:.2f} msecs")
    t0 = time.perf_counter()
    write_fn()
    write_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Writing file:\t{write_ms:.2f} msecs")
    if variant.final_finished:
        print("Finished")
    return 0


def _generate(args) -> int:
    if args.output:
        text_grid.generate_to_file(
            args.output, args.width, args.height, density=args.density, seed=args.seed
        )
    else:
        grid = text_grid.generate(
            args.width, args.height, density=args.density, seed=args.seed
        )
        sys.stdout.write(text_grid.encode(grid).decode("ascii"))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gol",
        description="Game of Life on one CUDA card (PyTorch port of gol_tpu)",
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="run a simulation (also the default command)")
    run.add_argument("width", nargs="?", default=None)
    run.add_argument("height", nargs="?", default=None)
    run.add_argument("input_file", nargs="?", default=None)
    run.add_argument(
        "--variant", default="tpu", choices=sorted(VARIANTS),
        help="which reference program to reproduce (ported: game, cuda, tpu)",
    )
    run.add_argument(
        "--kernel", default="auto", choices=("auto", "packed", "lax"),
        help="stencil kernel: packed (32 cells per word, CUDA kernels), lax "
        "(byte cells, any width), or auto (packed where the width divides "
        "by 32)",
    )
    run.add_argument("--gen-limit", type=int, default=GameConfig().gen_limit)
    run.add_argument("--gens", type=int, default=None, metavar="N",
                     help="alias for --gen-limit")
    run.add_argument(
        "--similarity-frequency", type=int, default=GameConfig().similarity_frequency
    )
    run.add_argument("--no-check-similarity", action="store_true")
    run.add_argument("--output", default=None, help="override the output file path")
    run.add_argument(
        "--warmup", action="store_true",
        help="run once, untimed, before the measured run",
    )
    run.set_defaults(func=_run)

    gen = sub.add_parser("generate", help="emit a random grid (replaces generate.sh)")
    gen.add_argument("width", type=int)
    gen.add_argument("height", type=int)
    gen.add_argument("-o", "--output", default=None)
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("--density", type=float, default=0.5)
    gen.set_defaults(func=_generate)
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # Default command is `run`, preserving the bare `<w> <h> <file>` contract.
    if not argv or argv[0] not in ("run", "generate", "-h", "--help"):
        argv = ["run", *argv]
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (ValueError, OSError, NoDeviceError) as e:
        print(f"gol: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
