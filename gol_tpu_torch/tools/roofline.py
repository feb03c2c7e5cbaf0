"""Flag-cost roofline of the 8-generation pass on one card.

    python -m gol_tpu_torch.tools.roofline [--out PATH] [--sizes 16384,65536]
                                           [--trace DIR]

The port's counterpart of ``tools/roofline_r4.py``. At each size (a square
torus, words made directly as random uint32 from
``numpy.random.default_rng(42)``) it times three kernels of
``csrc/stencil_packed.cu``:

- K1 ``bandt_kernel<SUMMARY>`` (``_step_t_fast_into``), what the main path
  runs;
- K2 ``bandt_kernel<EXACT>`` (``_step_t_into``), what the JAX package's
  A/B timed;
- K14 ``bandt_kernel<NONE>`` (``_step_t_noflags_into``), K2 with every
  flag operation compiled out.

Each is timed two ways, three repetitions each: (a) 100 launches in one
CUDA graph between two CUDA events (``obs.profiler.graph_ms``) and (b) the
device time of the same kernel in a ``torch.profiler`` capture of 100
launches (``obs.profiler.kernel_device_ms``, which raises if the capture
holds no kernel event). The report gives per size and kernel the ms per
pass (median of three) by both timings, cell-updates/s, the bytes and
operations bounds and the share of the bound reached; per size the JAX
package's ``flag_overhead_fraction`` = median(K14 rate) / median(K2 rate)
- 1, the same ratio against K1, and the tile's overfetch, ((rows + 16) /
rows) x ((words + 2) / words), with the strip's interior words read from
the built library (``sp.bandt_tile()``) and the rows of K1's bands at that
size (``sp.bandt_bands``), the counterpart of the JAX package's two-band
experiment. The operations bound counts the adder network's work:
``OPS_PER_WORD_GEN`` logic instructions per word and generation, with the
bound at ``packed_math``'s 28 two-input ops kept beside it
(``ops_ms_two_input``). After timing a kernel at a size it holds the
output and flags of its last timed launch against the plain version at
tolerance 0, and raises on any difference. The report ends with the SM
clock nvidia-smi reads once, right after the last size (the bound assumes
the maximum). It prints one JSON object and, with ``--out``, writes it
there too. ``--trace DIR`` keeps the Chrome trace of the first size's K1
capture. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from gol_tpu_torch.obs import profiler
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp

SIZES = (16384, 65536)
SEED = 42
REPS = 3
LAUNCHES = 100
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer logic results per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0:
# bitwise AND/OR/XOR, shifts and adds).
INT32_LOGIC_PER_CLK_PER_SM = 64
# The adder network's logic instructions per word and generation, as the
# card can issue them (csrc/stencil_packed.cu): push() takes the new row's
# west and east neighbours with 2 funnel shifts (SHF) and its sums with 4
# LOP3s (dm0 = w ^ e, dm1 = w & e, d0 = dm0 ^ d, d1 = dm1 | (d & dm0));
# next_gen() applies the rule with 6 (t0, tc, v0, v1, (v0 ^ tc) & ~v1,
# and that & (t0 | mid), each of at most 3 inputs). Loop overhead (moves,
# addresses, the branch) is not the function's work and is not counted;
# tools/sass_ops.py reports the steady loop's own count beside this one.
OPS_PER_WORD_GEN = 12
# packed_math.py's adder network in two-input ops, shifts included.
TWO_INPUT_OPS_PER_WORD_GEN = 28
KERNEL_NAME = "bandt_kernel"
# Written over the output before the last timed launches, so that a tile
# the kernel skipped cannot match the plain version by chance.
POISON = -1


def tile_overfetch(rows: int, words: int, ghost_rows: int) -> float:
    """Words a warp loads per word it owns: its band of ``rows`` rows
    (``sp.bandt_bands``) of ``words`` interior words (``sp.bandt_tile()``)
    with ``ghost_rows`` rows above and below and one ghost word per side."""
    return ((rows + 2 * ghost_rows) / rows) * ((words + 2) / words)


def logic_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer logic results per second:
    64 per clock per SM x SMs x the maximum SM clock (nvidia-smi)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    return INT32_LOGIC_PER_CLK_PER_SM * sms * mhz * 1e6


def pass_bounds(height: int, nwords: int, ops_per_s: float) -> dict:
    """The least time one 8-generation pass over (height, nwords) words
    could take: its words read once and written once over the memory
    rate, and its logic ops (``OPS_PER_WORD_GEN`` per word and generation)
    over the logic rate; the larger binds. ``ops_ms_two_input`` is the ops
    time at 28 two-input ops per word and generation."""
    nbytes = 2 * height * nwords * 4
    word_gens = sp.TEMPORAL_GENS * height * nwords
    ops = word_gens * OPS_PER_WORD_GEN
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops_ms_two_input": word_gens * TWO_INPUT_OPS_PER_WORD_GEN
            / ops_per_s * 1e3}


def cell_updates_per_s(size: int, ms: float) -> float:
    """Cell-updates per second of one pass over a size x size torus."""
    return size * size * sp.TEMPORAL_GENS / (ms / 1e3)


def summarize(size: int, times: dict, bounds: dict, tile: tuple) -> dict:
    """The report of one size from its raw timings: ``times[kernel][way]``
    is the list of ms per pass of the repetitions, ``way`` "graph" or
    "profiler"; ``tile`` is the (rows, words, ghost rows) of K1's strip
    at this size."""
    kernels = {}
    for kernel, ways in times.items():
        row = {}
        for way, reps in ways.items():
            ms = statistics.median(reps)
            row[way] = {"ms_reps": reps, "ms": ms,
                        "cell_updates_per_s": cell_updates_per_s(size, ms),
                        "share_of_bound": bounds["bound_ms"] / ms}
        kernels[kernel] = row

    def overhead(flagged: str, way: str) -> float:
        # The JAX package's ratio: the flag-free rate over the flagged one.
        return (kernels["K14"][way]["cell_updates_per_s"]
                / kernels[flagged][way]["cell_updates_per_s"] - 1)

    ways = sorted(next(iter(times.values())))
    return {
        "size": size, "words": [size, size // pm.BITS], **bounds,
        "kernels": kernels,
        "flag_overhead_fraction": {w: overhead("K2", w) for w in ways},
        "flag_overhead_fraction_k1": {w: overhead("K1", w) for w in ways},
        "tile_overfetch": tile_overfetch(*tile),
    }


def _kernels(dev) -> dict:
    """name -> ``(fn(src, dst) launching it once, its flag buffer or None,
    plain(words) -> (words, flags or None))``. A flag buffer only
    accumulates ORs: zero it before launches whose flags are read."""
    def flagged(into, nflags, exact):
        flags = torch.zeros(nflags, dtype=torch.int32, device=dev)
        return (lambda x, y: into(x, y, flags), flags,
                lambda x: sp._bandt_plain(x, exact=exact))

    return {"K1": flagged(sp._step_t_fast_into, sp.SUMMARY_FLAGS, False),
            "K2": flagged(sp._step_t_into, sp.EXACT_FLAGS, True),
            "K14": (sp._step_t_noflags_into, None,
                    lambda x: (sp._bandt_noflags_plain(x), None))}


def check(name: str, x, y, flags, plain) -> dict:
    """Hold the output ``y`` (and ``flags``) of the last launch from ``x``
    against the plain version at tolerance 0; raise on any difference."""
    want, want_flags = plain(x)
    result = {"words": y.numel(), "words_differing": int((y != want).sum()),
              "flags_differing": 0 if flags is None
              else int((flags != want_flags).sum())}
    if result["words_differing"] or result["flags_differing"]:
        raise RuntimeError(
            f"{name} at {tuple(x.shape)} words disagrees with its plain "
            f"version: {result}")
    return result


def measure(size: int, ops_per_s: float, tile: tuple,
            trace_dir: str | None = None) -> dict:
    """Time K1, K2 and K14 at ``size`` x ``size`` on the card, then hold
    each one's last timed output against its plain version (the graph
    timing ping-pongs, so each kernel sees its own input)."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    host = rng.integers(0, 1 << 32, (size, size // pm.BITS), dtype=np.uint32)
    x = pm.words_from_numpy(host, dev)
    y = torch.empty_like(x)
    del host
    times, checks = {}, {}
    for name, (launch, flags, plain) in _kernels(dev).items():
        launch(x, y)  # build, load and warm
        torch.cuda.synchronize()
        graph, prof = [], []
        for rep in range(REPS):
            graph.append(profiler.graph_ms(launch, x, y, LAUNCHES // 2)[0])
            # The profiler's launches all go from x to y: after the last
            # one, y and the flags are one pass's from x.
            y.fill_(POISON)
            if flags is not None:
                flags.zero_()
            keep = trace_dir if (rep == 0 and name == "K1") else None
            prof.append(profiler.kernel_device_ms(
                lambda: launch(x, y), LAUNCHES, (KERNEL_NAME,), keep))
        times[name] = {"graph": graph, "profiler": prof}
        checks[name] = check(name, x, y, flags, plain)
        print(f"{size}: {name} graph {graph} ms, profiler {prof} ms, "
              f"output identical to the plain version", file=sys.stderr,
              flush=True)
    bounds = pass_bounds(size, size // pm.BITS, ops_per_s)
    rows, bands = sp.bandt_bands(size, size // pm.BITS)
    return {**summarize(size, times, bounds, (rows, *tile[1:])),
            "bands": {"rows": rows, "per_strip": bands}, "checks": checks}


def sm_clock_mhz() -> float | None:
    """The SM clock nvidia-smi reads now (MHz), None where it reads no
    number (``[N/A]``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()
    try:
        return float(out[0])
    except (IndexError, ValueError):
        return None


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def report(sizes=SIZES, trace_dir: str | None = None) -> dict:
    """Measure every size on the card: the tool's JSON object."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline needs a CUDA card; torch sees none")
    tile = sp.bandt_tile()
    ops_per_s = logic_ops_per_s()
    measured = [measure(s, ops_per_s, tile, trace_dir if i == 0 else None)
                for i, s in enumerate(sizes)]
    return {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi_line(),
        "logic_ops_per_s": ops_per_s, "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "ops_per_word_gen": OPS_PER_WORD_GEN,
        "launches_per_timing": LAUNCHES, "reps": REPS, "seed": SEED,
        "tile": dict(zip(("rows", "words", "ghost_rows"), tile)),
        "sizes": measured,
        # Read once, right after the last size: the bound assumes the
        # card's maximum SM clock.
        "sm_clock_mhz_after_timing": sm_clock_mhz(),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gol_tpu_torch.tools.roofline",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--sizes", default=",".join(map(str, SIZES)),
                        help="comma-separated square grid sizes (multiples of 32)")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="keep the first size's K1 profiler trace in DIR")
    args = parser.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    if any(s <= 0 or s % pm.BITS for s in sizes):
        parser.error(f"--sizes must be positive multiples of {pm.BITS}")
    try:
        result = report(sizes, args.trace)
    except RuntimeError as e:
        print(f"roofline: {e}", file=sys.stderr)
        return 1
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
