"""Instructions per word and generation of bandt_kernel, read from its SASS.

    python -m gol_tpu_torch.tools.sass_ops [--sass FILE] [--out PATH]

Runs ``cuobjdump -sass`` on the built ``csrc/stencil_packed.cu`` library
(or reads a saved dump with ``--sass``) and, in each ``bandt_kernel``
instantiation, finds the steady loop: the loop (a backward conditional
branch) with the most warp shuffles. Every level of the pipeline pushes one
row per step with two shuffles (the west and east words), so the loop
handles ``SHFL / 2`` words-times-generations per lane, and the report gives
its instructions by opcode per word and generation. ``logic`` counts the
32-bit integer pipe's logic and shift instructions (LOP3, LOP, SHF, PLOP3)
in the loop, beside the network's own count that the operations bound of
the packed rows uses (``roofline.OPS_PER_WORD_GEN``); the difference is
the loop's overhead. A diagnostic: no bound reads it. It prints one JSON
object and, with ``--out``, writes it there too. Needs ``nvcc`` and
``cuobjdump`` unless given ``--sass``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

from gol_tpu_torch.tools.roofline import OPS_PER_WORD_GEN

LOGIC = ("LOP3", "LOP", "SHF", "PLOP3")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)"
                   r"(\.[A-Z0-9_.]+)?\s*(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
# bandt_kernel's template arguments in its mangled name: FlagMode, Source.
_INSTANCE = re.compile(r"bandt_kernelILNS_8FlagModeE(\d)ELNS_6SourceE(\d)E")
FLAG_MODES = ("summary", "exact", "none")
SOURCES = ("torus", "ghost rows", "ghost plane")


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"cuobjdump not found at {tool}")
    return tool


def dump_sass() -> str:
    """The SASS of the built stencil_packed library (builds it at first
    use, so it needs ``nvcc``)."""
    from gol_tpu_torch.ops import _build

    lib = _build.build("stencil_packed")
    return subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def functions(sass: str) -> dict:
    """``{mangled name: [(address, opcode, operands, predicated)]}``."""
    out, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(3),
                            (m.group(4) or "") + " " + m.group(5), bool(m.group(2))))
    return out


def steady_loop(insns: list) -> list:
    """The instructions of the loop with the most SHFL: the body between
    the target of a backward conditional branch and the branch. (The
    unconditional branches back are the returns from the out-of-line
    paths the compiler adds for a diverged warp's shuffles.)"""
    best = []
    for i, (addr, op, operands, predicated) in enumerate(insns):
        if op != "BRA" or not predicated or "DIV" in operands:
            continue
        m = _TARGET.search(operands)
        if not m or int(m.group(1), 16) >= addr:
            continue
        target = int(m.group(1), 16)
        body = [x for x in insns[:i + 1] if x[0] >= target]
        if sum(x[1] == "SHFL" for x in body) > sum(x[1] == "SHFL" for x in best):
            best = body
    return best


def analyse(sass: str) -> dict:
    """Per ``bandt_kernel`` instantiation: the steady loop's opcodes per
    word and generation, and its logic instructions per word and
    generation beside the network's (``OPS_PER_WORD_GEN``)."""
    result = {}
    for name, insns in functions(sass).items():
        m = _INSTANCE.search(name)
        if not m:
            continue
        loop = steady_loop(insns)
        counts = collections.Counter(x[1] for x in loop)
        pushes = counts["SHFL"] / 2
        if not pushes:
            raise RuntimeError(f"no shuffle loop found in {name}")
        key = f"{FLAG_MODES[int(m.group(1))]}, {SOURCES[int(m.group(2))]}"
        result[key] = {
            "loop_instructions": len(loop),
            "word_generations_per_iteration": pushes,
            "per_word_generation": {op: n / pushes
                                    for op, n in sorted(counts.items())},
            "logic_per_word_generation": sum(counts[op] for op in LOGIC) / pushes,
            "network_logic_per_word_generation": OPS_PER_WORD_GEN,
            "all_per_word_generation": len(loop) / pushes,
        }
    if not result:
        raise RuntimeError("no bandt_kernel in the SASS")
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gol_tpu_torch.tools.sass_ops",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--sass", default=None,
                        help="a saved `cuobjdump -sass` dump (default: dump "
                        "the built library)")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    try:
        if args.sass:
            with open(args.sass) as f:
                sass = f.read()
        else:
            sass = dump_sass()
        result = analyse(sass)
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"sass_ops: {e}", file=sys.stderr)
        return 1
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
