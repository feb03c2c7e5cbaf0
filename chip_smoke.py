#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

The quickest proof that the port still starts on the GPU. It needs one card,
``nvcc`` and nothing of JAX, and generates every input from a seed. Phases,
each of which fails the run (non-zero exit, no result line) on any error:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   kernels built from ``gol_tpu_torch/csrc`` with nvcc's ``-Xptxas -v``
   report (registers, shared memory, spills).
2. Kernels against their plain torch versions on the card: K1 (fast-flag
   8-generation pass), K2 (exact-flag pass) and K3 (one generation) at
   (height, nwords) (1,1) (7,1) (16,2) (17,5) (1000,7) (16384,512), on
   random words, a domino that dies inside a pass and an L-tromino that
   becomes still inside it. Words and flags must be identical.
3. Small flows through ``python -m gol_tpu_torch`` on the card, against the
   port's numpy oracle, for both loop conventions: the verify skill's four
   flows at 48^2 (random for 1000 generations, 2x2 block, lone cell, all
   dead; the byte ``lax`` path) and a random grid plus the same three
   patterns at 64^2 (the packed kernels).
4. The main path at full size, 16384^2 (268 MB of text, 32 MiB of packed
   words), through the CLI entry point: ``--variant game`` and ``cuda``,
   each on (a) a random grid for 1000 generations (K1 only), (b) the same
   for 1003 (a K3 tail), (c) an L-tromino that becomes still at generation
   1 (K2 replay) and (d) a three-cell diagonal that dies at generation 2 (K2
   replay, and under ``cuda`` the K3 empty-exit replay), (c) and (d) once in
   the middle and once across the torus corner. One uncounted run (a)
   warms the process first. For each variant the launch counters are set
   to 0 just before its six ``--kernel auto`` runs and read just after;
   each of K1, K2 and K3 must have launched on each. Every run is repeated
   with ``--kernel lax`` (byte cells, plain torch): output bytes and generation
   counts must match, and (c)/(d) must match the oracle on a 64^2 copy.
5. Timing at 16384^2: each kernel and its plain version over 100 warm
   launches (CUDA events), beside its bound — the larger of the bytes it
   must move over 3.35 TB/s and its ~28 logic ops per word per generation
   over the card's 32-bit integer logic rate: 64 results per clock per SM
   (CUDA C++ Programming Guide, arithmetic instruction throughput,
   compute capability 9.0: 32-bit bitwise AND/OR/XOR and shifts) times the
   SM count times the maximum SM clock (nvidia-smi ``clocks.max.sm``).
   No single PyTorch call computes a B3/S23 step, so ``library_ms`` is null.

The last lines are the kernel table as one JSON object, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gol_tpu_torch import cli, oracle, platform_env
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import _build, packed_math as pm, stencil_packed as sp

REPO = Path(__file__).resolve().parent
SIZE = 16384
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12
INT32_LOGIC_PER_CLK_PER_SM = 64
OPS_PER_WORD_GEN = 28
SHAPES = [(1, 1), (7, 1), (16, 2), (17, 5), (1000, 7), (SIZE, SIZE // 32)]
KERNELS = [
    {
        "key": "bandt_fast", "id": "K1", "gens": sp.TEMPORAL_GENS,
        "name": "K1 bandt_kernel<SUMMARY>: 8-generation pass, summary flags",
        "replaces": "gol_tpu/ops/stencil_packed.py:584",
        "into": sp._step_t_fast_into, "nflags": sp.SUMMARY_FLAGS,
        "plain": lambda x: sp._bandt_plain(x, exact=False),
    },
    {
        "key": "bandt", "id": "K2", "gens": sp.TEMPORAL_GENS,
        "name": "K2 bandt_kernel<EXACT>: 8-generation pass, exact flags",
        "replaces": "gol_tpu/ops/stencil_packed.py:437",
        "into": sp._step_t_into, "nflags": sp.EXACT_FLAGS,
        "plain": lambda x: sp._bandt_plain(x, exact=True),
    },
    {
        "key": "band", "id": "K3", "gens": 1,
        "name": "K3 band_kernel: one generation, fused flags",
        "replaces": "gol_tpu/ops/stencil_packed.py:164",
        "into": sp._step_into, "nflags": sp.STEP_FLAGS,
        "plain": sp._band_plain,
    },
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# 1. Card and build


def card_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    sp.load_kernels()
    print(f"built and loaded {_build.library_path('stencil_packed').name} "
          f"in {time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    print(_build.build_log("stencil_packed").rstrip())
    return smi


# ---------------------------------------------------------------------------
# 2. Kernels against their plain versions


def _pattern(height: int, width: int, cells) -> np.ndarray:
    g = np.zeros((height, width), np.uint8)
    for r, c in cells:
        g[r % height, c % width] = 1
    return g


def _kernel_inputs(height: int, nwords: int, rng) -> dict:
    width = 32 * nwords
    domino = _pattern(height, width, [(height // 2, width // 2),
                                      (height // 2, width // 2 + 1)])
    tromino = _pattern(height, width, [(-1, -1), (0, -1), (-1, 0)])
    return {
        "random": rng.integers(0, 2**32, size=(height, nwords),
                               dtype=np.uint64).astype(np.uint32),
        "dies_in_pass": pm.words_to_numpy(pm.encode(torch.from_numpy(domino))),
        "still_in_pass": pm.words_to_numpy(pm.encode(torch.from_numpy(tromino))),
    }


def check_kernels(dev, stats: dict) -> None:
    rng = np.random.default_rng(SEED)
    for height, nwords in SHAPES:
        for name, words in _kernel_inputs(height, nwords, rng).items():
            x = pm.words_from_numpy(words, dev)
            for k in KERNELS:
                out = torch.empty_like(x)
                flags = torch.zeros(k["nflags"], dtype=torch.int32, device=dev)
                k["into"](x, out, flags)
                want, want_flags = k["plain"](x)
                torch.cuda.synchronize(dev)
                err = max(
                    int((_u32(out) - _u32(want)).abs().max()),
                    int((flags - want_flags).abs().max()),
                )
                s = stats[k["key"]]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s["checks"] += 1
                if err:
                    fail(f"{k['id']} differs from its plain version at "
                         f"({height}, {nwords}) on {name}: {flags.tolist()} vs "
                         f"{want_flags.tolist()}")
        print(f"({height}, {nwords}): K1 K2 K3 == plain on random, "
              "dies_in_pass, still_in_pass (tolerance 0: words and flags "
              "identical)", flush=True)


# ---------------------------------------------------------------------------
# 3. Small flows through `python -m gol_tpu_torch`


def small_flows(work: Path) -> None:
    rng = np.random.default_rng(SEED + 1)
    flows = {}
    for n in (48, 64):
        flows[f"random{n}"] = (rng.random((n, n)) < 0.5).astype(np.uint8)
        flows[f"block{n}"] = _pattern(n, n, [(3, 3), (3, 4), (4, 3), (4, 4)])
        flows[f"lone{n}"] = _pattern(n, n, [(10, n - 8)])
        flows[f"dead{n}"] = np.zeros((n, n), np.uint8)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    try:
        _run_flows(flows, work, env, procs)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _run_flows(flows: dict, work: Path, env: dict, procs: list) -> None:
    for name, grid in flows.items():
        n = grid.shape[0]
        inp = work / f"{name}.txt"
        text_grid.write_grid(str(inp), grid)
        for variant in ("game", "cuda"):
            out = work / f"{name}.{variant}.out"
            cmd = [sys.executable, "-m", "gol_tpu_torch", str(n), str(n),
                   str(inp), "--variant", variant, "--output", str(out)]
            procs.append((name, variant, grid, out, subprocess.Popen(
                cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    for name, variant, grid, out, proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"python -m gol_tpu_torch on {name} --variant {variant} "
                 f"exited {proc.returncode}:\n{stderr}")
        convention = Convention.CUDA if variant == "cuda" else Convention.C
        want = oracle.run(grid, GameConfig(convention=convention))
        gens = int(re.search(r"Generations:\t(\d+)", stdout).group(1))
        if gens != want.generations or out.read_bytes() != text_grid.encode(want.grid):
            fail(f"{name} --variant {variant}: generations {gens} vs oracle "
                 f"{want.generations}, or output bytes differ")
        print(f"{name:9s} --variant {variant:4s}: Generations {gens} == oracle, "
              "output bytes == oracle", flush=True)


# ---------------------------------------------------------------------------
# 4. The main path at 16384^2


def _cli(args: list[str]) -> tuple[int, float, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    text = buf.getvalue()
    if rc != 0:
        fail(f"gol_tpu_torch {' '.join(args)} exited {rc}:\n{text}")
    gens = int(re.search(r"Generations:\t(\d+)", text).group(1))
    exec_ms = float(re.search(r"Execution time:\t([0-9.]+) msecs", text).group(1))
    return gens, exec_ms, text


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


# Small patterns as (row, col) offsets from an anchor: the grid's middle, or
# its (0, 0) corner, where negative offsets wrap across the torus seam.
TROMINO = [(-1, -1), (0, -1), (-1, 0)]
DIAGONAL = [(-1, -1), (0, 0), (1, 1)]


def _live_offsets(grid: np.ndarray, anchor) -> set:
    h, w = grid.shape
    return {(((r - anchor[0] + h // 2) % h) - h // 2,
             ((c - anchor[1] + w // 2) % w) - w // 2)
            for r, c in np.argwhere(grid)}


def main_path(work: Path, dev) -> dict:
    inputs = {"random": work / "random.txt"}
    t0 = time.perf_counter()
    text_grid.generate_to_file(str(inputs["random"]), SIZE, SIZE, seed=SEED)
    patterns = {}
    for pname, cells in (("tromino", TROMINO), ("diagonal", DIAGONAL)):
        for where, anchor in (("mid", (SIZE // 2, SIZE // 2)), ("corner", (0, 0))):
            key = f"{pname}_{where}"
            patterns[key] = (cells, anchor)
            inputs[key] = work / f"{key}.txt"
            text_grid.write_grid(str(inputs[key]), _pattern(
                SIZE, SIZE, [(anchor[0] + r, anchor[1] + c) for r, c in cells]))
    print(f"wrote {len(inputs)} {SIZE}x{SIZE} inputs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    runs = [("a", "random", 1000), ("b", "random", 1003)] + [
        (tag, key, 1000) for tag, key in
        (("c", "tromino_mid"), ("c", "tromino_corner"),
         ("d", "diagonal_mid"), ("d", "diagonal_corner"))]
    out = work / "out.txt"

    def run(variant, kernel, key, limit):
        gens, ms, _ = _cli([str(SIZE), str(SIZE), str(inputs[key]),
                            "--variant", variant, "--kernel", kernel,
                            "--gen-limit", str(limit), "--output", str(out)])
        return gens, ms

    # Warm the process at full size (allocator, first launches), uncounted;
    # run (a) is timed after it, as the CLI's --warmup would time it.
    gens, ms = run("game", "auto", "random", 1000)
    print(f"warm-up (uncounted): game random limit 1000: Generations {gens}, "
          f"Execution {ms:.3f} ms", flush=True)
    results, run_a, by_path = {}, {}, {}
    for variant in ("game", "cuda"):
        for k in sp.LAUNCHES:
            sp.LAUNCHES[k] = 0
        for tag, key, limit in runs:
            before = dict(sp.LAUNCHES)
            if tag == "a" and variant == "game":
                torch.cuda.reset_peak_memory_stats(dev)
            gens, ms = run(variant, "auto", key, limit)
            launched = {k: sp.LAUNCHES[k] - before[k] for k in sp.LAUNCHES}
            if tag == "a" and variant == "game":
                run_a = {
                    "variant": variant, "generations": gens, "exec_ms": ms,
                    "cell_updates_per_s": SIZE * SIZE * gens / (ms / 1000),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                    "launches": launched,
                }
            results[(variant, key, limit)] = (gens, _digest(out))
            print(f"({tag}) {variant:4s} {key:15s} limit {limit}: auto "
                  f"Generations {gens}, Execution {ms:.3f} ms, launches "
                  f"{launched}", flush=True)
            if key in patterns:
                cells, anchor = patterns[key]
                convention = Convention.CUDA if variant == "cuda" else Convention.C
                small_anchor = (32, 32) if key.endswith("mid") else (0, 0)
                small = _pattern(64, 64, [(small_anchor[0] + r, small_anchor[1] + c)
                                          for r, c in cells])
                want = oracle.run(small, GameConfig(convention=convention,
                                                    gen_limit=limit))
                got = text_grid.read_grid(str(out), SIZE, SIZE)
                if (gens != want.generations or _live_offsets(got, anchor)
                        != _live_offsets(want.grid, small_anchor)):
                    fail(f"{variant} {key}: Generations {gens} / live cells "
                         f"differ from the oracle's 64x64 copy "
                         f"({want.generations})")
        by_path[variant] = dict(sp.LAUNCHES)
        print(f"main path, --variant {variant} (its six --kernel auto runs): "
              f"launches {by_path[variant]}", flush=True)
        for k in KERNELS:
            if by_path[variant][k["key"]] == 0:
                fail(f"{k['id']} ({k['key']}) was never launched on the "
                     f"--variant {variant} path")

    for variant in ("game", "cuda"):
        for tag, key, limit in runs:
            gens, ms = run(variant, "lax", key, limit)
            if (gens, _digest(out)) != results[(variant, key, limit)]:
                fail(f"({tag}) {variant} {key}: --kernel lax (Generations "
                     f"{gens}) differs from --kernel auto "
                     f"({results[(variant, key, limit)][0]})")
            print(f"({tag}) {variant:4s} {key:15s} limit {limit}: lax "
                  f"Generations {gens}, Execution {ms:.3f} ms: bytes == auto",
                  flush=True)
    return {"launches": by_path, "run_a": run_a}


# ---------------------------------------------------------------------------
# 5. Timing at 16384^2


def _time(fn, x, y, pairs: int) -> float:
    """ms per call of ``fn(src, dst)`` over ``2 * pairs`` ping-pong calls."""
    for _ in range(3):
        fn(x, y)
        fn(y, x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(pairs):
        fn(x, y)
        fn(y, x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * pairs)


def logic_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer logic results per second."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    rate = INT32_LOGIC_PER_CLK_PER_SM * sms * mhz * 1e6
    print(f"32-bit logic rate: {INT32_LOGIC_PER_CLK_PER_SM}/clk/SM x {sms} SMs "
          f"x {mhz} MHz = {rate} ops/s", flush=True)
    return rate


def timing(dev) -> dict:
    ops_per_s = logic_ops_per_s()
    rng = np.random.default_rng(SEED + 2)
    nwords = SIZE // 32
    words = rng.integers(0, 2**32, size=(SIZE, nwords), dtype=np.uint64)
    x = pm.words_from_numpy(words.astype(np.uint32), dev)
    y = torch.empty_like(x)
    out = {}
    for k in KERNELS:
        flags = torch.zeros(k["nflags"], dtype=torch.int32, device=dev)
        ms = _time(lambda a, b: k["into"](a, b, flags), x, y, 50)
        plain_ms = _time(lambda a, b: k["plain"](a), x, y, 50)
        nbytes = 2 * SIZE * nwords * 4
        ops = k["gens"] * SIZE * nwords * OPS_PER_WORD_GEN
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        out[k["key"]] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
            "ops_ms": ops_ms, "logic_ops_per_s": ops_per_s,
        }
        print(f"{k['id']}: {ms:.6f} ms/launch (plain {plain_ms:.6f} ms); "
              f"bytes {nbytes} -> {bytes_ms:.6f} ms, logic ops {ops} -> "
              f"{ops_ms:.6f} ms", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this smoke test needs one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # The CLI runs below, in this process and in the subprocesses, pick
    # their device from the environment: make it the card.
    os.environ[platform_env.DEVICE_ENV] = "cuda"
    stats = {k["key"]: {"max_abs_err": 0, "checks": 0} for k in KERNELS}
    _build.BUILD_DIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR))
    try:
        phase("1. card and build")
        smi = card_and_build()
        phase("2. kernels against their plain versions")
        check_kernels(dev, stats)
        phase("3. small flows through python -m gol_tpu_torch")
        small_flows(work)
        phase(f"4. main path at {SIZE}x{SIZE} through the CLI")
        path = main_path(work, dev)
        phase(f"5. timing at {SIZE}x{SIZE}")
        times = timing(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print("main path run (a): " + json.dumps(path["run_a"]))
    table = []
    for k in KERNELS:
        key = k["key"]
        table.append({
            "name": k["name"], "id": k["id"], "route": "cuda",
            "source": "gol_tpu_torch/csrc/stencil_packed.cu",
            "replaces": k["replaces"],
            "launches": sum(n[key] for n in path["launches"].values()),
            "launches_by_path": {v: n[key] for v, n in path["launches"].items()},
            "max_abs_err": stats[key]["max_abs_err"],
            "checks": stats[key]["checks"], **times[key], "library_ms": None,
        })
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
