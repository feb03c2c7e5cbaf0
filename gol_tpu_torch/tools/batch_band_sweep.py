"""The banded and column-cut forms of B1 and B2 over their tiles and CTA sizes, on one card.

    python -m gol_tpu_torch.tools.batch_band_sweep [--threads 1024:1024,512:1024,256:512]
                                                   [--batches 64,8,2] [--out PATH]

For each pair ``P:M`` of ``--threads`` it writes a copy of
``csrc/stencil_batch.cu`` with ``kPackedBandThreads = P`` (B1's banded
form's most threads a CTA) and ``kMaskedBandThreads = M`` (B2's) into
``gol_tpu_torch/_build/batch_band_sweep/``, builds every copy with the
package's nvcc flags (all compilers started together) and, through each
copy's own C entries, times one block of 16 generations (every board
running) by CUDA-graph replay with fresh flag rows per launch (20
launches) at the batch lane's 1024^2 buckets:

- B1 (``gol_batch_packed_band``) on B boards of 1024 x 32 words;
- B2 (``gol_batch_masked_band``) on B boards of 1000^2 in a 1024^2 canvas;

for each B of ``--batches``, at the band rows R the plan chooses
(``gol_batch_band_plan``: one CTA an SM) and at R / 2 and 2 R where those
fit; and the column-cut forms at WIDE_BOARDS boards of the smoke's wide
pairs:

- B1 (``gol_batch_packed_wide``) on boards of 32 x 9,675 words;
- B2 (``gol_batch_masked_wide``) on boards of 30 x 309,590 in a 32 x
  309,600 canvas;

at the plan's tile of R rows x C words and at C / 2 and 2 C where those
fit. Boards are random from ``numpy.random.default_rng(SEED)``. After
timing, each copy's output and flags of one more block at the plan's
tile are held against the plain versions at tolerance 0, and the tool
raises on any difference. Beside the times stand each case's bound (the boards
read and written once over 3.35 TB/s, the network's 12 logic operations
per word of bits and generation over the card's logic rate; the larger)
and each copy's registers and spills as ptxas reports them. Settings
compare within one run only. It prints one JSON object and, with
``--out``, writes it there too. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import sys

import numpy as np
import torch

from gol_tpu_torch.ops import _build
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_batch as sb
from gol_tpu_torch.tools import roofline

SEED = 11
GENERATIONS = 16
LAUNCHES = 20
SIDE, MASKED_SIDE = 1024, 1000
THREADS = ((1024, 1024), (512, 1024), (256, 512))
BATCHES = (64, 8, 2)
WIDE_BOARDS, WIDE, WIDE_MASKED = 16, (32, 309600), (30, 309590)
SWEEP_DIR = _build.BUILD_DIR / "batch_band_sweep"
_CONSTANTS = ("kPackedBandThreads", "kMaskedBandThreads")


def variant_source(text: str, packed: int, masked: int) -> str:
    """The kernel source with ``kPackedBandThreads = packed`` and
    ``kMaskedBandThreads = masked``; raises unless each is defined on
    exactly one line."""
    for name, value in zip(_CONSTANTS, (packed, masked)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"csrc/stencil_batch.cu defines {name} on "
                               f"{n} lines, expected 1")
    return text


def _label(setting) -> str:
    return "B1 {} threads, B2 {} threads".format(*setting)


def registers(log: str) -> list[str]:
    """ptxas's lines for the banded and column-cut kernels (the template's
    false and true): registers, spills."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "_band_kernel" in line:
            name = re.search(r"(batch_[a-z]+_band_kernel)(?:ILb([01])E)?", line)
            label = line.strip() if not name else name.group(1) + (
                "" if name.group(2) is None else f"<{('false', 'true')[int(name.group(2))]}>")
            used = next((l.strip() for l in lines[i + 1:i + 6] if "Used" in l), "")
            spill = next((l.strip() for l in lines[i + 1:i + 6] if "spill" in l), "")
            out.append(f"{label}: {spill}; {used}")
    return out


def build_all(settings) -> dict:
    """``{(packed, masked): (ctypes library, ptxas lines)}``, built in
    parallel."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "stencil_batch.cu").read_text()
    sources = {}
    for setting in settings:
        path = SWEEP_DIR / "stencil_batch_{}_{}.cu".format(*setting)
        path.write_text(variant_source(text, *setting))
        sources[setting] = path
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.build_source, sources.values())))
    return {key: (sb._bind(ctypes.CDLL(str(libs[key]))),
                  registers(_build.source_log(sources[key])))
            for key in sources}


def band_rows(plan_rows: int, height: int, nwb: int, most: int) -> list[int]:
    """R / 2, R and 2 R, where a band of them and its ghost rows fit."""
    rows = sorted({max(1, plan_rows // 2), plan_rows, 2 * plan_rows})
    return [r for r in rows if r <= height and (r + 2 * GENERATIONS) * nwb <= most]


def tile_words(plan_cols: int, rows: int, height: int, nwb: int, most: int) -> list[int]:
    """C / 2, C and 2 C, where a tile of ``rows`` rows of them, its ghost
    rows (none for a tile of the whole height) and its ghost words fit."""
    held = height if rows >= height else rows + 2 * GENERATIONS
    cols = sorted({max(1, plan_cols // 2), plan_cols, 2 * plan_cols})
    return [c for c in cols if c < nwb and held * (c + 2) <= most]


def _block_ms(launch, x: torch.Tensor) -> float:
    """ms a block of ``launch(src, dst, flags)`` over LAUNCHES ping-pong
    launches in one CUDA graph, each into its own zeroed flag rows."""
    y = torch.empty_like(x)
    rows = torch.zeros((LAUNCHES, GENERATIONS, x.shape[0], sb.STEP_FLAGS),
                       dtype=torch.int32, device=x.device)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, b = x, y
        for k in range(LAUNCHES):
            launch(a, b, rows[k])
            a, b = b, a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # warm, then timed
        rows.zero_()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def cases(batch: int, dev) -> dict:
    """``{name: (x, launcher(lib, rows), plain, bound_ms)}`` at ``batch``
    boards: B1's 1024 x 32 words and B2's 1000^2 in a 1024^2 canvas."""
    rng = np.random.default_rng(SEED + batch)
    t, nwb = GENERATIONS, SIDE // 32
    words = pm.words_from_numpy(rng.integers(0, 2**32, (batch, SIDE, nwb),
                                             dtype=np.uint64).astype(np.uint32), dev)
    canvas = np.zeros((batch, SIDE, SIDE), np.uint8)
    canvas[:, :MASKED_SIDE, :MASKED_SIDE] = rng.integers(
        0, 2, (batch, MASKED_SIDE, MASKED_SIDE), dtype=np.uint8)
    cells = torch.from_numpy(canvas).to(dev)
    full = torch.full((batch,), t, dtype=torch.int32, device=dev)
    ext = torch.full((batch,), MASKED_SIDE, dtype=torch.int32, device=dev)

    def packed(lib, rows):
        def launch(a, b, flags):
            err = lib.gol_batch_packed_band(
                a.data_ptr(), b.data_ptr(), flags.data_ptr(), full.data_ptr(), 0, t,
                batch, SIDE, nwb, rows, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"B1 banded launch failed: CUDA error {err}")
        return launch

    def masked(lib, rows):
        def launch(a, b, flags):
            err = lib.gol_batch_masked_band(
                a.data_ptr(), b.data_ptr(), flags.data_ptr(), full.data_ptr(),
                ext.data_ptr(), ext.data_ptr(), 0, t, batch, SIDE, SIDE, rows,
                dev.index, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"B2 banded launch failed: CUDA error {err}")
        return launch

    rate = roofline.logic_ops_per_s()

    def bound(x, ops):
        return max(2 * x.numel() * x.element_size() / roofline.HBM_BYTES_PER_S,
                   ops / rate) * 1e3

    ops = batch * MASKED_SIDE * -(-MASKED_SIDE // 32) * roofline.OPS_PER_WORD_GEN * t
    return {
        f"B1 {batch} x {SIDE}x{nwb} words": (
            words, packed, lambda x: sb._batch_packed_block_plain(x, full, t),
            bound(words, words.numel() * roofline.OPS_PER_WORD_GEN * t)),
        f"B2 {batch} x {MASKED_SIDE}^2 in {SIDE}^2": (
            cells, masked, lambda x: sb._batch_masked_block_plain(x, full, ext, ext, t),
            bound(cells, ops)),
    }


def wide_cases(dev) -> dict:
    """``{name: (x, launcher(lib, rows, cols), plain, bound_ms, height,
    nwb)}`` for the column-cut forms at WIDE_BOARDS boards: B1's 32 x
    9,675 words and B2's 30 x 309,590 in a 32 x 309,600 canvas."""
    rng = np.random.default_rng(SEED + 1)
    t, batch, (height, width), (mh, mw) = GENERATIONS, WIDE_BOARDS, WIDE, WIDE_MASKED
    nwb = width // 32
    words = pm.words_from_numpy(rng.integers(0, 2**32, (batch, height, nwb),
                                             dtype=np.uint64).astype(np.uint32), dev)
    cells = torch.zeros((batch, height, width), dtype=torch.uint8, device=dev)
    cells[:, :mh, :mw] = torch.from_numpy(
        rng.integers(0, 2, (batch, mh, mw), dtype=np.uint8)).to(dev)
    full = torch.full((batch,), t, dtype=torch.int32, device=dev)
    eh = torch.full((batch,), mh, dtype=torch.int32, device=dev)
    ew = torch.full((batch,), mw, dtype=torch.int32, device=dev)

    def packed(lib, rows, cols):
        def launch(a, b, flags):
            err = lib.gol_batch_packed_wide(
                a.data_ptr(), b.data_ptr(), flags.data_ptr(), full.data_ptr(), 0, t,
                batch, height, nwb, rows, cols, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"B1 column-cut launch failed: CUDA error {err}")
        return launch

    def masked(lib, rows, cols):
        def launch(a, b, flags):
            err = lib.gol_batch_masked_wide(
                a.data_ptr(), b.data_ptr(), flags.data_ptr(), full.data_ptr(),
                eh.data_ptr(), ew.data_ptr(), 0, t, batch, height, width, rows,
                cols, dev.index, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"B2 column-cut launch failed: CUDA error {err}")
        return launch

    rate = roofline.logic_ops_per_s()

    def bound(x, ops):
        return max(2 * x.numel() * x.element_size() / roofline.HBM_BYTES_PER_S,
                   ops / rate) * 1e3

    return {
        f"B1-wide {batch} x {height}x{nwb} words": (
            words, packed, lambda x: sb._batch_packed_block_plain(x, full, t),
            bound(words, words.numel() * roofline.OPS_PER_WORD_GEN * t), height, nwb),
        f"B2-wide {batch} x {mh}x{mw} in {height}x{width}": (
            cells, masked, lambda x: sb._batch_masked_block_plain(x, full, eh, ew, t),
            bound(cells, batch * mh * -(-mw // 32) * roofline.OPS_PER_WORD_GEN * t),
            height, nwb),
    }


def _check_block(launch, x, plain, name, label) -> None:
    """One more block of ``launch`` against ``plain`` at tolerance 0."""
    y = torch.empty_like(x)
    flags = torch.zeros((GENERATIONS, x.shape[0], sb.STEP_FLAGS), dtype=torch.int32,
                        device=x.device)
    launch(x, y, flags)
    want, want_flags = plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(y, want) and torch.equal(flags, want_flags)):
        raise RuntimeError(f"{name}: the copy {label} disagrees with its plain version")


def _report(name: str, row: dict) -> None:
    best = min(row["ms"], key=row["ms"].get)
    print(f"{name}: bound {row['bound_ms']:.6f} ms; " + ", ".join(
        f"{k} {v:.6f}" for k, v in row["ms"].items())
        + f"; fastest {best} at {row['bound_ms'] / row['ms'][best]:.3f} of the bound",
        file=sys.stderr, flush=True)


def measure_wide(libs: dict, dev) -> dict:
    """The column-cut forms (``wide_cases``) at the plan's tile and at C / 2
    and 2 C, with each copy of ``libs``."""
    most = sb.block_max_words(dev.index)
    results = {}
    for name, (x, launcher, plain, bound_ms, height, nwb) in wide_cases(dev).items():
        _, rows, cols = sb.band_plan(dev.index, WIDE_BOARDS, height, nwb, GENERATIONS)
        row = {"bound_ms": bound_ms, "plan": [rows, cols], "ms": {}}
        for setting, (lib, _) in libs.items():
            for c in tile_words(cols, rows, height, nwb, most):
                row["ms"][f"{_label(setting)}, R {rows}, C {c}"] = _block_ms(
                    launcher(lib, rows, c), x)
            _check_block(launcher(lib, rows, cols), x, plain, name, _label(setting))
        results[name] = row
        _report(name, row)
    return results


def measure(libs: dict, batches, dev) -> dict:
    most = sb.block_max_words(dev.index)
    results = {}
    for batch in batches:
        _, plan_rows, _ = sb.band_plan(dev.index, batch, SIDE, SIDE // 32, GENERATIONS)
        for name, (x, launcher, plain, bound_ms) in cases(batch, dev).items():
            row = {"bound_ms": bound_ms, "plan_rows": plan_rows, "ms": {}}
            for setting, (lib, _) in libs.items():
                for rows in band_rows(plan_rows, SIDE, SIDE // 32, most):
                    row["ms"][f"{_label(setting)}, R {rows}"] = _block_ms(
                        launcher(lib, rows), x)
                _check_block(launcher(lib, plan_rows), x, plain, name, _label(setting))
            results[name] = row
            _report(name, row)
    return results


def _pair(text: str) -> tuple[int, int]:
    packed, masked = text.split(":")
    return int(packed), int(masked)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gol_tpu_torch.tools.batch_band_sweep",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", default=",".join(f"{p}:{m}" for p, m in THREADS),
                        help="kPackedBandThreads:kMaskedBandThreads pairs, comma-separated")
    parser.add_argument("--batches", default=",".join(map(str, BATCHES)),
                        help="boards a block, comma-separated")
    parser.add_argument("--out", help="also write the JSON report here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_band_sweep: torch sees no CUDA card", file=sys.stderr)
        return 2
    settings = [_pair(p) for p in args.threads.split(",")]
    libs = build_all(settings)
    dev = torch.device("cuda", 0)
    report = {
        "device": torch.cuda.get_device_name(0),
        "smi": roofline.smi_line(),
        "registers": {_label(s): libs[s][1] for s in settings},
        "cases": measure(libs, [int(b) for b in args.batches.split(",")], dev),
        "wide_cases": measure_wide(libs, dev),
    }
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
