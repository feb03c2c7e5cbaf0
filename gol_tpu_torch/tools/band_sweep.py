"""The launch constants of band_kernel (K3, K5), swept on one card.

    python -m gol_tpu_torch.tools.band_sweep [--rows 2,4,8] [--ahead 1,2,3,4]
                                             [--blocks 1,8,12] [--out PATH]

For each setting of ``kBandMinRows`` (the least rows of a warp's band),
``kAhead`` (the rows a lane keeps in flight) and ``kBandMinBlocks`` (the
blocks per SM ptxas must fit, which caps the registers) it writes a copy
of ``csrc/stencil_packed.cu`` with those three lines rewritten into
``gol_tpu_torch/_build/band_sweep/``, builds every copy with the package's
nvcc flags (all compilers started together) and, through each copy's own
C entries, times by CUDA-graph replay (``obs.profiler.ring_graph_ms``, 100
launches):

- K3 (``gol_band_step``) on the 16384^2 torus, 512 words a row;
- K5 (``gol_dist_band_step``) over the ring of the four shards of a 4x1
  and of a 2x2 mesh of that grid (4096 x 512 and 8192 x 256 words), each
  shard with its own random ghosts: 67 MB together, more than the L2.

Each case runs twice: on rows that are 16-byte aligned (the 16-byte form)
and on copies that start one word past a 16-byte boundary (the entries
then take the one-word form). Words are random uint32 from
``numpy.random.default_rng(SEED)``. After timing, each copy's output and
flags of one more launch on each case's first input are held against the
plain versions at tolerance 0, and the tool raises on any difference.
Beside the times stand the bytes bound (each input read once, each output
written once, over 3.35 TB/s), the time of ``torch``'s ``copy_`` over the
same shards in the same order (the same words in and out, nothing
computed: what the card's memory and a launch take for this stream), and
each copy's registers and spills as ptxas reports them. Settings compare within one run only. It prints one
JSON object and, with ``--out``, writes it there too. Needs a card and
nvcc.
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

from gol_tpu_torch.obs import profiler
from gol_tpu_torch.ops import _build
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.tools import roofline

SIZE = 16384
SEED = 7
LAUNCHES = 100
ROWS = (2, 4, 8)
AHEAD = (1, 2, 3, 4)
BLOCKS = (1, 8, 12)
SWEEP_DIR = _build.BUILD_DIR / "band_sweep"
_CONSTANTS = ("kBandMinRows", "kAhead", "kBandMinBlocks")


def variant_source(text: str, rows: int, ahead: int, blocks: int) -> str:
    """The kernel source with ``kBandMinRows = rows``, ``kAhead = ahead``
    and ``kBandMinBlocks = blocks``; raises unless each is defined on
    exactly one line."""
    for name, value in zip(_CONSTANTS, (rows, ahead, blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"csrc/stencil_packed.cu defines {name} on "
                               f"{n} lines, expected 1")
    return text


def _label(setting) -> str:
    return "rows {}, ahead {}, blocks {}".format(*setting)


def registers(log: str) -> list[str]:
    """ptxas's lines for band_kernel's instantiations: registers, spills."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "band_kernel" in line:
            name = re.search(r"'(\S+)'", line)
            used = next((l.strip() for l in lines[i + 1:i + 6] if "Used" in l), "")
            spill = next((l.strip() for l in lines[i + 1:i + 6] if "spill" in l), "")
            out.append(f"{name.group(1) if name else line.strip()}: {spill}; {used}")
    return out


def build_all(settings) -> dict:
    """``{(rows, ahead, blocks): (ctypes library, ptxas lines)}``, built in
    parallel."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "stencil_packed.cu").read_text()
    sources = {}
    for setting in settings:
        path = SWEEP_DIR / "stencil_packed_{}_{}_{}.cu".format(*setting)
        path.write_text(variant_source(text, *setting))
        sources[setting] = path
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.build_source, sources.values())))
    return {key: (sp.bind(ctypes.CDLL(str(libs[key]))),
                  registers(_build.source_log(sources[key])))
            for key in sources}


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` starting one word past a 16-byte boundary."""
    base = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = base[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _words(rng, shape, dev) -> torch.Tensor:
    return pm.words_from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32), dev)


def cases(dev) -> dict:
    """``{name: (shards, ghosts per shard or None)}``: K3 on the torus and
    K5 on the two rings, each aligned and one word off."""
    rng = np.random.default_rng(SEED)
    grid = _words(rng, (SIZE, SIZE // 32), dev)
    out = {"K3 16384x512": ([grid], None)}
    for name, (rows, cols) in (("4x1", (4, 1)), ("2x2", (2, 2))):
        h, n = SIZE // rows, SIZE // 32 // cols
        shards = [grid[r * h:(r + 1) * h, c * n:(c + 1) * n].contiguous()
                  for r in range(rows) for c in range(cols)]
        ghosts = [[_words(rng, (1, n), dev), _words(rng, (1, n), dev),
                   _words(rng, (h + 2,), dev), _words(rng, (h + 2,), dev)]
                  for _ in shards]
        out[f"K5 {name} ring {h}x{n}"] = (shards, ghosts)
    for name in list(out):
        shards, ghosts = out[name]
        out[name + " one-word"] = (
            [_misaligned(x) for x in shards],
            None if ghosts is None else [[_misaligned(g[0]), _misaligned(g[1]),
                                          g[2], g[3]] for g in ghosts])
    return out


def _launcher(lib, ghosts, flags):
    def launch(i, x, y):
        h, n = x.shape
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ghosts is None:
            err = lib.gol_band_step(x.data_ptr(), y.data_ptr(), flags.data_ptr(),
                                    h, n, x.device.index, stream)
        else:
            err = lib.gol_dist_band_step(
                x.data_ptr(), *(g.data_ptr() for g in ghosts[i]), y.data_ptr(),
                flags.data_ptr(), h, n, x.device.index, stream)
        if err:
            raise RuntimeError(f"band_kernel launch failed: CUDA error {err}")
    return launch


def _check(launch, shards, ghosts, flags) -> None:
    x = shards[0]
    y = torch.full_like(x, -1)
    flags.zero_()
    launch(0, x, y)
    want, want_flags = (sp._band_plain(x) if ghosts is None
                        else sp._dist_band_plain(x, *ghosts[0]))
    torch.cuda.synchronize()
    if not (torch.equal(y, want) and torch.equal(flags, want_flags)):
        raise RuntimeError("a band_kernel copy disagrees with its plain version")


def measure(libs: dict, dev) -> dict:
    flags = torch.zeros(sp.STEP_FLAGS, dtype=torch.int32, device=dev)
    results = {}
    for name, (shards, ghosts) in cases(dev).items():
        x = shards[0]
        nbytes = 2 * x.numel() * 4 + (0 if ghosts is None else
                                      sum(g.numel() * 4 for g in ghosts[0]))
        bound_ms = nbytes / roofline.HBM_BYTES_PER_S * 1e3
        outs = [torch.empty_like(s) for s in shards]
        copy_ms, _ = profiler.ring_graph_ms(lambda i, a, b: b.copy_(a), shards,
                                            outs, LAUNCHES // len(shards))
        row = {"bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
               "copy_ms": copy_ms, "shards": len(shards), "ms": {}}
        for setting, (lib, _) in libs.items():
            launch = _launcher(lib, ghosts, flags)
            ms, _ = profiler.ring_graph_ms(launch, shards, outs,
                                           LAUNCHES // len(shards))
            _check(launch, shards, ghosts, flags)
            row["ms"][_label(setting)] = ms
        results[name] = row
        best = min(row["ms"], key=row["ms"].get)
        print(f"{name}: bound {bound_ms:.6f} ms, copy_ {copy_ms:.6f} ms; " + ", ".join(
            f"{k} {v:.6f}" for k, v in row["ms"].items())
            + f"; fastest {best} at {bound_ms / row['ms'][best]:.3f} of the bound",
            file=sys.stderr, flush=True)
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gol_tpu_torch.tools.band_sweep",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default=",".join(map(str, ROWS)),
                        help="kBandMinRows values, comma-separated")
    parser.add_argument("--ahead", default=",".join(map(str, AHEAD)),
                        help="kAhead values, comma-separated")
    parser.add_argument("--blocks", default=",".join(map(str, BLOCKS)),
                        help="kBandMinBlocks values, comma-separated")
    parser.add_argument("--out", help="also write the JSON report here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_sweep: torch sees no CUDA card", file=sys.stderr)
        return 2
    settings = [(r, a, b) for r in map(int, args.rows.split(","))
                for a in map(int, args.ahead.split(","))
                for b in map(int, args.blocks.split(","))]
    libs = build_all(settings)
    report = {
        "device": torch.cuda.get_device_name(0),
        "smi": roofline.smi_line(),
        "registers": {_label(s): libs[s][1] for s in settings},
        "cases": measure(libs, torch.device("cuda", 0)),
    }
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
