"""The tile step kernel's CUDA source on the CPU, against its plain torch
version.

``gol_tpu_torch/csrc/stencil_tile.cu`` (T1) is compiled with the host C++
compiler against ``tests/cuda_emulation/cuda_runtime.h`` (a launch runs
each warp as 32 lanes on one host thread; the flag reduction is a warp
intrinsic) and driven through its own C entry. Each launch is held to
``stencil_tile``'s plain version at tolerance 0, interiors and per-tile
flags, in both output forms: tiles of odd and even edges (one warp's
columns and several, one band and several), padding rows, a still life, a
dead interior born from its ring. The card runs the same source in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gol_tpu_torch.ops import stencil_tile as st
from test_torch_bandt_emulated import emulated_source

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "gol_tpu_torch" / "csrc" / "stencil_tile.cu"
EMULATION = Path(__file__).resolve().parent / "cuda_emulation"

# (tiles, edge): the sparse lane's least tile, odd edges, a tile of two
# warps' columns, and one taller than a block's bands (16 rows x 8 warps).
SHAPES = [(3, 4), (5, 5), (2, 9), (4, 33), (2, 130)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or platform.machine() != "x86_64":
        pytest.skip("needs a host C++ compiler on x86-64 (the lanes' stack switch)")
    work = tmp_path_factory.mktemp("tile_emulated")
    src = work / "stencil_tile_emulated.cpp"
    src.write_text(emulated_source(SOURCE.read_text()))
    so = work / "libtile_emulated.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gol_tile_step.argtypes = [p] * 3 + [i] * 2 + [ll] * 2 + [i, p]
    return lib


def _blocks(batch, tile, rng):
    """Soup with a random ring, a still block, a dead interior that births
    from its ring, and an all-zero padding row last."""
    p = tile + 2
    out = np.zeros((batch, p, p), np.uint8)
    for b in range(batch - 1):
        kind = b % 3
        if kind == 0:
            out[b] = rng.random((p, p)) < 0.45
        elif kind == 1:
            out[b, 2:4, 2:4] = 1
        else:
            out[b, 0, 1:4] = 1
    return torch.from_numpy(out)


@pytest.mark.parametrize("form", ["compact", "padded"])
@pytest.mark.parametrize("batch,tile", SHAPES)
def test_tile_step_matches_plain(lib, batch, tile, form):
    x = _blocks(batch, tile, np.random.default_rng(batch * 100 + tile))
    want, want_flags = st._tile_step_plain(x)
    flags = torch.zeros((batch, 2), dtype=torch.int32)
    if form == "compact":
        out = torch.full((batch, tile, tile), 5, dtype=torch.uint8)
        at, pitch, stride = out.data_ptr(), tile, tile * tile
    else:
        out = torch.full_like(x, 5)
        at, pitch, stride = out.data_ptr() + tile + 3, tile + 2, (tile + 2) ** 2
    assert lib.gol_tile_step(x.data_ptr(), at, flags.data_ptr(), batch, tile,
                             pitch, stride, 0, None) == 0
    got = out if form == "compact" else out[:, 1:-1, 1:-1]
    assert torch.equal(got, want)
    assert torch.equal(flags, want_flags)
    if form == "padded":  # the ring is left as it was
        ring = out.clone()
        ring[:, 1:-1, 1:-1] = 5
        assert bool((ring == 5).all())
    assert tuple(flags[-1].tolist()) == (0, 0)  # a padding row
    if batch > 2:
        assert tuple(flags[1].tolist()) == (1, 0)  # a still life


def test_flags_accumulate_into_the_callers_buffer(lib):
    """Flags are ORed in, never stored: a set flag stays set."""
    x = torch.zeros((2, 6, 6), dtype=torch.uint8)
    out = torch.empty((2, 4, 4), dtype=torch.uint8)
    flags = torch.tensor([[1, 1], [0, 1]], dtype=torch.int32)
    assert lib.gol_tile_step(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                             2, 4, 4, 16, 0, None) == 0
    assert flags.tolist() == [[1, 1], [0, 1]]
    assert not out.any()
