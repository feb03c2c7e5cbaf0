"""The tile step kernel's CUDA source on the CPU, against its plain torch
version.

``gol_tpu_torch/csrc/stencil_tile.cu`` (T1) is compiled with the host C++
compiler against ``tests/cuda_emulation/cuda_runtime.h`` (a launch runs
each block's threads as lanes on one host thread, switching at warp
intrinsics and block barriers, with the block's shared memory) and driven
through its own C entries. Each launch is held to ``stencil_tile``'s plain
version at tolerance 0, interiors and per-tile flags, in both output forms
and both launch shapes: the banded n = 1 form (and n generations of it,
``stencil_tile.steps_by_generation``) and the whole-window form, at n in
{1, 2, 7}: tiles of odd and even edges (one word of a row and several, one
band and several), padding rows, a still life, a dead interior born from
its ring. The card runs the same source in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
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

# (tiles, edge): the sparse lane's least tile, odd edges, a tile whose
# padded rows take two words, and one of several 32-row bands with a
# ragged last band and five words a row.
SHAPES = [(3, 4), (5, 5), (2, 9), (4, 33), (2, 130)]
GENERATIONS = [1, 2, 7]


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
    lib.gol_tile_window_steps.argtypes = [p] * 3 + [i] * 3 + [ll] * 2 + [i, p]
    lib.gol_tile_window_max_words.argtypes = [i]
    lib.emu_misaligned.argtypes, lib.emu_misaligned.restype = [], i
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


def _dest(out, tile):
    """(pointer, row pitch, tile stride) of the interiors in ``out``:
    compact (B, t, t), or the interior of a padded (B, t+2, t+2) stack."""
    if out.shape[1] == tile:
        return out.data_ptr(), tile, tile * tile
    return out.data_ptr() + tile + 3, tile + 2, (tile + 2) ** 2


def _out(x, form):
    """A 5-filled output of ``form`` for the blocks ``x``, and its
    ``_dest``."""
    batch, p, _ = x.shape
    tile = p - 2
    out = (torch.full((batch, tile, tile), 5, dtype=torch.uint8)
           if form == "compact" else torch.full_like(x, 5))
    return out, _dest(out, tile)


def _check_out(x, out, flags, form, n):
    want, want_flags = st._tile_steps_plain(x, n)
    got = out if form == "compact" else out[:, 1:-1, 1:-1]
    assert torch.equal(got, want)
    assert torch.equal(flags, want_flags)
    if form == "padded":  # the ring is left as it was
        ring = out.clone()
        ring[:, 1:-1, 1:-1] = 5
        assert bool((ring == 5).all())
    assert tuple(flags[-1].tolist()) == (0, 0)  # a padding row
    if x.shape[0] > 2 and x.shape[1] > 5:
        assert tuple(flags[1].tolist()) == (1, 0)  # a still life


@pytest.mark.parametrize("form", ["compact", "padded"])
@pytest.mark.parametrize("batch,tile", SHAPES)
def test_tile_step_matches_plain(lib, batch, tile, form):
    x = _blocks(batch, tile, np.random.default_rng(batch * 100 + tile))
    flags = torch.zeros((batch, 2), dtype=torch.int32)
    out, (at, pitch, stride) = _out(x, form)
    assert lib.gol_tile_step(x.data_ptr(), at, flags.data_ptr(), batch, tile,
                             pitch, stride, 0, None) == 0
    _check_out(x, out, flags, form, 1)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("n", GENERATIONS)
@pytest.mark.parametrize("form", ["compact", "padded"])
@pytest.mark.parametrize("batch,tile", SHAPES)
def test_window_steps_match_plain(lib, batch, tile, form, n):
    """The whole-window form: n generations in one launch, each reading
    the block's own ring."""
    x = _blocks(batch, tile, np.random.default_rng(batch * 7 + tile + n))
    kept = x.clone()
    flags = torch.zeros((batch, 2), dtype=torch.int32)
    out, (at, pitch, stride) = _out(x, form)
    assert lib.gol_tile_window_steps(x.data_ptr(), at, flags.data_ptr(), batch,
                                     tile, n, pitch, stride, 0, None) == 0
    _check_out(x, out, flags, form, n)
    assert torch.equal(x, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("n", GENERATIONS)
@pytest.mark.parametrize("batch,tile", SHAPES)
def test_banded_steps_by_generation_match_plain(lib, batch, tile, n):
    """A window too large for one CTA: n launches of the banded form
    through two padded stacks, the last into the compact interiors."""
    x = _blocks(batch, tile, np.random.default_rng(batch * 11 + tile + n))

    def step(src, dst, f):
        at, pitch, stride = _dest(dst, tile)
        assert lib.gol_tile_step(src.data_ptr(), at, f.data_ptr(), batch, tile,
                                 pitch, stride, 0, None) == 0

    flags = torch.zeros((batch, 2), dtype=torch.int32)
    out, _ = _out(x, "compact")
    st.steps_by_generation(x, out, flags, n, step)
    _check_out(x, out, flags, "compact", n)


def test_window_past_48_kib_of_shared_memory(lib):
    """A 450^2 window (6780 words, 54,240 bytes for two copies): the
    kernel asks for the opt-in shared memory."""
    x = _blocks(2, 450, np.random.default_rng(450))
    flags = torch.zeros((2, 2), dtype=torch.int32)
    out, (at, pitch, stride) = _out(x, "compact")
    assert lib.gol_tile_window_steps(x.data_ptr(), at, flags.data_ptr(), 2, 450,
                                     2, pitch, stride, 0, None) == 0
    _check_out(x, out, flags, "compact", 2)
    # An H100's opt-in 232,448 bytes, less the warps' flag words.
    assert lib.gol_tile_window_max_words(0) == (232448 - 128) // 8 // 4 * 4


def test_flags_accumulate_into_the_callers_buffer(lib):
    """Flags are ORed in, never stored: a set flag stays set."""
    x = torch.zeros((2, 6, 6), dtype=torch.uint8)
    out = torch.empty((2, 4, 4), dtype=torch.uint8)
    flags = torch.tensor([[1, 1], [0, 1]], dtype=torch.int32)
    assert lib.gol_tile_step(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                             2, 4, 4, 16, 0, None) == 0
    assert flags.tolist() == [[1, 1], [0, 1]]
    assert not out.any()
