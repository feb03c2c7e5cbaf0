"""The kernels' CUDA source on the CPU, against the plain torch versions.

``gol_tpu_torch/csrc/stencil_packed.cu`` is compiled with the host C++
compiler against ``tests/cuda_emulation/cuda_runtime.h``, a host emulation
of the CUDA features the kernels use (a launch runs each warp as 32 lanes
on one host thread, each on its own stack, taking turns at every shuffle
and warp reduction), and driven through the source's own C entries and
launch plans.
So ``bandt_kernel``'s indexing, its pipeline's fill and drain, its band
plan and its three tile sources, and ``band_kernel``'s (K3, K5) two word
widths and two sources, are held to the plain versions at tolerance 0
where no nvcc runs; the card runs the same source in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Device ``d`` of the
emulation has the SMs and resident blocks per SM that ``OCCUPANCY[d]``
gives, so the plans cut short bands (one wave of the card's warps) and
tall ones (a card of one SM).
"""

import ctypes
import platform
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gol_tpu_torch.ops import stencil_packed as sp

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "gol_tpu_torch" / "csrc" / "stencil_packed.cu"
EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
# device -> (SMs, resident blocks per SM): an H100's 132 x 3 (bands of the
# least height), and one SM of one block (tall bands).
OCCUPANCY = {0: (132, 3), 1: (1, 1)}


def _top_level_split(config: str) -> list[str]:
    parts, depth, cur = [], 0, ""
    for ch in config:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [*parts, cur]


def emulated_source(text: str) -> str:
    """The source with each ``kernel<<<blocks, threads, shared, ...>>>(args)``
    launch turned into ``emu_set_shared(shared), emu_launch(blocks, threads,
    kernel, args)`` and each ``extern __shared__ T name[];`` into a pointer
    to the launch's dynamic shared memory."""
    def launch(m):
        config = [part.strip() for part in _top_level_split(m.group(2))]
        shared = config[2] if len(config) > 2 else "0"
        return (f"emu_set_shared({shared}), "
                f"emu_launch({config[0]}, {config[1]}, {m.group(1)}, ")

    out, n = re.subn(r"(\w+(?:<[^<>()]*>)?)<<<(.*?)>>>\(", launch, text, flags=re.S)
    assert n, "no launch found"
    return re.sub(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
                  r"\1* const \2 = static_cast<\1*>(emu_dynamic_shared());", out)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or platform.machine() != "x86_64":
        pytest.skip("needs a host C++ compiler on x86-64 (the lanes' stack switch)")
    work = tmp_path_factory.mktemp("bandt_emulated")
    src = work / "stencil_packed_emulated.cpp"
    src.write_text(emulated_source(SOURCE.read_text()))
    so = work / "libbandt_emulated.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gol_bandt_pass.argtypes = [p, p, p, i, i, i, i, p]
    lib.gol_bandt_noflags_pass.argtypes = [p, p, i, i, i, p]
    lib.gol_bandtrow_pass.argtypes = [p] * 5 + [i, i, i, i, p]
    lib.gol_bandtg_pass.argtypes = [p] * 7 + [i, i, i, i, p]
    lib.gol_bandt_bands.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.gol_bandt_tile.argtypes = [ctypes.POINTER(i)] * 3
    lib.gol_band_step.argtypes = [p, p, p, i, i, i, p]
    lib.gol_dist_band_step.argtypes = [p] * 7 + [i, i, i, p]
    lib.emu_misaligned.argtypes, lib.emu_misaligned.restype = [], i
    for device, (sms, blocks) in OCCUPANCY.items():
        lib.emu_occupancy(device, sms, blocks)
    return lib


def _words(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lib, mode, x, device, ghosts=()):
    """One pass of bandt_kernel: mode "summary", "exact" or "none"; ghosts
    () for the torus, (gtop, gbot) or (gtop, gbot, gwest, geast)."""
    h, n = x.shape
    out = torch.full_like(x, -1)
    flags = torch.zeros(sp.EXACT_FLAGS if mode == "exact" else sp.SUMMARY_FLAGS,
                        dtype=torch.int32)
    exact = int(mode == "exact")
    if mode == "none":
        err = lib.gol_bandt_noflags_pass(_ptr(x), _ptr(out), h, n, device, None)
    elif not ghosts:
        err = lib.gol_bandt_pass(_ptr(x), _ptr(out), _ptr(flags), h, n, exact,
                                 device, None)
    elif len(ghosts) == 2:
        err = lib.gol_bandtrow_pass(_ptr(x), *map(_ptr, ghosts), _ptr(out),
                                    _ptr(flags), h, n, exact, device, None)
    else:
        err = lib.gol_bandtg_pass(_ptr(x), *map(_ptr, ghosts), _ptr(out),
                                  _ptr(flags), h, n, exact, device, None)
    assert err == 0
    return out, flags


def _bands(lib, height, nwords, device):
    rows, bands = ctypes.c_int(), ctypes.c_int()
    assert lib.gol_bandt_bands(height, nwords, device, ctypes.byref(rows),
                               ctypes.byref(bands)) == 0
    return rows.value, bands.value


def test_the_source_emulates_every_launch():
    text = emulated_source(SOURCE.read_text())
    assert "<<<" not in text
    assert "emu_launch(blocks, kBandtWarps * kWarp, bandt_kernel<FLAGS, SRC>, " in text


@pytest.mark.parametrize("device", sorted(OCCUPANCY))
def test_band_plan(lib, device):
    sms, blocks = OCCUPANCY[device]
    warps = sms * blocks * 4
    rows_min = ctypes.c_int()
    lib.gol_bandt_tile(ctypes.byref(rows_min), ctypes.byref(ctypes.c_int()),
                       ctypes.byref(ctypes.c_int()))
    for height, nwords in [(1, 1), (33, 2), (273, 31), (16384, 512), (8192, 256)]:
        rows, bands = _bands(lib, height, nwords, device)
        strips = -(-nwords // 30)
        assert (bands - 1) * rows < height <= bands * rows
        assert rows >= min(rows_min.value, height)
        assert bands == 1 or strips * bands <= warps


@pytest.mark.parametrize("device", sorted(OCCUPANCY))
@pytest.mark.parametrize("height,nwords",
                         [(1, 1), (7, 1), (33, 2), (81, 31), (200, 37)])
def test_torus_forms_match_plain(lib, device, height, nwords):
    # K1, K2 and K14 on random words and on a grid that dies out.
    rng = np.random.default_rng(height * 131 + nwords)
    sparse = torch.zeros((height, nwords), dtype=torch.int32)
    sparse[height // 2, nwords // 2] = 0b11  # a domino: dies at generation 1
    for x in (_words(rng, height, nwords), sparse):
        for mode in ("summary", "exact"):
            out, flags = _launch(lib, mode, x, device)
            want, want_flags = sp._bandt_plain(x, exact=mode == "exact")
            assert torch.equal(out, want), mode
            assert torch.equal(flags, want_flags), mode
        out, _ = _launch(lib, "none", x, device)
        assert torch.equal(out, sp._bandt_noflags_plain(x))


@pytest.mark.parametrize("device", sorted(OCCUPANCY))
@pytest.mark.parametrize("height,nwords", [(8, 1), (17, 5), (81, 31), (200, 61)])
def test_shard_forms_match_plain(lib, device, height, nwords):
    # K7/K8 (ghost rows) and the ghost-plane forms (K9+K10, K11-K13), from
    # random ghosts (every bit random) and from dead ones around a dead shard.
    rng = np.random.default_rng(height * 7 + nwords)
    g = [_words(rng, 8, nwords), _words(rng, 8, nwords),
         _words(rng, height + 16), _words(rng, height + 16)]
    for x, ghosts in ((_words(rng, height, nwords), g),
                      (torch.zeros((height, nwords), dtype=torch.int32),
                       [torch.zeros_like(t) for t in g])):
        for mode in ("summary", "exact"):
            exact = mode == "exact"
            out, flags = _launch(lib, mode, x, device, ghosts[:2])
            want, want_flags = sp._bandtrow_plain(x, *ghosts[:2], exact)
            assert torch.equal(out, want) and torch.equal(flags, want_flags)
            out, flags = _launch(lib, mode, x, device, ghosts)
            want, want_flags = sp._bandtg_plain(x, *ghosts, exact)
            assert torch.equal(out, want) and torch.equal(flags, want_flags)


# band_kernel (K3, K5): heights 1 and 2 (the rows above and below are the
# row itself, or one row), one-word rows (a word is its own west and east
# neighbour; both edge words land on lane 0), strips of 32 words with a
# ragged end, and the 16-byte form (nwords % 4 == 0): one lane, one strip
# of 32 lanes and a second strip of one lane.
BAND_SHAPES = [(1, 1), (2, 1), (7, 1), (16, 2), (17, 5), (33, 4), (200, 37),
               (40, 132)]


def _one_generation(lib, x, device, ghosts=None, out=None):
    """K3 (``ghosts`` None) or K5 through the C entries: ``(out, flags)``."""
    h, n = x.shape
    out = torch.full_like(x, -1) if out is None else out.fill_(-1)
    flags = torch.zeros(sp.STEP_FLAGS, dtype=torch.int32)
    if ghosts is None:
        err = lib.gol_band_step(_ptr(x), _ptr(out), _ptr(flags), h, n, device,
                                None)
    else:
        err = lib.gol_dist_band_step(_ptr(x), *map(_ptr, ghosts), _ptr(out),
                                     _ptr(flags), h, n, device, None)
    assert err == 0
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"
    return out, flags


def _band_inputs(rng, height, nwords):
    """Random words, a domino that dies and a block that stays still."""
    dies = torch.zeros((height, nwords), dtype=torch.int32)
    dies[height // 2, nwords // 2] = 0b11
    still = torch.zeros((height, nwords), dtype=torch.int32)
    still[height // 2, nwords // 2] = still[(height // 2 + 1) % height,
                                            nwords // 2] = 0b110
    return {"random": _words(rng, height, nwords), "dies": dies, "still": still}


@pytest.mark.parametrize("device", sorted(OCCUPANCY))
@pytest.mark.parametrize("height,nwords", BAND_SHAPES)
def test_one_generation_matches_plain(lib, device, height, nwords):
    # K3 on the torus; K5 from random ghosts (every bit random) and from
    # dead ones. Words and flags identical, "differs" 0 where nothing moves.
    rng = np.random.default_rng(height * 977 + nwords)
    for name, x in _band_inputs(rng, height, nwords).items():
        out, flags = _one_generation(lib, x, device)
        want, want_flags = sp._band_plain(x)
        assert torch.equal(out, want) and torch.equal(flags, want_flags), name
        if name == "still" and height >= 4:
            assert flags.tolist() == [1, 0]
        shapes = [(1, nwords), (1, nwords), (height + 2,), (height + 2,)]
        ghosts = ([_words(rng, *s) for s in shapes] if name == "random" else
                  [torch.zeros(s, dtype=torch.int32) for s in shapes])
        out, flags = _one_generation(lib, x, device, ghosts)
        want, want_flags = sp._dist_band_plain(x, *ghosts)
        assert torch.equal(out, want) and torch.equal(flags, want_flags), name


def _offset(t):
    """A copy of ``t`` whose storage starts one word past a 16-byte
    boundary."""
    base = torch.empty(t.numel() + 4, dtype=t.dtype)
    assert base.data_ptr() % 16 == 0
    view = base[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", ["in", "out", "top", "bot"])
def test_one_generation_takes_any_alignment(lib, which):
    # nwords % 4 == 0, but one row pointer is not 16-byte aligned: the
    # entries take the one-word form, with the same words and flags.
    rng = np.random.default_rng(7)
    height, nwords = 19, 36
    x = _words(rng, height, nwords)
    ghosts = [_words(rng, 1, nwords), _words(rng, 1, nwords),
              _words(rng, height + 2), _words(rng, height + 2)]
    out = _offset(torch.empty_like(x)) if which == "out" else None
    if which == "in":
        x = _offset(x)
    if which in ("top", "bot"):
        k = 0 if which == "top" else 1
        ghosts[k] = _offset(ghosts[k])
    if which in ("in", "out"):
        got, flags = _one_generation(lib, x, 0, out=out)
        want, want_flags = sp._band_plain(x)
        assert torch.equal(got, want) and torch.equal(flags, want_flags)
    got, flags = _one_generation(lib, x, 0, ghosts, out=out)
    want, want_flags = sp._dist_band_plain(x, *ghosts)
    assert torch.equal(got, want) and torch.equal(flags, want_flags)
