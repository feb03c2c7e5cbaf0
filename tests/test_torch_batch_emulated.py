"""The batched step kernels' CUDA source on the CPU, against their plain
torch versions and the JAX package.

``gol_tpu_torch/csrc/stencil_batch.cu`` (B1 and B2: their block, banded
and column-cut forms) is compiled with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (a launch runs each block's threads
as lanes on one host thread, switching at warp intrinsics and block
barriers, with the block's shared memory) and driven through its own C
entries. Each launch is held to ``stencil_batch``'s plain version at
tolerance 0, words or cells and per-generation flags: mixed extents in one
canvas, spent step counts (a board copied through), one-word-wide and
one-row boards, and boards that die or stand still. The block forms run
whole blocks of t in {1, 2, 16, 18} generations with mixed step counts
(full, short, 0, past t), the banded forms the same blocks at explicit
band rows, and the column-cut forms at explicit tiles (rows 1, 3 and the
board's height; words 1, 3 and the whole row) and at the plan's; the
one-generation wrappers' launch is the column-cut form at one generation
a launch, and ``stencil_batch.streamed_block`` runs blocks of it. B2 also
runs on slots that start off a 16-byte boundary and with non-zero padding,
past 48 KiB of shared memory, and past the opt-in, where the block form is
refused. The column-cut forms over a block are also held to JAX's
``vmap(packed_math.evolve_torus_words)`` and ``_evolve_batch_masked``.
The emulation aborts on a divergent barrier or a warp intrinsic that a
lane misses, and two deliberately broken kernels show that it does. The
card runs the same source in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes
import platform
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.ops import packed_math as jax_pm
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_batch as sb
from test_torch_bandt_emulated import emulated_source

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "gol_tpu_torch" / "csrc" / "stencil_batch.cu"
EMULATION = Path(__file__).resolve().parent / "cuda_emulation"

# (boards, height, nwords): one-word and one-row boards, 32x32 (the trio's
# bucket), several 256-thread blocks per board, an odd word count.
PACKED = [(3, 1, 1), (2, 7, 1), (4, 32, 1), (3, 17, 5), (2, 40, 9)]
# (canvas height, width, extents): the masked bucket of the JAX tests, an
# exact-fit byte board (the byte mode), a canvas of several warps' columns,
# and one taller than a block's bands (B2's warps walk 16-row bands, eight
# to a block).
MASKED = [(32, 32, [(30, 30), (18, 24), (10, 13), (1, 1)]),
          (33, 20, [(33, 20), (33, 20)]),
          (19, 70, [(19, 70), (5, 64), (1, 3)]),
          (130, 40, [(130, 40), (129, 33)])]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or platform.machine() != "x86_64":
        pytest.skip("needs a host C++ compiler on x86-64 (the lanes' stack switch)")
    work = tmp_path_factory.mktemp("batch_emulated")
    src = work / "stencil_batch_emulated.cpp"
    src.write_text(emulated_source(SOURCE.read_text()))
    so = work / "libbatch_emulated.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gol_batch_packed_block.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.gol_batch_masked_block.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.gol_batch_block_max_words.argtypes = [i]
    lib.gol_batch_packed_band.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.gol_batch_masked_band.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.gol_batch_packed_wide.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.gol_batch_masked_wide.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.gol_batch_band_plan.argtypes = [i] * 5 + [p]
    lib.emu_misaligned.argtypes, lib.emu_misaligned.restype = [], i
    lib.emu_shared_optin.argtypes = [i, i]
    return lib


def _cells(height, width, rng, kind):
    g = np.zeros((height, width), np.uint8)
    if kind == "soup":
        g = (rng.random((height, width)) < 0.45).astype(np.uint8)
    elif kind == "dies":
        g[height // 2, width // 2] = 1
    elif kind == "still":  # a block, still where it fits
        g[:2, :2] = 1
    return g


KINDS = ["soup", "dies", "still"]


def _steps(batch):
    """Every board runs at gen 0 but one; at gen 2 the odd boards' steps
    are spent (copied through)."""
    return torch.tensor([3 if b % 2 == 0 else 2 for b in range(batch)],
                        dtype=torch.int32)


def _step_tile(lib, batch, height, nwb, device=0):
    """The one-generation wrappers' tile (``stencil_batch.step_tile``) on
    the emulated card."""
    return sb.fit_step_tile(_plan(lib, batch, height, nwb, 1, device)[1:],
                            lib.gol_batch_block_max_words(device))


def _packed_step(lib, src, dst, flags, steps, gen, device=0):
    """What ``batch_packed_step_into`` launches: the column-cut form at
    generation ``gen``, one generation, into the (B, 2) flag row."""
    batch, height, nwords = src.shape
    rows, cols = _step_tile(lib, batch, height, nwords, device)
    return lib.gol_batch_packed_wide(
        src.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(), gen,
        1, batch, height, nwords, rows, cols, device, None)


def _masked_step(lib, src, dst, flags, steps, heights, widths, gen, device=0):
    """What ``batch_masked_step_into`` launches, as ``_packed_step``."""
    batch, height, width = src.shape
    rows, cols = _step_tile(lib, batch, height, -(-width // 32), device)
    return lib.gol_batch_masked_wide(
        src.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), gen, 1, batch, height, width,
        rows, cols, device, None)


@pytest.mark.parametrize("gen", [0, 2])
@pytest.mark.parametrize("batch,height,nwords", PACKED)
def test_packed_batch_step_matches_plain(lib, batch, height, nwords, gen):
    rng = np.random.default_rng(batch * 100 + height * 7 + nwords)
    boards = [_cells(height, 32 * nwords, rng, KINDS[b % 3]) for b in range(batch)]
    words = torch.stack([pm.encode(torch.from_numpy(g)) for g in boards])
    steps = _steps(batch)
    if gen == 0:
        steps[-1] = 0  # a padding slot
    out = torch.full_like(words, -1)
    flags = torch.zeros((batch, 2), dtype=torch.int32)
    assert _packed_step(lib, words, out, flags, steps, gen) == 0
    want, want_flags = sb._batch_packed_plain(words, steps, gen)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)


@pytest.mark.parametrize("gen", [0, 2])
@pytest.mark.parametrize("height,width,extents", MASKED)
def test_masked_batch_step_matches_plain(lib, height, width, extents, gen):
    rng = np.random.default_rng(height * 13 + width)
    batch = len(extents)
    canvas = np.zeros((batch, height, width), np.uint8)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = _cells(h, w, rng, KINDS[b % 3])
    cells = torch.from_numpy(canvas)
    heights = torch.tensor([h for h, _ in extents], dtype=torch.int32)
    widths = torch.tensor([w for _, w in extents], dtype=torch.int32)
    steps = _steps(batch)
    out = torch.full_like(cells, 7)
    flags = torch.zeros((batch, 2), dtype=torch.int32)
    assert _masked_step(lib, cells, out, flags, steps, heights, widths, gen) == 0
    want, want_flags = sb._batch_masked_plain(cells, steps, heights, widths, gen)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)


def test_flags_accumulate_into_the_callers_buffer(lib):
    """Flags are ORed in, never stored: a set flag stays set, and a spent
    board writes none."""
    words = torch.zeros((2, 4, 1), dtype=torch.int32)
    out = torch.empty_like(words)
    flags = torch.tensor([[1, 1], [1, 0]], dtype=torch.int32)
    steps = torch.tensor([1, 0], dtype=torch.int32)
    assert _packed_step(lib, words, out, flags, steps, 0) == 0
    assert flags.tolist() == [[1, 1], [1, 0]]
    assert not out.any()


# B1's block form: t generations per launch. The shapes of PACKED and one
# board past 48 KiB of shared memory (the kernel asks for the opt-in).
BLOCK_TS = [1, 2, 16, 18]
BIG_BOARD = (1, 200, 32)  # 6400 words: two copies take 51,200 bytes


def _block_steps(batch, t):
    """Board b runs t, 1, 0 (spent: copied through) or t + 2 (clamped to
    t) generations, cycling."""
    return torch.tensor([(t, 1, 0, t + 2)[b % 4] for b in range(batch)],
                        dtype=torch.int32)


def _packed_boards(batch, height, nwords, seed):
    rng = np.random.default_rng(seed)
    boards = [_cells(height, 32 * nwords, rng, KINDS[b % 3]) for b in range(batch)]
    return torch.stack([pm.encode(torch.from_numpy(g)) for g in boards])


def _block_launch(lib, words, steps, t):
    batch, height, nwords = words.shape
    out = torch.full_like(words, -1)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32)
    assert lib.gol_batch_packed_block(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        t, batch, height, nwords, 0, None) == 0
    return out, flags


@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("batch,height,nwords", PACKED)
def test_packed_block_matches_plain(lib, batch, height, nwords, t):
    words = _packed_boards(batch, height, nwords, batch * 100 + height * 7 + nwords)
    steps = _block_steps(batch, t)
    kept = words.clone()
    out, flags = _block_launch(lib, words, steps, t)
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(words, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("batch,height,nwords", PACKED)
def test_packed_streaming_block_matches_plain(lib, batch, height, nwords, t):
    """The one-generation launch over a whole block: one launch a
    generation, ping-ponging a scratch stack and the output."""
    words = _packed_boards(batch, height, nwords, batch * 31 + height + nwords)
    steps = _block_steps(batch, t)

    out, scratch = torch.full_like(words, -1), torch.full_like(words, -1)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32)

    def step(src, dst, gen, n):
        assert n == 1
        assert _packed_step(lib, src, dst, flags[gen], steps, gen) == 0

    sb.streamed_block(words, out, t, scratch, step)
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)


def test_packed_block_past_48_kib_of_shared_memory(lib):
    words = _packed_boards(*BIG_BOARD, seed=5)
    steps = torch.tensor([2], dtype=torch.int32)
    out, flags = _block_launch(lib, words, steps, 2)
    want, want_flags = sb._batch_packed_block_plain(words, steps, 2)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


def test_block_form_refuses_a_board_past_the_opt_in(lib):
    """The most words the block form takes follow the device's opt-in
    shared memory (an H100's 232,448 bytes: 29,024 words), and a board
    past them is refused, not run."""
    assert lib.gol_batch_block_max_words(0) == 29024
    lib.emu_shared_optin(1, 4096)
    most = lib.gol_batch_block_max_words(1)
    assert most == (4096 - 256) // 8 // 4 * 4
    words = _packed_boards(1, most // 4 + 1, 4, seed=6)
    out = torch.full_like(words, -1)
    flags = torch.zeros((1, 1, 2), dtype=torch.int32)
    steps = torch.ones(1, dtype=torch.int32)
    assert lib.gol_batch_packed_block(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        1, 1, words.shape[1], 4, 1, None) != 0
    assert bool((out == -1).all())


# B2's block form: chip_smoke.py's phase-2 shapes (BATCH_MASKED_SHAPES) and
# the masked canvases above, whole blocks of BLOCK_TS generations.
MASKED_BLOCK = [(32, 32, [(30, 30), (18, 24), (10, 13), (1, 1)]),
                (33, 20, [(33, 20)] * 2),
                (256, 256, [(250, 250)] * 64),
                (19, 70, [(19, 70), (5, 64), (1, 3), (1, 70)]),
                (130, 40, [(130, 40), (129, 33)])]
# A canvas whose two bit copies take 400 x 16 x 8 = 51,200 bytes.
BIG_CANVAS = (400, 500, [(400, 500), (399, 481)])


def _canvas(height, width, extents, seed, padding=False):
    """Boards of ``extents`` in a (B, height, width) canvas: soup, dying
    and still boards in turn; with ``padding``, 0/1 noise past each extent
    (the first generation's differs flag must see it)."""
    rng = np.random.default_rng(seed)
    canvas = np.zeros((len(extents), height, width), np.uint8)
    if padding:
        canvas[:] = rng.integers(0, 2, canvas.shape, dtype=np.uint8)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = _cells(h, w, rng, KINDS[b % 3])
    return (torch.from_numpy(canvas),
            torch.tensor([h for h, _ in extents], dtype=torch.int32),
            torch.tensor([w for _, w in extents], dtype=torch.int32))


def _masked_block_launch(lib, cells, heights, widths, steps, t, device=0):
    batch, height, width = cells.shape
    out = torch.full_like(cells, 7)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32)
    rc = lib.gol_batch_masked_block(
        cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), t, batch, height, width, device,
        None)
    return rc, out, flags


@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("height,width,extents", MASKED_BLOCK,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_masked_block_matches_plain(lib, height, width, extents, t):
    cells, heights, widths = _canvas(height, width, extents, height * 13 + width + t)
    steps = _block_steps(len(extents), t)
    kept = cells.clone()
    rc, out, flags = _masked_block_launch(lib, cells, heights, widths, steps, t)
    assert rc == 0
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(cells, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("t", [1, 3])
def test_masked_block_off_16_byte_boundaries_with_padding(lib, t):
    """Slots of 33 x 20 bytes start off 16-byte boundaries (the first board
    of a view one slot in, the output a view of another offset, so a spent
    board's copy cannot pair its loads and stores); 0/1 noise in the
    padding counts as differing in the first generation only (the still
    block at 30x17 differs there and nowhere else), and a spent board
    keeps it."""
    extents = [(33, 20), (30, 17), (1, 20), (33, 1)]
    cells, heights, widths = _canvas(33, 20, [(33, 20)] + extents, 91, padding=True)
    cells, heights, widths = cells[1:], heights[1:], widths[1:]
    steps = torch.tensor([t, t, 0, 1], dtype=torch.int32)
    backing = torch.full((5 * 33 * 20 + 3,), 7, dtype=torch.uint8)
    out = backing[3:3 + 4 * 33 * 20].view(4, 33, 20)
    flags = torch.zeros((t, 4, 2), dtype=torch.int32)
    assert lib.gol_batch_masked_block(
        cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), t, 4, 33, 20, 0, None) == 0
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert flags[:, 1].tolist() == [[1, 1]] + [[1, 0]] * (t - 1)  # the block
    assert torch.equal(out[2], cells[2])  # spent: copied, padding and all
    assert lib.emu_misaligned() == 0


def test_masked_block_past_48_kib_of_shared_memory(lib):
    cells, heights, widths = _canvas(*BIG_CANVAS, seed=8)
    steps = torch.tensor([2, 1], dtype=torch.int32)
    rc, out, flags = _masked_block_launch(lib, cells, heights, widths, steps, 2)
    assert rc == 0
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, 2)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


def test_masked_block_refused_past_the_opt_in_runs_streamed(lib):
    """A canvas whose two bit copies pass the opt-in is refused, not run;
    the one-generation launch runs its block instead, one launch a
    generation, as ``batch_masked_step_into`` does on the card."""
    lib.emu_shared_optin(1, 4096)
    most = lib.gol_batch_block_max_words(1)
    height, width = 40, 400  # 40 rows x 13 words > most
    assert height * -(-width // 32) > most
    cells, heights, widths = _canvas(height, width, [(40, 400), (37, 390)], seed=9)
    steps = torch.tensor([3, 1], dtype=torch.int32)
    rc, out, _ = _masked_block_launch(lib, cells, heights, widths, steps, 3, device=1)
    assert rc != 0
    assert bool((out == 7).all())

    out, scratch = torch.full_like(cells, 7), torch.full_like(cells, 7)
    flags = torch.zeros((3, 2, 2), dtype=torch.int32)

    def step(src, dst, gen, n):
        assert _masked_step(lib, src, dst, flags[gen], steps, heights, widths,
                            gen, device=1) == 0

    sb.streamed_block(cells, out, 3, scratch, step)
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, 3)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


# The banded forms: a block of t generations in ceil(t / t') launches, each
# board in bands of R rows, a band and its t' ghost rows each side in one
# CTA's shared memory. Launched at explicit band rows R (1, 3 and the
# board's height: one band) over the block forms' shapes, so one-row and
# one-word boards, and boards shorter than a band and its ghost rows (their
# rows repeat), run through them too.
BAND_ROWS = [1, 3, None]  # None: one band of the whole board


def _plan(lib, batch, height, nwb, t, device=0):
    plan = (ctypes.c_int * 3)()
    assert lib.gol_batch_band_plan(device, batch, height, nwb, t, plan) == 0
    return plan[0], plan[1], plan[2]


def _band_block(lib, src, t, per, launch, junk):
    """A block of ``t`` generations of ``src`` through ``launch(cur, dst,
    flags, g0, n)`` (a banded entry's return code), ``per`` generations a
    launch, ping-ponging a scratch stack and the output as the wrappers do
    (``stencil_batch.streamed_block``)."""
    out, scratch = torch.full_like(src, junk), torch.full_like(src, junk)
    flags = torch.zeros((t, src.shape[0], 2), dtype=torch.int32)
    launches = []

    def step(cur, dst, g0, n):
        assert launch(cur, dst, flags, g0, n) == 0
        launches.append((g0, n))

    sb.streamed_block(src, out, t, scratch, step, per)
    assert len(launches) == -(-t // per)
    return out, flags


def _packed_band(lib, words, steps, t, per, rows, device=0):
    batch, height, nwords = words.shape
    return _band_block(lib, words, t, per, lambda cur, dst, flags, g0, n: (
        lib.gol_batch_packed_band(
            cur.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            g0, n, batch, height, nwords, rows, device, None)), -1)


def _masked_band(lib, cells, heights, widths, steps, t, per, rows, device=0):
    batch, height, width = cells.shape
    return _band_block(lib, cells, t, per, lambda cur, dst, flags, g0, n: (
        lib.gol_batch_masked_band(
            cur.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), g0, n, batch, height, width,
            rows, device, None)), 7)


@pytest.mark.parametrize("rows", BAND_ROWS, ids=["R1", "R3", "Rall"])
@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("batch,height,nwords", PACKED)
def test_packed_band_matches_plain(lib, batch, height, nwords, t, rows):
    words = _packed_boards(batch, height, nwords, batch * 17 + height + nwords + t)
    steps = _block_steps(batch, t)
    kept = words.clone()
    out, flags = _packed_band(lib, words, steps, t, t, rows or height)
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(words, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("rows", BAND_ROWS, ids=["R1", "R3", "Rall"])
@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("height,width,extents",
                         [c for c in MASKED_BLOCK if c[0] != 256],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_masked_band_matches_plain(lib, height, width, extents, t, rows):
    """Mixed extents in one canvas (rows at and past a board's height are
    its padding, whole bands of them too), the exact-fit byte mode, 1x1
    and one-row boards shorter than a band and its ghost rows, 0/1 noise
    in the padding (differs in the first generation only)."""
    cells, heights, widths = _canvas(height, width, extents, height + width + t,
                                     padding=True)
    steps = _block_steps(len(extents), t)
    kept = cells.clone()
    out, flags = _masked_band(lib, cells, heights, widths, steps, t, t,
                              rows or height)
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(cells, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("per", [1, 5, 17])
def test_band_block_in_several_launches_through_scratch(lib, per):
    """t' < t: a block of 18 generations in ceil(18 / t') launches, each of
    t' generations (the last fewer), ping-ponging a scratch stack; boards
    whose steps run out inside a launch or before it (copied through)."""
    words = _packed_boards(4, 40, 9, seed=per)
    steps = torch.tensor([18, 7, 0, 11], dtype=torch.int32)
    out, flags = _packed_band(lib, words, steps, 18, per, 6)
    want, want_flags = sb._batch_packed_block_plain(words, steps, 18)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)
    cells, heights, widths = _canvas(130, 40, [(130, 40), (129, 33), (5, 40), (130, 1)],
                                     seed=per, padding=True)
    out, flags = _masked_band(lib, cells, heights, widths, steps, 18, per, 7)
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, 18)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


@pytest.mark.parametrize("t", [1, 3])
def test_masked_band_off_16_byte_boundaries_with_padding(lib, t):
    """As the block form's case: slots of 33 x 20 bytes off 16-byte
    boundaries, the output at another offset, padding noise, a spent board
    keeping its padding; in bands of 4 rows, so bands end mid-slot."""
    extents = [(33, 20), (30, 17), (1, 20), (33, 1)]
    cells, heights, widths = _canvas(33, 20, [(33, 20)] + extents, 93, padding=True)
    cells, heights, widths = cells[1:], heights[1:], widths[1:]
    steps = torch.tensor([t, t, 0, 1], dtype=torch.int32)
    backing = torch.full((5 * 33 * 20 + 3,), 7, dtype=torch.uint8)
    out = backing[3:3 + 4 * 33 * 20].view(4, 33, 20)
    flags = torch.zeros((t, 4, 2), dtype=torch.int32)
    assert lib.gol_batch_masked_band(
        cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), 0, t, 4, 33, 20, 4, 0, None) == 0
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert flags[:, 1].tolist() == [[1, 1]] + [[1, 0]] * (t - 1)  # the block
    assert torch.equal(out[2], cells[2])  # spent: copied, padding and all
    assert lib.emu_misaligned() == 0


def test_band_plan_follows_the_rule(lib):
    """Whole-row bands where t' = min(t, max(1, rows / 4)) of the rows a
    copy may hold is t, as before: bands a board the most of the fewest
    that fit and min(SMs / batch, height / t'). Else the column cut: t' =
    min(t, 32), tiles of the board's whole height or of bands of about
    sqrt(t' x most) - 2 t' rows, as wide as two copies allow, narrowed to
    fill the whole waves they take. On an H100 (29,024 words a copy, 132
    SMs): the smoke's timing shapes and 4e's pairs in one launch of 16
    generations; rows past 453 words (past 9,674, where no whole-row band
    fits) cut into tiles that run the whole block."""
    assert _plan(lib, 64, 1024, 32, 16) == (16, 512, 32)  # 2 bands: 128 CTAs
    assert _plan(lib, 8, 1024, 32, 16) == (16, 64, 32)  # 16 bands: 128 CTAs
    assert _plan(lib, 2, 1024, 32, 16) == (16, 16, 32)  # a band owns >= t' rows
    assert _plan(lib, 1, 1024, 32, 18) == (18, 18, 32)
    assert _plan(lib, 64, 300, 400, 16) == (16, 38, 400)  # 72 rows a copy: 8 bands fit
    assert _plan(lib, 1, 4, 9674, 1) == (1, 1, 9674)  # whole rows at t = 1
    # Past 9,674 words a row (before: no plan, a launch a generation) and
    # past 453 (before: t' < 16), tiles of the whole height or of bands:
    assert _plan(lib, 1, 4, 9674, 16) == (16, 4, 74)  # 131 tiles
    assert _plan(lib, 1, 4, 9675, 16) == (16, 4, 74)
    assert _plan(lib, 16, 32, 9675, 16) == (16, 32, 605)  # 256 CTAs: 2 waves
    assert _plan(lib, 2, 16384, 512, 16) == (16, 631, 35)  # before: t' = 14
    assert _plan(lib, 1, 4, 9675, 40)[0] == 32  # one ghost word: t' <= 32
    lib.emu_shared_optin(1, 4096)  # 480 words a copy
    assert _plan(lib, 3, 40, 13, 16, device=1) == (16, 40, 7)  # before: (9, 8)
    assert _plan(lib, 3, 40, 13, 2, device=1) == (2, 2, 13)


@pytest.mark.parametrize("device", [0, 1], ids=["h100", "optin_480_words"])
def test_band_plan_runs_every_block_of_up_to_32_in_one_launch(lib, device):
    """t' = t for t <= 32 at every width and height, and the tile with its
    ghost rows (and, cut, its ghost words) fits in a copy."""
    lib.emu_shared_optin(1, 4096)
    most = lib.gol_batch_block_max_words(device)
    for nwb in (1, 7, 8, 60, 453, 454, 2048, 9674, 9675, 50000):
        for height in (1, 3, 32, 1024, 16384):
            for batch in (1, 16, 64):
                for t in (1, 2, 16, 18, 32):
                    per, rows, cols = _plan(lib, batch, height, nwb, t, device)
                    assert per == t and 1 <= rows <= height and 1 <= cols <= nwb
                    assert cols == nwb or nwb > 1
                    copy = ((rows + 2 * t) * nwb if cols == nwb else
                            (height if rows >= height else rows + 2 * t) * (cols + 2))
                    assert copy <= most, (nwb, height, batch, t, rows, cols)


def test_band_launch_refuses_what_does_not_fit(lib):
    """A band and its 2 tb ghost rows past the opt-in are refused, not run."""
    lib.emu_shared_optin(1, 4096)  # 480 words a copy: 36 rows of 13 words
    words = _packed_boards(1, 40, 13, seed=3)
    out = torch.full_like(words, -1)
    flags = torch.zeros((16, 1, 2), dtype=torch.int32)
    steps = torch.ones(1, dtype=torch.int32)
    for rows, tb in ((19, 9), (35, 1), (1, 18)):
        assert lib.gol_batch_packed_band(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            0, tb, 1, 40, 13, rows, 1, None) != 0
    assert bool((out == -1).all())
    assert lib.gol_batch_packed_band(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        0, 9, 1, 40, 13, 18, 1, None) == 0


@pytest.mark.parametrize("t", [2, 16, 18])
def test_block_call_past_the_block_form_takes_the_plan(lib, t):
    """What the wrappers do past the block form, at a shrunk opt-in (4096
    bytes: 480 words a copy): the plan's (t', R, C), ceil(t / t') launches
    of the banded form where C is the whole row, else of the column-cut
    form, equal to the plain versions; B1 at 40 x 13 words (whole-row
    bands at t = 2; t = 16 and 18 cut into tiles of the whole height, one
    launch), B2 on a 40 x 400 canvas (13 words a row) of mixed extents with
    padding noise."""
    lib.emu_shared_optin(1, 4096)
    most = lib.gol_batch_block_max_words(1)
    words = _packed_boards(3, 40, 13, seed=t)
    assert 40 * 13 > most
    per, rows, cols = _plan(lib, 3, 40, 13, t, device=1)
    assert per == t and (cols == 13) == (t == 2)
    steps = _block_steps(3, t)
    if cols == 13:
        out, flags = _packed_band(lib, words, steps, t, per, rows, device=1)
    else:
        out, flags = _packed_wide(lib, words, steps, t, per, rows, cols, device=1)
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)
    cells, heights, widths = _canvas(40, 400, [(40, 400), (37, 390), (3, 100)],
                                     seed=t, padding=True)
    steps = _block_steps(3, t)
    if cols == 13:
        out, flags = _masked_band(lib, cells, heights, widths, steps, t, per, rows,
                                  device=1)
    else:
        out, flags = _masked_wide(lib, cells, heights, widths, steps, t, per, rows,
                                  cols, device=1)
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


# The column-cut forms: a block of t generations in one launch, each board
# in tiles of R rows x C words with one ghost word each side (and t ghost
# rows each side, or none where a tile holds the whole height), at
# explicit tiles: R in BAND_ROWS, C 1, 3 and the whole row. B1 at 40 x 13
# words (before this form: t' = 9 at the shrunk opt-in), a board of 3 rows
# (shorter than its ghost rows: they repeat) and one of one row; B2 on a
# 40 x 400 canvas of mixed extents with padding noise, one board narrower
# than a tile of 3 words (its positions repeat its columns).
WIDE_PACKED = [(3, 40, 13), (2, 3, 200), (2, 1, 61)]
WIDE_COLS = [1, 3, None]  # None: the whole row
WIDE_MASKED = (40, 400, [(40, 400), (37, 390), (3, 100), (1, 33)])


def _packed_wide(lib, words, steps, t, per, rows, cols, device=0):
    batch, height, nwords = words.shape
    return _band_block(lib, words, t, per, lambda cur, dst, flags, g0, n: (
        lib.gol_batch_packed_wide(
            cur.data_ptr(), dst.data_ptr(), flags[g0].data_ptr(), steps.data_ptr(),
            g0, n, batch, height, nwords, rows, cols, device, None)), -1)


def _masked_wide(lib, cells, heights, widths, steps, t, per, rows, cols, device=0):
    batch, height, width = cells.shape
    return _band_block(lib, cells, t, per, lambda cur, dst, flags, g0, n: (
        lib.gol_batch_masked_wide(
            cur.data_ptr(), dst.data_ptr(), flags[g0].data_ptr(), steps.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), g0, n, batch, height, width,
            rows, cols, device, None)), 7)


@pytest.mark.parametrize("cols", WIDE_COLS, ids=["C1", "C3", "Call"])
@pytest.mark.parametrize("rows", BAND_ROWS, ids=["R1", "R3", "Rall"])
@pytest.mark.parametrize("t", BLOCK_TS)
@pytest.mark.parametrize("batch,height,nwords", WIDE_PACKED)
def test_packed_wide_matches_plain(lib, batch, height, nwords, t, rows, cols):
    words = _packed_boards(batch, height, nwords, batch * 19 + height + nwords + t)
    steps = _block_steps(batch, t)
    kept = words.clone()
    out, flags = _packed_wide(lib, words, steps, t, t, rows or height, cols or nwords)
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(words, kept)


@pytest.mark.parametrize("cols", WIDE_COLS, ids=["C1", "C3", "Call"])
@pytest.mark.parametrize("rows", BAND_ROWS, ids=["R1", "R3", "Rall"])
@pytest.mark.parametrize("t", BLOCK_TS)
def test_masked_wide_matches_plain(lib, t, rows, cols):
    """Tiles of padding alone (rows past a board, words past it), tiles
    that end inside a board's last word, 0/1 noise in the padding
    (differs in the first generation only)."""
    height, width, extents = WIDE_MASKED
    cells, heights, widths = _canvas(height, width, extents, width + t, padding=True)
    steps = _block_steps(len(extents), t)
    kept = cells.clone()
    out, flags = _masked_wide(lib, cells, heights, widths, steps, t, t,
                              rows or height, cols or -(-width // 32))
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(cells, kept)
    assert lib.emu_misaligned() == 0, "a 16-byte load off a 16-byte boundary"


@pytest.mark.parametrize("t", [1, 3])
def test_masked_wide_off_16_byte_boundaries_with_padding(lib, t):
    """As the block form's case, on slots of 33 x 70 bytes (3 words a bit
    row) off 16-byte boundaries, the output at another offset (a spent
    board's tiles copy byte by byte), padding noise, a spent board keeping
    its padding; in tiles of 4 rows x 1 word."""
    extents = [(33, 70), (30, 67), (1, 70), (33, 1)]
    cells, heights, widths = _canvas(33, 70, [(33, 70)] + extents, 95, padding=True)
    cells, heights, widths = cells[1:], heights[1:], widths[1:]
    steps = torch.tensor([t, t, 0, 1], dtype=torch.int32)
    backing = torch.full((5 * 33 * 70 + 3,), 7, dtype=torch.uint8)
    out = backing[3:3 + 4 * 33 * 70].view(4, 33, 70)
    flags = torch.zeros((t, 4, 2), dtype=torch.int32)
    assert lib.gol_batch_masked_wide(
        cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), 0, t, 4, 33, 70, 4, 1, 0, None) == 0
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert flags[:, 1].tolist() == [[1, 1]] + [[1, 0]] * (t - 1)  # the block
    assert torch.equal(out[2], cells[2])  # spent: copied, padding and all
    assert lib.emu_misaligned() == 0


def test_wide_launch_refuses_what_does_not_fit(lib):
    """A tile past the opt-in with its ghost rows and words, more than 32
    generations a launch, or wider than the row, is refused, not run."""
    lib.emu_shared_optin(1, 4096)  # 480 words a copy
    words = _packed_boards(1, 40, 13, seed=4)
    out = torch.full_like(words, -1)
    flags = torch.zeros((40, 1, 2), dtype=torch.int32)
    steps = torch.ones(1, dtype=torch.int32)
    for rows, cols, tb, device in ((37, 11, 1, 1), (39, 11, 16, 1), (1, 14, 1, 0),
                                   (4, 4, 33, 0), (0, 4, 1, 0)):
        assert lib.gol_batch_packed_wide(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            0, tb, 1, 40, 13, rows, cols, device, None) != 0
    assert bool((out == -1).all())
    for rows, cols, tb in ((40, 10, 16), (38, 1, 1), (16, 3, 16)):
        assert lib.gol_batch_packed_wide(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            0, tb, 1, 40, 13, rows, cols, 1, None) == 0


def _jax_block(evolve, state, steps, t):
    """JAX's step applied generation by generation, board b for min(steps[b],
    t) of them: ``(final, flags)`` as the block forms store them."""
    cur = state
    flags = np.zeros((t, state.shape[0], 2), np.int32)
    for i in range(t):
        new = np.asarray(evolve(cur))
        running = np.array([i < min(n, t) for n in steps])
        flags[i, :, 0] = running & new.reshape(len(steps), -1).any(axis=1)
        flags[i, :, 1] = running & (new != cur).reshape(len(steps), -1).any(axis=1)
        cur = np.where(running[:, None, None], new, cur)
    return cur, flags


@pytest.mark.parametrize("t", BLOCK_TS)
def test_wide_block_matches_jax(lib, t):
    """The emulated column-cut forms over a block of t generations, the
    port's plain versions and the JAX package's steps
    (``vmap(packed_math.evolve_torus_words)``, ``_evolve_batch_masked``),
    on the same numpy-seeded boards: B1 at 40 x 13 words, B2 on a 40 x 400
    canvas of mixed extents with padding noise, in tiles of 7 rows x 3
    words, steps t/1/0/t+2."""
    words = _packed_boards(4, 40, 13, seed=70 + t)
    steps = _block_steps(4, t)
    got, got_flags = _packed_wide(lib, words, steps, t, t, 7, 3)
    want, want_flags = _jax_block(jax.vmap(jax_pm.evolve_torus_words),
                                  pm.words_to_numpy(words), steps.tolist(), t)
    np.testing.assert_array_equal(pm.words_to_numpy(got), want)
    np.testing.assert_array_equal(got_flags.numpy(), want_flags)
    plain, plain_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(got, plain) and torch.equal(got_flags, plain_flags)

    height, width, extents = WIDE_MASKED
    cells, heights, widths = _canvas(height, width, extents, 80 + t, padding=True)
    steps = _block_steps(len(extents), t)
    got, got_flags = _masked_wide(lib, cells, heights, widths, steps, t, t, 7, 3)
    want, want_flags = _jax_block(
        lambda cur: jax_engine._evolve_batch_masked(cur, heights.numpy(), widths.numpy()),
        cells.numpy(), steps.tolist(), t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_flags.numpy(), want_flags)


# Kernels the card would hang on or read garbage in, and one it runs: the
# emulation must abort on each of the first three with its message.
STRICT_KERNELS = r"""
#include <cstdlib>
#include <cuda_runtime.h>

__global__ void divergent_barrier(int* out) {
  if (threadIdx.x == 5) return;
  __syncthreads();
  out[threadIdx.x] = 1;
}

__global__ void returned_lane(int* out) {
  if (threadIdx.x == 7) return;
  out[threadIdx.x] = __reduce_or_sync(0xffffffffu, threadIdx.x);
}

__global__ void lane_at_barrier(int* out) {
  if (threadIdx.x < 16) {
    __syncthreads();
  } else {
    out[threadIdx.x] = __reduce_or_sync(0xffffffffu, 1u);
    __syncthreads();
  }
}

__global__ void whole_block(int* out) {
  out[threadIdx.x] = __reduce_or_sync(0xffffffffu, threadIdx.x);
  __syncthreads();
  if (threadIdx.x >= 32) return;  // a whole warp, after the last barrier
  out[threadIdx.x] += 1;
}

int main(int argc, char** argv) {
  int out[64] = {};
  switch (std::atoi(argv[1])) {
    case 0: divergent_barrier<<<1, 32>>>(out); break;
    case 1: returned_lane<<<1, 64>>>(out); break;
    case 2: lane_at_barrier<<<1, 32>>>(out); break;
    default: whole_block<<<1, 64>>>(out); break;
  }
  return out[0] == 32 ? 0 : 3;
}
"""


@pytest.fixture(scope="module")
def strict_exe(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or platform.machine() != "x86_64":
        pytest.skip("needs a host C++ compiler on x86-64 (the lanes' stack switch)")
    work = tmp_path_factory.mktemp("strict_emulation")
    src = work / "strict.cpp"
    src.write_text(emulated_source(STRICT_KERNELS))
    exe = work / "strict"
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", str(EMULATION), "-o",
                    str(exe), str(src)], check=True, capture_output=True, text=True)
    return exe


@pytest.mark.parametrize("case,message", [
    (0, "returned while other lanes of its block wait at __syncthreads() "
        "(a divergent barrier)"),
    (1, "returned before a full-mask warp intrinsic that the rest of its "
        "warp runs"),
    (2, "waits at __syncthreads() while the rest of its warp runs a "
        "full-mask warp intrinsic"),
    (3, None),
], ids=["divergent_barrier", "returned_lane", "lane_at_barrier", "whole_block"])
def test_emulation_aborts_where_the_card_would_hang(strict_exe, case, message):
    proc = subprocess.run([str(strict_exe), str(case)], capture_output=True,
                          text=True, timeout=60)
    if message is None:
        assert proc.returncode == 0, proc.stderr
        assert proc.stderr == ""
    else:
        assert proc.returncode != 0
        assert f"cuda emulation: block 0, lane {(5, 7, 0)[case]}: {message}" \
            in proc.stderr
