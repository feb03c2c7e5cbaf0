"""The batched step kernels' CUDA source on the CPU, against their plain
torch versions.

``gol_tpu_torch/csrc/stencil_batch.cu`` (B1's block and streaming forms,
B2) is compiled with the host C++ compiler against
``tests/cuda_emulation/cuda_runtime.h`` (a launch runs each block's threads
as lanes on one host thread, switching at warp intrinsics and block
barriers, with the block's shared memory) and driven through its own C
entries. Each launch is held to ``stencil_batch``'s plain version at
tolerance 0, words or cells and per-board flags: mixed extents in one
canvas, spent step counts (a board copied through), one-word-wide and
one-row boards, and boards that die or stand still. B1's block form runs
whole blocks of t in {1, 2, 16, 18} generations with mixed step counts
(full, short, 0, past t), and its streaming form the same blocks one
launch a generation (``stencil_batch.streamed_block``). B2's block form
runs the same blocks at ``chip_smoke.py``'s phase-2 shapes (mixed extents
down to 1x1, the exact-fit byte mode, 64 boards of 250^2 in 256^2), on
slots that start off a 16-byte boundary and with non-zero padding, past 48
KiB of shared memory, and is refused past the opt-in, where B2's streaming
form runs the block. The emulation aborts on a divergent barrier or a
warp intrinsic that a lane misses, and two deliberately broken kernels show
that it does. The card runs the same source in ``tests/test_torch_cuda.py``
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
    lib.gol_batch_packed_step.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.gol_batch_masked_step.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.gol_batch_packed_block.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.gol_batch_masked_block.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.gol_batch_block_max_words.argtypes = [i]
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
    assert lib.gol_batch_packed_step(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        gen, batch, height, nwords, 0, None) == 0
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
    assert lib.gol_batch_masked_step(
        cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        heights.data_ptr(), widths.data_ptr(), gen, batch, height, width, 0,
        None) == 0
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
    assert lib.gol_batch_packed_step(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
        0, 2, 4, 1, 0, None) == 0
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
    """The streaming form over a whole block: one launch a generation,
    ping-ponging a scratch stack and the output."""
    words = _packed_boards(batch, height, nwords, batch * 31 + height + nwords)
    steps = _block_steps(batch, t)

    def step(src, dst, flags, st, gen):
        assert lib.gol_batch_packed_step(
            src.data_ptr(), dst.data_ptr(), flags.data_ptr(), st.data_ptr(),
            gen, batch, height, nwords, 0, None) == 0

    out, scratch = torch.full_like(words, -1), torch.full_like(words, -1)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32)
    sb.streamed_block(words, out, flags, steps, t, scratch, step)
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
    B2's streaming form runs its block instead, one launch a generation,
    as the wrapper does on the card."""
    lib.emu_shared_optin(1, 4096)
    most = lib.gol_batch_block_max_words(1)
    height, width = 40, 400  # 40 rows x 13 words > most
    assert height * -(-width // 32) > most
    cells, heights, widths = _canvas(height, width, [(40, 400), (37, 390)], seed=9)
    steps = torch.tensor([3, 1], dtype=torch.int32)
    rc, out, _ = _masked_block_launch(lib, cells, heights, widths, steps, 3, device=1)
    assert rc != 0
    assert bool((out == 7).all())

    def step(src, dst, f, st, gen):
        assert lib.gol_batch_masked_step(
            src.data_ptr(), dst.data_ptr(), f.data_ptr(), st.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), gen, 2, height, width, 1,
            None) == 0

    out, scratch = torch.full_like(cells, 7), torch.full_like(cells, 7)
    flags = torch.zeros((3, 2, 2), dtype=torch.int32)
    sb.streamed_block(cells, out, flags, steps, 3, scratch, step)
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, 3)
    assert torch.equal(out, want) and torch.equal(flags, want_flags)


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
