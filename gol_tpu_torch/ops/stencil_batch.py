"""Batched steps with per-board flags: B1 and B2, the batch lane's kernels.

The batch lane (``engine.make_batch_runner``) runs B independent boards in
one canvas. The JAX package steps the batch with ``jnp`` under ``vmap``
(``gol_tpu/engine.py`` ``_batch_evolve``, ``_evolve_batch_masked``) inside
one ``lax.while_loop``, with no Pallas kernel on the path. The port's loop
runs on the host and reads back one flag tensor per block of generations,
so each board's flags come out of the step's own pass, from the kernels in
``csrc/stencil_batch.cu``:

- ``batch_packed_block_into`` (B1): a whole block of generations of B
  exact-fit tori of words, (B, height, nwords) int32 (bit j of word w =
  column 32*w + j, as ``packed_math``), board b for ``min(steps[b], t)``
  generations, writing generation i's pair of board b to ``flags[i, b]``
  of a caller-zeroed (t, B, 2) buffer. Three forms, chosen by shape: the
  block form, one launch with each board in one CTA's shared memory
  (``LAUNCHES["batch_packed_block"]``), for boards whose two copies fit
  there (``block_max_words``); past it the banded form
  (``LAUNCHES["batch_packed_band"]``), each board in bands of R whole rows,
  a band and t' ghost rows each side in one CTA's shared memory, where
  such bands run the whole block (on an H100 rows of up to 453 words,
  14,496 cells, at t = 16); and for wider rows the column-cut form
  (``batch_packed_wide_into``, ``LAUNCHES["batch_packed_wide"]``), tiles
  of R rows x C words with one ghost word each side, up to 32 generations
  a launch at any width. ``band_plan`` gives (t', R, C): ceil(t / t')
  launches, one for the engine's block of 16;
- ``batch_masked_block_into`` (B2): the same block of generations over B
  uint8 boards in one (B, height, width) canvas, board b wrapping at its
  own extent ``(heights[b], widths[b])``, every cell at or past it written
  0 (the semantics of ``_evolve_batch_masked``); the exact-fit byte mode
  runs through it with the canvas's extent. Its forms hold the slot's
  cells as bits (height x ceil(width / 32) words a copy), which is exact
  for the lane's cells, 0 or 1 as every decoder feeding it gives them:
  the block form (``LAUNCHES["batch_masked_block"]``), the banded form
  (``LAUNCHES["batch_masked_band"]``, bands of the canvas's rows, ghost
  rows modulo each board's own height) past ``block_max_words``, and the
  column-cut form (``batch_masked_wide_into``,
  ``LAUNCHES["batch_masked_wide"]``) past that;
- ``batch_packed_step_into`` and ``batch_masked_step_into``: one
  generation, the column-cut form at one generation a launch, ORing board
  b's ``(alive, differs)`` into ``flags[b]`` of a caller-zeroed (B, 2)
  int32 buffer; a board whose steps are spent at the launch's generation
  ``gen`` (``gen >= steps[b]``) is copied through and writes no flag.

Flags store "similar" negated, as in ``stencil_packed``; B2's pair covers
the board's whole slot, padding included. On a CUDA tensor each wrapper
launches its kernel, or raises; on a CPU tensor it runs its plain torch
version (``_batch_packed_block_plain`` and ``_batch_packed_plain``, loops
of ``packed_math.evolve_torus_words`` over the boards;
``_batch_masked_plain``, the gather form of the masked rule, and
``_batch_masked_block_plain``, it once per generation); any other device
raises. ``LAUNCHES`` counts the kernel launches, one per launch on the
card and nothing for the CPU path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gol_tpu_torch.ops import _build, packed_math

STEP_FLAGS = 2  # (alive, differs) per board
LAUNCHES = {"batch_packed_block": 0, "batch_packed_band": 0, "batch_packed_wide": 0,
            "batch_masked_block": 0, "batch_masked_band": 0, "batch_masked_wide": 0}


# ---------------------------------------------------------------------------
# Plain torch versions: the CPU path, and what the kernels are held against.


def _board_flags(new: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    return torch.stack([(new != 0).any(), (new != cur).any()]).to(torch.int32)


def _batch_packed_plain(words: torch.Tensor, steps: torch.Tensor, gen: int):
    """B1's plain version: ``(new, flags)`` with flags (B, 2)."""
    new = words.clone()
    flags = torch.zeros((words.shape[0], STEP_FLAGS), dtype=torch.int32,
                        device=words.device)
    for b, n in enumerate(steps.tolist()):
        if gen < n:
            new[b] = packed_math.evolve_torus_words(words[b])
            flags[b] = _board_flags(new[b], words[b])
    return new, flags


def _batch_packed_block_plain(words: torch.Tensor, steps: torch.Tensor, t: int):
    """B1's block form's plain version: ``(final, flags)`` with flags (t, B,
    2), row i of board b set for i < min(steps[b], t) and 0 past it."""
    final = words.clone()
    flags = torch.zeros((t, words.shape[0], STEP_FLAGS), dtype=torch.int32,
                        device=words.device)
    for b, n in enumerate(steps.tolist()):
        cur = words[b]
        for i in range(min(n, t)):
            new = packed_math.evolve_torus_words(cur)
            flags[i, b] = _board_flags(new, cur)
            cur = new
        final[b] = cur
    return final, flags


def _batch_masked_block_plain(cells: torch.Tensor, steps: torch.Tensor,
                              heights: torch.Tensor, widths: torch.Tensor, t: int):
    """B2's block form's plain version: ``(final, flags)`` with flags (t,
    B, 2), row i of board b set for i < min(steps[b], t) and 0 past it;
    ``_batch_masked_plain`` once per generation."""
    final = torch.empty_like(cells)
    flags = torch.zeros((t, cells.shape[0], STEP_FLAGS), dtype=torch.int32,
                        device=cells.device)
    streamed_block(cells, final, t, None, lambda cur, dst, g0, n: _masked_plain_into(
        cur, dst, flags[g0], steps, heights, widths, g0))
    return final, flags


def _masked_plain_into(cells, out, flags, steps, heights, widths, gen: int) -> None:
    new, step_flags = _batch_masked_plain(cells, steps, heights, widths, gen)
    out.copy_(new)
    flags |= step_flags


def _evolve_masked_board(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One generation of the (h, w) torus at ``g[:h, :w]`` of a padded
    canvas slot, cells past the extent 0: JAX's per-board gathers, each
    index taken modulo the board's own extent."""
    ph, pw = g.shape
    r = torch.arange(ph, device=g.device)
    c = torch.arange(pw, device=g.device)
    up = g.index_select(0, torch.remainder(r - 1, h))
    down = g.index_select(0, torch.remainder(r + 1, h))
    rows3 = up + g + down  # vertical triple sum, <= 3 fits uint8
    west = rows3.index_select(1, torch.remainder(c - 1, w))
    east = rows3.index_select(1, torch.remainder(c + 1, w))
    n = west + rows3 + east - g  # 3x3 block sum minus the centre
    new = (n == 3) | ((n == 2) & (g == 1))
    mask = (r[:, None] < h) & (c[None, :] < w)
    return (new & mask).to(torch.uint8)


def _batch_masked_plain(cells: torch.Tensor, steps: torch.Tensor,
                        heights: torch.Tensor, widths: torch.Tensor, gen: int):
    """B2's plain version: ``(new, flags)`` with flags (B, 2)."""
    new = cells.clone()
    flags = torch.zeros((cells.shape[0], STEP_FLAGS), dtype=torch.int32,
                        device=cells.device)
    for b, (n, h, w) in enumerate(zip(steps.tolist(), heights.tolist(),
                                      widths.tolist())):
        if gen < n:
            new[b] = _evolve_masked_board(cells[b], h, w)
            flags[b] = _board_flags(new[b], cells[b])
    return new, flags


# ---------------------------------------------------------------------------
# The kernels.


def _lib() -> ctypes.CDLL:
    return _build.load("stencil_batch", _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_batch_packed_block.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.gol_batch_packed_block.restype = i32
    lib.gol_batch_block_max_words.argtypes = [i32]
    lib.gol_batch_block_max_words.restype = i32
    lib.gol_batch_masked_block.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.gol_batch_masked_block.restype = i32
    lib.gol_batch_packed_band.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.gol_batch_packed_band.restype = i32
    lib.gol_batch_masked_band.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.gol_batch_masked_band.restype = i32
    lib.gol_batch_packed_wide.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.gol_batch_packed_wide.restype = i32
    lib.gol_batch_masked_wide.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.gol_batch_masked_wide.restype = i32
    lib.gol_batch_band_plan.argtypes = [i32] * 5 + [ptr]
    lib.gol_batch_band_plan.restype = i32
    lib.gol_error_string.argtypes = [i32]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (at first use) and load the kernels ahead of a run."""
    _lib()


@functools.lru_cache(maxsize=None)
def block_max_words(device_index: int) -> int:
    """The most words a board may have for the block forms on card
    ``device_index``: two copies in one CTA's opt-in shared memory (for
    B2, the slot's bits: height x ceil(width / 32) words)."""
    most = _lib().gol_batch_block_max_words(device_index)
    if most < 0:
        msg = _lib().gol_error_string(-most).decode()
        raise RuntimeError(f"shared memory query failed: CUDA error {-most} ({msg})")
    return most


@functools.lru_cache(maxsize=None)
def band_plan(device_index: int, batch: int, height: int, nwb: int,
              t: int) -> tuple[int, int, int]:
    """The banded and column-cut forms' ``(t', R, C)`` on card
    ``device_index`` for a block of ``t`` generations of ``batch`` boards
    of ``height`` rows, ``nwb`` words a row as bits (B1: nwords; B2:
    ceil(width / 32)): ``t'`` generations a launch (never 0), tiles of
    ``R`` rows x ``C`` words; ``C == nwb`` is the banded form's whole rows,
    ``C < nwb`` the column-cut form (``gol_batch_band_plan`` says how they
    are chosen)."""
    plan = (ctypes.c_int * 3)()
    err = _lib().gol_batch_band_plan(device_index, batch, height, nwb, t, plan)
    if err != 0:
        msg = _lib().gol_error_string(err).decode()
        raise RuntimeError(f"band plan failed: CUDA error {err} ({msg})")
    return plan[0], plan[1], plan[2]


def step_tile(device_index: int, batch: int, height: int, nwb: int) -> tuple[int, int]:
    """The column-cut tile ``(R, C)`` of a one-generation launch on card
    ``device_index``: the plan's for t = 1 (``fit_step_tile``)."""
    return fit_step_tile(band_plan(device_index, batch, height, nwb, 1)[1:],
                         block_max_words(device_index))


def fit_step_tile(tile: tuple[int, int], most: int) -> tuple[int, int]:
    """A plan's ``(R, C)`` for t = 1, narrowed (and, for a board one word
    wide, shortened) so that the tile with a ghost row and a ghost word
    each side fits in ``most`` words a copy where the plan kept whole
    rows."""
    rows = min(tile[0], most // 3 - 2)
    return rows, min(tile[1], most // (rows + 2) - 2)


def _check(src: torch.Tensor, out: torch.Tensor, flags: torch.Tensor,
           steps: torch.Tensor, dtype: torch.dtype, extents=(),
           flag_rows: int | None = None) -> None:
    if src.dtype != dtype or src.dim() != 3:
        raise ValueError(f"boards must be a 3D {dtype} tensor, got "
                         f"{src.dim()}D {src.dtype}")
    batch, height, width = src.shape
    if batch < 1 or height < 1 or width < 1 or height * width >= 2**31:
        raise ValueError(f"unsupported board stack shape {tuple(src.shape)}")
    if out.shape != src.shape or out.dtype != dtype:
        raise ValueError(f"out must be {dtype} {tuple(src.shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    want = (batch, STEP_FLAGS) if flag_rows is None else (flag_rows, batch,
                                                          STEP_FLAGS)
    if flags.dtype != torch.int32 or tuple(flags.shape) != want:
        raise ValueError(f"flags must be int32 {want}, got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    vectors = [("steps", steps), *extents]
    for name, t in vectors:
        if t.dtype != torch.int32 or tuple(t.shape) != (batch,):
            raise ValueError(f"{name} must be int32 ({batch},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in [("src", src), ("out", out), ("flags", flags), *vectors]:
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, boards on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == src.data_ptr():
        raise ValueError("out must not alias the boards (threads read "
                         "their neighbours)")


def _launched(src: torch.Tensor, key: str, launch) -> bool:
    """Launch on the card (True), or leave a CPU tensor to the plain
    version (False); raises for any other device or a failed launch."""
    if src.device.type == "cpu":
        return False
    if src.device.type != "cuda":
        raise ValueError(f"no batch kernel for device {src.device}")
    err = launch(torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        msg = _lib().gol_error_string(err).decode()
        raise RuntimeError(f"{key} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[key] += 1
    return True


def streamed_block(src, out, t: int, scratch, step, per: int = 1) -> None:
    """A block of ``t`` generations as ceil(t / per) launches ``step(cur,
    dst, g0, n)`` of generations g0 .. g0 + n - 1, ping-ponging ``scratch``
    (a third stack, allocated when None and more than one launch runs) and
    ``out`` so that the last lands in ``out``; ``src`` is never written."""
    starts = range(0, t, per)
    if len(starts) > 1:
        scratch = _scratch(src, out, scratch)
    cur = src
    for k, g0 in enumerate(starts):
        dst = out if (len(starts) - k) % 2 else scratch
        step(cur, dst, g0, min(per, t - g0))
        cur = dst


def _scratch(src, out, scratch):
    """The multi-launch forms' third stack: ``scratch``, or a new one."""
    scratch = torch.empty_like(src) if scratch is None else scratch
    if scratch.data_ptr() in (src.data_ptr(), out.data_ptr()) or \
            scratch.shape != src.shape or scratch.dtype != src.dtype:
        raise ValueError("scratch must be a third stack of the boards' shape")
    return scratch


def _past_block(src, out, t: int, scratch, nwb: int, band, wide) -> None:
    """A block of boards past the block form on the card: ceil(t / t')
    launches (``band_plan``) through ``scratch`` and ``out``, of the banded
    form ``band(cur, dst, g0, n, rows)`` where the plan keeps whole rows,
    else of the column-cut form ``wide(cur, dst, g0, n, rows, cols)``."""
    batch, height = src.shape[:2]
    per, rows, cols = band_plan(src.device.index, batch, height, nwb, t)
    if cols == nwb:
        step = lambda cur, dst, g0, n: band(cur, dst, g0, n, rows)  # noqa: E731
    else:
        step = lambda cur, dst, g0, n: wide(cur, dst, g0, n, rows, cols)  # noqa: E731
    streamed_block(src, out, t, scratch, step, per)


def _run_plain(src, steps, g0: int, n: int, block_plain, *extents):
    """``block_plain`` over generations g0 .. g0 + n - 1: board b runs
    min(steps[b] - g0, n) of them."""
    return block_plain(src, (steps - g0).clamp(min=0), *extents, n)


def batch_packed_block_into(words, out, flags, steps, t: int,
                            scratch=None) -> None:
    """B1: board b of ``words`` (B, H, NW) for ``min(steps[b], t)``
    generations into ``out`` (a board with steps 0 copied), generation i's
    ``(alive, differs)`` of board b stored to ``flags[i, b]`` of a
    caller-zeroed (t, B, 2) buffer. One launch of the block form where a
    board's two copies fit in a CTA's shared memory, else ceil(t / t')
    launches of the banded or the column-cut form, through ``scratch`` (a
    third stack, allocated when None and needed) and ``out``; ``words`` is
    never written."""
    if t < 1:
        raise ValueError(f"a block runs t >= 1 generations, got {t}")
    _check(words, out, flags, steps, torch.int32, flag_rows=t)
    batch, height, nwords = words.shape
    dev = words.device.index
    if words.device.type == "cuda" and height * nwords > block_max_words(dev):
        _past_block(
            words, out, t, scratch, nwords,
            lambda cur, dst, g0, n, rows: _launched(
                cur, "batch_packed_band", lambda stream: _lib().gol_batch_packed_band(
                    cur.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(),
                    g0, n, batch, height, nwords, rows, dev, stream)),
            lambda cur, dst, g0, n, rows, cols: batch_packed_wide_into(
                cur, dst, flags[g0:g0 + n], steps, g0, n, rows, cols))
        return
    if _launched(words, "batch_packed_block", lambda stream: _lib().gol_batch_packed_block(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            t, batch, height, nwords, dev, stream)):
        return
    final, block_flags = _batch_packed_block_plain(words, steps, t)
    out.copy_(final)
    flags |= block_flags


def batch_packed_wide_into(words, out, flags, steps, g0: int, n: int, rows: int,
                           cols: int) -> None:
    """B1's column-cut form: generations g0 .. g0 + n - 1 of a block (n <=
    32) of each board of ``words`` (B, H, NW), board b running
    ``min(steps[b] - g0, n)`` of them (none: copied), into ``out``, in tiles
    of ``rows`` rows x ``cols`` words; generation g0 + i's ``(alive,
    differs)`` of board b ORed into ``flags[i, b]`` of an (n, B, 2)
    buffer (the block's flag rows from g0 on)."""
    _check(words, out, flags, steps, torch.int32, flag_rows=n)
    batch, height, nwords = words.shape
    if _launched(words, "batch_packed_wide", lambda stream: _lib().gol_batch_packed_wide(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            g0, n, batch, height, nwords, rows, cols, words.device.index, stream)):
        return
    final, block_flags = _run_plain(words, steps, g0, n, _batch_packed_block_plain)
    out.copy_(final)
    flags |= block_flags


def batch_packed_step_into(words, out, flags, steps, gen: int) -> None:
    """B1 at one generation: each board of ``words`` (B, H, NW) whose
    ``steps`` are not spent at ``gen`` into ``out`` (the others copied);
    ORs each running board's ``(alive, differs)`` into ``flags[b]``. On
    the card one launch of the column-cut form (``step_tile``)."""
    _check(words, out, flags, steps, torch.int32)
    batch, height, nwords = words.shape
    dev = words.device.index

    def launch(stream):
        rows, cols = step_tile(dev, batch, height, nwords)
        return _lib().gol_batch_packed_wide(
            words.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            gen, 1, batch, height, nwords, rows, cols, dev, stream)

    if _launched(words, "batch_packed_wide", launch):
        return
    new, step_flags = _batch_packed_plain(words, steps, gen)
    out.copy_(new)
    flags |= step_flags


def batch_masked_step_into(cells, out, flags, steps, heights, widths,
                           gen: int) -> None:
    """B2 at one generation: each board of ``cells`` (B, PH, PW) whose
    ``steps`` are not spent at ``gen``, each wrapping at its own
    ``(heights[b], widths[b])`` with the rest of its slot 0, into ``out``
    (the others copied); ORs each running board's ``(alive, differs)`` over
    its whole slot into ``flags[b]``. On the card one launch of the
    column-cut form (``step_tile``)."""
    _check(cells, out, flags, steps, torch.uint8,
           (("heights", heights), ("widths", widths)))
    batch, height, width = cells.shape
    dev = cells.device.index

    def launch(stream):
        rows, cols = step_tile(dev, batch, height, -(-width // 32))
        return _lib().gol_batch_masked_wide(
            cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), gen, 1, batch, height, width,
            rows, cols, dev, stream)

    if _launched(cells, "batch_masked_wide", launch):
        return
    _masked_plain_into(cells, out, flags, steps, heights, widths, gen)


def batch_masked_wide_into(cells, out, flags, steps, heights, widths, g0: int,
                           n: int, rows: int, cols: int) -> None:
    """B2's column-cut form: generations g0 .. g0 + n - 1 of a block (n <=
    32) of each board of ``cells`` (B, PH, PW) as ``batch_masked_block_into``
    runs them, in tiles of ``rows`` canvas rows x ``cols`` words of bits,
    flags as ``batch_packed_wide_into``'s."""
    _check(cells, out, flags, steps, torch.uint8,
           (("heights", heights), ("widths", widths)), flag_rows=n)
    batch, height, width = cells.shape
    if _launched(cells, "batch_masked_wide", lambda stream: _lib().gol_batch_masked_wide(
            cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), g0, n, batch, height, width,
            rows, cols, cells.device.index, stream)):
        return
    final, block_flags = _run_plain(cells, steps, g0, n, _batch_masked_block_plain,
                                    heights, widths)
    out.copy_(final)
    flags |= block_flags


def batch_masked_block_into(cells, out, flags, steps, heights, widths, t: int,
                            scratch=None) -> None:
    """B2: board b of ``cells`` (B, PH, PW) for ``min(steps[b], t)``
    generations, wrapping at its own ``(heights[b], widths[b])`` with the
    rest of its slot 0, into ``out`` (a board with steps 0 copied byte for
    byte); generation i's ``(alive, differs)`` of board b, over its whole
    slot, stored to ``flags[i, b]`` of a caller-zeroed (t, B, 2) buffer.
    One launch of the block form where the slot's two bit copies fit in a
    CTA's shared memory, else ceil(t / t') launches of the banded or the
    column-cut form, through ``scratch`` (a third stack, allocated when
    None and needed) and ``out``; ``cells`` is never written."""
    if t < 1:
        raise ValueError(f"a block runs t >= 1 generations, got {t}")
    _check(cells, out, flags, steps, torch.uint8,
           (("heights", heights), ("widths", widths)), flag_rows=t)
    batch, height, width = cells.shape
    dev = cells.device.index
    nwb = -(-width // 32)
    if cells.device.type == "cuda" and height * nwb > block_max_words(dev):
        _past_block(
            cells, out, t, scratch, nwb,
            lambda cur, dst, g0, n, rows: _launched(
                cur, "batch_masked_band", lambda stream: _lib().gol_batch_masked_band(
                    cur.data_ptr(), dst.data_ptr(), flags.data_ptr(), steps.data_ptr(),
                    heights.data_ptr(), widths.data_ptr(), g0, n, batch, height,
                    width, rows, dev, stream)),
            lambda cur, dst, g0, n, rows, cols: batch_masked_wide_into(
                cur, dst, flags[g0:g0 + n], steps, heights, widths, g0, n, rows, cols))
        return
    if _launched(cells, "batch_masked_block", lambda stream: _lib().gol_batch_masked_block(
            cells.data_ptr(), out.data_ptr(), flags.data_ptr(), steps.data_ptr(),
            heights.data_ptr(), widths.data_ptr(), t, batch, height, width,
            dev, stream)):
        return
    final, block_flags = _batch_masked_block_plain(cells, steps, heights, widths, t)
    out.copy_(final)
    flags |= block_flags
