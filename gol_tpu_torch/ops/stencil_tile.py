"""The batched halo tile step with per-tile flags: T1, the sparse and macro
lanes' kernel.

The sparse engine steps a giant universe's active tiles, each assembled on
the host with its 1-cell halo ring, and the macro engine advances its leaf
windows the same way. The JAX package runs that step with ``jnp`` under
``vmap`` (``stencil_lax.evolve_padded_batch`` jitted by
``engine.make_tile_step_runner``, gol_tpu/engine.py:1834), with no Pallas
kernel on the path. The port's host loop needs each tile's flags out of the
step's own pass, so the step is one kernel in ``csrc/stencil_tile.cu``:

- ``tile_step_into`` (T1): ``n >= 1`` generations of B uint8 blocks ``(B,
  t+2, t+2)``, interior cells reading only in-block neighbours and the
  block's ring held as it is in the input for every generation, the last
  generation written to ``out``: either compact ``(B, t, t)``, or the
  interior of a second padded stack ``(B, t+2, t+2)`` whose ring is left as
  it is. It ORs tile b's ``(alive, changed)`` of the last generation into
  ``flags[b]`` of a caller-zeroed (B, 2) int32 buffer: any live cell in the
  new interior, any interior cell that differs from the generation before.

Two shapes of launch, chosen by shape: ``n == 1`` cuts each tile into bands
of rows, one CTA each (``LAUNCHES["tile_step"]``); ``n > 1`` holds each
window in one CTA's shared memory for all n generations, one launch
(``LAUNCHES["tile_window"]``), where the window fits there
(``window_max_words``), and takes n launches of the banded form where it
does not.

On a CUDA tensor the wrapper launches the kernel, or raises; on a CPU
tensor it runs the plain torch version (``_tile_steps_plain``, n
applications of ``stencil_lax.evolve_padded_batch``); any other device
raises. ``LAUNCHES`` counts the kernel launches, one per launch on the card
and nothing for the CPU path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gol_tpu_torch.ops import _build, stencil_lax

TILE_FLAGS = 2  # (alive, changed) per tile
MAX_BATCH = 65535  # the kernel's tile axis is a grid dimension
LAUNCHES = {"tile_step": 0, "tile_window": 0}


def _tile_steps_plain(blocks: torch.Tensor, n: int):
    """T1's plain version: ``(interiors (B, t, t), flags (B, 2) int32)``
    after ``n`` generations, each reading the input's ring; the flags are
    the last generation's."""
    cur = blocks
    for _ in range(n):
        new, alive, changed = stencil_lax.evolve_padded_batch(cur)
        cur = blocks.clone()
        cur[:, 1:-1, 1:-1] = new
    return new, torch.stack([alive, changed], dim=1).to(torch.int32)


def _lib() -> ctypes.CDLL:
    return _build.load("stencil_tile", _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gol_tile_step.argtypes = [ptr] * 3 + [i32] * 2 + [i64] * 2 + [i32, ptr]
    lib.gol_tile_step.restype = i32
    lib.gol_tile_window_steps.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 2 + [i32, ptr]
    lib.gol_tile_window_steps.restype = i32
    lib.gol_tile_window_max_words.argtypes = [i32]
    lib.gol_tile_window_max_words.restype = i32
    lib.gol_error_string.argtypes = [i32]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (at first use) and load the kernel ahead of a run."""
    _lib()


@functools.lru_cache(maxsize=None)
def window_max_words(device_index: int) -> int:
    """The most bit words a window may have for the one-launch form of
    ``n > 1`` on card ``device_index``: two copies in one CTA's opt-in
    shared memory. A window of edge t has ``window_words(t)``."""
    most = _lib().gol_tile_window_max_words(device_index)
    if most < 0:
        msg = _lib().gol_error_string(-most).decode()
        raise RuntimeError(f"shared memory query failed: CUDA error {-most} ({msg})")
    return most


def window_words(tile: int) -> int:
    """Bit words of a (tile + 2)^2 block: 32 cells a word, rows padded."""
    return (tile + 2) * -(-(tile + 2) // 32)


def _check(blocks: torch.Tensor, out: torch.Tensor, flags: torch.Tensor) -> bool:
    """Validate the operands; True when ``out`` is the padded form."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 3:
        raise ValueError(f"blocks must be a 3D uint8 tensor, got "
                         f"{blocks.dim()}D {blocks.dtype}")
    batch, h, w = blocks.shape
    if h != w or h < 3 or not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"unsupported block stack shape {tuple(blocks.shape)}; "
                         f"need (1..{MAX_BATCH}, t+2, t+2)")
    tile = h - 2
    padded = out.dim() == 3 and tuple(out.shape) == tuple(blocks.shape)
    if out.dtype != torch.uint8 or not (
            padded or tuple(out.shape) == (batch, tile, tile)):
        raise ValueError(f"out must be uint8 ({batch}, {tile}, {tile}) or "
                         f"({batch}, {h}, {w}), got {out.dtype} {tuple(out.shape)}")
    if flags.dtype != torch.int32 or tuple(flags.shape) != (batch, TILE_FLAGS):
        raise ValueError(f"flags must be int32 ({batch}, {TILE_FLAGS}), got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    for name, t in (("out", out), ("flags", flags)):
        if t.device != blocks.device:
            raise ValueError(f"{name} is on {t.device}, blocks on {blocks.device}")
    for name, t in (("blocks", blocks), ("out", out), ("flags", flags)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == blocks.data_ptr():
        raise ValueError("out must not alias the blocks (threads read "
                         "their neighbours)")
    return padded


def tile_step_into(blocks: torch.Tensor, out: torch.Tensor,
                   flags: torch.Tensor, n: int = 1) -> None:
    """T1: ``n`` generations of each halo-extended block of ``blocks`` (B,
    t+2, t+2), each reading the block's own ring, into ``out`` — compact
    (B, t, t), or the interior of a padded (B, t+2, t+2) stack whose ring
    is left untouched — ORing each tile's last ``(alive, changed)`` into
    ``flags[b]``. ``blocks`` is never written."""
    if n < 1:
        raise ValueError(f"a tile step runs n >= 1 generations, got {n}")
    padded = _check(blocks, out, flags)
    tile = blocks.shape[1] - 2
    if blocks.device.type == "cpu":
        new, step_flags = _tile_steps_plain(blocks, n)
        (out[:, 1:-1, 1:-1] if padded else out).copy_(new)
        flags |= step_flags
        return
    if blocks.device.type != "cuda":
        raise ValueError(f"no tile kernel for device {blocks.device}")
    if n > 1 and window_words(tile) > window_max_words(blocks.device.index):
        # Too large for one CTA: n launches of the banded form.
        steps_by_generation(blocks, out, flags, n,
                            lambda src, dst, f: _launch(src, dst, f, 1))
        return
    _launch(blocks, out, flags, n)


def steps_by_generation(blocks, out, flags, n: int, step) -> None:
    """``n`` generations as ``n`` one-generation steps ``step(src, dst,
    flags)`` through two padded stacks that keep the blocks' rings, the
    last into ``out`` and ``flags``; ``blocks`` is never written."""
    pair = [blocks.clone(), blocks.clone()]
    scratch = torch.zeros_like(flags)
    cur = blocks
    for g in range(n - 1):
        step(cur, pair[g % 2], scratch)
        cur = pair[g % 2]
    step(cur, out, flags)


def _launch(blocks, out, flags, n: int) -> None:
    """One launch of T1 on the card: the banded form for ``n == 1``, the
    whole-window form for ``n > 1``."""
    batch, pitch, _ = blocks.shape
    tile = pitch - 2
    if out.shape == blocks.shape:  # interior row r of tile b at out[b, r + 1, 1:]
        at = out.data_ptr() + pitch + 1
        row, stride = pitch, pitch * pitch
    else:
        at, row, stride = out.data_ptr(), tile, tile * tile
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    device = blocks.device.index
    if n == 1:
        key = "tile_step"
        err = _lib().gol_tile_step(blocks.data_ptr(), at, flags.data_ptr(),
                                   batch, tile, row, stride, device, stream)
    else:
        key = "tile_window"
        err = _lib().gol_tile_window_steps(blocks.data_ptr(), at, flags.data_ptr(),
                                           batch, tile, n, row, stride, device,
                                           stream)
    if err != 0:
        msg = _lib().gol_error_string(err).decode()
        raise RuntimeError(f"{key} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[key] += 1
