"""Byte-cell single-device stencil with fused flags: K4, ``--kernel pallas``.

The port of ``gol_tpu/ops/stencil_pallas.py``'s single-device ``_step`` /
``pallas_step`` (here one function, ``pallas_step``). ``_step_into`` (K4,
replaces ``_band_kernel``) writes the
next uint8 generation into the caller's ``out`` and ORs ``(alive,
differs)`` into a caller-zeroed int32 flag pair — the same flag form as
``stencil_packed._step_into``, so the engine's blocked loop reads both
kernels alike. On a CUDA tensor it launches the kernel in
``csrc/stencil_pallas.cu``; on a CPU tensor it runs the plain torch version
(``_band_plain``: ``stencil_lax.evolve_torus`` plus the two flags); any
other device raises.

The kernel wraps rows and columns modulo the grid, so it takes every shape:
the TPU gate (height % 8, width % 128, the v5e width cap) does not carry
over. Cells are 0/1 bytes, as the text decode and every generation give.

``LAUNCHES`` counts the kernel launches, one per launch on the card and
nothing for the CPU path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gol_tpu_torch.ops import _build, stencil_lax

STEP_FLAGS = 2  # (alive, differs)
LAUNCHES = {"byte_band": 0}


def supports(height: int, width: int) -> bool:
    """Shape gate of K4: any grid whose cell index fits a 32-bit int."""
    return height >= 1 and width >= 1 and height * width < 2**31


def _band_plain(cur: torch.Tensor):
    """One generation: ``(new, flags)`` with flags ``[alive, differs]``."""
    new = stencil_lax.evolve_torus(cur)
    flags = torch.stack([new.any(), (new != cur).any()]).to(torch.int32)
    return new, flags


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_pallas")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_byte_step.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.gol_byte_step.restype = i32
    lib.gol_error_string.argtypes = [i32]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (at first use) and load the kernel ahead of a run."""
    _lib()


def _check(cur: torch.Tensor, out: torch.Tensor, flags: torch.Tensor) -> None:
    if cur.dtype != torch.uint8 or cur.dim() != 2:
        raise ValueError(
            f"cells must be a 2D uint8 tensor, got {cur.dim()}D {cur.dtype}"
        )
    if not supports(*cur.shape):
        raise ValueError(f"unsupported grid shape {tuple(cur.shape)}")
    if out.shape != cur.shape or out.dtype != torch.uint8:
        raise ValueError(
            f"out must be uint8 {tuple(cur.shape)}, got {out.dtype} "
            f"{tuple(out.shape)}"
        )
    if flags.dtype != torch.int32 or flags.numel() < STEP_FLAGS:
        raise ValueError(f"flags must hold {STEP_FLAGS} int32 words")
    for name, t in (("cur", cur), ("out", out), ("flags", flags)):
        if t.device != cur.device:
            raise ValueError(f"{name} is on {t.device}, cur on {cur.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == cur.data_ptr():
        raise ValueError("out must not alias cur (blocks read their halos)")


def _step_into(cur: torch.Tensor, out: torch.Tensor, flags: torch.Tensor) -> None:
    """K4: one generation of ``cur`` into ``out``; ORs ``(alive, differs)``
    into ``flags[0:2]``."""
    _check(cur, out, flags)
    if cur.device.type == "cuda":
        height, width = cur.shape
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        err = _lib().gol_byte_step(
            cur.data_ptr(), out.data_ptr(), flags.data_ptr(), height, width,
            cur.device.index, stream,
        )
        if err != 0:
            msg = _lib().gol_error_string(err).decode()
            raise RuntimeError(f"byte_band launch failed: CUDA error {err} ({msg})")
        LAUNCHES["byte_band"] += 1
        return
    if cur.device.type != "cpu":
        raise ValueError(f"no byte kernel for device {cur.device}")
    new, step_flags = _band_plain(cur)
    out.copy_(new)
    flags[:STEP_FLAGS] |= step_flags


def pallas_step(cur: torch.Tensor):
    """Fused generation step: ``cur -> (new, any_alive, similar)`` (0-d bool
    tensors), the JAX package's ``_step``/``pallas_step`` signature — K4 on
    the card, its plain version on the CPU."""
    out = torch.empty_like(cur)
    flags = torch.zeros(STEP_FLAGS, dtype=torch.int32, device=cur.device)
    _step_into(cur, out, flags)
    return out, flags[0] != 0, flags[1] == 0
