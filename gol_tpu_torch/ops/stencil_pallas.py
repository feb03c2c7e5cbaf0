"""Byte-cell stencil with fused flags: K4 and K6, ``--kernel pallas``.

The port of ``gol_tpu/ops/stencil_pallas.py``. ``_step_into`` (K4,
replaces ``_band_kernel``) writes the next uint8 generation of a torus into
the caller's ``out`` and ORs ``(alive, differs)`` into a caller-zeroed
int32 flag pair — the same flag form as ``stencil_packed._step_into``, so
the engine's blocked loop reads both kernels alike.
``_distributed_step_into`` (K6, replaces ``_dist_band_kernel``) does the
same for one shard of a mesh, from the ghost rows and the (h+2) ghost
columns of the halo exchange. On a CUDA tensor each launches its kernel in
``csrc/stencil_pallas.cu``; on a CPU tensor it runs its plain torch version
(``_band_plain``, ``_dist_band_plain``); any other device raises.
``pallas_step_into`` is the engine's form over a (sharded) state, as in
``stencil_packed``.

K4 wraps rows and columns modulo the grid and K6 reads its ghosts, so both
take every shape: the TPU gate (height % 8, width % 128, the v5e width cap)
does not carry over. Cells are 0/1 bytes, as the text decode and every
generation give.

``LAUNCHES`` counts the kernel launches, one per launch on the card and
nothing for the CPU path.
"""

from __future__ import annotations

import ctypes

import torch

from gol_tpu_torch.ops import _build, stencil_lax
from gol_tpu_torch.parallel import collectives, halo
from gol_tpu_torch.parallel.mesh import SINGLE_DEVICE, Topology

STEP_FLAGS = 2  # (alive, differs)
LAUNCHES = {"byte_band": 0, "dist_byte_band": 0}


def supports(height: int, width: int, topology: Topology = SINGLE_DEVICE) -> bool:
    """Shape gate of K4 and K6 (the local shard's shape): any grid whose
    cell index fits a 32-bit int."""
    return height >= 1 and width >= 1 and height * width < 2**31


def _band_plain(cur: torch.Tensor):
    """One generation: ``(new, flags)`` with flags ``[alive, differs]``."""
    new = stencil_lax.evolve_torus(cur)
    flags = torch.stack([new.any(), (new != cur).any()]).to(torch.int32)
    return new, flags


def _dist_band_plain(cur, top, bot, gwest, geast):
    """One shard generation from its ghosts: ``(new, flags)`` with flags
    ``[alive, differs]``."""
    padded = torch.cat([gwest[:, None], torch.cat([top, cur, bot]), geast[:, None]],
                       dim=1)
    new = stencil_lax.evolve_padded(padded)
    flags = torch.stack([new.any(), (new != cur).any()]).to(torch.int32)
    return new, flags


def _lib() -> ctypes.CDLL:
    return _build.load("stencil_pallas", _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_byte_step.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.gol_byte_step.restype = i32
    lib.gol_dist_byte_step.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
    lib.gol_dist_byte_step.restype = i32
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


def _launched(cur: torch.Tensor, key: str, launch) -> bool:
    """Launch on the card (True), or leave a CPU tensor to the plain
    version (False); raises for any other device or a failed launch."""
    if cur.device.type == "cpu":
        return False
    if cur.device.type != "cuda":
        raise ValueError(f"no byte kernel for device {cur.device}")
    err = launch(torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        msg = _lib().gol_error_string(err).decode()
        raise RuntimeError(f"{key} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[key] += 1
    return True


def _step_into(cur: torch.Tensor, out: torch.Tensor, flags: torch.Tensor) -> None:
    """K4: one generation of ``cur`` into ``out``; ORs ``(alive, differs)``
    into ``flags[0:2]``."""
    _check(cur, out, flags)
    height, width = cur.shape
    if _launched(cur, "byte_band", lambda stream: _lib().gol_byte_step(
            cur.data_ptr(), out.data_ptr(), flags.data_ptr(), height, width,
            cur.device.index, stream)):
        return
    new, step_flags = _band_plain(cur)
    out.copy_(new)
    flags[:STEP_FLAGS] |= step_flags


def _distributed_step_into(cur, top, bot, gwest, geast, out, flags) -> None:
    """K6: one generation of the shard ``cur`` into ``out`` from its ghost
    rows (1, w) and ghost columns (h+2,); ORs ``(alive, differs)`` into
    ``flags[0:2]``."""
    _check(cur, out, flags)
    height, width = cur.shape
    for name, t, shape in (("top", top, (1, width)), ("bot", bot, (1, width)),
                           ("gwest", gwest, (height + 2,)),
                           ("geast", geast, (height + 2,))):
        if t.dtype != torch.uint8 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be uint8 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != cur.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {cur.device}")
    if _launched(cur, "dist_byte_band", lambda stream: _lib().gol_dist_byte_step(
            cur.data_ptr(), top.data_ptr(), bot.data_ptr(), gwest.data_ptr(),
            geast.data_ptr(), out.data_ptr(), flags.data_ptr(), height, width,
            cur.device.index, stream)):
        return
    new, step_flags = _dist_band_plain(cur, top, bot, gwest, geast)
    out.copy_(new)
    flags[:STEP_FLAGS] |= step_flags


def pallas_step_into(src, dst, flags, topology: Topology) -> None:
    """One generation of every shard of ``src`` into ``dst``: K4 on a
    single device, else the halo exchange then K6 per shard."""
    if not topology.distributed:
        _step_into(src[0], dst[0], flags[0])
        return
    for x, y, f, ghosts in zip(src, dst, flags,
                               halo.exchange_parts(src, topology)):
        _distributed_step_into(x, *ghosts, y, f)


def pallas_step(cur, topology: Topology = SINGLE_DEVICE):
    """Fused generation step: ``cur -> (new, any_alive, similar)`` (0-d bool
    tensors), the JAX package's ``pallas_step`` signature — K4 on the card,
    its plain version on the CPU. On a mesh ``cur`` is the list of shards
    and so is the new state (K6), and the flags are the votes."""
    if not topology.distributed:
        out = torch.empty_like(cur)
        flags = torch.zeros(STEP_FLAGS, dtype=torch.int32, device=cur.device)
        _step_into(cur, out, flags)
        return out, flags[0] != 0, flags[1] == 0
    out = [torch.empty_like(s) for s in cur]
    flags = [torch.zeros(STEP_FLAGS, dtype=torch.int32, device=s.device) for s in cur]
    pallas_step_into(cur, out, flags, topology)
    voted = collectives.any_flag(flags, topology)
    return out, voted[0] != 0, voted[1] == 0
