"""Packed single-device stencil: the three kernels of the main path.

The port of the single-device half of ``gol_tpu/ops/stencil_packed.py``.
Words are int32 tensors of shape (height, nwords) holding the uint32 bit
patterns (bit j of word w = column 32*w + j; see ``packed_math``). Each
kernel is a CUDA kernel in ``csrc/stencil_packed.cu``:

- ``_step_t_fast_into`` (K1, replaces ``_bandt_fast_kernel``): 8 torus
  generations in one pass, with the pass summary flags;
- ``_step_t_into`` (K2, replaces ``_bandt_kernel``): the same pass with
  exact per-generation flags — the replay target of K1;
- ``_step_into`` (K3, replaces ``_band_kernel``): one generation with fused
  alive/similar flags.

Each of them takes its output and flag buffers from the caller, launches its
kernel on a CUDA tensor and runs its plain torch version (``_band_plain``,
``_bandt_plain``) on a CPU tensor; any other device raises. Flags are ORed
into an int32 buffer the caller zeroes, and "similar" is stored negated, as
``differs`` — the form concurrent CUDA blocks can accumulate. ``_step``,
``_step_t`` and ``_step_t_fast`` wrap them in the JAX package's signatures
(fresh buffers, flags as similar/alive values).

``LAUNCHES`` counts the kernel launches, one per launch on the card and
nothing for the CPU path, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gol_tpu_torch.ops import _build, packed_math

BITS = packed_math.BITS
TEMPORAL_GENS = 8
# Flag words per call: a fast pass's summary (in_alive, out_alive, diffT,
# diff1), an exact pass's alive[0:T] + differs[T:2T], a step's
# (alive, differs).
SUMMARY_FLAGS = 4
EXACT_FLAGS = 2 * TEMPORAL_GENS
STEP_FLAGS = 2

LAUNCHES = {"bandt_fast": 0, "bandt": 0, "band": 0}

encode = packed_math.encode
decode = packed_math.decode


def supports(height: int, width: int) -> bool:
    """Shape gate of the port's packed kernels: the width must pack into
    32-bit words. Any height runs (the kernels wrap rows modulo it), so the
    JAX gate's ``height % 8`` — a TPU tiling rule — does not apply."""
    return height >= 1 and width >= BITS and width % BITS == 0


# ---------------------------------------------------------------------------
# Plain torch versions: the CPU path, and what the kernels are held against.


def _band_plain(words: torch.Tensor):
    """One generation: ``(new, flags)`` with flags ``[alive, differs]``."""
    new = packed_math.evolve_torus_words(words)
    flags = torch.stack([(new != 0).any(), (new != words).any()]).to(torch.int32)
    return new, flags


def _bandt_plain(words: torch.Tensor, exact: bool):
    """TEMPORAL_GENS generations: ``(new, flags)`` with the exact flags
    ``alive[0:T] + differs[T:2T]``, or the summary ``[in_alive, out_alive,
    differs(g_T, g_T-1), differs(g_1, g_0)]``."""
    alive, differs = [], []
    prev = words
    for _ in range(TEMPORAL_GENS):
        new = packed_math.evolve_torus_words(prev)
        alive.append((new != 0).any())
        differs.append((new != prev).any())
        prev = new
    if exact:
        flags = torch.stack(alive + differs)
    else:
        flags = torch.stack(
            [(words != 0).any(), alive[-1], differs[-1], differs[0]]
        )
    return prev, flags.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers.


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("stencil_packed")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_band_step.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.gol_band_step.restype = i32
    lib.gol_bandt_pass.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.gol_bandt_pass.restype = i32
    lib.gol_error_string.argtypes = [i32]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (at first use) and load the kernels ahead of a run."""
    _lib()


def _check(words: torch.Tensor, out: torch.Tensor, flags: torch.Tensor,
           nflags: int) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(
            f"packed words must be a 2D int32 tensor, got {words.dim()}D "
            f"{words.dtype}"
        )
    height, nwords = words.shape
    if height < 1 or nwords < 1 or height * nwords >= 2**31:
        raise ValueError(f"unsupported word array shape {tuple(words.shape)}")
    if out.shape != words.shape or out.dtype != torch.int32:
        raise ValueError(
            f"out must be int32 {tuple(words.shape)}, got {out.dtype} "
            f"{tuple(out.shape)}"
        )
    if flags.dtype != torch.int32 or flags.numel() < nflags:
        raise ValueError(f"flags must hold {nflags} int32 words")
    for name, t in (("words", words), ("out", out), ("flags", flags)):
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == words.data_ptr():
        raise ValueError("out must not alias words (blocks read their halos)")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().gol_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _route(words: torch.Tensor) -> bool:
    """True for the card, False for the CPU path; raises for anything else."""
    if words.device.type == "cuda":
        return True
    if words.device.type == "cpu":
        return False
    raise ValueError(f"no packed kernel for device {words.device}")


def _launch_bandt(words, out, flags, exact: bool) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_bandt_pass(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), height, nwords,
        int(exact), words.device.index, stream,
    )
    _raise_on(err, "bandt" if exact else "bandt_fast")
    LAUNCHES["bandt" if exact else "bandt_fast"] += 1


def _launch_band(words, out, flags) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_band_step(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), height, nwords,
        words.device.index, stream,
    )
    _raise_on(err, "band")
    LAUNCHES["band"] += 1


def _step_t_fast_into(words, out, flags) -> None:
    """K1: TEMPORAL_GENS generations of ``words`` into ``out``; ORs the pass
    summary ``(in_alive, out_alive, diffT, diff1)`` into ``flags[0:4]``."""
    _check(words, out, flags, SUMMARY_FLAGS)
    if _route(words):
        _launch_bandt(words, out, flags, exact=False)
        return
    new, summary = _bandt_plain(words, exact=False)
    out.copy_(new)
    flags[:SUMMARY_FLAGS] |= summary


def _step_t_into(words, out, flags) -> None:
    """K2: TEMPORAL_GENS generations of ``words`` into ``out``; ORs
    ``alive[0:T]`` and ``differs[T:2T]`` into ``flags``."""
    _check(words, out, flags, EXACT_FLAGS)
    if _route(words):
        _launch_bandt(words, out, flags, exact=True)
        return
    new, exact = _bandt_plain(words, exact=True)
    out.copy_(new)
    flags[:EXACT_FLAGS] |= exact


def _step_into(words, out, flags) -> None:
    """K3: one generation of ``words`` into ``out``; ORs ``(alive,
    differs)`` into ``flags[0:2]``."""
    _check(words, out, flags, STEP_FLAGS)
    if _route(words):
        _launch_band(words, out, flags)
        return
    new, step_flags = _band_plain(words)
    out.copy_(new)
    flags[:STEP_FLAGS] |= step_flags


# ---------------------------------------------------------------------------
# The JAX package's signatures.


def _flags(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device=device)


def _step(words: torch.Tensor):
    """One generation: ``(new, alive, similar)`` (0-d bool tensors)."""
    out, flags = torch.empty_like(words), _flags(STEP_FLAGS, words.device)
    _step_into(words, out, flags)
    return out, flags[0] != 0, flags[1] == 0


def _step_t(words: torch.Tensor):
    """TEMPORAL_GENS generations: ``(new, alive_vec, similar_vec)``, int32
    (TEMPORAL_GENS,) vectors, one entry per generation."""
    out, flags = torch.empty_like(words), _flags(EXACT_FLAGS, words.device)
    _step_t_into(words, out, flags)
    T = TEMPORAL_GENS
    return out, flags[:T].clone(), 1 - flags[T:]


def summary_needs_replay(summary) -> bool:
    """Whether a fast pass's summary ``(in_alive, out_alive, diffT, diff1)``
    hides a transition inside the pass.

    Both exits are monotone over the whole torus: an empty generation stays
    empty, and a generation equal to its predecessor is a still life. So
    ``out_alive`` alone gives every generation's alive flag and ``simT``
    every similar flag — unless the grid died inside the pass
    (in_alive=1, out_alive=0) or became still inside it (simT=1, sim1=0).
    """
    in_alive, out_alive, diff_t, diff_1 = (int(v) for v in summary)
    return (in_alive and not out_alive) or (not diff_t and diff_1)


def _derive_or_replay(summary, exact_thunk):
    """Per-generation ``(alive, similar)`` lists from a fast pass's summary,
    exact always: derived from the summary, or ``exact_thunk()`` (the exact
    pass over the same input) where ``summary_needs_replay``. Each transition
    happens at most once per run, so the replay runs at most twice."""
    if summary_needs_replay(summary):
        return exact_thunk()
    T = TEMPORAL_GENS
    out_alive, diff_t = int(summary[1]), int(summary[2])
    return [out_alive] * T, [1 - diff_t] * T


def _step_t_fast(words: torch.Tensor):
    """TEMPORAL_GENS generations with the fast-flag kernel:
    ``(new, alive_vec, similar_vec)`` as ``_step_t`` gives them. The summary
    is read back here (one sync); the exact pass reruns only when
    ``summary_needs_replay``."""
    out, flags = torch.empty_like(words), _flags(SUMMARY_FLAGS, words.device)
    _step_t_fast_into(words, out, flags)
    alive, similar = _derive_or_replay(
        flags.tolist(), lambda: [v.tolist() for v in _step_t(words)[1:]]
    )
    vec = functools.partial(torch.tensor, dtype=torch.int32, device=words.device)
    return out, vec(alive), vec(similar)


def _gate(words: torch.Tensor) -> None:
    height, nwords = words.shape
    if not supports(height, nwords * BITS):
        raise ValueError(
            f"the packed kernel needs a width that is a multiple of {BITS}; "
            f"got {height}x{nwords * BITS}"
        )


def packed_step(words: torch.Tensor):
    """Fused generation step on packed state: ``words -> (words, alive,
    similar)`` — K3 on the card, its plain version on the CPU."""
    _gate(words)
    return _step(words)


def packed_step_multi(words: torch.Tensor):
    """TEMPORAL_GENS fused generations: ``words -> (words_T, alive_vec,
    similar_vec)`` — K1, with K2 replayed on a mid-pass exit."""
    _gate(words)
    return _step_t_fast(words)
