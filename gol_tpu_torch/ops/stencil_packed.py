"""Packed stencil: the word kernels of the single-device and mesh paths.

The port of ``gol_tpu/ops/stencil_packed.py`` for one device and for the
shards of an R x C mesh. Words are int32 tensors of
shape (height, nwords) holding the uint32 bit patterns (bit j of word w =
column 32*w + j; see ``packed_math``). Each kernel is a CUDA kernel in
``csrc/stencil_packed.cu``:

- ``_step_t_fast_into`` (K1, replaces ``_bandt_fast_kernel``): 8 torus
  generations in one pass, with the pass summary flags;
- ``_step_t_into`` (K2, replaces ``_bandt_kernel``): the same pass with
  exact per-generation flags — the replay target of K1;
- ``_step_into`` (K3, replaces ``_band_kernel``): one generation with fused
  alive/similar flags;
- ``_distributed_step_into`` (K5, replaces ``_dist_band_kernel``): K3 for
  one mesh shard, from the depth-1 ghost rows and the (h+2) east/west carry
  words of ``exchange_packed``;
- ``_step_trow_fast_into`` (K7, replaces ``_bandtrow_fast_kernel``) and
  ``_step_trow_into`` (K8, replaces ``_bandtrow_kernel``): K1 and K2 for a
  full-width shard of an R x 1 mesh, from its neighbours' 8-row ghost
  blocks (``exchange_packed_deep``);
- ``_step_tg_fast_into`` (replaces K9 + K10, ``_stript_fast_kernel`` and
  ``_bandtrow_stitch_fast_kernel``) and ``_step_tg_into`` (replaces K11 +
  K12, ``_stript_kernel`` and ``_bandtrow_stitch_kernel``, and K13,
  ``_bandtg_kernel``): K1 and K2 for a shard of a mesh with columns, from
  the ghost blocks and the neighbours' whole edge word columns over rows
  -8..h+7 (``deep_ghost_operands``). The JAX package's edge strip, lane
  fold and stitch are its TPU tiling's; here the tile kernel reads the
  ghost columns as one more source, so one kernel is the whole pass;
- ``_step_t_noflags_into`` (K14, replaces ``_bandt_noflags_kernel`` of
  ``tools/roofline_r4.py``): K2's pass with every flag operation compiled
  out, words only. A measurement kernel for the flag-cost roofline
  (``gol_tpu_torch/tools/roofline.py``); no engine path launches it.

``packed_step_into``, ``packed_step_multi_into`` and
``packed_step_exact_into`` are the engine's forms over a (sharded) state: a
row-major list of shards (one for a single device), their output buffers
and their flag buffers, and the ``Topology``. On a mesh they exchange the
ghosts from the pass's inputs, then launch each shard's kernel; every
shard ORs into its flag buffer, and the buffers OR into the vote
(``parallel/collectives.py``). The 8-generation pass runs on a single
device and on every mesh whose shards are at least 8 rows high
(``supports_multi``), with one exchange per pass; shorter shards run K5
once per generation.

Each of them takes its output and flag buffers from the caller, launches its
kernel on a CUDA tensor and runs its plain torch version (``_band_plain``,
``_bandt_plain``, ``_bandtg_plain``, ...) on a CPU tensor; any other device
raises. Flags are ORed
into an int32 buffer the caller zeroes, and "similar" is stored negated, as
``differs`` — the form concurrent CUDA blocks can accumulate. ``_step``,
``_step_t``, ``_step_t_fast``, ``_step_tgb``, ``_step_tsplit`` and
``_step_tsplit_fast`` wrap them in the JAX package's signatures (fresh
buffers, flags as similar/alive values).

``LAUNCHES`` counts the kernel launches, one per launch on the card and
nothing for the CPU path, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gol_tpu_torch.ops import _build, packed_math
from gol_tpu_torch.parallel import collectives, halo
from gol_tpu_torch.parallel.mesh import SINGLE_DEVICE, Topology

BITS = packed_math.BITS
_BIT31 = -(1 << 31)  # the int32 pattern of bit 31
TEMPORAL_GENS = 8
# Flag words per call: a fast pass's summary (in_alive, out_alive, diffT,
# diff1), an exact pass's alive[0:T] + differs[T:2T], a step's
# (alive, differs).
SUMMARY_FLAGS = 4
EXACT_FLAGS = 2 * TEMPORAL_GENS
STEP_FLAGS = 2

LAUNCHES = {"bandt_fast": 0, "bandt": 0, "band": 0,
            "dist_band": 0, "bandtrow_fast": 0, "bandtrow": 0,
            "bandtg_fast": 0, "bandtg": 0, "bandt_noflags": 0}

encode = packed_math.encode
decode = packed_math.decode


def supports(height: int, width: int, topology: Topology = SINGLE_DEVICE) -> bool:
    """Shape gate of the port's packed kernels (``height``/``width`` are the
    local shard's): the width must pack into 32-bit words. Any height runs
    (the kernels wrap rows modulo it, or take them from ghosts), so the JAX
    gate's ``height % 8`` — a TPU tiling rule — does not apply."""
    return height >= 1 and width >= BITS and width % BITS == 0


def supports_multi(height: int, width: int,
                   topology: Topology = SINGLE_DEVICE) -> bool:
    """The 8-generation pass: on one device wherever ``supports``; on a
    mesh, of any number of columns, for shards at least TEMPORAL_GENS rows
    high, the ghost depth. (JAX's gates, ``h % 8 == 0 and h >= 16`` and
    ``nwords >= 2`` for the split form, are its Pallas tiling's.)"""
    if not supports(height, width, topology):
        return False
    return not topology.distributed or height >= TEMPORAL_GENS


# ---------------------------------------------------------------------------
# Plain torch versions: the CPU path, and what the kernels are held against.


def _band_plain(words: torch.Tensor):
    """One generation: ``(new, flags)`` with flags ``[alive, differs]``."""
    new = packed_math.evolve_torus_words(words)
    flags = torch.stack([(new != 0).any(), (new != words).any()]).to(torch.int32)
    return new, flags


def _pass_flags(words: torch.Tensor, gens, exact: bool):
    """``(gens[-1], flags)`` of a pass from ``words`` through the
    TEMPORAL_GENS generations ``gens``: the exact flags ``alive[0:T] +
    differs[T:2T]``, or the summary ``[in_alive, out_alive, differs(g_T,
    g_T-1), differs(g_1, g_0)]``."""
    alive = [(g != 0).any() for g in gens]
    differs = [(g != p).any() for p, g in zip([words, *gens], gens)]
    if exact:
        flags = torch.stack(alive + differs)
    else:
        flags = torch.stack(
            [(words != 0).any(), alive[-1], differs[-1], differs[0]]
        )
    return gens[-1], flags.to(torch.int32)


def _bandt_plain(words: torch.Tensor, exact: bool):
    """TEMPORAL_GENS torus generations: ``(new, flags)`` (``_pass_flags``)."""
    gens, x = [], words
    for _ in range(TEMPORAL_GENS):
        x = packed_math.evolve_torus_words(x)
        gens.append(x)
    return _pass_flags(words, gens, exact)


def _bandt_noflags_plain(words: torch.Tensor) -> torch.Tensor:
    """TEMPORAL_GENS torus generations, words only: K14's plain version
    (the words of ``_bandt_plain(words, exact=True)``)."""
    x = words
    for _ in range(TEMPORAL_GENS):
        x = packed_math.evolve_torus_words(x)
    return x


def _dist_band_plain(words, top, bot, gwest, geast):
    """One shard generation from its ghosts: ``(new, flags)`` with flags
    ``[alive, differs]``."""
    new = packed_math.evolve_ghost(words, top, bot, gwest, geast)
    flags = torch.stack([(new != 0).any(), (new != words).any()]).to(torch.int32)
    return new, flags


def _bandtrow_plain(words, gtop, gbot, exact: bool):
    """TEMPORAL_GENS generations of a full-width shard from its 8-row ghost
    blocks: ``(new, flags)`` as ``_bandt_plain``. The (h+16)-row extended
    block evolves as a torus; its wrapped rows spoil only the frontier,
    one row per generation from each end, never the shard's own rows."""
    T, h = TEMPORAL_GENS, words.shape[0]
    gens, x = [], torch.cat([gtop, words, gbot])
    for _ in range(T):
        x = packed_math.evolve_torus_words(x)
        gens.append(x[T:T + h])
    return _pass_flags(words, gens, exact)


def _bandtg_plain(words, gtop, gbot, gwest, geast, exact: bool):
    """TEMPORAL_GENS generations of a shard of a mesh with columns, from
    its 8-row ghost blocks and the (h+16,) ghost word columns over rows
    -8..h+7: ``(new, flags)`` as ``_bandt_plain``. The (h+16, nwords+2)
    extended block ``[gwest | gtop; words; gbot | geast]`` evolves as a
    torus; what wraps spoils one row per generation from each end and one
    bit per generation from each ghost word's far side, never the shard's
    own cells."""
    T, (h, nwords) = TEMPORAL_GENS, words.shape
    gens = []
    x = torch.cat([gwest[:, None], torch.cat([gtop, words, gbot]),
                   geast[:, None]], dim=1)
    for _ in range(T):
        x = packed_math.evolve_torus_words(x)
        gens.append(x[T:T + h, 1:nwords + 1])
    return _pass_flags(words, gens, exact)


# ---------------------------------------------------------------------------
# Kernel wrappers.


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("stencil_packed"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a built ``csrc/stencil_packed.cu`` (the
    package's, or a copy ``tools/band_sweep.py`` built) to ctypes."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_band_step.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.gol_band_step.restype = i32
    lib.gol_bandt_pass.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.gol_bandt_pass.restype = i32
    lib.gol_bandt_noflags_pass.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.gol_bandt_noflags_pass.restype = i32
    lib.gol_dist_band_step.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
    lib.gol_dist_band_step.restype = i32
    lib.gol_bandtrow_pass.argtypes = [ptr] * 5 + [i32, i32, i32, i32, ptr]
    lib.gol_bandtrow_pass.restype = i32
    lib.gol_bandtg_pass.argtypes = [ptr] * 7 + [i32, i32, i32, i32, ptr]
    lib.gol_bandtg_pass.restype = i32
    lib.gol_bandt_tile.argtypes = [ctypes.POINTER(i32)] * 3
    lib.gol_bandt_tile.restype = None
    lib.gol_bandt_bands.argtypes = [i32, i32, i32] + [ctypes.POINTER(i32)] * 2
    lib.gol_bandt_bands.restype = i32
    lib.gol_error_string.argtypes = [i32]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> None:
    """Build (at first use) and load the kernels ahead of a run."""
    _lib()


def bandt_tile() -> tuple[int, int, int]:
    """``(rows, words, ghost_rows)`` of ``bandt_kernel``'s tile, read from
    the built library: the least rows of a warp's band (unless the grid has
    fewer), the interior words of its strip, and the ghost rows it loads
    above and below (it loads one ghost word per side besides). Builds the
    kernels at first use, so it needs ``nvcc``."""
    rows, words, ghost = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _lib().gol_bandt_tile(ctypes.byref(rows), ctypes.byref(words),
                          ctypes.byref(ghost))
    return rows.value, words.value, ghost.value


def bandt_bands(height: int, nwords: int, device: int = 0) -> tuple[int, int]:
    """``(rows, bands)``: how a K1 launch over (height, nwords) words on the
    card ``device`` splits each strip's rows — the rows of a band and the
    bands per strip, as many as the card's resident warps hold in one wave.
    Needs the card."""
    rows, bands = ctypes.c_int(), ctypes.c_int()
    _raise_on(_lib().gol_bandt_bands(height, nwords, device, ctypes.byref(rows),
                                     ctypes.byref(bands)), "bandt_bands")
    return rows.value, bands.value


def _check(words: torch.Tensor, out: torch.Tensor, flags: torch.Tensor | None,
           nflags: int) -> None:
    """The checks every wrapper makes; ``flags`` None for K14, which has
    no flag buffer."""
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
    tensors = [("words", words), ("out", out)]
    if flags is not None:
        if flags.dtype != torch.int32 or flags.numel() < nflags:
            raise ValueError(f"flags must hold {nflags} int32 words")
        tensors.append(("flags", flags))
    for name, t in tensors:
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == words.data_ptr():
        raise ValueError("out must not alias words (blocks read their halos)")


def _check_ghosts(words: torch.Tensor, ghosts) -> None:
    """``ghosts``: ``(name, tensor, shape)`` triples a shard kernel reads."""
    for name, t, shape in ghosts:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_deep(words, gtop, gbot, gwest=None, geast=None) -> None:
    height, nwords = words.shape
    if height < TEMPORAL_GENS:
        raise ValueError(f"a shard of the {TEMPORAL_GENS}-generation pass needs "
                         f"at least {TEMPORAL_GENS} rows, got {height}")
    ghosts = [("gtop", gtop, (TEMPORAL_GENS, nwords)),
              ("gbot", gbot, (TEMPORAL_GENS, nwords))]
    if gwest is not None:
        ghosts += [("gwest", gwest, (height + 2 * TEMPORAL_GENS,)),
                   ("geast", geast, (height + 2 * TEMPORAL_GENS,))]
    _check_ghosts(words, ghosts)


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


def _launch_bandt_noflags(words, out) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_bandt_noflags_pass(
        words.data_ptr(), out.data_ptr(), height, nwords, words.device.index,
        stream,
    )
    _raise_on(err, "bandt_noflags")
    LAUNCHES["bandt_noflags"] += 1


def _launch_band(words, out, flags) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_band_step(
        words.data_ptr(), out.data_ptr(), flags.data_ptr(), height, nwords,
        words.device.index, stream,
    )
    _raise_on(err, "band")
    LAUNCHES["band"] += 1


def _launch_dist_band(words, top, bot, gwest, geast, out, flags) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_dist_band_step(
        words.data_ptr(), top.data_ptr(), bot.data_ptr(), gwest.data_ptr(),
        geast.data_ptr(), out.data_ptr(), flags.data_ptr(), height, nwords,
        words.device.index, stream,
    )
    _raise_on(err, "dist_band")
    LAUNCHES["dist_band"] += 1


def _launch_bandtrow(words, gtop, gbot, out, flags, exact: bool) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_bandtrow_pass(
        words.data_ptr(), gtop.data_ptr(), gbot.data_ptr(), out.data_ptr(),
        flags.data_ptr(), height, nwords, int(exact), words.device.index, stream,
    )
    key = "bandtrow" if exact else "bandtrow_fast"
    _raise_on(err, key)
    LAUNCHES[key] += 1


def _launch_bandtg(words, gtop, gbot, gwest, geast, out, flags,
                   exact: bool) -> None:
    height, nwords = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _lib().gol_bandtg_pass(
        words.data_ptr(), gtop.data_ptr(), gbot.data_ptr(), gwest.data_ptr(),
        geast.data_ptr(), out.data_ptr(), flags.data_ptr(), height, nwords,
        int(exact), words.device.index, stream,
    )
    key = "bandtg" if exact else "bandtg_fast"
    _raise_on(err, key)
    LAUNCHES[key] += 1


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


def _step_t_noflags_into(words, out) -> None:
    """K14: TEMPORAL_GENS generations of ``words`` into ``out``, no flags."""
    _check(words, out, None, 0)
    if _route(words):
        _launch_bandt_noflags(words, out)
        return
    out.copy_(_bandt_noflags_plain(words))


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


def _distributed_step_into(words, top, bot, gwest, geast, out, flags) -> None:
    """K5: one generation of the shard ``words`` into ``out`` from its
    ghosts (``exchange_packed``); ORs ``(alive, differs)`` into
    ``flags[0:2]``."""
    _check(words, out, flags, STEP_FLAGS)
    height, nwords = words.shape
    _check_ghosts(words, (("top", top, (1, nwords)), ("bot", bot, (1, nwords)),
                          ("gwest", gwest, (height + 2,)),
                          ("geast", geast, (height + 2,))))
    if _route(words):
        _launch_dist_band(words, top, bot, gwest, geast, out, flags)
        return
    new, step_flags = _dist_band_plain(words, top, bot, gwest, geast)
    out.copy_(new)
    flags[:STEP_FLAGS] |= step_flags


def _step_trow_fast_into(words, gtop, gbot, out, flags) -> None:
    """K7: TEMPORAL_GENS generations of a full-width shard into ``out``
    from its 8-row ghost blocks; ORs the pass summary into ``flags[0:4]``."""
    _check(words, out, flags, SUMMARY_FLAGS)
    _check_deep(words, gtop, gbot)
    if _route(words):
        _launch_bandtrow(words, gtop, gbot, out, flags, exact=False)
        return
    new, summary = _bandtrow_plain(words, gtop, gbot, exact=False)
    out.copy_(new)
    flags[:SUMMARY_FLAGS] |= summary


def _step_trow_into(words, gtop, gbot, out, flags) -> None:
    """K8: K7 with the exact per-generation flags ``alive[0:T]`` and
    ``differs[T:2T]``."""
    _check(words, out, flags, EXACT_FLAGS)
    _check_deep(words, gtop, gbot)
    if _route(words):
        _launch_bandtrow(words, gtop, gbot, out, flags, exact=True)
        return
    new, exact = _bandtrow_plain(words, gtop, gbot, exact=True)
    out.copy_(new)
    flags[:EXACT_FLAGS] |= exact


def _step_tg_fast_into(words, gtop, gbot, gwest, geast, out, flags) -> None:
    """K9 + K10: TEMPORAL_GENS generations of a shard of a mesh with columns
    into ``out``, from its 8-row ghost blocks and its (h+16,) ghost word
    columns; ORs the pass summary over all of the shard's cells into
    ``flags[0:4]``."""
    _check(words, out, flags, SUMMARY_FLAGS)
    _check_deep(words, gtop, gbot, gwest, geast)
    if _route(words):
        _launch_bandtg(words, gtop, gbot, gwest, geast, out, flags, exact=False)
        return
    new, summary = _bandtg_plain(words, gtop, gbot, gwest, geast, exact=False)
    out.copy_(new)
    flags[:SUMMARY_FLAGS] |= summary


def _step_tg_into(words, gtop, gbot, gwest, geast, out, flags) -> None:
    """K11 + K12, and K13: the same pass with the exact per-generation
    flags ``alive[0:T]`` and ``differs[T:2T]``."""
    _check(words, out, flags, EXACT_FLAGS)
    _check_deep(words, gtop, gbot, gwest, geast)
    if _route(words):
        _launch_bandtg(words, gtop, gbot, gwest, geast, out, flags, exact=True)
        return
    new, exact = _bandtg_plain(words, gtop, gbot, gwest, geast, exact=True)
    out.copy_(new)
    flags[:EXACT_FLAGS] |= exact


# ---------------------------------------------------------------------------
# Over a (sharded) state: the engine's forms.


def exchange_packed(shards, shape):
    """Two-phase packed halo: per shard ``(top, bot, gwest, geast)``, the
    (1, nwords) ghost word rows, then the (h+2,) carry words over rows
    -1..h with the neighbour's bit at bit 31 (west) and bit 0 (east)."""
    return [(top, bot, gw & _BIT31, ge & 1)
            for top, bot, gw, ge in halo.exchange_parts(shards, shape)]


def exchange_packed_deep(shards, shape):
    """The deep halo of an R x 1 mesh: per shard its TEMPORAL_GENS-row
    ghost blocks ``(gtop, gbot)``. Full-width shards wrap east/west within
    themselves, so no column phase exists."""
    return halo.ghost_slices(shards, shape, depth=TEMPORAL_GENS)


def deep_ghost_operands(shards, shape):
    """The deep halo of a mesh with columns: per shard ``(gtop, gbot, gwest,
    geast)``, its TEMPORAL_GENS-row ghost blocks and the neighbours' whole
    edge word columns over rows -8..h+7. The column phase runs over the
    row-extended range, so the ghost rows' corner words are the diagonal
    neighbours'. (JAX stacks the two columns as the plane ``G_ext``; the
    kernel here takes them apart.)"""
    return halo.exchange_parts(shards, shape, depth=TEMPORAL_GENS)


def packed_step_into(src, dst, flags, topology: Topology) -> None:
    """One generation of every shard of ``src`` into ``dst``: K3 on a
    single device, else the exchange then K5 per shard."""
    if not topology.distributed:
        _step_into(src[0], dst[0], flags[0])
        return
    for x, y, f, ghosts in zip(src, dst, flags, exchange_packed(src, topology.shape)):
        _distributed_step_into(x, *ghosts, y, f)


def _multi_into(src, dst, flags, topology: Topology, exact: bool) -> None:
    if not topology.distributed:
        (_step_t_into if exact else _step_t_fast_into)(src[0], dst[0], flags[0])
        return
    if topology.shape[1] == 1:
        step = _step_trow_into if exact else _step_trow_fast_into
        ghosts = exchange_packed_deep(src, topology.shape)
    else:
        step = _step_tg_into if exact else _step_tg_fast_into
        ghosts = deep_ghost_operands(src, topology.shape)
    for x, y, f, g in zip(src, dst, flags, ghosts):
        step(x, *g, y, f)


def packed_step_multi_into(src, dst, flags, topology: Topology) -> None:
    """TEMPORAL_GENS generations with the pass summary: K1, or the deep
    exchange then one kernel per shard: K7 on one mesh column, else the
    ghost-plane form (K9 + K10)."""
    _multi_into(src, dst, flags, topology, exact=False)


def packed_step_exact_into(src, dst, flags, topology: Topology) -> None:
    """The same pass with exact per-generation flags: K2, or per shard K8
    or the ghost-plane form (K11 + K12, K13)."""
    _multi_into(src, dst, flags, topology, exact=True)


# ---------------------------------------------------------------------------
# The JAX package's signatures.


def _flags(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device=device)


def _step(words: torch.Tensor):
    """One generation: ``(new, alive, similar)`` (0-d bool tensors)."""
    out, flags = torch.empty_like(words), _flags(STEP_FLAGS, words.device)
    _step_into(words, out, flags)
    return out, flags[0] != 0, flags[1] == 0


def _vectors(exact_flags: torch.Tensor):
    """An exact pass's flags as JAX's ``(alive_vec, similar_vec)``."""
    T = TEMPORAL_GENS
    return exact_flags[:T].clone(), 1 - exact_flags[T:]


def _step_t(words: torch.Tensor):
    """TEMPORAL_GENS generations: ``(new, alive_vec, similar_vec)``, int32
    (TEMPORAL_GENS,) vectors, one entry per generation."""
    out, flags = torch.empty_like(words), _flags(EXACT_FLAGS, words.device)
    _step_t_into(words, out, flags)
    return (out, *_vectors(flags))


def _step_t_noflags(words: torch.Tensor) -> torch.Tensor:
    """K14 in ``tools/roofline_r4.py``'s signature: the words
    TEMPORAL_GENS generations later, in a fresh buffer."""
    out = torch.empty_like(words)
    _step_t_noflags_into(words, out)
    return out


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


def _derived_vectors(summary: torch.Tensor, exact_thunk):
    """``_derive_or_replay`` on a summary tensor (read back here, one sync),
    as JAX's int32 ``(alive_vec, similar_vec)`` on the summary's device."""
    alive, similar = _derive_or_replay(summary.tolist(), exact_thunk)
    vec = functools.partial(torch.tensor, dtype=torch.int32, device=summary.device)
    return vec(alive), vec(similar)


def _step_t_fast(words: torch.Tensor):
    """TEMPORAL_GENS generations with the fast-flag kernel:
    ``(new, alive_vec, similar_vec)`` as ``_step_t`` gives them. The summary
    is read back here (one sync); the exact pass reruns only when
    ``summary_needs_replay``."""
    out, flags = torch.empty_like(words), _flags(SUMMARY_FLAGS, words.device)
    _step_t_fast_into(words, out, flags)
    return (out, *_derived_vectors(
        flags, lambda: [v.tolist() for v in _step_t(words)[1:]]))


def _plane_columns(G_ext):
    """The (h+16, 2) ghost-column plane of the JAX signatures as the two
    contiguous columns the kernel takes."""
    if G_ext.dim() != 2 or G_ext.shape[1] != 2:
        raise ValueError(f"G_ext must be (h+16, 2), got {tuple(G_ext.shape)}")
    return G_ext[:, 0].contiguous(), G_ext[:, 1].contiguous()


def _step_tgb(words, gtop, gbot, G_ext):
    """K13's signature: TEMPORAL_GENS generations of a shard from its ghost
    blocks and the ghost-column plane ``G_ext`` (west in column 0, east in
    column 1): ``(new, alive_vec, similar_vec)``, exact per generation."""
    out, flags = torch.empty_like(words), _flags(EXACT_FLAGS, words.device)
    _step_tg_into(words, gtop, gbot, *_plane_columns(G_ext), out, flags)
    return (out, *_vectors(flags))


def _check_cols4(words, cols4) -> None:
    """``cols4`` is the shard's own edge columns ``[w0, w1, w_{n-2},
    w_{n-1}]``, pre-extracted for JAX's edge strip. The kernel here reads
    them from ``words``, so the operand is only held to that."""
    if not torch.equal(cols4, torch.cat([words[:, :2], words[:, -2:]], dim=1)):
        raise ValueError("cols4 is not the shard's edge columns")


def _step_tsplit(words, gtop, gbot, cols4, G_ext):
    """K11 + K12's signature (the exact split-edge composition):
    ``(new, alive_vec, similar_vec)``."""
    _check_cols4(words, cols4)
    return _step_tgb(words, gtop, gbot, G_ext)


def _step_tsplit_fast(words, gtop, gbot, cols4, G_ext):
    """K9 + K10's signature (the fast-flag split-edge composition) for one
    shard: the summary is read back here, and the exact form reruns only
    when ``summary_needs_replay``."""
    _check_cols4(words, cols4)
    out, flags = torch.empty_like(words), _flags(SUMMARY_FLAGS, words.device)
    _step_tg_fast_into(words, gtop, gbot, *_plane_columns(G_ext), out, flags)
    return (out, *_derived_vectors(
        flags, lambda: [v.tolist() for v in _step_tgb(words, gtop, gbot, G_ext)[1:]]))


def _gate(words: torch.Tensor, topology: Topology = SINGLE_DEVICE,
          gate=supports) -> None:
    height, nwords = words.shape
    if not gate(height, nwords * BITS, topology):
        rows, cols = topology.shape
        raise ValueError(
            f"the packed kernel{' pass' if gate is supports_multi else ''} "
            f"does not take a {height}x{nwords * BITS} shard on a "
            f"{rows}x{cols} mesh (the width must be a multiple of {BITS})"
        )


def _mesh_call(into, shards, topology: Topology, nflags: int):
    """Run a ``*_into`` form over fresh buffers: ``(out, voted flags)``."""
    out = [torch.empty_like(s) for s in shards]
    flags = [_flags(nflags, s.device) for s in shards]
    into(shards, out, flags, topology)
    return out, collectives.any_flag(flags)


def packed_step(cur, topology: Topology = SINGLE_DEVICE):
    """Fused generation step on packed state: ``words -> (words, alive,
    similar)`` — K3 on the card, its plain version on the CPU. On a mesh
    ``cur`` is the list of shards and so is the new state (K5), and the
    flags are the votes."""
    if not topology.distributed:
        _gate(cur)
        return _step(cur)
    for s in cur:
        _gate(s, topology)
    out, flags = _mesh_call(packed_step_into, cur, topology, STEP_FLAGS)
    return out, flags[0] != 0, flags[1] == 0


def packed_step_multi(cur, topology: Topology = SINGLE_DEVICE):
    """TEMPORAL_GENS fused generations: ``words -> (words_T, alive_vec,
    similar_vec)`` — K1, with K2 replayed on a mid-pass exit. On a mesh
    ``cur`` is the list of shards (K7 with K8 replayed on one mesh column,
    else the ghost-plane pair): the summaries are voted across shards
    before the derivation, since one shard's summary can hide a transient
    that crossed its border."""
    if not topology.distributed:
        _gate(cur, gate=supports_multi)
        return _step_t_fast(cur)
    for s in cur:
        _gate(s, topology, supports_multi)
    out, summary = _mesh_call(packed_step_multi_into, cur, topology, SUMMARY_FLAGS)

    def exact():
        f = _mesh_call(packed_step_exact_into, cur, topology, EXACT_FLAGS)[1].tolist()
        T = TEMPORAL_GENS
        return f[:T], [1 - d for d in f[T:]]

    return (out, *_derived_vectors(summary, exact))
