"""The simulation engine: a host loop over K-generation blocks.

The port of ``gol_tpu/engine.py``'s runners, on one device or over a mesh
of shards (``parallel/mesh.py``). The JAX engine runs the whole simulation
as one ``lax.while_loop`` on the device, under ``shard_map`` on a mesh;
here the loop runs on the host and the devices run the kernels. Kernels
with a fused form take the blocked loops (``_simulate_c_block``,
``_simulate_cuda_block``): each block of K=16 generations is enqueued
without a sync and then ONE small flag tensor is read back. The packed
kernel runs a block as two 8-generation passes (K1; K7 on an R x 1 mesh;
the ghost-plane form that replaces K9-K13 on a mesh with columns) plus a
``t % 8`` single-generation tail (K3; K5 on a mesh), or, where the pass
does not take the shard (under 8 rows on a mesh), every generation singly;
the byte ``pallas`` kernel (K4; K6 on a mesh) has no multi-generation pass
and runs all of a block's generations one by one.
The host replays the exits from the per-generation flags exactly as the
JAX replays do (gol_tpu/engine.py:244-263, :359-373). A pass whose summary
hides a death or a stillness onset is rerun from the block's start with the
exact-flag pass (K2; K8 or the exact ghost-plane form on a mesh) — at most
twice per run, as in the JAX ``_derive_or_replay``.

Exactness of the blocked loop is the JAX argument unchanged: both early
exits are fixed points (an empty grid stays empty, a still life stays
still), so generations that overrun an exit inside a block leave the grid
as stopping on time would; only the counters need the exit point. The CUDA
convention's empty exit keeps the last non-empty generation, which is no
fixed point, so that block is replayed from its start state.

Every loop takes ``resume=(gen0, counter0, seg_end)`` to run one segment of
a longer run and returns ``(final, gen, counter, stopped)``, as the JAX
loops do; the segment runners carry those scalars between calls. The JAX
runners' donated carry becomes explicit buffers: three scratch buffers that
never include the caller's state, so a block's start state stays intact
while the generations ping-pong between the other two, and a runner never
writes its input. The non-fused ``lax`` kernel keeps the per-generation
loop, reading its alive flag every generation and comparing for similarity
only on the generations where the check fires.

The loops carry a state as the row-major list of its shards, one on a
single device. On a mesh every launch of a block is the halo exchange from
the pass's inputs, then one kernel per shard; the shards OR their flags
into one buffer per device, the buffers are voted (ORed) at the block's
end, and the block still reads back once. The voted summary of a mesh's
8-generation pass decides the replay, so a transient that crosses a shard
border cannot make one shard's summary lie; a replay and the CUDA
convention's empty-exit replay (K5) run on every shard from its kept start
state. Every runner takes the mesh: with one, its state is the row-major
list of shards, uint8 cells or, for the packed-state runners, int32 words.
In a multi-process run (``parallel/bootstrap.py``) the list is the
process's own shards, the exchanges reach the other ranks' shards, and
every vote (a block's flags, a replay's, the byte loop's alive and
similarity checks) is reduced across the ranks at the same point of the
loop: every rank replays the same exits from the same voted flags, leaves
the loop at the same block and issues the same collectives in the same
order.

The batched engine (``make_batch_runner``, ``simulate_batch``; the
serving batcher's compute entry) runs B independent boards in one canvas
with the same blocked design per board: each block enqueues its launches
of the batched step (B1 packed, one launch a block; B2 masked and byte,
one a generation; ``ops/stencil_batch``) without a sync, reads back one
(block x B x 2) flag tensor for the whole batch, and replays each board's
exits on the host with the solo rules.

Spans and counters are the JAX engine's, on the same sites (``obs/trace``,
``obs/registry``): ``engine.compile`` around building a whole-run runner
(``make_runner``, ``make_packed_runner``: the kernels' build and load, the
counterpart of JAX's ``compile_runner``), ``engine.segment`` around each
segment of ``_iter_segments`` (``engine_segments_total``,
``engine_generations_total``), ``engine.simulate`` around a
``simulate`` run (``engine_runs_total``, ``engine_generations_total``) and
``engine.simulate_batch`` around a ``simulate_batch`` run
(``engine_batches_total``, ``engine_boards_total``,
``engine_generations_total``; ``engine_stage_packs_total`` per staging
that packs).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import sys
import threading
from typing import Any

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig
from gol_tpu_torch.io import bitpack
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.profiler import fence
from gol_tpu_torch.ops import (Kernel, get_kernel, packed_math, resolve_kernel,
                               stencil_batch, stencil_packed, stencil_tile,
                               with_temporal_depth)
from gol_tpu_torch.parallel import collectives
from gol_tpu_torch.parallel.mesh import Mesh, Topology, gather, split, topology_for, validate_grid

logger = logging.getLogger(__name__)

_TERMINATION_BLOCK = 16

# Per-convention: (first generation value, reported count from the final gen).
_GEN_START = {Convention.C: 1, Convention.CUDA: 0}
_REPORT = {Convention.C: lambda gen: gen - 1, Convention.CUDA: lambda gen: gen}


@dataclasses.dataclass
class EngineResult:
    """Host-side view of a finished run."""

    grid: np.ndarray  # uint8 {0,1}, (height, width)
    generations: int  # the count the matching reference variant would print


# Per-board exit classification of the batched engine (index = wire code):
# a batch returns many fates per dispatch, so the reason travels with each
# board.
EXIT_GEN_LIMIT, EXIT_EMPTY, EXIT_SIMILAR = 0, 1, 2
EXIT_REASONS = ("gen_limit", "empty", "similar")


@dataclasses.dataclass
class BatchBoardResult:
    """One board's slice of a finished batch — an ``EngineResult`` plus the
    exit reason (bit-identical grid/count to a solo run of the same board)."""

    grid: np.ndarray  # uint8 {0,1}, (height, width) — cropped, not padded
    generations: int
    exit_reason: str  # one of EXIT_REASONS
    # The packed lane's board words (io/bitpack.py convention, uint32; the
    # packed mode is exact-fit, so the words ARE the cropped board), kept
    # so a packed response never re-packs. None on the byte/masked lanes.
    words: np.ndarray | None = None


class _Flags:
    """An int32 flag buffer per device the shards live on. Each shard ORs
    into its device's buffer; ``read`` votes (ORs) the buffers, and across
    the ranks of a multi-process run, and reads them back with one sync."""

    def __init__(self, n: int, state, topology: Topology):
        self.devices = [s.device for s in state]
        self.topology = topology
        self.bufs = {d: torch.zeros(n, dtype=torch.int32, device=d)
                     for d in self.devices}

    def zero_(self) -> None:
        for b in self.bufs.values():
            b.zero_()

    def slots(self, lo: int, hi: int) -> list:
        """Each shard's view of slots ``lo:hi``."""
        return [self.bufs[d][lo:hi] for d in self.devices]

    def read(self) -> list:
        return collectives.any_flag(list(self.bufs.values()), self.topology).tolist()


def _empty_like(state) -> list:
    return [torch.empty_like(s) for s in state]


class _Buffers:
    """Three scratch buffers for the carried state and the block's flags.
    The caller's state is never one of them."""

    def __init__(self, state, kernel: Kernel, block: int, topology: Topology):
        self.pool = [_empty_like(state) for _ in range(3)]
        if kernel.fused_multi is not None:
            self.tail_base = stencil_packed.SUMMARY_FLAGS * (block // kernel.multi_gens)
        else:
            self.tail_base = 0
        self.flags = _Flags(self.tail_base + stencil_packed.STEP_FLAGS * block,
                            state, topology)

    def scratch(self, start, cur):
        """A buffer holding neither the block's start state nor ``cur``."""
        return next(b for b in self.pool if b is not start and b is not cur)


def _generation(cur, kernel: Kernel, topology: Topology):
    """One generation through the kernel's fused form, into a fresh buffer."""
    out = _empty_like(cur)
    flags = _Flags(stencil_packed.STEP_FLAGS, cur, topology)
    kernel.fused(cur, out, flags.slots(0, stencil_packed.STEP_FLAGS), topology)
    return out


def _exact_passes(start, kernel: Kernel, topology: Topology):
    """Lazily rerun a block's passes from its start state with the exact-flag
    pass; ``get(j)`` is pass j's ``(alive, similar)`` lists."""
    T = kernel.multi_gens
    done = []

    def get(j: int):
        while len(done) <= j:
            src = done[-1][0] if done else start
            out = _empty_like(src)
            flags = _Flags(2 * T, src, topology)
            kernel.exact_multi(src, out, flags.slots(0, 2 * T), topology)
            f = flags.read()
            done.append((out, f[:T], [1 - d for d in f[T:]]))
        return done[j][1:]

    return get


def _any_alive(state, topology: Topology) -> bool:
    """The alive vote: any shard (of any rank) holds a live cell."""
    return bool(collectives.any_flag([s.any() for s in state], topology))


def _all_equal(cur, new, topology: Topology) -> bool:
    """The similarity vote: no shard (of any rank) differs."""
    return bool(collectives.all_agree([(a != b).any() for a, b in zip(cur, new)],
                                      topology))


def _block_generations(start, t, config: GameConfig, kernel: Kernel,
                       topology: Topology, block, bufs: _Buffers):
    """Run ``t`` generations from ``start``: ``(cur, a_all, s_all)``.

    A kernel with a multi-generation pass runs ``t // T`` passes into flag
    slots T*j..T*j+T-1 and a single-generation tail into t-rem..t-1; one
    without runs all ``t`` generations singly. The callers' replays are
    oblivious to the grouping. ``a_all``/``s_all`` are ``block``-slot host
    lists; ``s_all`` is None when the similarity check is off. Every launch
    of the block is enqueued before the one readback."""
    S, P = stencil_packed.SUMMARY_FLAGS, stencil_packed.STEP_FLAGS
    if kernel.fused_multi is not None:
        T, passes = kernel.multi_gens, t // kernel.multi_gens
    else:
        T, passes = 1, 0
    flags = bufs.flags
    flags.zero_()
    cur = start
    for j in range(passes):
        out = bufs.scratch(start, cur)
        kernel.fused_multi(cur, out, flags.slots(S * j, S * (j + 1)), topology)
        cur = out
    base = bufs.tail_base
    for i in range(passes * T, t):
        out = bufs.scratch(start, cur)
        kernel.fused(cur, out, flags.slots(base + P * i, base + P * (i + 1)),
                     topology)
        cur = out
    f = flags.read()  # the block's one device->host sync, voted over shards
    a_all, s_all = [0] * block, [0] * block
    exact = _exact_passes(start, kernel, topology)
    for j in range(passes):
        alive, similar = stencil_packed._derive_or_replay(
            f[S * j: S * (j + 1)], lambda j=j: exact(j), T
        )
        a_all[T * j: T * j + T] = alive
        s_all[T * j: T * j + T] = similar
    for i in range(passes * T, t):
        a_all[i] = f[base + P * i]
        s_all[i] = 1 - f[base + P * i + 1]
    a_all = [bool(a) for a in a_all]
    s_all = [bool(s) for s in s_all] if config.check_similarity else None
    return cur, a_all, s_all


def _replay_similarity(counter, freq, s_all, i, check: bool):
    """One replayed generation's similarity outcome: ``(similar_i, counter')``.
    The counter fires every ``freq``-th generation and resets on fire."""
    if not check:
        return False, counter
    fire = (counter + 1) == freq
    return fire and s_all[i], (0 if fire else counter + 1)


def _simulate_c_block(state, config, kernel, topology, gen0, counter0, bound,
                      block):
    """Blocked C-convention loop: K generations per flag readback, bit-exact
    with the per-generation loop (see the module docstring). The block never
    crosses ``bound`` — the generation limit is no fixed point. Returns
    ``(final, gen, counter, alive, similar)``."""
    freq = config.similarity_frequency
    bufs = _Buffers(state, kernel, block, topology)
    gen, counter = gen0, counter0
    alive, similar = _any_alive(state, topology), False
    cur = state
    while alive and not similar and gen <= bound:
        t = min(block, bound - gen + 1)
        cur, a_all, s_all = _block_generations(cur, t, config, kernel, topology,
                                               block, bufs)
        for i in range(t):
            sim_i, counter = _replay_similarity(
                counter, freq, s_all, i, config.check_similarity
            )
            alive, similar = a_all[i], sim_i
            if not sim_i:
                gen += 1
            if not (alive and not similar and gen <= bound):
                break
    return cur, gen, counter, alive, similar


def _simulate_c(state, config: GameConfig, kernel: Kernel, topology: Topology,
                resume=None, block: int | None = None):
    """C-variant loop (src/game.c:177-196): emptiness checked at the top of
    every generation; the similarity break does not increment the counter;
    the reported count is ``generation - 1``.

    ``resume`` is None for a whole run, or ``(gen0, counter0, seg_end)`` to
    run one segment of a longer one; ``block`` is a tuned plan's
    generations per flag readback (``_TERMINATION_BLOCK`` when None).
    Returns ``(final, gen, counter, stopped)``."""
    limit = config.gen_limit
    gen0, counter0, seg_end = resume if resume is not None else (1, 0, limit)
    bound = min(limit, seg_end)
    if kernel.fused is not None:
        final, gen, counter, alive, similar = _simulate_c_block(
            state, config, kernel, topology, gen0, counter0, bound,
            block or _TERMINATION_BLOCK)
        return final, gen, counter, not alive or similar or gen > limit
    freq, gen, counter = config.similarity_frequency, gen0, counter0
    cur = state
    alive, similar = _any_alive(cur, topology), False
    while alive and not similar and gen <= bound:
        new = kernel.step(cur, topology)
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and _all_equal(cur, new, topology)
            counter = 0 if fire else counter + 1
        alive = _any_alive(new, topology)
        if not similar:
            gen += 1
        cur = new
    return cur, gen, counter, not alive or similar or gen > limit


def _simulate_cuda_block(state, config, kernel, topology, gen0, counter0, bound,
                         block):
    """Blocked CUDA-convention loop: K generations per flag readback.

    A similarity exit is a still life, so the block-end state IS the exit
    state. An empty exit at in-block iteration i keeps state_i, the last
    non-empty generation: replay i single generations from the block's start
    state, which the buffer pool keeps intact (on every shard). Returns
    ``(final, gen, counter, stopped)``."""
    freq = config.similarity_frequency
    bufs = _Buffers(state, kernel, block, topology)
    gen, counter = gen0, counter0
    start = cur = state
    stopped, exit_i, exit_empty = False, 0, False
    while not stopped and gen < bound:
        t = min(block, bound - gen)
        start = cur
        cur, a_all, s_all = _block_generations(start, t, config, kernel, topology,
                                               block, bufs)
        # Flag entry i is (alive, similar) of the *new* grid of CUDA
        # iteration i; on the stop iteration gen does not advance.
        for i in range(t):
            sim_i, counter = _replay_similarity(
                counter, freq, s_all, i, config.check_similarity
            )
            empty_i = not a_all[i]
            if sim_i or empty_i:
                stopped, exit_i, exit_empty = True, i, empty_i and not sim_i
                break
            gen += 1
    final = cur
    if stopped and exit_empty:
        final = start
        for _ in range(exit_i):
            final = _generation(final, kernel, topology)
    return final, gen, counter, stopped


def _simulate_cuda(state, config: GameConfig, kernel: Kernel,
                   topology: Topology, resume=None, block: int | None = None):
    """CUDA-variant loop (src/game_cuda.cu:222-276): 0-based exclusive
    bound; no emptiness test before the first evolve; the emptiness test
    runs on the new grid and breaks before the swap, so an empty exit keeps
    the last non-empty generation; the reported count is the raw counter.
    ``resume`` and ``block`` as for ``_simulate_c``. Returns ``(final, gen,
    counter, stopped)``."""
    limit = config.gen_limit
    gen0, counter0, seg_end = resume if resume is not None else (0, 0, limit)
    bound = min(limit, seg_end)
    if kernel.fused is not None:
        final, gen, counter, stop = _simulate_cuda_block(
            state, config, kernel, topology, gen0, counter0, bound,
            block or _TERMINATION_BLOCK)
        return final, gen, counter, stop or gen >= limit
    freq, gen, counter = config.similarity_frequency, gen0, counter0
    cur, stop = state, False
    while gen < bound:
        new = kernel.step(cur, topology)
        similar = False
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and _all_equal(cur, new, topology)
            counter = 0 if fire else counter + 1
        if similar or not _any_alive(new, topology):
            stop = True
            break  # the break precedes the swap (src/game_cuda.cu:250,266)
        cur = new
        gen += 1
    return cur, gen, counter, stop or gen >= limit


_SIMULATORS = {Convention.C: _simulate_c, Convention.CUDA: _simulate_cuda}


def put_grid(grid, device=None, mesh: Mesh | None = None):
    """Place a host uint8 grid on the device, or, with a mesh, split it into
    the mesh's shards (a list) on their devices."""
    arr = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
    if mesh is not None:
        return split(arr, mesh)
    return torch.from_numpy(arr).to(platform_env.resolve_device(device))


def _apply_plan(tuned, kernel_obj: Kernel, local_h: int, local_w: int,
                topology: Topology, packed_state: bool):
    """Resolve a measured plan (``tune/``) against this build's shape.

    Returns ``(tuned, kernel_obj)`` — the plan dropped (with a loud warning)
    when its kernel cannot serve the shape or lane, the kernel swapped to
    the planned one otherwise. Depth and block apply at the call site."""
    if tuned is None or not tuned.kernel or tuned.kernel == kernel_obj.name:
        return tuned, kernel_obj
    if packed_state and tuned.kernel != "packed":
        logger.warning(
            "tuned plan names kernel %r, which cannot carry packed word "
            "state; ignoring the plan", tuned.kernel,
        )
        return None, kernel_obj
    try:
        planned = get_kernel(tuned.kernel)
    except ValueError:
        planned = None
    if planned is None or not planned.supports(local_h, local_w, topology):
        logger.warning(
            "tuned plan names kernel %r, which does not support a %dx%d "
            "shard on a %dx%d topology; ignoring the plan",
            tuned.kernel, local_h, local_w, *topology.shape,
        )
        return None, kernel_obj
    return tuned, planned


def _build_runner(shape, config: GameConfig, kernel: str, device, *,
                  segmented: bool, packed_state: bool, mesh: Mesh | None = None,
                  plan=None):
    """Shared scaffold of the four runner factories: shape, mesh and kernel
    validation, the kernels' build and load, and the simulate wrapper.

    ``packed_state`` runners take and return the (height, width/32) int32
    word tensor and never touch a uint8 grid; otherwise a kernel with its
    own carried state (packed words) converts once at the loop boundary.
    ``segmented`` runners take and return the resume scalars. With a
    ``mesh`` the runner takes and returns the row-major list of shards:
    (local_h, local_w) cells or (local_h, local_w/32) words.

    ``plan`` is a measured execution plan (``tune.space.EnginePlan``:
    kernel, temporal depth, termination block). The auto-selected lanes
    (``kernel='auto'`` and the packed-state lane) consult the plan cache
    (``tune/select.py``) when no plan is passed; an explicitly named kernel
    never does. With no plan cached this builds exactly the plan-less
    runner."""
    height, width = shape
    if height <= 0 or width <= 0:
        raise ValueError(f"grid shape must be positive, got {height}x{width}")
    topology = topology_for(mesh)
    devices = list(mesh.devices) if mesh is not None else [
        platform_env.resolve_device(device)]
    local_h, local_w = validate_grid(height, width, topology)
    tuned = plan
    if tuned is None and (kernel == "auto" or packed_state):
        from gol_tpu_torch.tune import select

        tuned = select.engine_plan(shape, config, mesh,
                                   packed_state=packed_state, device=devices[0])
    kobj = resolve_kernel("packed" if packed_state else kernel, local_h, local_w,
                          topology)
    tuned, kobj = _apply_plan(tuned, kobj, local_h, local_w, topology,
                              packed_state)
    if not kobj.supports(local_h, local_w, topology):
        hint = ("packed state has no fallback — use the unpacked lane"
                if packed_state
                else "use kernel='auto' to fall back automatically")
        raise ValueError(
            f"kernel {kobj.name!r} does not support a {local_h}x{local_w} "
            f"local shard on a {topology.shape[0]}x{topology.shape[1]} "
            f"topology; {hint}"
        )
    block = None
    if tuned is not None:
        block = tuned.termination_block or None
        if tuned.temporal_depth:
            try:
                kobj = with_temporal_depth(kobj, tuned.temporal_depth)
            except ValueError as err:
                logger.warning("tuned plan temporal depth dropped: %s", err)
    if not kobj.supports_multi(local_h, local_w, topology):
        # The 8-generation pass only where the kernel takes the shard: a
        # block then runs every generation through ``fused``.
        kobj = dataclasses.replace(kobj, fused_multi=None)
    if kobj.load is not None and any(d.type == "cuda" for d in devices):
        kobj.load()
    simulate = _SIMULATORS[config.convention]
    report = _REPORT[config.convention]
    if packed_state:
        want, what = (torch.int32, (local_h, local_w // stencil_packed.BITS)), "an int32"
        encode = decode = None
    else:
        want, what = (torch.uint8, (local_h, local_w)), "a uint8"
        encode, decode = kobj.encode, kobj.decode

    def check(shards) -> None:
        dtype, state_shape = want
        if len(shards) != len(devices):
            raise ValueError(f"runner takes {len(devices)} shards, got {len(shards)}")
        for s, dev in zip(shards, devices):
            if tuple(s.shape) != state_shape or s.dtype != dtype:
                raise ValueError(
                    f"runner takes {what} {state_shape[0]}x{state_shape[1]} "
                    f"{'shard' if mesh is not None else 'state'}, got "
                    f"{s.dtype} {tuple(s.shape)}"
                )
            if s.device != dev:
                raise ValueError(f"state is on {s.device}, runner on {dev}")

    def run_loop(state, resume):
        shards = list(state) if mesh is not None else [state]
        check(shards)
        carried = [encode(s) for s in shards] if encode is not None else shards
        final, gen, counter, stopped = simulate(carried, config, kobj, topology,
                                                resume, block)
        if decode is not None:
            final = [decode(s) for s in final]
        return (final if mesh is not None else final[0]), gen, counter, stopped

    if segmented:
        def run(state, gen0: int, counter0: int, seg_end: int):
            return run_loop(state, (gen0, counter0, seg_end))
    else:
        def run(state):
            final, gen, _, _ = run_loop(state, None)
            return final, report(gen)
    return run


def make_runner(shape: tuple[int, int], config: GameConfig = DEFAULT_CONFIG,
                kernel: str = "auto", device=None, mesh: Mesh | None = None):
    """A ``grid -> (final_grid, generations)`` runner for one grid shape.

    ``grid`` is a uint8 (height, width) tensor on ``device`` (the platform
    default — the card — when None); the final grid stays on the device.
    With a ``mesh`` the runner takes and returns the mesh's shards (a
    row-major list, ``put_grid(grid, mesh=mesh)``) and ``device`` is unused.
    Building the runner builds and loads the card's kernels, so a run's
    timing excludes them. The runner never writes its input."""
    with obs_trace.span("engine.compile"):
        return _build_runner(shape, config, kernel, device, mesh=mesh,
                             segmented=False, packed_state=False)


def make_segment_runner(shape: tuple[int, int],
                        config: GameConfig = DEFAULT_CONFIG,
                        kernel: str = "auto", device=None,
                        mesh: Mesh | None = None):
    """A resumable segment: ``(grid, gen0, counter0, seg_end) -> (grid, gen,
    counter, stopped)``.

    Running segments back to back with the carried (gen, counter) scalars
    is bit-exact with one whole run — the basis for snapshots and resume.
    The runner never writes its input: where the JAX runner donates (and
    so consumes) the state passed in, here that state stays valid. With a
    ``mesh`` the state is the list of shards, as for ``make_runner``."""
    return _build_runner(shape, config, kernel, device, mesh=mesh,
                         segmented=True, packed_state=False)


def make_packed_runner(shape: tuple[int, int],
                       config: GameConfig = DEFAULT_CONFIG, device=None,
                       mesh: Mesh | None = None):
    """A runner over packed state: ``words -> (words, generations)``.

    ``shape`` is the logical (height, width) grid shape; the operand is its
    (height, width/32) int32 word tensor (``io/packed_io`` reads and writes
    those directly, so no uint8 grid exists anywhere). The state passed in
    stays valid. With a ``mesh`` the operand and the result are the
    row-major list of (local_h, local_w/32) word shards."""
    with obs_trace.span("engine.compile"):
        return _build_runner(shape, config, "packed", device, mesh=mesh,
                             segmented=False, packed_state=True)


def make_packed_segment_runner(shape: tuple[int, int],
                               config: GameConfig = DEFAULT_CONFIG,
                               device=None, mesh: Mesh | None = None):
    """The packed analog of ``make_segment_runner``: ``(words, gen0,
    counter0, seg_end) -> (words, gen, counter, stopped)``. The state passed
    in stays valid; with a ``mesh`` it is the list of word shards."""
    return _build_runner(shape, config, "packed", device, mesh=mesh,
                         segmented=True, packed_state=True)


def resume_scalars(config: GameConfig, completed: int) -> tuple[int, int]:
    """Loop scalars ``(gen0, counter0)`` for resuming after ``completed``
    generations of a run that had not early-exited.

    Both conventions increment the similarity counter once per executed
    generation and reset it on every ``similarity_frequency``-th, so mid-run
    state needs no sidecar metadata: ``counter = completed mod frequency``.
    """
    if completed < 0:
        raise ValueError(f"completed generations must be >= 0, got {completed}")
    counter = completed % config.similarity_frequency if config.check_similarity else 0
    return _GEN_START[config.convention] + completed, counter


def _iter_segments(runner, state, config: GameConfig, segment: int,
                   completed: int = 0):
    """Drive a segment runner to completion, yielding after every segment."""
    if segment <= 0:
        raise ValueError(f"segment must be positive, got {segment}")
    report = _REPORT[config.convention]
    gen, counter = resume_scalars(config, completed)
    while True:
        seg_end = gen + segment - (1 if config.convention == Convention.C else 0)
        with obs_trace.span("engine.segment", gen0=gen, seg_end=seg_end):
            prev = gen
            state, gen, counter, stopped = runner(state, gen, counter, seg_end)
            # The span measures the segment's device work, not its enqueue.
            fence(state)
        reg = obs_registry.default()
        reg.inc("engine_segments_total")
        reg.inc("engine_generations_total", max(0, gen - prev))
        yield report(gen), state, stopped
        if stopped:
            return


def simulate_segments(grid, config: GameConfig = DEFAULT_CONFIG,
                      kernel: str = "auto", segment: int = 100,
                      completed: int = 0, device=None,
                      mesh: Mesh | None = None):
    """Generator of ``(generations_so_far, device_grid, stopped)`` per segment.

    The same final grid and reported count as one ``simulate`` call, but
    control returns to the caller every ``segment`` generations so it can
    snapshot, log or stop. ``completed`` resumes: the grid is taken to be
    the state after that many generations of a longer run, and the loop
    continues to ``config.gen_limit`` with the similarity phase realigned
    (``resume_scalars``). Every yielded state stays valid. With a ``mesh``
    ``grid`` is a host grid and the yielded states are lists of shards."""
    if mesh is not None:
        runner = make_segment_runner(tuple(np.shape(grid)), config, kernel,
                                     mesh=mesh)
        state = put_grid(grid, mesh=mesh)
    else:
        dev = platform_env.resolve_device(device)
        runner = make_segment_runner(tuple(grid.shape), config, kernel, dev)
        state = grid if isinstance(grid, torch.Tensor) else put_grid(grid, dev)
    yield from _iter_segments(runner, state, config, segment, completed)


def simulate_packed_segments(words, shape: tuple[int, int],
                             config: GameConfig = DEFAULT_CONFIG,
                             segment: int = 100, completed: int = 0,
                             device=None, mesh: Mesh | None = None):
    """Packed-state counterpart of ``simulate_segments``: ``shape`` is the
    logical (height, width), ``words`` its (height, width/32) int32 tensor
    or, with a ``mesh``, the list of its word shards. Yields word state,
    which every consumer writes back through ``io/packed_io``."""
    runner = make_packed_segment_runner(shape, config, device, mesh=mesh)
    yield from _iter_segments(runner, words, config, segment, completed)


def simulate(grid, config: GameConfig = DEFAULT_CONFIG, kernel: str = "auto",
             device=None, mesh: Mesh | None = None) -> EngineResult:
    """Run a full simulation (over the mesh's shards, given one) and fetch
    the result to the host. As in JAX, the run is one ``engine.simulate``
    span and the runner's build no ``engine.compile`` span."""
    shape = tuple(np.shape(grid))
    if mesh is None:
        device = platform_env.resolve_device(device)
    runner = _build_runner(shape, config, kernel, device, mesh=mesh,
                           segmented=False, packed_state=False)
    state = put_grid(grid, device, mesh)
    with obs_trace.span("engine.simulate", shape=f"{shape[0]}x{shape[1]}",
                        convention=config.convention):
        final, generations = runner(state)
        fence(final)  # the span measures the run, not its enqueue
    reg = obs_registry.default()
    reg.inc("engine_runs_total")
    reg.inc("engine_generations_total", generations)
    if mesh is not None:
        if mesh.owners is not None:
            raise ValueError(
                "simulate fetches the whole grid to one host, which a "
                "multi-process mesh never holds; write it with io/sharded "
                "instead")
        final = gather(final, mesh.shape)
    return EngineResult(final.cpu().numpy(), generations)


# ---------------------------------------------------------------------------
# Batched engine (the serve/batcher.py compute entry).
#
# B independent boards share one canvas and one host loop. The JAX package
# runs the batch as one lax.while_loop over vmapped steps with per-board
# freeze masks (gol_tpu/engine.py:1129-1249); here each block of the solo
# engine's length enqueues the batched step without a sync (B1 for
# "packed": one launch for the whole block; B2 for "masked" and "byte":
# one launch per generation), then reads back ONE (block x B x 2) flag
# tensor, and the host replays each board's exits with the solo rules. A
# board whose generation limit falls inside the block is given fewer
# steps (``steps[b]``) and copied through once they are spent, so no block crosses a board's limit; boards that exit early
# run on to their steps, which is exact for the same reason the solo block
# is (both early exits are fixed points), and the CUDA convention's empty
# exit replays that board alone from the block's start state.
#
# Three step flavors, chosen per bucket (``resolve_batch_mode``):
#   "packed" — boards exactly fill the canvas and the width packs: B1 on
#              host-packed words (32 cells/word);
#   "byte"   — boards exactly fill the canvas: B2 with the canvas's extent
#              (JAX's vmapped byte roll stencil, the same cells);
#   "masked" — boards smaller than the canvas: B2, each board wrapping at
#              its own (h, w), so one runner serves mixed shapes.
# ---------------------------------------------------------------------------

BATCH_MODES = ("packed", "byte", "masked")


def _validate_batch_params(padded_shape, batch: int, mode: str,
                           convention: str, temporal_depth: int) -> None:
    """The batch runner factory's validation, with the JAX package's
    messages."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if mode not in BATCH_MODES:
        raise ValueError(f"unknown batch mode {mode!r}; one of {BATCH_MODES}")
    if mode == "packed" and padded_shape[1] % 32 != 0:
        raise ValueError(
            f"packed batch mode needs width % 32 == 0, got {padded_shape[1]}"
        )
    if convention not in _BATCH_SIMULATORS:
        raise ValueError(f"unknown convention: {convention!r}")
    if not 1 <= temporal_depth <= 64:
        raise ValueError(
            f"temporal_depth must be in [1, 64], got {temporal_depth}"
        )


def resolve_batch_mode(
    heights, widths, padded_shape: tuple[int, int]
) -> str:
    """Pick the step flavor for a set of boards sharing one padded canvas."""
    ph, pw = padded_shape
    if any(h > ph or w > pw for h, w in zip(heights, widths)):
        raise ValueError(
            f"board exceeds the {ph}x{pw} padded canvas: "
            f"{list(zip(heights, widths))}"
        )
    if all(h == ph and w == pw for h, w in zip(heights, widths)):
        # The host-side bit packing assumes a little-endian host (bit j of
        # a word = column 32w+j via np.packbits + a uint32 view); big-endian
        # hosts take the byte lane instead of scrambling columns.
        return (
            "packed" if pw % 32 == 0 and sys.byteorder == "little" else "byte"
        )
    return "masked"


def _pack_board_words(stacked: np.ndarray) -> np.ndarray:
    """(B, H, W) uint8 cells -> (B, H, W/32) uint32 words on the host
    (``io/bitpack.py``: bit j of word w = column 32w+j)."""
    return bitpack.pack_words(stacked)


def _unpack_board_words(words: np.ndarray) -> np.ndarray:
    """Inverse of ``_pack_board_words``: words -> (B, H, W) uint8 cells."""
    return bitpack.unpack_words(words)


class _BatchBuffers:
    """Three scratch board stacks and the block's flags, (block, B, 2). The
    caller's stack is never one of them, so a block's start state survives
    it (the CUDA convention's empty-exit replay reads it)."""

    def __init__(self, state: torch.Tensor, block: int):
        self.pool = [torch.empty_like(state) for _ in range(3)]
        self.flags = torch.zeros((block, state.shape[0], stencil_batch.STEP_FLAGS),
                                 dtype=torch.int32, device=state.device)

    def first(self, n: int) -> "_BatchBuffers":
        """The same storage over its first ``n`` boards (a ring drain of
        fewer boards than the buffers hold); nothing is allocated."""
        view = object.__new__(_BatchBuffers)
        view.pool = [b[:n] for b in self.pool]
        # A contiguous (block, n, 2) over the same storage: B1's block form
        # stores generation i's pair of board b at row i * n + b.
        block = self.flags.shape[0]
        view.flags = self.flags.view(-1)[:block * n * stencil_batch.STEP_FLAGS] \
            .view(block, n, stencil_batch.STEP_FLAGS)
        return view

    def scratch(self, start, cur):
        return next(b for b in self.pool if b is not start and b is not cur)


def _batch_block(start, steps: np.ndarray, run_block, bufs: _BatchBuffers):
    """Run board b of ``start`` for ``steps[b]`` generations (the others
    copied through): ``(cur, alive, similar)``, the last two (T, B) bool
    host arrays of generation i's new board, T = max(steps). The block's
    launches are all enqueued before its one readback."""
    t = int(steps.max())
    flags = bufs.flags[:t]
    flags.zero_()
    steps_dev = torch.from_numpy(steps.astype(np.int32)).to(start.device)
    out = bufs.scratch(start, start)
    run_block(start, out, flags, steps_dev, t, bufs.scratch(start, out))
    f = flags.cpu().numpy()  # the block's one device->host sync
    return out, f[:, :, 0] != 0, f[:, :, 1] == 0


def _quiet_boards(alive, similar, steps, counter, freq: int, check: bool):
    """The boards that meet no exit in their steps of the block: alive at
    every generation and similar at no generation where their counter
    fires. Their replay is closed-form (``gen += steps``, the counter
    advanced mod ``freq``); the others replay generation by generation."""
    i = np.arange(alive.shape[0])[:, None]
    exits = ~alive
    if check:
        fires = (counter[None, :] + i + 1) % freq == 0
        exits = exits | (fires & similar)
    return ~(exits & (i < steps[None, :])).any(axis=0)


def _advance_quiet(quiet, steps, gen, counter, freq: int, check: bool) -> None:
    gen[quiet] += steps[quiet]
    if check:
        counter[quiet] = (counter[quiet] + steps[quiet]) % freq


def _batch_alive(state: torch.Tensor) -> np.ndarray:
    return state.reshape(state.shape[0], -1).ne(0).any(dim=1).cpu().numpy()


def _batch_simulate_c(state0, limits, run_block, replay, check: bool, freq: int,
                      block: int, bufs: _BatchBuffers | None = None):
    """Batched C-convention loop: per board the replay of
    ``_simulate_c_block`` (oracle._run_c is the semantics contract).
    ``bufs`` are a ring's preallocated buffers (fresh ones when None).
    Returns ``(final, generations, exit_reasons)``."""
    b = state0.shape[0]
    gen = np.ones(b, np.int64)
    counter = np.zeros(b, np.int64)
    alive = _batch_alive(state0)
    similar = np.zeros(b, bool)
    bufs = bufs or _BatchBuffers(state0, block)
    cur = state0
    while True:
        run = alive & ~similar & (gen <= limits)
        if not run.any():
            break
        steps = np.where(run, np.minimum(block, limits - gen + 1), 0)
        cur, a, s = _batch_block(cur, steps, run_block, bufs)
        quiet = run & _quiet_boards(a, s, steps, counter, freq, check)
        _advance_quiet(quiet, steps, gen, counter, freq, check)
        for j in np.flatnonzero(run & ~quiet):
            g, c = int(gen[j]), int(counter[j])
            for i in range(int(steps[j])):
                sim_i, c = _replay_similarity(c, freq, s[:, j], i, check)
                alive[j], similar[j] = a[i, j], sim_i
                if not sim_i:
                    g += 1
                if not (alive[j] and not similar[j] and g <= limits[j]):
                    break
            gen[j], counter[j] = g, c
    reason = np.where(similar, EXIT_SIMILAR,
                      np.where(~alive, EXIT_EMPTY, EXIT_GEN_LIMIT))
    return cur, gen - 1, reason  # reported count is gen-1 (src/game.c:202)


def _batch_simulate_cuda(state0, limits, run_block, replay, check: bool, freq: int,
                         block: int, bufs: _BatchBuffers | None = None):
    """Batched CUDA-convention loop: per board the replay of
    ``_simulate_cuda_block``; a board's empty exit at in-block iteration i
    keeps its state i, replayed from the block's start state for that board
    alone. ``bufs`` as for ``_batch_simulate_c``. Returns ``(final,
    generations, exit_reasons)``."""
    b = state0.shape[0]
    gen = np.zeros(b, np.int64)
    counter = np.zeros(b, np.int64)
    stop = np.zeros(b, bool)
    reason = np.full(b, EXIT_GEN_LIMIT, np.int64)
    bufs = bufs or _BatchBuffers(state0, block)
    cur = state0
    while True:
        run = ~stop & (gen < limits)
        if not run.any():
            break
        steps = np.where(run, np.minimum(block, limits - gen), 0)
        start = cur
        cur, a, s = _batch_block(start, steps, run_block, bufs)
        quiet = run & _quiet_boards(a, s, steps, counter, freq, check)
        _advance_quiet(quiet, steps, gen, counter, freq, check)
        for j in np.flatnonzero(run & ~quiet):
            c = int(counter[j])
            for i in range(int(steps[j])):
                sim_i, c = _replay_similarity(c, freq, s[:, j], i, check)
                empty_i = not a[i, j]
                if sim_i or empty_i:
                    # Similarity is checked before emptiness
                    # (src/game_cuda.cu:238-259).
                    stop[j] = True
                    reason[j] = EXIT_SIMILAR if sim_i else EXIT_EMPTY
                    if not sim_i:  # the break precedes the swap
                        cur[j].copy_(replay(start, int(j), i))
                    break
                gen[j] += 1
            counter[j] = c
    return cur, gen, reason  # reported count is the raw counter


_BATCH_SIMULATORS = {
    Convention.C: _batch_simulate_c,
    Convention.CUDA: _batch_simulate_cuda,
}


def _batch_block_step(mode: str, heights: torch.Tensor, widths: torch.Tensor):
    """The mode's block of generations over a (B', ...) slice of the stack
    starting at board ``lo``: ``block(src, out, flags, steps, t, scratch,
    lo=0)`` runs board b for ``min(steps[b], t)`` generations from ``src``
    into ``out``, generation i's flags in ``flags[i]`` ((t, B', 2), zeroed
    by the caller); ``scratch`` is a third stack, and ``src`` is never
    written. Packed: one B1 call for the block; masked and byte: one B2
    call, each board's extents sliced from ``heights``/``widths``."""
    if mode == "packed":
        return lambda src, out, flags, steps, t, scratch, lo=0: (
            stencil_batch.batch_packed_block_into(src, out, flags, steps, t,
                                                  scratch))

    def masked(src, out, flags, steps, t, scratch, lo=0):
        hs, ws = heights[lo:lo + src.shape[0]], widths[lo:lo + src.shape[0]]
        stencil_batch.batch_masked_block_into(src, out, flags, steps, hs, ws, t,
                                              scratch)
    return masked


def _batch_block_length(temporal_depth: int) -> int:
    """Generations per flag readback of the batched loop: the solo block,
    rounded up to a multiple of ``temporal_depth``."""
    return -(-_TERMINATION_BLOCK // temporal_depth) * temporal_depth


def _board_replay(run_block):
    """``replay(start, b, i)``: board b of ``start`` after i generations,
    run alone (one block call on a one-board stack, ``steps = [i]``) so
    the rest of the batch is untouched."""
    def replay(start, b: int, i: int) -> torch.Tensor:
        x = start[b:b + 1]
        if i == 0:
            return x[0]
        out, scratch = torch.empty_like(x), torch.empty_like(x)
        flags = torch.zeros((i, 1, stencil_batch.STEP_FLAGS), dtype=torch.int32,
                            device=x.device)
        steps = torch.tensor([i], dtype=torch.int32, device=x.device)
        run_block(x, out, flags, steps, i, scratch, lo=b)
        return out[0]
    return replay


@functools.lru_cache(maxsize=256)
def make_batch_runner(
    padded_shape: tuple[int, int],
    batch: int,
    convention: str = Convention.C,
    check_similarity: bool = True,
    similarity_frequency: int = DEFAULT_CONFIG.similarity_frequency,
    mode: str = "masked",
    temporal_depth: int = 1,
):
    """A B-board runner: ``(boards, heights, widths, limits) -> (finals,
    generations, exit_reasons)``.

    ``boards`` is a (B, PH, PW) uint8 tensor with dead padding — except in
    "packed" mode, where it (and the returned state) is the (B, PH, PW/32)
    int32 word tensor of the host-packed words (``_pack_board_words``), so
    no encode/decode runs on the device. ``heights``/``widths`` give each
    board's true extent ((B,) ints, consumed only by the masked mode but
    always part of the signature); ``limits`` is each board's OWN
    generation bound, a runtime operand, so jobs with different
    ``gen_limit`` share one runner. The finals stay on the boards' device;
    generations and exit reasons are (B,) host arrays. The runner never
    writes its input.

    ``temporal_depth`` (the JAX package's generations per while iteration)
    is validated as there and only groups generations here: a block runs a
    multiple of it, bit-exact at any value. The kernels build at the first
    launch (``batcher.warm`` pays it ahead of traffic).
    """
    _validate_batch_params(padded_shape, batch, mode, convention,
                           temporal_depth)
    block = _batch_block_length(temporal_depth)
    dtype, board = _board_state(padded_shape, mode)
    state_shape = (batch, *board)

    def run(boards: torch.Tensor, heights, widths, limits):
        if tuple(boards.shape) != state_shape or boards.dtype != dtype:
            raise ValueError(f"batch runner takes {dtype} {state_shape}, got "
                             f"{boards.dtype} {tuple(boards.shape)}")
        return _run_batch_loop(boards, (heights, widths, limits), mode,
                               padded_shape, convention, check_similarity,
                               similarity_frequency, block)

    return run


def _board_state(padded_shape, mode: str):
    """``(dtype, board shape)`` of one board of a batch stack."""
    ph, pw = padded_shape
    if mode == "packed":
        return torch.int32, (ph, pw // stencil_packed.BITS)
    return torch.uint8, (ph, pw)


def _run_batch_loop(boards, vectors, mode, padded_shape, convention, check,
                    freq, block, bufs=None):
    """The batched loop over ``boards`` (B, ...) with per-board
    ``(heights, widths, limits)``: ``(final, generations, exit_reasons)``."""
    ph, pw = padded_shape
    batch = boards.shape[0]
    vectors = [np.asarray(v, dtype=np.int64).reshape(-1) for v in vectors]
    if any(v.shape != (batch,) for v in vectors):
        raise ValueError(f"heights, widths and limits take {batch} values each")
    h, w, lim = vectors
    if mode == "byte":
        h, w = np.full(batch, ph), np.full(batch, pw)
    if (h < 1).any() or (h > ph).any() or (w < 1).any() or (w > pw).any():
        raise ValueError(f"board extents must lie in 1..{ph} x 1..{pw}")
    dev = boards.device
    run_block = _batch_block_step(mode, torch.from_numpy(h.astype(np.int32)).to(dev),
                                  torch.from_numpy(w.astype(np.int32)).to(dev))
    return _BATCH_SIMULATORS[convention](boards, lim, run_block,
                                         _board_replay(run_block), check, freq,
                                         block, bufs)


@dataclasses.dataclass
class StagedBatch:
    """Host-side operands of one batch, ready to dispatch: all CPU work —
    stacking, zero-padding, ``packbits`` — done, nothing on the device. The
    host operand is retained so a retry re-dispatches without re-staging."""

    runner: Any
    operand: np.ndarray  # (total, PH, PW) uint8, or packed (total, PH, PW/32)
    h_arr: np.ndarray
    w_arr: np.ndarray
    limits: np.ndarray
    heights: list
    widths: list
    mode: str
    padded_shape: tuple[int, int]
    boards: int  # real board count (<= total)
    total: int  # padded batch slots the runner runs
    convention: str = Convention.C
    check_similarity: bool = True
    similarity_frequency: int = DEFAULT_CONFIG.similarity_frequency
    temporal_depth: int = 1


@dataclasses.dataclass
class InflightBatch:
    """One dispatched batch: the final stack on the device, the per-board
    counts and reasons, and the staging it came from; ``complete_batch``
    fetches and crops."""

    staged: StagedBatch
    finals: Any  # the final board stack, on the device
    gens: Any
    reasons: Any


def stage_batch(
    boards,
    configs,
    padded_shape: tuple[int, int] | None = None,
    pad_batch_to: int | None = None,
    temporal_depth: int = 1,
    packed_boards=None,
) -> StagedBatch | None:
    """Host staging for ``simulate_batch``: validate, stack, pad, pack.

    Returns None for an empty board list. Pure host work. Packing happens
    exactly once per staging (``engine_stage_packs_total`` counts the
    ``packbits`` passes). ``packed_boards`` (aligned with ``boards``; each
    board's pre-packed (H, W/32) uint32 words, or None) is the
    zero-re-pack lane: when the batch resolves to the packed mode and
    EVERY board carries words, the operand is assembled from them and no
    ``packbits`` pass runs; any board without words falls the batch back to
    stack-and-pack."""
    boards = [np.ascontiguousarray(np.asarray(b, dtype=np.uint8)) for b in boards]
    if not boards:
        return None
    if isinstance(configs, GameConfig):
        configs = [configs] * len(boards)
    configs = list(configs)
    if len(configs) != len(boards):
        raise ValueError(
            f"{len(boards)} boards but {len(configs)} configs"
        )
    head = configs[0]
    for c in configs[1:]:
        if (
            c.convention != head.convention
            or c.check_similarity != head.check_similarity
            or c.similarity_frequency != head.similarity_frequency
        ):
            raise ValueError(
                "boards in one batch must share convention and similarity "
                "settings (only gen_limit may vary); split into buckets"
            )
    heights = [b.shape[0] for b in boards]
    widths = [b.shape[1] for b in boards]
    if padded_shape is None:
        padded_shape = (max(heights), max(widths))
    mode = resolve_batch_mode(heights, widths, padded_shape)
    b = len(boards)
    total = max(b, pad_batch_to or b)
    ph, pw = padded_shape
    h_arr = np.ones((total,), np.int32)
    w_arr = np.ones((total,), np.int32)
    h_arr[:b] = heights
    w_arr[:b] = widths
    # Padding slots: zero boards with limit 0 never run in either convention.
    limits = np.zeros((total,), np.int32)
    limits[:b] = [c.gen_limit for c in configs]
    runner = make_batch_runner(
        padded_shape, total, head.convention,
        head.check_similarity, head.similarity_frequency, mode,
        temporal_depth,
    )
    words = None
    if (
        mode == "packed"
        and packed_boards is not None
        and len(packed_boards) == b
        and all(w is not None for w in packed_boards)
    ):
        words = np.zeros((total, ph, pw // 32), np.uint32)
        for i, w in enumerate(packed_boards):
            w = np.ascontiguousarray(np.asarray(w, dtype=np.uint32))
            if w.shape != (ph, pw // 32):
                raise ValueError(
                    f"packed board {i} has word shape {w.shape}; the "
                    f"{ph}x{pw} packed canvas needs ({ph}, {pw // 32})"
                )
            words[i] = w
    if mode == "packed" and words is not None:
        # The zero-re-pack lane: no cell canvas, no np.packbits pass, and
        # engine_stage_packs_total deliberately not incremented.
        operand = words
    else:
        stacked = np.zeros((total, ph, pw), np.uint8)
        for i, board in enumerate(boards):
            stacked[i, : heights[i], : widths[i]] = board
        if mode == "packed":
            operand = _pack_board_words(stacked)
            obs_registry.default().inc("engine_stage_packs_total")
        else:
            operand = stacked
    return StagedBatch(
        runner=runner, operand=operand, h_arr=h_arr, w_arr=w_arr,
        limits=limits, heights=heights, widths=widths, mode=mode,
        padded_shape=padded_shape, boards=b, total=total,
        convention=head.convention,
        check_similarity=head.check_similarity,
        similarity_frequency=head.similarity_frequency,
        temporal_depth=temporal_depth,
    )


def dispatch_batch(staged: StagedBatch, device=None) -> InflightBatch:
    """Dispatch a staged batch: upload its operand (a fresh device tensor
    built from the retained host array, which is never written) and run
    the loop, which syncs once per block. Dispatching the same staging
    twice — the retry path — is safe and idempotent."""
    dev = platform_env.resolve_device(device)
    if staged.mode == "packed":
        operand = packed_math.words_from_numpy(staged.operand, dev)
    else:
        operand = torch.from_numpy(np.array(staged.operand, np.uint8)).to(dev)
    finals, gens, reasons = staged.runner(
        operand, staged.h_arr, staged.w_arr, staged.limits)
    return InflightBatch(staged=staged, finals=finals, gens=gens,
                         reasons=reasons)


def _collect_board_results(staged: StagedBatch, finals, gens, reasons
                           ) -> list[BatchBoardResult]:
    """Crop one batch's fetched results (host arrays; the packed mode's
    finals as uint32 words) back into per-board slices."""
    finals = np.asarray(finals)
    final_words = None
    if staged.mode == "packed":
        final_words = finals
        finals = _unpack_board_words(finals)
    finals = np.asarray(finals, dtype=np.uint8)
    gens = np.asarray(gens)
    reasons = np.asarray(reasons)
    b = staged.boards
    reg = obs_registry.default()
    reg.inc("engine_batches_total")
    reg.inc("engine_boards_total", b)
    reg.inc("engine_generations_total", int(gens[:b].sum()))
    return [
        BatchBoardResult(
            grid=finals[i, : staged.heights[i], : staged.widths[i]].copy(),
            generations=int(gens[i]),
            exit_reason=EXIT_REASONS[int(reasons[i])],
            words=(
                np.asarray(final_words[i], dtype=np.uint32).copy()
                if final_words is not None else None
            ),
        )
        for i in range(b)
    ]


def complete_batch(inflight: InflightBatch) -> list[BatchBoardResult]:
    """Fetch an in-flight batch's results and crop per-board slices."""
    finals = inflight.finals
    if inflight.staged.mode == "packed":
        host = packed_math.words_to_numpy(finals)
    else:
        host = finals.cpu().numpy()
    return _collect_board_results(inflight.staged, host, inflight.gens,
                                  inflight.reasons)


def simulate_batch(
    boards,
    configs,
    padded_shape: tuple[int, int] | None = None,
    pad_batch_to: int | None = None,
    temporal_depth: int = 1,
    device=None,
) -> list[BatchBoardResult]:
    """Run many independent boards in ONE batched loop.

    ``boards`` is a sequence of (h, w) uint8 arrays; ``configs`` one
    ``GameConfig`` shared by all boards or a sequence of per-board configs.
    All configs must agree on convention/similarity settings; ``gen_limit``
    may differ per board (a runtime operand). Boards are zero-padded into a
    shared ``padded_shape`` canvas (default: the max extent over the batch)
    and, when ``pad_batch_to`` exceeds the board count, inert zero boards
    fill the remaining slots so a handful of request sizes reuse one runner.
    ``stage_batch`` -> ``dispatch_batch`` -> ``complete_batch`` back to back.

    Each returned (grid, generations, exit_reason) is bit-identical to a solo
    ``simulate`` run of the same board (test-pinned for both conventions,
    including boards that exit early inside a still-running batch).
    """
    staged = stage_batch(boards, configs, padded_shape, pad_batch_to,
                         temporal_depth)
    if staged is None:
        return []
    ph, pw = staged.padded_shape
    with obs_trace.span("engine.simulate_batch", boards=staged.boards,
                        slots=staged.total, canvas=f"{ph}x{pw}",
                        mode=staged.mode):
        return complete_batch(dispatch_batch(staged, device))


# ---------------------------------------------------------------------------
# Resident ring engine (the serve/resident.py compute entry).
#
# ``dispatch_batch`` runs a batch's whole loop before it returns, so a
# pipelined scheduler overlaps only staging and journaling with the card.
# A ring runner owns, for one bucket geometry and batch rung, the device
# storage of R slots of B boards and everything a drain needs, allocated
# once and reused by every drain:
#
# - two slot storages of R*B boards (uint8 cells or packed int32 words) that
#   take turns per drain. A refill (``fill``) copies a staged host operand
#   through a pinned buffer into slot i of the open storage on the runner's
#   copy stream and records an event, so slots refill while the previous
#   drain computes. A storage is refilled only after the last drain that
#   read it has finished its loop (a host-side event the drain thread sets
#   after its final sync), so no refill writes a board an unfinished drain
#   still reads;
# - the batched loop's three scratch stacks and its flag buffer, sized for
#   R*B boards (``_BatchBuffers``);
# - a compute stream and a drain thread. A drain of k filled slots runs the
#   batched loop ONCE over the first k*B boards of its storage: one B1
#   launch per block (B2: per generation) and one flag readback per block
#   for the whole drain, never over R*B boards (JAX's compile-for-filled).
#   It waits on the slots' copy events first. Each board keeps its own limit and extent, so
#   per-slot results equal ``complete_batch`` of the same staging bit for
#   bit. ``dispatch_ring`` returns at once; the drain thread runs the host
#   loop (it must read flags back once per block), copies the finals to the
#   host and resolves the drain, and ``complete_ring`` waits for that.
#
# On the CPU the same code runs with the kernels' plain versions, host
# copies and no streams. The drain thread is started when a drain is posted
# and exits when none is pending, so no thread outlives the work;
# ``RingRunner.close`` joins it.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotFill:
    """One refilled slot: the storage it went into, the copy's event on the
    card (None on the CPU) and the pinned host buffer the copy reads, kept
    alive until the event has passed."""

    storage: int
    slot: int
    event: Any = None
    pinned: Any = None


class RingRunner:
    """The device side of one resident ring (see the section comment)."""

    def __init__(self, padded_shape: tuple[int, int], batch: int, ring: int,
                 convention: str = Convention.C, check_similarity: bool = True,
                 similarity_frequency: int = DEFAULT_CONFIG.similarity_frequency,
                 mode: str = "masked", temporal_depth: int = 1, device=None,
                 thread_name: str = "gol-ring-drain"):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        _validate_batch_params(padded_shape, batch, mode, convention,
                               temporal_depth)
        self.geometry = (tuple(padded_shape), batch, convention,
                         check_similarity, similarity_frequency, mode,
                         temporal_depth)
        self.batch, self.ring = batch, ring
        self.device = platform_env.resolve_device(device)
        self._block = _batch_block_length(temporal_depth)
        dtype, board = _board_state(padded_shape, mode)
        self._storage = [torch.zeros((ring * batch, *board), dtype=dtype,
                                     device=self.device) for _ in range(2)]
        self._free = [threading.Event(), threading.Event()]
        for ev in self._free:
            ev.set()
        self._open = 0  # the storage the next drain binds
        self._bufs = _BatchBuffers(self._storage[0], self._block)
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._compute_stream = torch.cuda.Stream(self.device) if cuda else None
        self._thread_name = thread_name
        self._lock = threading.Lock()  # the pending drains and the thread
        self._pending: collections.deque = collections.deque()
        self._thread: threading.Thread | None = None
        # Serialises fill-then-dispatch for callers without a lane of their
        # own (``dispatch_ring`` without device slots).
        self.host_lock = threading.RLock()

    def fill(self, slot: int, operand: np.ndarray) -> SlotFill:
        """Copy one staged host operand ((B, ...) cells or uint32 words)
        into slot ``slot`` of the open storage; waits while the last drain
        that read that storage is unfinished."""
        if not 0 <= slot < self.ring:
            raise ValueError(f"slot {slot} outside the ring of {self.ring}")
        idx = self._open
        view = self._storage[idx][slot * self.batch:(slot + 1) * self.batch]
        arr = np.ascontiguousarray(operand)
        if view.dtype == torch.int32:
            arr = arr.astype(np.uint32, copy=False).view(np.int32)
        host = torch.from_numpy(arr)
        if tuple(host.shape) != tuple(view.shape):
            raise ValueError(f"slot operand is {tuple(host.shape)}, the ring's "
                             f"slots hold {tuple(view.shape)}")
        self._free[idx].wait()
        if self._copy_stream is None:
            view.copy_(host)
            return SlotFill(idx, slot)
        pinned = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            view.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return SlotFill(idx, slot, event, pinned)

    def dispatch(self, sr: "StagedRing", fills: list[SlotFill]) -> "InflightRing":
        """Bind the open storage's first ``len(sr.staged)`` slots to a drain
        and post it to the drain thread; returns without blocking."""
        idx = self._open
        if [(f.storage, f.slot) for f in fills] != [
                (idx, i) for i in range(len(sr.staged))]:
            raise ValueError("a drain takes the open storage's slots 0..k-1, "
                             "refilled in slot order")
        self._free[idx].clear()
        self._open = 1 - idx
        inflight = InflightRing(staged_ring=sr, storage=idx, fills=fills)
        with self._lock:
            self._pending.append(inflight)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain_loop, name=self._thread_name,
                    daemon=True)
                self._thread.start()
        return inflight

    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None
                    return
                inflight = self._pending.popleft()
            self._run(inflight)

    def _run(self, inflight: "InflightRing") -> None:
        padded_shape, batch, convention, check, freq, mode, _ = self.geometry
        staged = inflight.staged_ring.staged
        n = len(staged) * batch
        stream = self._compute_stream
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                for f in inflight.fills:
                    if f.event is not None:
                        stream.wait_event(f.event)
                vectors = [np.concatenate([getattr(s, name) for s in staged])
                           for name in ("h_arr", "w_arr", "limits")]
                finals, gens, reasons = _run_batch_loop(
                    self._storage[inflight.storage][:n], vectors, mode,
                    padded_shape, convention, check, freq, self._block,
                    self._bufs.first(n))
                if mode == "packed":
                    host = packed_math.words_to_numpy(finals)
                else:
                    host = finals.cpu().numpy()
            inflight.finals, inflight.gens, inflight.reasons = host, gens, reasons
        except BaseException as err:  # noqa: BLE001 - carried to the waiters
            inflight.error = err
            if stream is not None:
                try:
                    stream.synchronize()  # nothing may still read the slots
                except RuntimeError:
                    pass
        finally:
            self._free[inflight.storage].set()
            inflight.done.set()

    def close(self) -> None:
        """Join the drain thread (it finishes the pending drains first)."""
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join()


@functools.lru_cache(maxsize=32)
def make_ring_runner(
    padded_shape: tuple[int, int],
    batch: int,
    ring: int,
    convention: str = Convention.C,
    check_similarity: bool = True,
    similarity_frequency: int = DEFAULT_CONFIG.similarity_frequency,
    mode: str = "masked",
    temporal_depth: int = 1,
    device=None,
) -> RingRunner:
    """The shared R-slot ring runner of one geometry on ``device`` (cached,
    as JAX caches its compiled drain). A resident lane builds its own
    ``RingRunner`` instead, so that its storage and drain thread are its
    own."""
    return RingRunner(padded_shape, batch, ring, convention, check_similarity,
                      similarity_frequency, mode, temporal_depth, device)


@dataclasses.dataclass
class StagedRing:
    """Up to ``ring`` staged batches bound to one ring runner."""

    runner: Any
    staged: list  # StagedBatch per FILLED slot, in slot order
    ring: int


@dataclasses.dataclass
class InflightRing:
    """One dispatched drain. The drain thread sets ``finals`` (the host
    copy of its k*B final boards; uint32 words in the packed mode),
    ``gens`` and ``reasons``, or ``error``, then ``done``."""

    staged_ring: StagedRing
    storage: int = 0
    fills: list = dataclasses.field(default_factory=list)
    finals: Any = None
    gens: Any = None
    reasons: Any = None
    error: BaseException | None = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


def stage_ring(staged_batches: list, ring: int, runner: RingRunner | None = None
               ) -> StagedRing:
    """Bind staged batches (same bucket geometry) to an R-slot ring runner:
    ``runner``, or the shared one of their geometry."""
    if not staged_batches:
        raise ValueError("cannot stage an empty ring")
    if len(staged_batches) > ring:
        raise ValueError(
            f"{len(staged_batches)} staged batches exceed the ring of {ring}"
        )
    head = staged_batches[0]
    for s in staged_batches[1:]:
        if (
            s.padded_shape != head.padded_shape
            or s.total != head.total
            or s.mode != head.mode
            or s.convention != head.convention
            or s.check_similarity != head.check_similarity
            or s.similarity_frequency != head.similarity_frequency
            or s.temporal_depth != head.temporal_depth
        ):
            raise ValueError(
                "staged batches in one ring must share the bucket geometry "
                "(canvas, batch rung, mode, convention, similarity, depth)"
            )
    geometry = (tuple(head.padded_shape), head.total, head.convention,
                head.check_similarity, head.similarity_frequency, head.mode,
                head.temporal_depth)
    if runner is None:
        runner = make_ring_runner(*geometry[:2], ring, *geometry[2:])
    elif runner.geometry != geometry or runner.ring < ring:
        raise ValueError("the ring runner was built for another bucket "
                         "geometry or a smaller ring")
    return StagedRing(runner=runner, staged=list(staged_batches), ring=ring)


def dispatch_ring(sr: StagedRing, device_slots: list | None = None
                  ) -> InflightRing:
    """Dispatch a staged ring; returns WITHOUT blocking on any result.

    ``device_slots`` are the ``SlotFill``s a caller already made (the
    resident lane's refill-while-the-drain-runs path: ``RingRunner.fill``
    at submit time); absent, or None for a slot, the retained host operands
    are copied in here — which is also the idempotent retry path, since the
    host staging is never written."""
    runner = sr.runner
    with runner.host_lock:
        fills = [
            device_slots[i] if device_slots is not None
            and device_slots[i] is not None
            else runner.fill(i, s.operand)
            for i, s in enumerate(sr.staged)
        ]
        return runner.dispatch(sr, fills)


def complete_ring(inflight: InflightRing) -> list[list[BatchBoardResult]]:
    """Wait for a drain's results; one ``BatchBoardResult`` list per filled
    slot, in slot order (each list bit-identical to ``complete_batch`` of
    the same staged batch)."""
    inflight.done.wait()
    if inflight.error is not None:
        raise inflight.error
    out = []
    for i, staged in enumerate(inflight.staged_ring.staged):
        lo, hi = i * staged.total, (i + 1) * staged.total
        out.append(_collect_board_results(
            staged, inflight.finals[lo:hi], inflight.gens[lo:hi],
            inflight.reasons[lo:hi]))
    return out


# ---------------------------------------------------------------------------
# The sparse lane's tile step. The dense engines cost O(width x height) per
# generation however dead the board is; the sparse engine (``sparse/``)
# steps only a universe's active tiles, and the macro engine (``macro/``)
# its leaf windows. What the device runs is this runner: one generation of
# B halo-extended tiles (a leaf advance: n) through T1
# (``ops/stencil_tile``), batched up the serve batcher's padding ladder, so
# a tile size builds at most one runner per rung. The JAX package donates
# its operand; here the runner owns its buffers — pinned host staging, a
# device block stack, the compact interiors and the flag pair per tile —
# and reuses them on every call.
# ---------------------------------------------------------------------------


class TileStepRunner:
    """``runner(blocks) -> (interiors, alive, changed)`` over (B, t+2, t+2)
    uint8 host blocks: the (B, t, t) next interiors and (B,) bool flags, all
    host numpy arrays the caller owns. ``runner.advance(blocks, n)`` runs n
    generations of blocks whose rings are dead and stay dead (the macro
    leaf windows): one upload, one T1 call for all n generations (one
    launch where a window fits in a CTA's shared memory), one readback of
    the (B, t, t) interiors.

    One call at a time per runner (a lock): the sparse and macro memos
    serve a server's worker threads, which share the cached runners."""

    def __init__(self, tile: int, batch: int, device: torch.device):
        self.tile, self.batch, self.device = tile, batch, device
        pin = device.type == "cuda"
        shape = (batch, tile + 2, tile + 2)
        self._host_in = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
        self._block = torch.zeros(shape, dtype=torch.uint8, device=device)
        self._out = torch.empty((batch, tile, tile), dtype=torch.uint8,
                                device=device)
        self._flags = torch.zeros((batch, stencil_tile.TILE_FLAGS),
                                  dtype=torch.int32, device=device)
        self._host_out = torch.empty((batch, tile, tile), dtype=torch.uint8,
                                     pin_memory=pin)
        self._host_flags = torch.empty((batch, stencil_tile.TILE_FLAGS),
                                       dtype=torch.int32, pin_memory=pin)
        self._lock = threading.Lock()

    def _upload(self, blocks) -> None:
        blocks = np.asarray(blocks, dtype=np.uint8)
        if blocks.shape != tuple(self._host_in.shape):
            raise ValueError(f"tile step runner takes uint8 "
                             f"{tuple(self._host_in.shape)}, got {blocks.shape}")
        self._host_in.numpy()[...] = blocks
        self._block.copy_(self._host_in, non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def __call__(self, blocks):
        with self._lock:
            self._upload(blocks)
            self._flags.zero_()
            stencil_tile.tile_step_into(self._block, self._out, self._flags)
            self._host_out.copy_(self._out, non_blocking=True)
            self._host_flags.copy_(self._flags, non_blocking=True)
            self._sync()  # the chunk's one device->host wait
            flags = self._host_flags.numpy()
            return (self._host_out.numpy().copy(), flags[:, 0] != 0,
                    flags[:, 1] != 0)

    def advance(self, blocks, generations: int) -> np.ndarray:
        """The (B, t, t) interiors after ``generations`` steps of
        ``blocks``, each step reading a dead ring."""
        with self._lock:
            self._upload(blocks)
            if generations > 0:
                # Every generation reads the uploaded ring: dead, as a
                # fresh zero-ringed block per step would be.
                stencil_tile.tile_step_into(self._block, self._out,
                                            self._flags, generations)
                self._host_out.copy_(self._out, non_blocking=True)
            else:
                self._host_out.copy_(self._block[:, 1:-1, 1:-1],
                                     non_blocking=True)
            self._sync()
            return self._host_out.numpy().copy()


def make_tile_step_runner(tile: int, batch: int, device=None) -> TileStepRunner:
    """The B-tile halo step runner for ``(tile, batch)`` on ``device`` (the
    run's device when None), cached like the JAX package's compiled
    runners. One generation per call by design — the halo ring is
    re-exchanged on the host, from the occupancy index, between
    generations. Convention-independent: the loop accounting lives in the
    sparse host loop, so a tile step is a pure function of its block (what
    makes it memoizable, ``sparse/memo.py``)."""
    if tile < 4:
        raise ValueError(f"tile must be >= 4, got {tile}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    return _tile_step_runner(tile, batch, platform_env.resolve_device(device))


@functools.lru_cache(maxsize=64)
def _tile_step_runner(tile: int, batch: int, device: torch.device
                      ) -> TileStepRunner:
    return TileStepRunner(tile, batch, device)
