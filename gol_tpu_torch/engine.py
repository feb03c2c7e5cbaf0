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

Spans and counters are the JAX engine's, on the same sites (``obs/trace``,
``obs/registry``): ``engine.compile`` around building a whole-run runner
(``make_runner``, ``make_packed_runner``: the kernels' build and load, the
counterpart of JAX's ``compile_runner``), ``engine.segment`` around each
segment of ``_iter_segments`` (``engine_segments_total``,
``engine_generations_total``) and ``engine.simulate`` around a
``simulate`` run (``engine_runs_total``, ``engine_generations_total``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.profiler import fence
from gol_tpu_torch.ops import Kernel, resolve_kernel, stencil_packed
from gol_tpu_torch.parallel import collectives
from gol_tpu_torch.parallel.mesh import Mesh, Topology, gather, split, topology_for, validate_grid

_TERMINATION_BLOCK = 16

# Per-convention: (first generation value, reported count from the final gen).
_GEN_START = {Convention.C: 1, Convention.CUDA: 0}
_REPORT = {Convention.C: lambda gen: gen - 1, Convention.CUDA: lambda gen: gen}


@dataclasses.dataclass
class EngineResult:
    """Host-side view of a finished run."""

    grid: np.ndarray  # uint8 {0,1}, (height, width)
    generations: int  # the count the matching reference variant would print


class _Flags:
    """An int32 flag buffer per device the shards live on. Each shard ORs
    into its device's buffer; ``read`` votes (ORs) the buffers and reads
    them back with one sync."""

    def __init__(self, n: int, state):
        self.devices = [s.device for s in state]
        self.bufs = {d: torch.zeros(n, dtype=torch.int32, device=d)
                     for d in self.devices}

    def zero_(self) -> None:
        for b in self.bufs.values():
            b.zero_()

    def slots(self, lo: int, hi: int) -> list:
        """Each shard's view of slots ``lo:hi``."""
        return [self.bufs[d][lo:hi] for d in self.devices]

    def read(self) -> list:
        return collectives.any_flag(list(self.bufs.values())).tolist()


def _empty_like(state) -> list:
    return [torch.empty_like(s) for s in state]


class _Buffers:
    """Three scratch buffers for the carried state and the block's flags.
    The caller's state is never one of them."""

    def __init__(self, state, kernel: Kernel, block: int):
        self.pool = [_empty_like(state) for _ in range(3)]
        if kernel.fused_multi is not None:
            self.tail_base = stencil_packed.SUMMARY_FLAGS * (block // kernel.multi_gens)
        else:
            self.tail_base = 0
        self.flags = _Flags(self.tail_base + stencil_packed.STEP_FLAGS * block, state)

    def scratch(self, start, cur):
        """A buffer holding neither the block's start state nor ``cur``."""
        return next(b for b in self.pool if b is not start and b is not cur)


def _generation(cur, kernel: Kernel, topology: Topology):
    """One generation through the kernel's fused form, into a fresh buffer."""
    out = _empty_like(cur)
    flags = _Flags(stencil_packed.STEP_FLAGS, cur)
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
            flags = _Flags(2 * T, src)
            kernel.exact_multi(src, out, flags.slots(0, 2 * T), topology)
            f = flags.read()
            done.append((out, f[:T], [1 - d for d in f[T:]]))
        return done[j][1:]

    return get


def _any_alive(state) -> bool:
    """The alive vote: any shard holds a live cell."""
    return bool(collectives.any_flag([s.any() for s in state]))


def _all_equal(cur, new) -> bool:
    """The similarity vote: no shard differs."""
    return bool(collectives.all_agree([(a != b).any() for a, b in zip(cur, new)]))


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
            f[S * j: S * (j + 1)], lambda j=j: exact(j)
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
    bufs = _Buffers(state, kernel, block)
    gen, counter = gen0, counter0
    alive, similar = _any_alive(state), False
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
                resume=None):
    """C-variant loop (src/game.c:177-196): emptiness checked at the top of
    every generation; the similarity break does not increment the counter;
    the reported count is ``generation - 1``.

    ``resume`` is None for a whole run, or ``(gen0, counter0, seg_end)`` to
    run one segment of a longer one. Returns ``(final, gen, counter,
    stopped)``."""
    limit = config.gen_limit
    gen0, counter0, seg_end = resume if resume is not None else (1, 0, limit)
    bound = min(limit, seg_end)
    if kernel.fused is not None:
        final, gen, counter, alive, similar = _simulate_c_block(
            state, config, kernel, topology, gen0, counter0, bound,
            _TERMINATION_BLOCK)
        return final, gen, counter, not alive or similar or gen > limit
    freq, gen, counter = config.similarity_frequency, gen0, counter0
    cur = state
    alive, similar = _any_alive(cur), False
    while alive and not similar and gen <= bound:
        new = kernel.step(cur, topology)
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and _all_equal(cur, new)
            counter = 0 if fire else counter + 1
        alive = _any_alive(new)
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
    bufs = _Buffers(state, kernel, block)
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
                   topology: Topology, resume=None):
    """CUDA-variant loop (src/game_cuda.cu:222-276): 0-based exclusive
    bound; no emptiness test before the first evolve; the emptiness test
    runs on the new grid and breaks before the swap, so an empty exit keeps
    the last non-empty generation; the reported count is the raw counter.
    ``resume`` as for ``_simulate_c``. Returns ``(final, gen, counter,
    stopped)``."""
    limit = config.gen_limit
    gen0, counter0, seg_end = resume if resume is not None else (0, 0, limit)
    bound = min(limit, seg_end)
    if kernel.fused is not None:
        final, gen, counter, stop = _simulate_cuda_block(
            state, config, kernel, topology, gen0, counter0, bound,
            _TERMINATION_BLOCK)
        return final, gen, counter, stop or gen >= limit
    freq, gen, counter = config.similarity_frequency, gen0, counter0
    cur, stop = state, False
    while gen < bound:
        new = kernel.step(cur, topology)
        similar = False
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and _all_equal(cur, new)
            counter = 0 if fire else counter + 1
        if similar or not _any_alive(new):
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


def _build_runner(shape, config: GameConfig, kernel: str, device, *,
                  segmented: bool, packed_state: bool, mesh: Mesh | None = None):
    """Shared scaffold of the four runner factories: shape, mesh and kernel
    validation, the kernels' build and load, and the simulate wrapper.

    ``packed_state`` runners take and return the (height, width/32) int32
    word tensor and never touch a uint8 grid; otherwise a kernel with its
    own carried state (packed words) converts once at the loop boundary.
    ``segmented`` runners take and return the resume scalars. With a
    ``mesh`` the runner takes and returns the row-major list of shards:
    (local_h, local_w) cells or (local_h, local_w/32) words."""
    height, width = shape
    if height <= 0 or width <= 0:
        raise ValueError(f"grid shape must be positive, got {height}x{width}")
    topology = topology_for(mesh)
    devices = list(mesh.devices) if mesh is not None else [
        platform_env.resolve_device(device)]
    local_h, local_w = validate_grid(height, width, topology)
    kobj = resolve_kernel("packed" if packed_state else kernel, local_h, local_w,
                          topology)
    if not kobj.supports(local_h, local_w, topology):
        hint = ("packed state has no fallback — use the unpacked lane"
                if packed_state
                else "use kernel='auto' to fall back automatically")
        raise ValueError(
            f"kernel {kobj.name!r} does not support a {local_h}x{local_w} "
            f"local shard on a {topology.shape[0]}x{topology.shape[1]} "
            f"topology; {hint}"
        )
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
                                                resume)
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
        final = gather(final, mesh.shape)
    return EngineResult(final.cpu().numpy(), generations)
