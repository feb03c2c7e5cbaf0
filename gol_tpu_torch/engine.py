"""The simulation engine on one device: a host loop over K-generation blocks.

The port of ``gol_tpu/engine.py``'s single-device runner. The JAX engine
runs the whole simulation as one ``lax.while_loop`` on the device; here the
loop runs on the host and the device runs the kernels. The fused packed
kernel takes the blocked loops (``_simulate_c_block``,
``_simulate_cuda_block``): each block of K=16 generations is two 8-generation
passes (K1) plus a ``t % 8`` single-generation tail (K3), all enqueued
without a sync, and then ONE small flag tensor is read back. The host
replays the exits from those per-generation flags exactly as the JAX
replays do (gol_tpu/engine.py:244-263, :359-373). A pass whose summary
hides a death or a stillness onset is rerun from the block's start with the
exact-flag pass (K2) — at most twice per run, as in the JAX
``_derive_or_replay``.

Exactness of the blocked loop is the JAX argument unchanged: both early
exits are fixed points (an empty grid stays empty, a still life stays
still), so generations that overrun an exit inside a block leave the grid
as stopping on time would; only the counters need the exit point. The CUDA
convention's empty exit keeps the last non-empty generation, which is no
fixed point, so that block is replayed from its start state.

The JAX runner's donated carry becomes three explicit buffers: the block's
start state stays intact while the passes ping-pong between the other two.
The non-fused ``lax`` kernel keeps the per-generation loop, reading its
alive flag every generation and comparing for similarity only on the
generations where the check fires.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gol_tpu_torch import platform_env
from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig
from gol_tpu_torch.ops import Kernel, resolve_kernel, stencil_packed

_TERMINATION_BLOCK = 16

# Per-convention: (first generation value, reported count from the final gen).
_GEN_START = {Convention.C: 1, Convention.CUDA: 0}
_REPORT = {Convention.C: lambda gen: gen - 1, Convention.CUDA: lambda gen: gen}


@dataclasses.dataclass
class EngineResult:
    """Host-side view of a finished run."""

    grid: np.ndarray  # uint8 {0,1}, (height, width)
    generations: int  # the count the matching reference variant would print


class _Buffers:
    """The carried state's three buffers and the block's flag tensor."""

    def __init__(self, state: torch.Tensor, kernel: Kernel, block: int):
        self.pool = [state, torch.empty_like(state), torch.empty_like(state)]
        self.tail_base = stencil_packed.SUMMARY_FLAGS * (block // kernel.multi_gens)
        self.flags = torch.zeros(
            self.tail_base + stencil_packed.STEP_FLAGS * block,
            dtype=torch.int32, device=state.device,
        )

    def scratch(self, start: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """A buffer holding neither the block's start state nor ``cur``."""
        return next(b for b in self.pool if b is not start and b is not cur)


def _generation(cur: torch.Tensor, kernel: Kernel) -> torch.Tensor:
    """One generation through the kernel's fused form, into a fresh buffer."""
    out = torch.empty_like(cur)
    flags = torch.zeros(stencil_packed.STEP_FLAGS, dtype=torch.int32,
                        device=cur.device)
    kernel.fused(cur, out, flags)
    return out


def _exact_passes(start: torch.Tensor, kernel: Kernel):
    """Lazily rerun a block's passes from its start state with the exact-flag
    pass; ``get(j)`` is pass j's ``(alive, similar)`` lists."""
    T = kernel.multi_gens
    done = []

    def get(j: int):
        while len(done) <= j:
            src = done[-1][0] if done else start
            out = torch.empty_like(src)
            flags = torch.zeros(2 * T, dtype=torch.int32, device=src.device)
            kernel.exact_multi(src, out, flags)
            f = flags.tolist()
            done.append((out, f[:T], [1 - d for d in f[T:]]))
        return done[j][1:]

    return get


def _block_generations(start, t, config: GameConfig, kernel: Kernel, block,
                       bufs: _Buffers):
    """Run ``t`` generations from ``start``: ``(cur, a_all, s_all)``.

    ``t // T`` fast passes fill flag slots T*j..T*j+T-1 and the tail fills
    t-rem..t-1, so the callers' replays are oblivious to the grouping.
    ``a_all``/``s_all`` are ``block``-slot host lists; ``s_all`` is None
    when the similarity check is off. Every launch of the block is enqueued
    before the one readback."""
    T = kernel.multi_gens
    S, P = stencil_packed.SUMMARY_FLAGS, stencil_packed.STEP_FLAGS
    passes = t // T
    flags = bufs.flags
    flags.zero_()
    cur = start
    for j in range(passes):
        out = bufs.scratch(start, cur)
        kernel.fused_multi(cur, out, flags[S * j: S * (j + 1)])
        cur = out
    base = bufs.tail_base
    for i in range(passes * T, t):
        out = bufs.scratch(start, cur)
        kernel.fused(cur, out, flags[base + P * i: base + P * (i + 1)])
        cur = out
    f = flags.tolist()  # the block's one device->host sync
    a_all, s_all = [0] * block, [0] * block
    exact = _exact_passes(start, kernel)
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


def _simulate_c_block(words, config, kernel, gen0, counter0, bound, block):
    """Blocked C-convention loop: K generations per flag readback, bit-exact
    with the per-generation loop (see the module docstring). The block never
    crosses ``bound`` — the generation limit is no fixed point."""
    freq = config.similarity_frequency
    bufs = _Buffers(words, kernel, block)
    gen, counter = gen0, counter0
    alive, similar = bool((words != 0).any()), False
    cur = words
    while alive and not similar and gen <= bound:
        t = min(block, bound - gen + 1)
        cur, a_all, s_all = _block_generations(cur, t, config, kernel, block, bufs)
        for i in range(t):
            sim_i, counter = _replay_similarity(
                counter, freq, s_all, i, config.check_similarity
            )
            alive, similar = a_all[i], sim_i
            if not sim_i:
                gen += 1
            if not (alive and not similar and gen <= bound):
                break
    return cur, gen, counter


def _simulate_c(grid, config: GameConfig, kernel: Kernel):
    """C-variant loop (src/game.c:177-196): emptiness checked at the top of
    every generation; the similarity break does not increment the counter;
    the reported count is ``generation - 1``. Returns ``(final, gen)``."""
    gen, bound = _GEN_START[Convention.C], config.gen_limit
    if kernel.fused is not None:
        final, gen, _ = _simulate_c_block(grid, config, kernel, gen, 0, bound,
                                          _TERMINATION_BLOCK)
        return final, gen
    freq, counter = config.similarity_frequency, 0
    cur = grid
    alive, similar = bool(cur.any()), False
    while alive and not similar and gen <= bound:
        new = kernel.step(cur)
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and torch.equal(cur, new)
            counter = 0 if fire else counter + 1
        alive = bool(new.any())
        if not similar:
            gen += 1
        cur = new
    return cur, gen


def _simulate_cuda_block(words, config, kernel, gen0, counter0, bound, block):
    """Blocked CUDA-convention loop: K generations per flag readback.

    A similarity exit is a still life, so the block-end state IS the exit
    state. An empty exit at in-block iteration i keeps state_i, the last
    non-empty generation: replay i single generations from the block's start
    state, which the three-buffer pool keeps intact. Returns
    ``(final, gen, counter, stopped)``."""
    freq = config.similarity_frequency
    bufs = _Buffers(words, kernel, block)
    gen, counter = gen0, counter0
    start = cur = words
    stopped, exit_i, exit_empty = False, 0, False
    while not stopped and gen < bound:
        t = min(block, bound - gen)
        start = cur
        cur, a_all, s_all = _block_generations(start, t, config, kernel, block,
                                               bufs)
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
            final = _generation(final, kernel)
    return final, gen, counter, stopped


def _simulate_cuda(grid, config: GameConfig, kernel: Kernel):
    """CUDA-variant loop (src/game_cuda.cu:222-276): 0-based exclusive
    bound; no emptiness test before the first evolve; the emptiness test
    runs on the new grid and breaks before the swap, so an empty exit keeps
    the last non-empty generation; the reported count is the raw counter.
    Returns ``(final, gen)``."""
    gen, bound = _GEN_START[Convention.CUDA], config.gen_limit
    if kernel.fused is not None:
        final, gen, _, _ = _simulate_cuda_block(grid, config, kernel, gen, 0,
                                                bound, _TERMINATION_BLOCK)
        return final, gen
    freq, counter = config.similarity_frequency, 0
    cur = grid
    while gen < bound:
        new = kernel.step(cur)
        similar = False
        if config.check_similarity:
            fire = (counter + 1) == freq
            similar = fire and torch.equal(cur, new)
            counter = 0 if fire else counter + 1
        if similar or not bool(new.any()):
            break  # the break precedes the swap (src/game_cuda.cu:250,266)
        cur = new
        gen += 1
    return cur, gen


_SIMULATORS = {Convention.C: _simulate_c, Convention.CUDA: _simulate_cuda}


def put_grid(grid, device=None) -> torch.Tensor:
    """Place a host uint8 grid on the device."""
    dev = platform_env.resolve_device(device)
    arr = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
    return torch.from_numpy(arr).to(dev)


def make_runner(shape: tuple[int, int], config: GameConfig = DEFAULT_CONFIG,
                kernel: str = "auto", device=None):
    """A ``grid -> (final_grid, generations)`` runner for one grid shape.

    ``grid`` is a uint8 (height, width) tensor on ``device`` (the platform
    default — the card — when None); the final grid stays on the device.
    Building the runner builds and loads the card's kernels, so a run's
    timing excludes them. The runner never writes its input."""
    dev = platform_env.resolve_device(device)
    height, width = shape
    if height <= 0 or width <= 0:
        raise ValueError(f"grid shape must be positive, got {height}x{width}")
    kobj = resolve_kernel(kernel, height, width)
    if not kobj.supports(height, width):
        raise ValueError(
            f"kernel {kobj.name!r} does not support a {height}x{width} grid; "
            "use kernel='auto' to pick one that does"
        )
    if dev.type == "cuda" and kobj.load is not None:
        kobj.load()
    simulate = _SIMULATORS[config.convention]
    report = _REPORT[config.convention]

    def run(grid: torch.Tensor):
        if tuple(grid.shape) != (height, width) or grid.dtype != torch.uint8:
            raise ValueError(
                f"runner takes a uint8 {height}x{width} grid, got "
                f"{grid.dtype} {tuple(grid.shape)}"
            )
        if grid.device != dev:
            raise ValueError(f"grid is on {grid.device}, runner on {dev}")
        state = kobj.encode(grid) if kobj.encode is not None else grid
        final, gen = simulate(state, config, kobj)
        if kobj.decode is not None:
            final = kobj.decode(final)
        return final, report(gen)

    return run


def simulate(grid, config: GameConfig = DEFAULT_CONFIG, kernel: str = "auto",
             device=None) -> EngineResult:
    """Run a full simulation and fetch the result to the host."""
    dev = platform_env.resolve_device(device)
    shape = tuple(np.shape(grid))
    runner = make_runner(shape, config, kernel, dev)
    final, generations = runner(put_grid(grid, dev))
    return EngineResult(final.cpu().numpy(), generations)
