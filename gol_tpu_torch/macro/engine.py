"""The macrocell superstep driver: arbitrary ``--gens`` in O(log) jumps.

The port's copy of ``gol_tpu/macro/engine.py``.

Every other engine in the tree is O(generations) in time; this driver
decomposes an arbitrary generation count (non-powers-of-two included)
into exponential jumps through the memoized centered advance
(``macro/advance.py``), with auto-expanding padding — each jump
returns the center half of its root, so capacity is grown (one ring of
THE canonical empty node, near-free under hash-consing) before every
jump.

**Plane vs torus.** The sparse and dense lanes are toroidal; macrocell
is plane-semantics. The two agree exactly as long as no live cell ever
enters the universe's outermost cell ring (a ring cell's neighborhood —
and influence — wraps). Before each jump of ``s`` generations the live
bounding box grown by ``s`` (the light-cone bound on growth) must stay
inside that ring; jumps shrink to fit, and when not even a single step
fits the driver raises ``MacroPlaneError`` with the fix (a larger
``--universe``, or the sparse lane, which wraps natively) instead of
silently diverging.

**Early-exit parity.** The sparse engine's per-generation loop exits on
emptiness and on the periodic similarity check, with convention-specific
accounting (sparse/engine._run_c/_run_cuda — the oracle contract). Both
predicates are *monotone* along a plane evolution — an empty board stays
empty, and a board equal to its predecessor is a fixed point forever —
so the exact first-empty / first-still generation is recovered by
bisection over memoized states (O(log^2) advances, mostly memo hits),
and the exit generation/reason/board reproduce the per-generation loop
byte-for-byte. Stillness itself is decided by node identity:
``advance(root, 1) is advance(root, 0)`` — hash-consing makes the
fixed-point test a pointer comparison.
"""

from __future__ import annotations

import dataclasses

from gol_tpu_torch.config import Convention, DEFAULT_CONFIG, GameConfig
from gol_tpu_torch.macro.advance import MacroMemo, MacroStats, advance
from gol_tpu_torch.macro.node import MacroUniverse, NodeStore
from gol_tpu_torch.obs import registry as obs_registry, trace as obs_trace
from gol_tpu_torch.sparse.board import SparseBoard
from gol_tpu_torch.sparse.engine import EXIT_EMPTY, EXIT_GEN_LIMIT, EXIT_SIMILAR

# Above this generation limit the CLI's auto lane prefers macrocell over
# the per-generation sparse loop (when the placement admits plane
# semantics for the whole run). The shipped default is deliberately
# conservative — macro pays tree-build + hashing overhead that a short
# run never amortizes; a plan-cached per-host value overrides it
# (tune.select.macro_auto_gens consults the plan store; this constant is
# the bundled-default/last-resort fallback).
MACRO_AUTO_GENS = 10_000


class MacroPlaneError(ValueError):
    """The run's live cells reached the universe edge ring, where torus
    and plane semantics diverge — the macro lane cannot proceed
    exactly."""


@dataclasses.dataclass
class MacroResult:
    """Final state of a macro run (the SparseResult analog — same
    board/generations/exit vocabulary, deep-time stats)."""

    board: SparseBoard
    generations: int
    exit_reason: str
    stats: MacroStats


def _prepared(u: MacroUniverse, t: int) -> MacroUniverse:
    """Expand until the root can answer a ``t``-step advance: level >= 2,
    ``t`` within the light-cone cap, and the live bbox grown by ``t``
    inside the root's CENTER half (the advance only returns the center)."""
    while u.root.level < 2:
        u = u.expanded()
    while True:
        cap = u.tile << (u.root.level - 2)
        ok = t <= cap
        if ok and u.root.population:
            b = u.bbox_cells()
            t_edge = u.tile
            q = 1 << (u.root.level - 2)
            r0 = (u.oy + q) * t_edge
            c0 = (u.ox + q) * t_edge
            r1 = (u.oy + 3 * q) * t_edge
            c1 = (u.ox + 3 * q) * t_edge
            ok = (b[0] - t >= r0 and b[1] - t >= c0
                  and b[2] + t < r1 and b[3] + t < c1)
        if ok:
            return u
        u = u.expanded()


def advance_universe(u: MacroUniverse, memo: MacroMemo, t: int,
                     stats: MacroStats | None = None) -> MacroUniverse:
    """One ``t``-generation jump of a whole universe (pads, advances,
    re-anchors the half-size result where the old center was)."""
    u = _prepared(u, t)
    root = advance(memo, u.root, t, stats)
    q = 1 << (u.root.level - 2)
    return MacroUniverse(u.store, u.height, u.width, root,
                         u.oy + q, u.ox + q)


def _safe_jump(u: MacroUniverse) -> int:
    """The largest jump whose light cone provably stays off the torus
    seam: bbox distance to the edge ring, from the current state."""
    b = u.bbox_cells()
    return min(b[0] - 1, b[1] - 1,
               u.height - 2 - b[2], u.width - 2 - b[3])


def _plane_error(u: MacroUniverse, g: int) -> MacroPlaneError:
    b = u.bbox_cells()
    return MacroPlaneError(
        f"macro engine: live cells reach the universe edge at generation "
        f"{g} (bbox rows {b[0]}..{b[2]}, cols {b[1]}..{b[3]} of "
        f"{u.height}x{u.width}) where toroidal wrap and plane semantics "
        f"diverge; enlarge --universe so the pattern keeps a margin, or "
        f"use --engine sparse (which wraps natively)"
    )


class _Run:
    """One simulation's state cache: generation -> universe, advanced
    lazily via guarded exponential jumps (power-of-two sized, so the
    bisections downstream re-ask mostly-memoized questions)."""

    def __init__(self, u0: MacroUniverse, memo: MacroMemo,
                 stats: MacroStats):
        self.states = {0: u0}
        self.memo = memo
        self.stats = stats

    def state_at(self, g: int) -> MacroUniverse:
        base = max(k for k in self.states if k <= g)
        u = self.states[base]
        while base < g:
            if u.root.population == 0:
                self.states[g] = u
                return u
            s = min(g - base, _safe_jump(u))
            if s < 1:
                raise _plane_error(u, base)
            s = 1 << (s.bit_length() - 1)  # largest power of two that fits
            with obs_trace.span("macro.advance", jump=s, generation=base):
                u = advance_universe(u, self.memo, s, self.stats)
            self.stats.supersteps += 1
            base += s
            self.states[base] = u
        return u

    def still_at(self, g: int) -> bool:
        """``board(g) == board(g-1)``, by node identity: both one-step
        and zero-step results are computed in the SAME padded window, so
        hash-consing turns board equality into ``is``."""
        u = self.state_at(g - 1)
        if u.root.population == 0:
            return True
        if _safe_jump(u) < 1:
            raise _plane_error(u, g - 1)
        u = _prepared(u, 1)
        one = advance(self.memo, u.root, 1, self.stats)
        zero = advance(self.memo, u.root, 0, self.stats)
        return one is zero


def _bisect_first(lo: int, hi: int, pred) -> int:
    """Smallest g in (lo, hi] with pred(g), given monotone pred,
    pred(hi) True and pred(lo) conceptually False."""
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pred(mid):
            hi = mid
        else:
            lo = mid
    return hi


def simulate_macro(
    board: SparseBoard,
    config: GameConfig = DEFAULT_CONFIG,
    memo: MacroMemo | None = None,
    checkpoints=(),
    on_checkpoint=None,
) -> MacroResult:
    """Run a full macro simulation, byte-identical to ``simulate_sparse``
    — cells, generation count, exit reason, all three exits, both
    conventions — wherever plane semantics hold (else MacroPlaneError).

    ``checkpoints`` is an iterable of generation numbers; for each one
    within the generation limit, ``on_checkpoint(gen, SparseBoard)`` is
    called with the exact state at that generation (the byte-gate hook,
    and the deep-time sampling API)."""
    if memo is None:
        memo = MacroMemo(NodeStore(board.tile))
    if memo.store.leaf_size != board.tile:
        raise ValueError(
            f"memo leaf {memo.store.leaf_size} != board tile {board.tile}"
        )
    reg = obs_registry.default()
    stats = MacroStats()
    with obs_trace.span("macro.simulate",
                        shape=f"{board.height}x{board.width}",
                        tile=board.tile, live_tiles=board.live_tiles,
                        convention=config.convention):
        result = _simulate(board, config, memo, stats,
                           tuple(checkpoints), on_checkpoint)
    reg.inc("macro_runs_total")
    reg.inc("macro_generations_total", result.generations)
    reg.inc("macro_supersteps_total", stats.supersteps)
    reg.set_gauge("macro_interned_nodes", memo.store.interned_nodes())
    return result


def _simulate(board, config, memo, stats, checkpoints, on_checkpoint
              ) -> MacroResult:
    run = _Run(MacroUniverse.from_board(memo.store, board), memo, stats)
    G = config.gen_limit
    f = config.similarity_frequency
    check = config.check_similarity
    cuda = config.convention == Convention.CUDA

    def finish(out_board: SparseBoard, gens: int, reason: str
               ) -> MacroResult:
        stats.generations = gens
        if on_checkpoint is not None:
            for c in sorted(set(checkpoints)):
                if 0 <= c <= G:
                    on_checkpoint(c, run.state_at(c).to_board())
        return MacroResult(out_board, gens, reason, stats)

    u0 = run.states[0]
    if u0.root.population == 0:
        # The conventions disagree on an initially-empty board: C's loop
        # never runs (EMPTY); CUDA steps it — gen_limit 0 wins first,
        # then a frequency-1 similarity check fires before the emptiness
        # break (sparse/engine._run_cuda's check ordering).
        if not cuda:
            return finish(u0.to_board(), 0, EXIT_EMPTY)
        if G == 0:
            return finish(u0.to_board(), 0, EXIT_GEN_LIMIT)
        if check and f == 1:
            return finish(u0.to_board(), 0, EXIT_SIMILAR)
        return finish(u0.to_board(), 0, EXIT_EMPTY)
    if G == 0:
        return finish(u0.to_board(), 0, EXIT_GEN_LIMIT)

    end = run.state_at(G)
    if end.root.population == 0:
        # Emptiness beats the similarity exit in both conventions: a
        # board still nonempty never fired "unchanged", and once empty,
        # C's loop condition exits before another step while CUDA's
        # break fires in the dying iteration itself.
        g_e = _bisect_first(0, G,
                            lambda g: run.state_at(g).root.population == 0)
        if not cuda:
            return finish(run.state_at(g_e).to_board(), g_e, EXIT_EMPTY)
        # CUDA's break precedes the swap: the reported board is the last
        # NON-empty generation, one before the empty one.
        return finish(run.state_at(g_e - 1).to_board(), g_e - 1, EXIT_EMPTY)
    if check and run.still_at(G):
        # First still generation, then the first similarity CHECK at or
        # after it (the check fires every `f` generations); both
        # conventions report generation g_check - 1 with the still board.
        g0 = _bisect_first(0, G, run.still_at)
        g_sim = f * ((g0 + f - 1) // f)
        if g_sim <= G:
            return finish(run.state_at(g0).to_board(), g_sim - 1,
                          EXIT_SIMILAR)
    return finish(end.to_board(), G, EXIT_GEN_LIMIT)


def auto_macro(height: int, width: int, tile: int, gen_limit: int,
               pattern_bbox, gens_threshold: int | None = None) -> bool:
    """The auto lane's sparse/macro pick, consulted only AFTER auto
    already chose sparse: macro wins when the run is deep enough to
    amortize the tree (the tuned/plan-cached crossover) AND the initial
    placement provably keeps the whole run off the torus seam
    (conservative: bbox + gen_limit inside the edge ring — auto must
    never pick a lane that can raise mid-run).

    ``pattern_bbox`` is (min_row, min_col, max_row, max_col) of the
    initial live cells in universe coordinates, or None (unknown =
    stay sparse)."""
    if tile % 2 or pattern_bbox is None:
        return False
    if gens_threshold is None:
        try:
            from gol_tpu_torch.tune import select

            gens_threshold = select.macro_auto_gens(MACRO_AUTO_GENS)
        except Exception:  # noqa: BLE001 - cache trouble = default
            gens_threshold = MACRO_AUTO_GENS
    if gen_limit < gens_threshold:
        return False
    r0, c0, r1, c1 = pattern_bbox
    margin = min(r0 - 1, c0 - 1, height - 2 - r1, width - 2 - c1)
    return margin >= gen_limit
