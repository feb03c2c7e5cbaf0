"""The port's batched engine (gol_tpu_torch.engine.simulate_batch, on the
CPU through B1's and B2's plain versions) against the JAX package's
(gol_tpu.engine.simulate_batch): grid, generations, exit reason and the
packed lane's words, at tolerance 0, for both loop conventions. The same
numpy-seeded boards go through both, and the plain versions of the two
batched kernels are held against JAX's ``_batch_evolve`` per mode.
"""

import jax
import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu import oracle as jax_oracle
from gol_tpu.config import GameConfig as JaxGameConfig
from gol_tpu.obs import registry as jax_registry
from gol_tpu.obs import trace as jax_trace
from gol_tpu.ops import packed_math as jax_pm
from gol_tpu_torch import engine
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import bitpack, text_grid
from gol_tpu_torch.obs import registry, trace
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_batch as sb

CONVENTIONS = [Convention.C, Convention.CUDA]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _configs(limits, convention, **kw):
    if isinstance(limits, int):
        return JaxGameConfig(gen_limit=limits, convention=convention, **kw), \
            GameConfig(gen_limit=limits, convention=convention, **kw)
    return ([JaxGameConfig(gen_limit=n, convention=convention, **kw) for n in limits],
            [GameConfig(gen_limit=n, convention=convention, **kw) for n in limits])


def _both(boards, limits, convention, **kw):
    """``(jax results, port results)`` of one batch; ``kw`` goes to both
    ``simulate_batch`` calls, config settings (``check_similarity``, ...)
    to both configs."""
    cfg = {k: kw.pop(k) for k in ("check_similarity", "similarity_frequency")
           if k in kw}
    jcfg, pcfg = _configs(limits, convention, **cfg)
    return (jax_engine.simulate_batch(boards, jcfg, **kw),
            engine.simulate_batch(boards, pcfg, **kw))


def _assert_same(jax_results, port_results):
    assert len(port_results) == len(jax_results)
    for j, p in zip(jax_results, port_results):
        np.testing.assert_array_equal(p.grid, j.grid)
        assert p.grid.dtype == np.uint8
        assert (p.generations, p.exit_reason) == (j.generations, j.exit_reason)
        if j.words is None:
            assert p.words is None
        else:
            assert p.words.dtype == j.words.dtype == np.uint32
            np.testing.assert_array_equal(p.words, np.asarray(j.words))


def _trio():
    """JAX's mixed-fate trio (tests/test_serve.py): 32x32 boards that die,
    stand still and run to the limit at gen_limit 60."""
    dies = np.zeros((32, 32), np.uint8)
    dies[4, 4] = 1
    still = np.zeros((32, 32), np.uint8)
    still[3:5, 3:5] = 1
    soup = text_grid.generate(32, 32, seed=7)
    return [("dies", dies, "empty"), ("still", still, "similar"),
            ("soup", soup, "gen_limit")]


def _diagonal(height, width):
    """Three diagonal cells: one survives generation 1, none generation 2
    (the CUDA convention's empty exit keeps a live board, so it replays)."""
    g = np.zeros((height, width), np.uint8)
    for k in range(3):
        g[2 + k, 3 + k] = 1
    return g


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_mixed_fates_match_jax_and_the_oracle(convention):
    named = _trio()
    boards = [b for _, b, _ in named]
    jax_res, port_res = _both(boards, 60, convention)
    _assert_same(jax_res, port_res)
    cfg = JaxGameConfig(gen_limit=60, convention=convention)
    for (name, board, reason), got in zip(named, port_res):
        want = jax_oracle.run(board, cfg)
        np.testing.assert_array_equal(got.grid, want.grid)
        assert got.generations == want.generations, name
        assert got.exit_reason == reason, name
        assert got.words is not None  # 32x32 exact fit: the packed lane


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_masked_bucket_matches_jax(convention):
    boards = [text_grid.generate(30, 30, seed=1), text_grid.generate(18, 24, seed=2),
              np.zeros((10, 13), np.uint8)]
    boards[2][2:4, 2:4] = 1  # block: a similarity exit inside a running batch
    jax_res, port_res = _both(boards, 40, convention, padded_shape=(32, 32),
                              pad_batch_to=4)
    _assert_same(jax_res, port_res)
    assert all(r.words is None for r in port_res)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_byte_mode_matches_jax(convention):
    boards = [text_grid.generate(33, 20, seed=s) for s in (3, 4)]
    boards.append(_diagonal(33, 20))
    assert engine.resolve_batch_mode([33] * 3, [20] * 3, (33, 20)) == "byte"
    jax_res, port_res = _both(boards, 30, convention)
    _assert_same(jax_res, port_res)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mode_shape", [(32, 64), (24, 40)], ids=["packed", "masked"])
def test_empty_exit_inside_a_block_matches_jax(convention, mode_shape):
    """A board that dies at generation 2 while the batch runs on: under
    the CUDA convention it is replayed alone from the block's start."""
    h, w = mode_shape
    boards = [_diagonal(h, w), text_grid.generate(w, h, seed=5),
              _diagonal(h, w)[::-1].copy()]
    jax_res, port_res = _both(boards, 25, convention, padded_shape=(32, 64))
    _assert_same(jax_res, port_res)
    assert port_res[0].exit_reason == "empty"


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("freq", [3, 5])
@pytest.mark.parametrize("shape", [(32, 32), (29, 32)], ids=["packed", "masked"])
def test_late_exits_after_quiet_blocks_match_jax(convention, freq, shape):
    """Soups that settle (still or dead) after several blocks without an
    exit: the quiet blocks' closed-form counters must leave the similarity
    check firing on JAX's generations."""
    h, w = shape
    boards = [text_grid.generate(32, 32, seed=s)[:h, :w].copy()
              for s in (19, 24, 27, 165)]
    jax_res, port_res = _both(boards, 300, convention, padded_shape=(32, 32),
                              similarity_frequency=freq)
    _assert_same(jax_res, port_res)
    assert {r.exit_reason for r in port_res} != {"gen_limit"}


def _block_cases():
    """The masked and byte buckets through B2's block call: (boards,
    limits, padded_shape, mode). Masked: a 32x32 canvas of mixed extents,
    1x1, one row and one column among them, a diagonal that empties at
    generation 2 (inside the first block) and a still block; byte: the
    exact-fit 33x20 canvas. No limit is a multiple of the 16-generation
    block, so boards stop inside blocks."""
    still = np.zeros((12, 13), np.uint8)
    still[3:5, 3:5] = 1
    masked = [text_grid.generate(30, 30, seed=81), np.ones((1, 1), np.uint8),
              text_grid.generate(20, 1, seed=82), text_grid.generate(1, 20, seed=83),
              _diagonal(24, 27), still]
    byte = [text_grid.generate(20, 33, seed=s) for s in (84, 85)] + [_diagonal(33, 20)]
    return {"masked": (masked, [37, 5, 17, 40, 23, 19], (32, 32), "masked"),
            "byte": (byte, [7, 19, 33], (33, 20), "byte")}


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("case", ["masked", "byte"])
def test_masked_and_byte_blocks_match_jax(convention, case, monkeypatch):
    """B2's block call (its plain version on the CPU) under the batched
    loop: grids, Generations and exit reasons equal JAX's, the diagonal's
    empty exit (replayed alone under the CUDA convention) included."""
    boards, limits, padded, mode = _block_cases()[case]
    assert engine.resolve_batch_mode([b.shape[0] for b in boards],
                                     [b.shape[1] for b in boards], padded) == mode
    calls = []
    plain = sb._batch_masked_block_plain
    monkeypatch.setattr(sb, "_batch_masked_block_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    engine.make_batch_runner.cache_clear()
    jax_res, port_res = _both(boards, limits, convention, padded_shape=padded)
    _assert_same(jax_res, port_res)
    assert calls and max(calls) == 16  # whole blocks, one call each
    assert port_res[-1 if case == "byte" else 4].exit_reason == "empty"


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_per_board_limits_share_one_runner(convention):
    boards = [text_grid.generate(32, 32, seed=s) for s in (21, 22, 23)]
    engine.make_batch_runner.cache_clear()
    jax_res, port_res = _both(boards, [5, 17, 60], convention)
    _assert_same(jax_res, port_res)
    assert [r.generations for r in port_res] == [5, 17, 60]
    jax_res, port_res = _both(boards, [60, 5, 17], convention)
    _assert_same(jax_res, port_res)
    info = engine.make_batch_runner.cache_info()
    assert (info.misses, info.hits) == (1, 1)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("depth", [1, 2, 7])
def test_temporal_depth_is_bit_exact(convention, depth):
    boards = [text_grid.generate(30, 30, seed=31), _diagonal(20, 30),
              text_grid.generate(30, 30, seed=32)]
    jax_res, port_res = _both(boards, [23, 40, 9], convention,
                              padded_shape=(32, 32), temporal_depth=depth)
    _assert_same(jax_res, port_res)
    _assert_same(engine.simulate_batch(boards, _configs([23, 40, 9], convention)[1],
                                       padded_shape=(32, 32)), port_res)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_no_similarity_check_and_frequency_match_jax(convention):
    boards = [b for _, b, _ in _trio()]
    for kw in ({"check_similarity": False}, {"similarity_frequency": 1},
               {"similarity_frequency": 5}):
        jax_res, port_res = _both(boards, 33, convention, **dict(kw))
        _assert_same(jax_res, port_res)


def test_packed_boards_lane_counts_no_pack():
    boards = [text_grid.generate(64, 32, seed=s) for s in (41, 42)]
    cfg = GameConfig(gen_limit=12)
    reg = registry.default()
    before = reg.counter("engine_stage_packs_total")
    words = [bitpack.pack_words(b) for b in boards]
    staged = engine.stage_batch(boards, cfg, pad_batch_to=4, packed_boards=words)
    assert reg.counter("engine_stage_packs_total") == before
    assert staged.mode == "packed" and staged.operand.dtype == np.uint32
    classic = engine.stage_batch(boards, cfg, pad_batch_to=4)
    assert reg.counter("engine_stage_packs_total") == before + 1
    np.testing.assert_array_equal(staged.operand, classic.operand)
    jax_res = jax_engine.simulate_batch(boards, JaxGameConfig(gen_limit=12),
                                        pad_batch_to=4)
    _assert_same(jax_res, engine.complete_batch(engine.dispatch_batch(staged)))
    # A board without words falls the whole batch back to the pack.
    engine.stage_batch(boards, cfg, packed_boards=[words[0], None])
    assert reg.counter("engine_stage_packs_total") == before + 2


def test_redispatch_is_idempotent_and_never_writes_the_operand():
    boards = [b for _, b, _ in _trio()]
    staged = engine.stage_batch(boards, GameConfig(gen_limit=20, convention="cuda"),
                                pad_batch_to=4)
    operand = staged.operand.copy()
    first = engine.complete_batch(engine.dispatch_batch(staged))
    second = engine.complete_batch(engine.dispatch_batch(staged))
    np.testing.assert_array_equal(staged.operand, operand)
    _assert_same(first, second)


def test_runner_keeps_its_input():
    boards = np.stack([b for _, b, _ in _trio()])
    words = pm.words_from_numpy(bitpack.pack_words(boards), "cpu")
    kept = words.clone()
    run = engine.make_batch_runner((32, 32), 3, Convention.CUDA, mode="packed")
    finals, gens, reasons = run(words, [32] * 3, [32] * 3, [60] * 3)
    assert torch.equal(words, kept)
    assert finals.data_ptr() != words.data_ptr()
    assert list(gens) == [0, 2, 60]
    assert [engine.EXIT_REASONS[r] for r in reasons] == ["empty", "similar", "gen_limit"]


def test_empty_and_limit_zero_batches_match_jax():
    assert engine.simulate_batch([], GameConfig()) == []
    boards = [b for _, b, _ in _trio()]
    for convention in CONVENTIONS:
        _assert_same(*_both(boards, 0, convention))


def test_exit_constants_match_jax():
    assert engine.EXIT_REASONS == jax_engine.EXIT_REASONS
    assert (engine.EXIT_GEN_LIMIT, engine.EXIT_EMPTY, engine.EXIT_SIMILAR) == (
        jax_engine.EXIT_GEN_LIMIT, jax_engine.EXIT_EMPTY, jax_engine.EXIT_SIMILAR)
    assert engine.BATCH_MODES == jax_engine.BATCH_MODES


@pytest.mark.parametrize("args", [
    ((32, 32), 0, "c", True, 3, "masked", 1),
    ((32, 32), 2, "c", True, 3, "bogus", 1),
    ((32, 33), 2, "c", True, 3, "packed", 1),
    ((32, 32), 2, "mpi", True, 3, "masked", 1),
    ((32, 32), 2, "c", True, 3, "masked", 0),
    ((32, 32), 2, "cuda", True, 3, "byte", 65),
], ids=["batch", "mode", "packed_width", "convention", "depth0", "depth65"])
def test_runner_validation_messages_match_jax(args):
    with pytest.raises(ValueError) as jax_err:
        jax_engine.make_batch_runner(*args)
    with pytest.raises(ValueError) as port_err:
        engine.make_batch_runner(*args)
    assert str(port_err.value) == str(jax_err.value)


def _staging_errors():
    a, b = np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint8)
    return {
        "counts": ([a, b], "configs3", {}),
        "settings": ([a, b], "mixed", {}),
        "too_big": ([np.zeros((40, 8), np.uint8)], "one", {"padded_shape": (32, 32)}),
        "word_shape": ([np.zeros((32, 32), np.uint8)], "one",
                       {"packed_boards": [np.zeros((32, 2), np.uint32)]}),
    }


@pytest.mark.parametrize("case", sorted(_staging_errors()))
def test_staging_errors_match_jax(case):
    boards, cfg, kw = _staging_errors()[case]
    configs = {"configs3": lambda G: [G()] * 3,
               "mixed": lambda G: [G(), G(convention="cuda")],
               "one": lambda G: G()}[cfg]
    with pytest.raises(ValueError) as jax_err:
        jax_engine.stage_batch(boards, configs(JaxGameConfig), **kw)
    with pytest.raises(ValueError) as port_err:
        engine.stage_batch(boards, configs(GameConfig), **kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", [
    ([32, 32], [32, 64], (32, 64)), ([32, 16], [64, 64], (32, 64)),
    ([33, 33], [20, 20], (33, 20)), ([8], [40], (8, 40)),
])
def test_resolve_batch_mode_matches_jax(case):
    assert engine.resolve_batch_mode(*case) == jax_engine.resolve_batch_mode(*case)


def test_span_and_counters_match_jax():
    boards = [b for _, b, _ in _trio()]
    names = ("engine_batches_total", "engine_boards_total",
             "engine_generations_total")
    seen = {}
    for tag, tracer, reg, run in (
            ("jax", jax_trace, jax_registry.default(),
             lambda: jax_engine.simulate_batch(boards, JaxGameConfig(gen_limit=30),
                                               pad_batch_to=4)),
            ("port", trace, registry.default(),
             lambda: engine.simulate_batch(boards, GameConfig(gen_limit=30),
                                           pad_batch_to=4))):
        tracer.enable()
        tracer.clear()
        try:
            before = {k: reg.counter(k) for k in names}
            run()
            spans = [(s["name"], s["attrs"]) for s in tracer.snapshot()]
        finally:
            # The tracers are process-wide: left on, they would change what
            # later tests in this worker send (the JAX fleet router adds
            # trace headers while tracing is on).
            tracer.disable()
            tracer.clear()
        seen[tag] = (spans, {k: reg.counter(k) - v for k, v in before.items()})
    assert seen["port"] == seen["jax"]
    assert [n for n, _ in seen["port"][0]] == ["engine.simulate_batch"]


# ---------------------------------------------------------------------------
# The kernels' plain versions against JAX's per-mode step.


def _jax_steps(mode, state, heights, widths, gens):
    out = []
    evolve = jax_engine._batch_evolve(mode, np.asarray(heights, np.int32),
                                      np.asarray(widths, np.int32))
    for _ in range(gens):
        state = np.asarray(evolve(state))
        out.append(state)
    return out


def _port_steps(step, state, gens):
    out, flags = [], []
    steps = torch.full((state.shape[0],), gens, dtype=torch.int32)
    for g in range(gens):
        new = torch.empty_like(state)
        f = torch.zeros((state.shape[0], 2), dtype=torch.int32)
        step(state, new, f, steps, g)
        flags.append(f)
        state = new
        out.append(state)
    return out, flags


def test_b1_plain_matches_jax_packed_step():
    boards = np.stack([text_grid.generate(64, 32, seed=s) for s in (51, 52)]
                      + [_diagonal(32, 64)])
    words = bitpack.pack_words(boards)
    want = _jax_steps("packed", words, [32] * 3, [64] * 3, 4)
    got, flags = _port_steps(sb.batch_packed_step_into,
                             pm.words_from_numpy(words, "cpu"), 4)
    prev = words
    for w, g, f in zip(want, got, flags):
        np.testing.assert_array_equal(pm.words_to_numpy(g), w)
        assert f[:, 0].tolist() == [int(x.any()) for x in w]
        assert f[:, 1].tolist() == [int((x != p).any()) for x, p in zip(w, prev)]
        prev = w


@pytest.mark.parametrize("mode", ["byte", "masked"])
def test_b2_plain_matches_jax_step(mode):
    ph, pw = 24, 40
    extents = [(24, 40)] * 3 if mode == "byte" else [(24, 40), (17, 33), (5, 9)]
    canvas = np.zeros((3, ph, pw), np.uint8)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = text_grid.generate(w, h, seed=60 + b)
    heights = [h for h, _ in extents]
    widths = [w for _, w in extents]
    want = _jax_steps(mode, canvas, heights, widths, 4)
    h_t = torch.tensor(heights, dtype=torch.int32)
    w_t = torch.tensor(widths, dtype=torch.int32)
    got, flags = _port_steps(
        lambda s, d, f, st, g: sb.batch_masked_step_into(s, d, f, st, h_t, w_t, g),
        torch.from_numpy(canvas), 4)
    prev = canvas
    for w, g, f in zip(want, got, flags):
        np.testing.assert_array_equal(g.numpy(), w)
        assert f[:, 0].tolist() == [int(x.any()) for x in w]
        assert f[:, 1].tolist() == [int((x != p).any()) for x, p in zip(w, prev)]
        prev = w


@pytest.mark.parametrize("t", [1, 2, 16, 18])
def test_b1_block_plain_matches_jax_vmapped_steps(t):
    """B1's block form's plain version against JAX's vmapped word step
    applied generation by generation, each board for its own steps (full,
    one, none, past the block), with per-generation flags."""
    boards = np.stack([text_grid.generate(64, 32, seed=s) for s in (71, 72, 73)]
                      + [_diagonal(32, 64)])
    words = bitpack.pack_words(boards)
    steps = [t, 1, 0, t + 2]
    evolve = jax.vmap(jax_pm.evolve_torus_words)
    cur = words
    want_flags = np.zeros((t, 4, 2), np.int32)
    for i in range(t):
        new = np.asarray(evolve(cur))
        running = np.array([i < min(n, t) for n in steps])
        want_flags[i, :, 0] = running & new.reshape(4, -1).any(axis=1)
        want_flags[i, :, 1] = running & (new != cur).reshape(4, -1).any(axis=1)
        cur = np.where(running[:, None, None], new, cur)
    got, flags = sb._batch_packed_block_plain(
        pm.words_from_numpy(words, "cpu"), torch.tensor(steps, dtype=torch.int32), t)
    np.testing.assert_array_equal(pm.words_to_numpy(got), cur)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    out = torch.empty_like(got)
    block_flags = torch.zeros((t, 4, 2), dtype=torch.int32)
    sb.batch_packed_block_into(pm.words_from_numpy(words, "cpu"), out, block_flags,
                               torch.tensor(steps, dtype=torch.int32), t)
    assert torch.equal(out, got) and torch.equal(block_flags, flags)
    assert sb.LAUNCHES["batch_packed_block"] == 0  # no kernel on the CPU


@pytest.mark.parametrize("t", [1, 2, 16, 18])
@pytest.mark.parametrize("mode", ["byte", "masked"])
def test_b2_block_plain_matches_jax_steps(mode, t):
    """B2's block form's plain version against JAX's per-mode step
    (``_batch_evolve``) applied generation by generation, each board for
    its own steps (full, one, none, past the block), with per-generation
    flags over the whole slot: a masked canvas's 0/1 padding noise differs
    from the 0 written there in a board's first generation only, and a
    board with no steps keeps it."""
    ph, pw = 24, 40
    extents = [(24, 40)] * 4 if mode == "byte" else [(24, 40), (17, 33), (1, 1), (1, 9)]
    rng = np.random.default_rng(90 + t)
    canvas = np.zeros((4, ph, pw), np.uint8)
    if mode == "masked":
        canvas[:] = rng.integers(0, 2, canvas.shape, dtype=np.uint8)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = text_grid.generate(w, h, seed=95 + b)
    heights = [h for h, _ in extents]
    widths = [w for _, w in extents]
    steps = [t, 1, 0, t + 2]
    evolve = jax_engine._batch_evolve(mode, np.asarray(heights, np.int32),
                                      np.asarray(widths, np.int32))
    cur = canvas
    want_flags = np.zeros((t, 4, 2), np.int32)
    for i in range(t):
        new = np.asarray(evolve(cur))
        running = np.array([i < min(n, t) for n in steps])
        want_flags[i, :, 0] = running & new.reshape(4, -1).any(axis=1)
        want_flags[i, :, 1] = running & (new != cur).reshape(4, -1).any(axis=1)
        cur = np.where(running[:, None, None], new, cur)
    args = (torch.from_numpy(canvas), torch.tensor(steps, dtype=torch.int32),
            torch.tensor(heights, dtype=torch.int32),
            torch.tensor(widths, dtype=torch.int32))
    got, flags = sb._batch_masked_block_plain(*args, t)
    np.testing.assert_array_equal(got.numpy(), cur)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    out = torch.empty_like(got)
    block_flags = torch.zeros((t, 4, 2), dtype=torch.int32)
    before = dict(sb.LAUNCHES)
    sb.batch_masked_block_into(args[0], out, block_flags, *args[1:], t)
    assert torch.equal(out, got) and torch.equal(block_flags, flags)
    assert sb.LAUNCHES == before  # no kernel on the CPU


def test_spent_steps_copy_through_without_flags():
    words = pm.words_from_numpy(bitpack.pack_words(
        np.stack([text_grid.generate(32, 8, seed=s) for s in (1, 2)])), "cpu")
    out = torch.empty_like(words)
    flags = torch.zeros((2, 2), dtype=torch.int32)
    sb.batch_packed_step_into(words, out, flags, torch.tensor([5, 1], dtype=torch.int32), 1)
    assert torch.equal(out[1], words[1]) and flags[1].tolist() == [0, 0]
    assert torch.equal(out[0], pm.evolve_torus_words(words[0]))


@pytest.mark.parametrize("bad", ["dtype", "shape", "flags", "steps", "alias", "device"])
def test_wrappers_refuse_bad_operands(bad):
    cells = torch.zeros((2, 8, 8), dtype=torch.uint8)
    out = torch.empty_like(cells)
    flags = torch.zeros((2, 2), dtype=torch.int32)
    steps = torch.ones(2, dtype=torch.int32)
    ext = torch.full((2,), 8, dtype=torch.int32)
    args = [cells, out, flags, steps, ext, ext]
    if bad == "dtype":
        args[0] = cells.to(torch.int32)
    elif bad == "shape":
        args[1] = torch.empty((2, 8, 9), dtype=torch.uint8)
    elif bad == "flags":
        args[2] = torch.zeros(4, dtype=torch.int32)
    elif bad == "steps":
        args[3] = torch.ones(3, dtype=torch.int32)
    elif bad == "alias":
        args[1] = cells
    else:
        args[0] = cells.to("meta")
    with pytest.raises(ValueError):
        sb.batch_masked_step_into(*args, 0)


@pytest.mark.parametrize("bad", ["t0", "flags", "extents", "alias"])
def test_masked_block_call_refuses_bad_operands(bad):
    cells = torch.zeros((2, 8, 8), dtype=torch.uint8)
    out = torch.empty_like(cells)
    flags = torch.zeros((3, 2, 2), dtype=torch.int32)
    steps = torch.ones(2, dtype=torch.int32)
    ext = torch.full((2,), 8, dtype=torch.int32)
    args, t = [cells, out, flags, steps, ext, ext], 3
    if bad == "t0":
        t = 0
    elif bad == "flags":
        args[2] = torch.zeros((2, 2), dtype=torch.int32)  # a one-generation buffer
    elif bad == "extents":
        args[5] = torch.full((3,), 8, dtype=torch.int32)
    else:
        args[1] = cells
    with pytest.raises(ValueError):
        sb.batch_masked_block_into(*args, t)
