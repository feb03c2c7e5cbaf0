"""The port's sparse lane (gol_tpu_torch.sparse and
engine.make_tile_step_runner, on the CPU through T1's plain version)
against the JAX package's, at tolerance 0: the tile step's interiors and
both flags, ``simulate_sparse`` (boards, generations, exit reasons, work
counts) with and without a memo in both conventions, ``step_tiles`` over
an ownership slice with ghost rings, the memo's keys and CAS entries in
both directions, and the ``--engine auto`` picks under a pinned plan cache.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.config import GameConfig as JaxGameConfig
from gol_tpu.ops import stencil_lax as jax_lax
from gol_tpu.sparse import SparseBoard as JaxBoard
from gol_tpu.sparse import TileMemo as JaxMemo
from gol_tpu.sparse import engine as jax_sparse
from gol_tpu.tune import select as jax_select
from gol_tpu_torch import engine
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.obs import registry
from gol_tpu_torch.ops import stencil_tile
from gol_tpu_torch.sparse import SparseBoard, TileMemo, simulate_sparse
from gol_tpu_torch.sparse import engine as sparse_engine
from gol_tpu_torch.tune import plans, select

CONVENTIONS = [Convention.C, Convention.CUDA]
GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.uint8)
Ring = collections.namedtuple("Ring", "top bottom left right")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


# ---------------------------------------------------------------------------
# The tile step: T1's plain version and the runner

KINDS = ["soup", "still", "ring_birth", "dies"]


def _blocks(batch, tile, rng):
    """Blocks of several fates: random soup, a still block, a dead interior
    whose ring births (three live ring cells next to one interior cell), a
    lone cell that dies, and all-zero padding rows."""
    p = tile + 2
    out = np.zeros((batch, p, p), np.uint8)
    for b in range(batch - 1):  # the last row stays a padding row
        kind = KINDS[b % len(KINDS)]
        if kind == "soup":
            out[b] = rng.random((p, p)) < 0.4
        elif kind == "still":
            out[b, 2:4, 2:4] = 1
        elif kind == "ring_birth":
            out[b, 0, 1:4] = 1
        else:
            out[b, p // 2, p // 2] = 1
    return out


@pytest.mark.parametrize("tile,batch", [(4, 5), (5, 3), (9, 6), (16, 8)])
def test_tile_runner_matches_jax(tile, batch):
    rng = np.random.default_rng(tile * 31 + batch)
    blocks = _blocks(batch, tile, rng)
    interiors, alive, changed = engine.make_tile_step_runner(tile, batch)(blocks)
    j_int, j_alive, j_changed = jax_engine.make_tile_step_runner(tile, batch)(
        jnp.asarray(blocks))
    np.testing.assert_array_equal(interiors, np.asarray(j_int))
    np.testing.assert_array_equal(alive, np.asarray(j_alive))
    np.testing.assert_array_equal(changed, np.asarray(j_changed))
    assert interiors.dtype == np.uint8 and alive.dtype == bool
    # The fixtures' fates: a still block is alive and unchanged, a ring
    # birth is alive and changed, a padding row neither.
    fates = {"still": (True, False), "ring_birth": (True, True)}
    for b in range(batch - 1):
        if KINDS[b % len(KINDS)] in fates:
            assert (alive[b], changed[b]) == fates[KINDS[b % len(KINDS)]]
    assert (alive[-1], changed[-1]) == (False, False)


@pytest.mark.parametrize("tile", [4, 7, 16])
def test_tile_step_plain_forms_match_jax(tile):
    """T1 on a CPU tensor, compact and padded output: the padded form
    writes only the interior and leaves the ring as it was; flags are ORed
    into the caller's buffer."""
    rng = np.random.default_rng(tile)
    blocks = _blocks(6, tile, rng)
    want, want_alive, want_changed = (np.asarray(a) for a in
                                      jax_lax.evolve_padded_batch(jnp.asarray(blocks)))
    x = torch.from_numpy(blocks)
    out = torch.full((6, tile, tile), 9, dtype=torch.uint8)
    flags = torch.zeros((6, 2), dtype=torch.int32)
    stencil_tile.tile_step_into(x, out, flags)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(flags.numpy(), np.stack(
        [want_alive, want_changed], 1).astype(np.int32))
    padded = torch.full_like(x, 7)
    flags = torch.ones((6, 2), dtype=torch.int32)
    stencil_tile.tile_step_into(x, padded, flags)
    np.testing.assert_array_equal(padded[:, 1:-1, 1:-1].numpy(), want)
    ring = padded.clone()
    ring[:, 1:-1, 1:-1] = 7
    assert bool((ring == 7).all())
    assert bool((flags == 1).all())
    assert stencil_tile.LAUNCHES["tile_step"] == 0  # no kernel on the CPU


def test_runner_advance_matches_jax_per_generation_loop():
    """``advance`` (one upload, n steps on the device, one readback) equals
    JAX's loop of one runner call per step with the ring re-zeroed."""
    rng = np.random.default_rng(5)
    tile, batch = 16, 4
    blocks = np.zeros((batch, tile + 2, tile + 2), np.uint8)
    blocks[:, 1:-1, 1:-1] = rng.random((batch, tile, tile)) < 0.45
    blocks[-1] = 0
    got = engine.make_tile_step_runner(tile, batch).advance(blocks, 6)
    runner = jax_engine.make_tile_step_runner(tile, batch)
    cur = blocks
    for _ in range(6):
        inner = np.asarray(runner(jnp.asarray(cur))[0])
        cur = np.zeros_like(cur)
        cur[:, 1:-1, 1:-1] = inner
    np.testing.assert_array_equal(got, cur[:, 1:-1, 1:-1])
    np.testing.assert_array_equal(
        engine.make_tile_step_runner(tile, batch).advance(blocks, 0),
        blocks[:, 1:-1, 1:-1])


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("tile", [4, 9, 16])
def test_tile_steps_plain_matches_jax_runner_loop(tile, n):
    """T1's plain version over n generations against n applications of
    JAX's tile step runner, each step reading a dead ring (the macro
    lane's windows): interiors, and the last generation's flags, through
    the wrapper in both output forms."""
    rng = np.random.default_rng(tile * 13 + n)
    blocks = _blocks(6, tile, rng)
    blocks[:, 0], blocks[:, -1], blocks[:, :, 0], blocks[:, :, -1] = 0, 0, 0, 0
    runner = jax_engine.make_tile_step_runner(tile, 6)
    cur = blocks
    for _ in range(n):
        inner, alive, changed = (np.asarray(a) for a in runner(jnp.asarray(cur)))
        cur = np.zeros_like(cur)
        cur[:, 1:-1, 1:-1] = inner
    want_flags = np.stack([alive, changed], 1).astype(np.int32)
    x = torch.from_numpy(blocks)
    got, flags = stencil_tile._tile_steps_plain(x, n)
    np.testing.assert_array_equal(got.numpy(), inner)
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    for out in (torch.full((6, tile, tile), 9, dtype=torch.uint8),
                torch.full_like(x, 9)):
        flags = torch.zeros((6, 2), dtype=torch.int32)
        stencil_tile.tile_step_into(x, out, flags, n)
        inside = out if out.shape[1] == tile else out[:, 1:-1, 1:-1]
        np.testing.assert_array_equal(inside.numpy(), inner)
        np.testing.assert_array_equal(flags.numpy(), want_flags)
    assert torch.equal(x, torch.from_numpy(blocks))
    assert stencil_tile.LAUNCHES == {"tile_step": 0, "tile_window": 0}


@pytest.mark.parametrize("call", [
    lambda m: m.make_tile_step_runner(3, 4),
    lambda m: m.make_tile_step_runner(8, 0),
])
def test_tile_runner_validation_matches_jax(call):
    with pytest.raises(ValueError) as want:
        call(jax_engine)
    with pytest.raises(ValueError) as got:
        call(engine)
    assert str(got.value) == str(want.value)


def test_tile_runner_is_cached_and_checks_its_operand():
    r = engine.make_tile_step_runner(8, 2)
    assert engine.make_tile_step_runner(8, 2) is r
    assert engine.make_tile_step_runner(8, 4) is not r
    with pytest.raises(ValueError, match="takes uint8"):
        r(np.zeros((2, 9, 9), np.uint8))


# ---------------------------------------------------------------------------
# simulate_sparse


def _grids():
    corner = np.zeros((64, 64), np.uint8)
    corner[1:4, 1:4] = GLIDER
    still = np.zeros((16, 16), np.uint8)
    still[4:6, 4:6] = 1
    lone = np.zeros((16, 16), np.uint8)
    lone[3, 3] = 1
    edge = np.zeros((16, 24), np.uint8)
    edge[0, 0] = edge[0, 23] = edge[15, 0] = edge[15, 23] = 1
    edge[0, 1] = edge[1, 0] = edge[15, 22] = 1
    soup = (np.random.default_rng(11).random((24, 24)) < 0.4).astype(np.uint8)
    self_wrap = np.zeros((8, 8), np.uint8)
    self_wrap[0:3, 0:3] = GLIDER
    return {"glider_corner": (corner, 300), "still": (still, 40),
            "lone": (lone, 40), "edge_wrap": (edge, 20), "soup": (soup, 60),
            "one_tile": (self_wrap, 50), "dead": (np.zeros((16, 16), np.uint8), 10)}


def _both_sparse(grid, limit, convention, memo=False, **kw):
    cfg = dict(gen_limit=limit, convention=convention, **kw)
    got = simulate_sparse(SparseBoard.from_dense(grid, 8), GameConfig(**cfg),
                          TileMemo() if memo else None)
    want = jax_sparse.simulate_sparse(JaxBoard.from_dense(grid, 8),
                                      JaxGameConfig(**cfg),
                                      JaxMemo() if memo else None)
    return got, want


def _assert_same(got, want):
    assert (got.generations, got.exit_reason) == (want.generations, want.exit_reason)
    assert got.board.to_rle() == want.board.to_rle()
    assert sorted(got.board.tiles) == sorted(want.board.tiles)
    assert (got.stats.generations, got.stats.tiles_active,
            got.stats.tiles_computed, got.stats.memo_hits) == (
        want.stats.generations, want.stats.tiles_active,
        want.stats.tiles_computed, want.stats.memo_hits)


@pytest.mark.parametrize("memo", [False, True], ids=["plain", "memo"])
@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("case", sorted(_grids()))
def test_simulate_sparse_matches_jax(case, convention, memo):
    grid, limit = _grids()[case]
    _assert_same(*_both_sparse(grid, limit, convention, memo))


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("kw", [{"check_similarity": False},
                                {"similarity_frequency": 1},
                                {"similarity_frequency": 7}, {"gen_limit": 0}])
def test_simulate_sparse_settings_match_jax(convention, kw):
    grid, limit = _grids()["still"]
    kw = dict(kw)
    limit = kw.pop("gen_limit", limit)
    _assert_same(*_both_sparse(grid, limit, convention, **kw))


def test_sparse_registry_series_match_jax_names():
    grid, limit = _grids()["glider_corner"]
    before = registry.default().snapshot()["counters"].get("sparse_runs_total", 0)
    simulate_sparse(SparseBoard.from_dense(grid, 8), GameConfig(gen_limit=20))
    snap = registry.default().snapshot()
    assert snap["counters"]["sparse_runs_total"] == before + 1
    for name in ("sparse_generations_total", "sparse_tiles_simulated_total",
                 "sparse_tiles_computed_total"):
        assert name in snap["counters"]
    for name in ("sparse_tiles_per_generation", "sparse_occupancy"):
        assert name in snap["gauges"]


# ---------------------------------------------------------------------------
# step_tiles: one worker's ownership slice with ghost rings


def _slice(board, owned):
    tiles = {c: a for c, a in board.tiles.items() if owned(c)}
    ghost = {c: Ring(a[0], a[-1], a[:, 0], a[:, -1])
             for c, a in board.tiles.items() if not owned(c)}
    return tiles, ghost


def test_step_tiles_with_ghosts_and_ownership_matches_jax():
    rng = np.random.default_rng(3)
    grid = (rng.random((32, 48)) < 0.2).astype(np.uint8)
    owned = lambda coord: coord[1] < 3  # noqa: E731 - the left half
    unowned = lambda coord: coord[1] >= 3  # noqa: E731
    merged, merged_changed = {}, False
    for mine in (owned, unowned):
        tiles, ghost = _slice(SparseBoard.from_dense(grid, 8), mine)
        b = SparseBoard(32, 48, 8, tiles)
        jb = JaxBoard(32, 48, 8, tiles)
        got, changed = sparse_engine.step_tiles(
            b, None, sparse_engine.SparseStats(), ghost=ghost, owned=mine)
        want, jchanged = jax_sparse.step_tiles(
            jb, None, jax_sparse.SparseStats(), ghost=ghost, owned=mine)
        assert changed == jchanged
        assert sorted(got.tiles) == sorted(want.tiles)
        assert got.to_rle() == want.to_rle()
        assert all(mine(c) for c in got.tiles)
        merged.update(got.tiles)
        merged_changed |= changed
    # The two slices together are one solo step.
    solo, solo_changed = sparse_engine.step_tiles(
        SparseBoard.from_dense(grid, 8), None, sparse_engine.SparseStats())
    assert SparseBoard(32, 48, 8, merged) == solo
    assert merged_changed == solo_changed


# ---------------------------------------------------------------------------
# The tile memo: keys and CAS entries in both directions


def test_memo_keys_equal_jax():
    rng = np.random.default_rng(9)
    block = (rng.random((10, 10)) < 0.5).astype(np.uint8)
    assert TileMemo.key(block, 8) == JaxMemo.key(block, 8)
    assert TileMemo.key(block, 8) != TileMemo.key(block, 16)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_memo_cas_written_by_either_package_hits_in_the_other(tmp_path, writer):
    grid, limit = _grids()["soup"]
    cas = str(tmp_path / "memo")
    cfg = dict(gen_limit=limit)
    if writer == "jax":
        cold = jax_sparse.simulate_sparse(JaxBoard.from_dense(grid, 8),
                                          JaxGameConfig(**cfg), JaxMemo(cas_dir=cas))
        warm = simulate_sparse(SparseBoard.from_dense(grid, 8), GameConfig(**cfg),
                               TileMemo(cas_dir=cas))
    else:
        cold = simulate_sparse(SparseBoard.from_dense(grid, 8), GameConfig(**cfg),
                               TileMemo(cas_dir=cas))
        warm = jax_sparse.simulate_sparse(JaxBoard.from_dense(grid, 8),
                                          JaxGameConfig(**cfg), JaxMemo(cas_dir=cas))
    assert warm.board.to_rle() == cold.board.to_rle()
    assert (warm.generations, warm.exit_reason) == (cold.generations, cold.exit_reason)
    assert cold.stats.tiles_computed > 0
    assert warm.stats.tiles_computed == 0
    assert warm.stats.memo_hits == warm.stats.tiles_active


# ---------------------------------------------------------------------------
# --engine auto's dense/sparse pick under a pinned plan cache


@pytest.fixture
def pinned_cache(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(plans.ENV_CACHE_PATH, str(path))
    select.reset()
    jax_select.reset()
    yield path
    select.reset()
    jax_select.reset()


@pytest.mark.parametrize("extents,tile", [
    ((4096, 4096), 256), ((8192, 4096), 256), ((8192, 8192), 256),
    ((8192, 8200), 256), ((65536, 65536), 256), ((6144, 6144), 512),
    ((64, 64), 8),
])
def test_auto_engine_picks_as_jax(pinned_cache, extents, tile):
    h, w = extents
    assert sparse_engine.auto_engine(h, w, tile) == jax_sparse.auto_engine(h, w, tile)
    assert select.sparse_auto_area(1) == jax_select.sparse_auto_area(1) == 1 << 25
    for area in (1 << 12, 1 << 26):
        assert sparse_engine.auto_engine(h, w, tile, area) == \
            jax_sparse.auto_engine(h, w, tile, area)


def test_measured_crossover_and_macro_threshold_are_consulted(pinned_cache):
    """Each package reads its own measured entry (the fingerprints carry the
    framework's versions); equal entries give equal picks, and an entry
    outside the band falls back to the default in both."""
    from gol_tpu.tune import plans as jax_plans

    for area, gens in ((1 << 20, 500), (1 << 40, 1 << 50)):
        plans.PlanStore().put(select.sparse_fingerprint(), {"auto_area": area})
        jax_plans.PlanStore().put(jax_select.sparse_fingerprint(), {"auto_area": area})
        plans.PlanStore().put(select.macro_fingerprint(), {"auto_gens": gens})
        jax_plans.PlanStore().put(jax_select.macro_fingerprint(), {"auto_gens": gens})
        select.reset()
        jax_select.reset()
        assert select.sparse_auto_area(7) == jax_select.sparse_auto_area(7)
        assert select.macro_auto_gens(9) == jax_select.macro_auto_gens(9)
        for side in (512, 2048, 8192):
            assert sparse_engine.auto_engine(side, side, 256) == \
                jax_sparse.auto_engine(side, side, 256)
