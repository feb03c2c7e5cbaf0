"""The port's engine over a mesh (gol_tpu_torch.engine on the CPU, with 8
mesh devices) against the JAX package's engine under ``shard_map`` on the
same R x C mesh of this suite's 8 virtual CPU devices, and against the
port's oracle, for both loop conventions.

Final grids and generation counts must be identical (tolerance zero). The
port's ``auto`` (packed: K7 with K8 replays on 4x1, the ghost-plane pass
that replaces K9-K13 on 2x2, 2x4 and 1x4, K5 for block tails), ``pallas``
(K6) and ``lax`` run against JAX's ``packed``, ``pallas`` and ``lax``, and
on the meshes with columns against JAX's ``packed-interp``, which runs its
split-edge Pallas kernels in interpret mode. The inputs are a random soup,
the still, dying and onset cases of tests/test_packed.py moved onto a shard
border, a glider crossing the seams, the cross-shard transients of
``test_fast_flag_cross_shard_transient`` and
``test_split_fast_cross_shard_transient``, and shards of 8, 9 and 17 rows,
of one word, of odd and of fewer than 8 rows.
"""

import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.ops import stencil_pallas as spl
from gol_tpu_torch.parallel.mesh import Topology, gather, make_mesh, split

CONVENTIONS = (Convention.C, Convention.CUDA)
JAX_KERNEL = {"auto": "packed", "pallas": "pallas", "lax": "lax"}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")


def _pattern(shape, cells):
    g = np.zeros(shape, np.uint8)
    for r, c in cells:
        g[r % shape[0], c % shape[1]] = 1
    return g


def _border_cases():
    """32 x 512: every 4x1, 2x2 and 2x4 shard is at least 8 x 128 (JAX's
    Pallas tiles). Rows 15/16 and columns 127/128 are shard borders."""
    shape = (32, 512)
    return {
        "random": text_grid.generate(512, 32, seed=31),
        "still": _pattern(shape, [(15, 127), (15, 128), (16, 127), (16, 128)]),
        "dying": _pattern(shape, [(15, 127), (15, 128)]),
        "onset": _pattern(shape, [(15, 127), (16, 127), (15, 128)]),
        "glider": _pattern(shape, [(-2, -1), (-1, 0), (0, -2), (0, -1), (0, 0)]),
    }


BORDER_CASES = _border_cases()


@pytest.mark.parametrize("kernel", ["auto", "pallas", "lax"])
@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (2, 4), (1, 4)])
def test_mesh_matches_jax_and_oracle(mesh_shape, convention, kernel):
    config = GameConfig(convention=convention, gen_limit=300)
    mesh, jmesh = make_mesh(*mesh_shape), jax_make_mesh(*mesh_shape)
    for name, grid in BORDER_CASES.items():
        want = oracle.run(grid, config)
        j = jax_engine.simulate(grid, config, mesh=jmesh, kernel=JAX_KERNEL[kernel])
        got = engine.simulate(grid, config, kernel=kernel, mesh=mesh)
        assert got.generations == j.generations == want.generations, name
        np.testing.assert_array_equal(got.grid, want.grid, err_msg=name)
        np.testing.assert_array_equal(j.grid, want.grid, err_msg=name)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize(
    "rows,cols",
    [([31, 27, 30, 31, 29, 27, 28, 30, 29, 30, 27],
      [68, 70, 68, 67, 70, 60, 69, 70, 65, 60, 65]),
     ([29, 30, 30, 29, 30, 31], [64, 65, 63, 66, 66, 68])],
    ids=["transient1", "transient2"],
)
def test_cross_shard_transient(rows, cols, convention):
    # 16-row shards run the 8-generation pass (K7); a transient enters one
    # shard between its summary taps, so only the voted summary is exact.
    config = GameConfig(convention=convention, gen_limit=30, similarity_frequency=1)
    g = np.zeros((64, 128), np.uint8)
    g[rows, cols] = 1
    want = oracle.run(g, config)
    j = jax_engine.simulate(g, config, mesh=jax_make_mesh(4, 1), kernel="packed")
    assert j.generations == want.generations
    for kernel in ("auto", "pallas"):
        for shape in ((4, 1), (2, 2)):
            got = engine.simulate(g, config, kernel=kernel, mesh=make_mesh(*shape))
            assert got.generations == want.generations, (kernel, shape)
            np.testing.assert_array_equal(got.grid, want.grid)


def _spy_on(monkeypatch, *names):
    """Count the calls of ``stencil_packed``'s wrappers ``names``."""
    calls = dict.fromkeys(names, 0)

    def spy(name):
        real = getattr(sp, name)

        def wrapper(*args):
            calls[name] += 1
            return real(*args)

        return wrapper

    for name in names:
        monkeypatch.setattr(sp, name, spy(name))
    return calls


PASS_AND_STEP = ("_step_tg_fast_into", "_step_tg_into", "_step_trow_fast_into",
                 "_distributed_step_into")


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (1, 4)])
def test_column_meshes_match_jax_packed_interp(mesh_shape, convention, monkeypatch):
    # JAX runs K9-K12 in interpret mode under shard_map; the port's one
    # ghost-plane pass must give the same bytes and counts. 2T+3
    # generations: two passes and a 3-generation tail (K5).
    grid = np.random.default_rng(53).integers(0, 2, size=(64, 256), dtype=np.uint8)
    config = GameConfig(convention=convention, gen_limit=2 * sp.TEMPORAL_GENS + 3)
    want = oracle.run(grid, config)
    j = jax_engine.simulate(grid, config, mesh=jax_make_mesh(*mesh_shape),
                            kernel="packed-interp")
    calls = _spy_on(monkeypatch, *PASS_AND_STEP)
    got = engine.simulate(grid, config, mesh=make_mesh(*mesh_shape))
    assert got.generations == j.generations == want.generations
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(j.grid, want.grid)
    # The spy: the 8-generation route was taken, two passes and three single
    # generations per shard.
    shards = mesh_shape[0] * mesh_shape[1]
    assert calls == {"_step_tg_fast_into": 2 * shards, "_step_tg_into": 0,
                     "_step_trow_fast_into": 0, "_distributed_step_into": 3 * shards}


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize(
    "rows,cols",
    [([32, 33, 32, 32, 34, 33, 34, 32, 32, 31, 34, 32, 34],
      [130, 128, 125, 127, 128, 129, 128, 129, 131, 131, 124, 130, 132]),
     ([32, 33, 32, 34, 34, 31], [130, 131, 127, 130, 131, 129])],
    ids=["transient1", "transient2"],
)
def test_cross_shard_transient_on_a_mesh_with_columns(rows, cols, convention,
                                                      monkeypatch):
    # Transients on both seams of a 2x2 mesh die inside a pass, so a shard's
    # own summary lies about stillness (tests/test_packed.py's
    # test_split_fast_cross_shard_transient): only the voted summary, then
    # the exact replay on every shard, counts right.
    config = GameConfig(convention=convention, gen_limit=30, similarity_frequency=1)
    g = np.zeros((64, 256), np.uint8)
    g[rows, cols] = 1
    want = oracle.run(g, config)
    if convention == Convention.C:
        j = jax_engine.simulate(g, config, mesh=jax_make_mesh(2, 2),
                                kernel="packed-interp")
        assert j.generations == want.generations
        np.testing.assert_array_equal(j.grid, want.grid)
    calls = _spy_on(monkeypatch, "_step_tg_fast_into", "_step_tg_into")
    got = engine.simulate(g, config, mesh=make_mesh(2, 2))
    assert got.generations == want.generations
    np.testing.assert_array_equal(got.grid, want.grid)
    assert calls["_step_tg_fast_into"] > 0 and calls["_step_tg_into"] > 0
    got = engine.simulate(g, config, kernel="pallas", mesh=make_mesh(2, 2))
    assert got.generations == want.generations


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("height,width,mesh_shape,passes",
                         [(16, 64, (2, 2), True), (18, 64, (2, 2), True),
                          (34, 128, (2, 2), True), (17, 64, (1, 2), True),
                          (14, 64, (2, 2), False), (8, 256, (1, 8), True)],
                         ids=["8_rows_one_word", "9_rows_one_word", "17_rows",
                              "1x2_one_word", "7_rows", "1x8_one_word"])
def test_shards_the_jax_pass_does_not_take(height, width, mesh_shape, passes,
                                           convention, monkeypatch):
    # The port's pass takes any shard of at least 8 rows, one word wide
    # too; JAX's needs h % 8 == 0, h >= 16 (its tiling), so its packed
    # kernel runs these per generation and only the bytes compare. Shards
    # under 8 rows run K5 every generation here as well.
    grid = text_grid.generate(width, height, seed=height + width)
    config = GameConfig(convention=convention, gen_limit=100)
    want = oracle.run(grid, config)
    j = jax_engine.simulate(grid, config, mesh=jax_make_mesh(*mesh_shape),
                            kernel="lax")
    assert j.generations == want.generations
    np.testing.assert_array_equal(j.grid, want.grid)
    calls = _spy_on(monkeypatch, *PASS_AND_STEP)
    got = engine.simulate(grid, config, mesh=make_mesh(*mesh_shape))
    assert got.generations == want.generations
    np.testing.assert_array_equal(got.grid, want.grid)
    assert (calls["_step_tg_fast_into"] > 0) == passes
    assert passes or calls["_distributed_step_into"] > 0


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("height", [36, 20], ids=["odd_shards", "short_shards"])
def test_odd_and_short_shards(height, convention):
    # 4x1 shards of 9 rows (the 8-generation pass) and of 5 rows (K5 every
    # generation); 2x2 shards of 18 and 10 rows (the ghost-plane pass).
    # JAX's Pallas kernels take
    # no such shard, so pallas is held against JAX's lax and the oracle.
    grid = text_grid.generate(128, height, seed=height)
    config = GameConfig(convention=convention, gen_limit=200)
    want = oracle.run(grid, config)
    j = jax_engine.simulate(grid, config, mesh=jax_make_mesh(4, 1), kernel="lax")
    assert j.generations == want.generations
    np.testing.assert_array_equal(j.grid, want.grid)
    for shape in ((4, 1), (2, 2)):
        for kernel in ("auto", "pallas", "lax"):
            got = engine.simulate(grid, config, kernel=kernel, mesh=make_mesh(*shape))
            assert got.generations == want.generations, (shape, kernel)
            np.testing.assert_array_equal(got.grid, want.grid)


def test_mesh_runner_contract():
    mesh = make_mesh(4, 1)
    grid = BORDER_CASES["random"]
    run = engine.make_runner(grid.shape, mesh=mesh)
    shards = engine.put_grid(grid, mesh=mesh)
    assert len(shards) == 4 and all(tuple(s.shape) == (8, 512) for s in shards)
    before = [s.clone() for s in shards]
    final, gens = run(shards)
    assert all(bool((a == b).all()) for a, b in zip(shards, before))
    assert len(final) == 4 and gens == oracle.run(grid).generations
    with pytest.raises(ValueError, match="4 shards"):
        run(shards[:3])
    with pytest.raises(ValueError, match="does not divide over a 3x1 mesh"):
        engine.make_runner(grid.shape, mesh=make_mesh(3, 1))
    # The segment and packed-state runners over the same mesh: the list of
    # cell shards or of (8, 16) word shards in, the same out.
    want = oracle.run(grid)
    words = [pm.encode(s) for s in shards]
    final_w, gens_w = engine.make_packed_runner(grid.shape, mesh=mesh)(words)
    assert gens_w == gens and all(tuple(w.shape) == (8, 16) for w in final_w)
    np.testing.assert_array_equal(
        gather([pm.decode(w) for w in final_w], (4, 1)).numpy(), want.grid)
    for factory, state, decode in (
            (engine.make_segment_runner, shards, lambda s: s),
            (engine.make_packed_segment_runner, words, pm.decode)):
        seg = factory(grid.shape, mesh=mesh)
        mid, gen, counter, stopped = seg(state, 1, 0, 20)
        assert (gen, stopped) == (21, False) and len(mid) == 4
        end, gen, _, stopped = seg(mid, gen, counter, 1000)
        assert (gen - 1, stopped) == (gens, True)
        np.testing.assert_array_equal(
            gather([decode(s) for s in end], (4, 1)).numpy(), want.grid)
    with pytest.raises(ValueError, match="int32 8x16 shard"):
        engine.make_packed_runner(grid.shape, mesh=mesh)(shards)
    # A 1x1 mesh is the single-device engine behind the shard-list API.
    one = engine.make_runner(grid.shape, mesh=make_mesh(1, 1))
    final1, gens1 = one(engine.put_grid(grid, mesh=make_mesh(1, 1)))
    assert gens1 == gens and len(final1) == 1


@pytest.mark.parametrize("case", ["random", "transient"])
def test_mesh_steps_match_the_single_device_steps(case):
    # The JAX-signature steps over a list of shards: their voted flags are
    # the single device's. The transient makes one 16-row shard's own
    # summary claim stillness for the whole pass (test_packed.py:722-749).
    if case == "random":
        g = text_grid.generate(128, 64, seed=8)
    else:
        g = np.zeros((64, 128), np.uint8)
        g[[29, 30, 30, 29, 30, 31], [64, 65, 63, 66, 66, 68]] = 1
    mesh = make_mesh(4, 1)
    words = pm.encode(torch.from_numpy(g))
    shards = split(words, mesh)
    for _ in range(3):
        new, alive, similar = sp.packed_step_multi(shards, Topology((4, 1)))
        want = sp.packed_step_multi(words)
        assert torch.equal(gather(new, (4, 1)), want[0])
        assert alive.tolist() == want[1].tolist()
        assert similar.tolist() == want[2].tolist()
        shards, words = new, want[0]
    # ... and over a mesh with columns (the ghost-plane pair), from the start.
    words = pm.encode(torch.from_numpy(g))
    for shape in ((2, 2), (1, 4)):
        shards, single = split(words, make_mesh(*shape)), words
        for _ in range(3):
            new, alive, similar = sp.packed_step_multi(shards, Topology(shape))
            want = sp.packed_step_multi(single)
            assert torch.equal(gather(new, shape), want[0])
            assert alive.tolist() == want[1].tolist()
            assert similar.tolist() == want[2].tolist()
            shards, single = new, want[0]
    words = single
    for shape in ((4, 1), (2, 2)):
        new, alive, similar = sp.packed_step(split(words, make_mesh(*shape)),
                                             Topology(shape))
        want = sp.packed_step(words)
        assert torch.equal(gather(new, shape), want[0])
        assert (bool(alive), bool(similar)) == (bool(want[1]), bool(want[2]))
        cells = pm.decode(words)
        new, alive, similar = spl.pallas_step(split(cells, make_mesh(*shape)),
                                              Topology(shape))
        want = spl.pallas_step(cells)
        assert torch.equal(gather(new, shape), want[0])
        assert (bool(alive), bool(similar)) == (bool(want[1]), bool(want[2]))
    # A shard under 8 rows is what the pass still refuses.
    with pytest.raises(ValueError, match="pass does not take"):
        sp.packed_step_multi(split(words[:8], make_mesh(2, 2)), Topology((2, 2)))
