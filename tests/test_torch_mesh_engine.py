"""The port's engine over a mesh (gol_tpu_torch.engine on the CPU, with 8
mesh devices) against the JAX package's engine under ``shard_map`` on the
same R x C mesh of this suite's 8 virtual CPU devices, and against the
port's oracle, for both loop conventions.

Final grids and generation counts must be identical (tolerance zero). The
port's ``auto`` (packed: K7 with K8 replays and K5 tails on 4x1, K5 every
generation on 2x2 and 2x4), ``pallas`` (K6) and ``lax`` run against JAX's
``packed``, ``pallas`` and ``lax``. The inputs are a random soup, the still,
dying and onset cases of tests/test_packed.py moved onto a shard border, a
glider crossing the seams, the two cross-shard transients of
``test_fast_flag_cross_shard_transient``, and shards of odd and of fewer
than 8 rows.
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
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (2, 4)])
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


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("height", [36, 20], ids=["odd_shards", "short_shards"])
def test_odd_and_short_shards(height, convention):
    # 4x1 shards of 9 rows (the 8-generation pass) and of 5 rows (K5 every
    # generation); 2x2 shards of 18 and 10 rows. JAX's Pallas kernels take
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
    for factory in (engine.make_segment_runner, engine.make_packed_runner,
                    engine.make_packed_segment_runner):
        with pytest.raises(ValueError, match="Queue 1 item 11c"):
            factory(grid.shape, mesh=mesh)
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
    with pytest.raises(ValueError, match="pass does not take"):
        sp.packed_step_multi(split(words, make_mesh(2, 2)), Topology((2, 2)))
