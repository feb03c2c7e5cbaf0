"""Segmented runs of the port's engine (on the CPU) against whole runs, the
oracle and the JAX package's segment loop.

The generation number and the similarity counter carry across segment
calls, so exits fire on exactly the generations of one whole run —
including exits that land inside a segment, on its boundary, inside a
K=16 flag block, and the CUDA convention's empty exit, which keeps the last
non-empty generation. Byte state (``lax``, ``pallas``, ``packed`` through
encode/decode) and packed word state (``simulate_packed_segments``), both
conventions, zero tolerance; then the same over meshes of shards, against
the JAX package's segment loop on the same mesh.
"""

import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.config import GameConfig as JaxConfig
from gol_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.parallel.mesh import gather, make_mesh, split

CONVENTIONS = (Convention.C, Convention.CUDA)
SEGMENTS = (1, 7, 16, 17)


def _grids() -> dict:
    patch = np.zeros((32, 64), np.uint8)
    patch[12:17, 28:33] = np.random.default_rng(203).integers(0, 2, (5, 5),
                                                              dtype=np.uint8)
    block = np.zeros((32, 64), np.uint8)
    block[4:6, 4:6] = 1
    lone = np.zeros((32, 64), np.uint8)
    lone[8, 8] = 1
    return {
        "random": text_grid.generate(64, 32, seed=13),
        "still": block,  # similarity exit at generation 2-3
        "lone": lone,  # empty exit at generation 1
        "dies_in_block": patch,  # empty at generation 44 (C)
        "sparse_dies": text_grid.generate(64, 32, seed=166, density=0.06),
    }


GRIDS = _grids()


def _last(segments):
    last = None
    for last in segments:
        pass
    return last


def _port_config(convention, **kw):
    return GameConfig(convention=convention, **kw)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("freq", [1, 3, 4])
@pytest.mark.parametrize("check", [True, False])
def test_resume_scalars_match_jax(convention, freq, check):
    port = GameConfig(convention=convention, similarity_frequency=freq,
                      check_similarity=check)
    jax = JaxConfig(convention=convention, similarity_frequency=freq,
                    check_similarity=check)
    for completed in (0, 1, 2, 3, 7, 12, 13, 999):
        assert engine.resume_scalars(port, completed) == \
            jax_engine.resume_scalars(jax, completed)
    with pytest.raises(ValueError, match=">= 0"):
        engine.resume_scalars(port, -1)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("kernel", ["lax", "pallas", "packed"])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_segmented_byte_state_matches_whole_run(segment, kernel, convention):
    for name, grid in GRIDS.items():
        config = _port_config(convention, gen_limit=120)
        want = oracle.run(grid, config)
        gens, final, stopped = _last(engine.simulate_segments(
            grid, config, kernel, segment, device="cpu"))
        assert (gens, stopped) == (want.generations, True), name
        np.testing.assert_array_equal(final.numpy(), want.grid, err_msg=name)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("segment", SEGMENTS)
def test_segmented_packed_state_matches_whole_run(segment, convention):
    for name, grid in GRIDS.items():
        config = _port_config(convention, gen_limit=120)
        want = oracle.run(grid, config)
        words = pm.encode(torch.from_numpy(grid))
        gens, final, stopped = _last(engine.simulate_packed_segments(
            words, grid.shape, config, segment, device="cpu"))
        assert (gens, stopped) == (want.generations, True), name
        np.testing.assert_array_equal(pm.decode(final).numpy(), want.grid,
                                      err_msg=name)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_segment_yields_match_jax(convention):
    grid = GRIDS["dies_in_block"]
    jconfig = JaxConfig(convention=convention, gen_limit=100)
    config = _port_config(convention, gen_limit=100)
    want = [(g, np.asarray(s), bool(st)) for g, s, st in
            jax_engine.simulate_segments(grid, jconfig, None, "lax", 7)]
    got = [(g, s.numpy(), st) for g, s, st in
           engine.simulate_segments(grid, config, "pallas", 7, device="cpu")]
    assert [(g, st) for g, _, st in got] == [(g, st) for g, _, st in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cuda_empty_exit_recovery_across_segments():
    grid = text_grid.generate(32, 32, seed=166, density=0.06)  # dies at 72
    config = _port_config(Convention.CUDA, gen_limit=200)
    want = oracle.run(grid, config)
    assert want.generations == 72 and want.grid.any()
    for kernel in ("pallas", "packed"):
        for segment in (1, 3, 5, 16, 100):
            gens, final, stopped = _last(engine.simulate_segments(
                grid, config, kernel, segment, device="cpu"))
            assert (gens, stopped) == (72, True), (kernel, segment)
            np.testing.assert_array_equal(final.numpy(), want.grid)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("split", [12, 13, 16, 17])
def test_resumed_run_matches_uninterrupted(convention, split):
    grid = GRIDS["random"]
    config = _port_config(convention, gen_limit=40)
    want = oracle.run(grid, config)
    snap = oracle.run(grid, _port_config(convention, gen_limit=split))
    assert want.generations > split  # the split lands mid-run
    for kernel in ("lax", "pallas", "packed"):
        gens, final, _ = _last(engine.simulate_segments(
            snap.grid, config, kernel, 5, completed=split, device="cpu"))
        assert gens == want.generations, kernel
        np.testing.assert_array_equal(final.numpy(), want.grid)
    words = pm.encode(torch.from_numpy(snap.grid))
    gens, final, _ = _last(engine.simulate_packed_segments(
        words, grid.shape, config, 6, completed=split, device="cpu"))
    assert gens == want.generations
    np.testing.assert_array_equal(pm.decode(final).numpy(), want.grid)


def test_runners_leave_their_state_intact():
    grid = torch.from_numpy(GRIDS["random"].copy())
    words = pm.encode(grid)
    config = GameConfig(gen_limit=100)
    for state, run in (
        (grid, engine.make_runner(grid.shape, config, "pallas", "cpu")),
        (words, engine.make_packed_runner(grid.shape, config, "cpu")),
    ):
        before = state.clone()
        first = run(state)
        assert torch.equal(state, before)
        assert first[1] == run(state)[1] == oracle.run(GRIDS["random"], config).generations
    seg = engine.make_segment_runner(grid.shape, config, "pallas", "cpu")
    before = grid.clone()
    out, gen, counter, stopped = seg(grid, 1, 0, 50)
    assert torch.equal(grid, before) and (gen, stopped) == (51, False)
    # A zero-step call hands the state back unchanged.
    same, gen0, _, _ = seg(out, gen, counter, 0)
    assert same is out and gen0 == gen


def test_packed_runner_rejects_byte_state():
    run = engine.make_packed_runner((32, 64), device="cpu")
    with pytest.raises(ValueError, match="int32 32x2"):
        run(torch.zeros((32, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="segment must be positive"):
        _last(engine.simulate_segments(GRIDS["lone"], GameConfig(), "lax", 0,
                                       device="cpu"))


# ---------------------------------------------------------------------------
# Segments over a mesh.

MESHES = [(2, 2), (4, 1), (1, 2)]


@pytest.fixture
def eight_shards(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("segment", [7, 16, 17])
def test_segmented_mesh_state_matches_whole_run(segment, mesh_shape, convention,
                                                eight_shards):
    # 32 x 64 over 2x2 (16-row, one-word shards), 4x1 (8-row shards) and
    # 1x2: cell shards through every kernel, then word shards.
    mesh = make_mesh(*mesh_shape)
    for name, grid in GRIDS.items():
        config = _port_config(convention, gen_limit=120)
        want = oracle.run(grid, config)
        for kernel in ("packed", "pallas", "lax"):
            gens, final, stopped = _last(engine.simulate_segments(
                grid, config, kernel, segment, mesh=mesh))
            assert (gens, stopped) == (want.generations, True), (name, kernel)
            np.testing.assert_array_equal(gather(final, mesh_shape).numpy(),
                                          want.grid, err_msg=name)
        words = split(pm.encode(torch.from_numpy(grid)), mesh)
        gens, final, stopped = _last(engine.simulate_packed_segments(
            words, grid.shape, config, segment, mesh=mesh))
        assert (gens, stopped) == (want.generations, True), name
        np.testing.assert_array_equal(
            gather([pm.decode(w) for w in final], mesh_shape).numpy(), want.grid,
            err_msg=name)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_mesh_segment_yields_match_jax(convention, eight_shards):
    grid = GRIDS["dies_in_block"]
    jconfig = JaxConfig(convention=convention, gen_limit=100)
    config = _port_config(convention, gen_limit=100)
    want = [(g, np.asarray(s), bool(st)) for g, s, st in
            jax_engine.simulate_segments(grid, jconfig, jax_make_mesh(2, 2),
                                         "packed", 7)]
    got = [(g, gather(s, (2, 2)).numpy(), st) for g, s, st in
           engine.simulate_segments(grid, config, "packed", 7,
                                    mesh=make_mesh(2, 2))]
    assert [(g, st) for g, _, st in got] == [(g, st) for g, _, st in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("split_at", [12, 13, 16, 17])
def test_resumed_mesh_run_matches_uninterrupted(convention, split_at, eight_shards):
    grid = GRIDS["random"]
    mesh = make_mesh(2, 2)
    config = _port_config(convention, gen_limit=40)
    want = oracle.run(grid, config)
    snap = oracle.run(grid, _port_config(convention, gen_limit=split_at))
    gens, final, _ = _last(engine.simulate_segments(
        snap.grid, config, "auto", 5, completed=split_at, mesh=mesh))
    assert gens == want.generations
    np.testing.assert_array_equal(gather(final, (2, 2)).numpy(), want.grid)
    words = split(pm.encode(torch.from_numpy(snap.grid)), mesh)
    gens, final, _ = _last(engine.simulate_packed_segments(
        words, grid.shape, config, 6, completed=split_at, mesh=mesh))
    assert gens == want.generations
    np.testing.assert_array_equal(
        gather([pm.decode(w) for w in final], (2, 2)).numpy(), want.grid)
