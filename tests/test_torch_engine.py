"""The port's engine (gol_tpu_torch.engine, on the CPU) against the JAX
package's engine and the port's oracle, for both loop conventions.

Final grids and generation counts must be identical (the tolerance is
zero). The flows are the verify skill's four (random 48^2 for 1000
generations, 2x2 block, lone cell, all dead), a random 64^2 packed grid, a
glider crossing the torus seams of a 32x64 grid, and small patches that die
or settle deep inside a K=16 block (the K2 replay and, under the CUDA
convention, the empty-exit replay). ``auto`` takes the packed kernels where
the width divides by 32 and the byte ``lax`` loop otherwise; both kernels
run every packable flow.
"""

import numpy as np
import pytest

from gol_tpu import engine as jax_engine
from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.platform_env import NoDeviceError


def _patch(seed: int) -> np.ndarray:
    g = np.zeros((32, 64), np.uint8)
    g[12:17, 28:33] = np.random.default_rng(seed).integers(0, 2, (5, 5),
                                                           dtype=np.uint8)
    return g


def _flows() -> dict:
    block = np.zeros((48, 48), np.uint8)
    block[20:22, 20:22] = 1
    lone = np.zeros((48, 48), np.uint8)
    lone[7, 9] = 1
    glider = np.zeros((32, 64), np.uint8)
    glider[0, 1] = glider[1, 2] = glider[2, 0:3] = 1
    return {
        "random48": text_grid.generate(48, 48, seed=0),
        "block": block,
        "lone": lone,
        "dead": np.zeros((48, 48), np.uint8),
        "random64": text_grid.generate(64, 64, seed=1),
        "glider": glider,
        "dies_in_block": _patch(203),  # C: empty at generation 44
        "settles_in_block": _patch(26),  # C: still life found at 41
    }


FLOWS = _flows()
CONVENTIONS = (Convention.C, Convention.CUDA)


def _port(grid, config, kernel="auto"):
    return engine.simulate(grid, config, kernel=kernel, device="cpu")


def _check(grid, config, kernels=("auto",), with_jax=True):
    want = oracle.run(grid, config)
    if with_jax:
        j = jax_engine.simulate(grid, config)
        assert j.generations == want.generations
        np.testing.assert_array_equal(j.grid, want.grid)
    for kernel in kernels:
        got = _port(grid, config, kernel)
        assert got.generations == want.generations, kernel
        np.testing.assert_array_equal(got.grid, want.grid, err_msg=kernel)
    return want


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flow_matches_jax_and_oracle(flow, convention):
    grid = FLOWS[flow]
    kernels = ("auto", "lax", "packed") if grid.shape[1] % 32 == 0 else ("auto",)
    want = _check(grid, GameConfig(convention=convention), kernels)
    expected = {  # the verify skill's pinned counts (C convention)
        "block": 2, "lone": 1, "dead": 0, "dies_in_block": 44,
        "settles_in_block": 41,
    }
    if convention == Convention.C and flow in expected:
        assert want.generations == expected[flow]


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize(
    "options",
    [
        {"gen_limit": 37},
        {"gen_limit": 3},
        {"check_similarity": False},
        {"similarity_frequency": 1},
        {"similarity_frequency": 5},
    ],
    ids=["limit37", "limit3", "no_similarity", "freq1", "freq5"],
)
def test_options_match_jax_and_oracle(options, convention):
    config = GameConfig(convention=convention, **options)
    _check(FLOWS["random64"], config, ("auto", "lax"))
    _check(FLOWS["settles_in_block"], config, ("auto", "lax"), with_jax=False)
    _check(FLOWS["dies_in_block"], config, ("auto",), with_jax=False)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_packed_odd_heights_and_zero_limit(convention):
    # Heights the JAX Pallas gate refuses run on the port's packed kernels.
    for height in (1, 5, 13):
        grid = text_grid.generate(64, height, seed=height)
        _check(grid, GameConfig(convention=convention, gen_limit=40),
               ("packed",), with_jax=False)
    _check(FLOWS["random64"], GameConfig(convention=convention, gen_limit=0),
           ("auto",), with_jax=False)


def test_runner_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="does not support"):
        engine.make_runner((48, 48), kernel="packed", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        engine.make_runner((64, 64), kernel="bogus", device="cpu")
    run = engine.make_runner((64, 64), device="cpu")
    with pytest.raises(ValueError, match="uint8 64x64"):
        run(engine.put_grid(np.zeros((32, 64), np.uint8), "cpu"))


def test_runner_leaves_its_input_intact():
    grid = engine.put_grid(FLOWS["random64"], "cpu")
    before = grid.clone()
    run = engine.make_runner((64, 64), device="cpu")
    first = run(grid)
    assert bool((grid == before).all())
    second = run(grid)
    assert first[1] == second[1] and bool((first[0] == second[0]).all())


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        engine.make_runner((64, 64), device="cuda")
    with pytest.raises(NoDeviceError):
        engine.put_grid(np.zeros((4, 4), np.uint8), "cuda")
    monkeypatch.delenv("GOL_TORCH_DEVICE", raising=False)
    with pytest.raises(NoDeviceError):
        engine.make_runner((64, 64))  # the default device is the card
