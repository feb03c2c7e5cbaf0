"""The port's byte kernel K4 (its plain version, on the CPU) against the JAX
package's Pallas ``stencil_pallas._step`` run in interpret mode, and the
engine's ``kernel="pallas"`` against the oracle.

New grid, alive flag and similar flag must be identical (the tolerance is
zero) on seeded grids and on patterns that die, are already still and
become still. JAX's Pallas kernel only takes heights that are multiples of
8 and widths that are multiples of 128; the port's kernel takes every
shape, and those JAX refuses are held against the oracle instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.ops import stencil_pallas as jsp
from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import stencil_pallas as tsp

KINDS = ("soup", "dead", "still", "death", "onset")
CONVENTIONS = (Convention.C, Convention.CUDA)


def _grid(kind: str, height: int, width: int, seed: int = 0) -> np.ndarray:
    g = np.zeros((height, width), np.uint8)
    r, c = height // 2, width // 2
    if kind == "soup":
        g = np.random.default_rng(seed).integers(0, 2, (height, width),
                                                 dtype=np.uint8)
    elif kind == "still":  # block: already still
        for dr in (0, 1):
            for dc in (0, 1):
                g[(r + dr) % height, (c + dc) % width] = 1
    elif kind == "death":  # domino: dies at generation 1
        g[r, c % width] = g[r, (c + 1) % width] = 1
    elif kind == "onset":  # L-tromino -> block at generation 1
        g[r, c % width] = g[(r + 1) % height, c % width] = 1
        g[r, (c + 1) % width] = 1
    return g


@pytest.mark.parametrize("height,width", [(8, 128), (16, 256)])
def test_step_matches_pallas(height, width):
    for kind in KINDS:
        g = _grid(kind, height, width, seed=height)
        jn, ja, js = jsp._step(jnp.asarray(g), interpret=True)
        tn, ta, ts = tsp.pallas_step(torch.from_numpy(g))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=kind)
        assert (bool(ta), bool(ts)) == (bool(ja), bool(js)), kind


@pytest.mark.parametrize("height,width", [(1, 1), (7, 3), (17, 161), (30, 30), (5, 130)])
def test_shapes_pallas_refuses_match_oracle(height, width):
    assert not jsp.supports(height, width, None) and tsp.supports(height, width)
    for kind in KINDS:
        g = _grid(kind, height, width, seed=width)
        want = oracle.evolve(g)
        new, alive, similar = tsp.pallas_step(torch.from_numpy(g))
        np.testing.assert_array_equal(new.numpy(), want, err_msg=kind)
        assert bool(alive) == bool(want.any()), kind
        assert bool(similar) == np.array_equal(want, g), kind


def test_step_into_ors_its_flags():
    g = torch.from_numpy(_grid("still", 8, 16))
    out = torch.empty_like(g)
    flags = torch.tensor([0, 1], dtype=torch.int32)  # an earlier "differs"
    tsp._step_into(g, out, flags)
    assert flags.tolist() == [1, 1]  # alive ORed in, differs kept
    dead = torch.zeros((8, 16), dtype=torch.uint8)
    flags = torch.zeros(2, dtype=torch.int32)
    tsp._step_into(dead, out, flags)
    assert flags.tolist() == [0, 0]


def test_wrapper_checks_its_operands():
    g = torch.from_numpy(_grid("soup", 8, 16))
    flags = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="alias"):
        tsp._step_into(g, g, flags)
    with pytest.raises(ValueError, match="uint8"):
        tsp._step_into(g.to(torch.int32), torch.empty_like(g), flags)
    with pytest.raises(ValueError, match="flags"):
        tsp._step_into(g, torch.empty_like(g), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tsp._step_into(g.t(), torch.empty_like(g.t()), flags)
    with pytest.raises(ValueError, match="unsupported"):
        tsp._step_into(g[:0], torch.empty_like(g[:0]), flags)
    # The plain path counts no launches: the counter is for the card.
    before = dict(tsp.LAUNCHES)
    tsp.pallas_step(g)
    assert tsp.LAUNCHES == before


def _flows() -> dict:
    block = np.zeros((48, 48), np.uint8)
    block[20:22, 20:22] = 1
    lone = np.zeros((48, 48), np.uint8)
    lone[7, 9] = 1
    glider = np.zeros((32, 64), np.uint8)
    glider[0, 1] = glider[1, 2] = glider[2, 0:3] = 1
    patch = np.zeros((32, 64), np.uint8)
    patch[12:17, 28:33] = np.random.default_rng(203).integers(0, 2, (5, 5),
                                                              dtype=np.uint8)
    return {
        "random48": text_grid.generate(48, 48, seed=0),
        "block": block,
        "lone": lone,
        "dead": np.zeros((48, 48), np.uint8),
        "glider": glider,
        "dies_in_block": patch,  # C: empty at generation 44
        "random30": text_grid.generate(30, 30, seed=2),
        "random17x161": text_grid.generate(161, 17, seed=3),
    }


FLOWS = _flows()


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_engine_pallas_matches_oracle(flow, convention):
    grid = FLOWS[flow]
    for limit in (1000, 37):
        config = GameConfig(convention=convention, gen_limit=limit)
        want = oracle.run(grid, config)
        got = engine.simulate(grid, config, kernel="pallas", device="cpu")
        assert got.generations == want.generations, limit
        np.testing.assert_array_equal(got.grid, want.grid)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_engine_pallas_matches_jax_pallas(convention):
    grid = _grid("soup", 16, 128, seed=21)
    config = GameConfig(convention=convention, gen_limit=60)
    want = jax_engine.simulate(grid, config, kernel="pallas")
    got = engine.simulate(grid, config, kernel="pallas", device="cpu")
    assert got.generations == want.generations
    np.testing.assert_array_equal(got.grid, want.grid)
