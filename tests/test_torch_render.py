"""The port's VT100 renderer (gol_tpu_torch/render.py) against the JAX
package's (gol_tpu/render.py): the same escape-code stream and the same
final grid on seeded grids, with zero tolerance."""

import io

import numpy as np
import pytest

from gol_tpu import render as jax_render
from gol_tpu_torch import render

SHAPES = [(1, 1), (2, 3), (8, 8), (5, 17), (16, 9)]


def _grid(shape, seed):
    return (np.random.default_rng(seed).random(shape) < 0.4).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_frame_matches_jax(shape):
    grid = _grid(shape, seed=shape[0] * 31 + shape[1])
    assert render.frame(grid) == jax_render.frame(grid)
    for module in (render, jax_render):
        out = io.StringIO()
        module.show(grid, out)
        assert out.getvalue() == render.frame(grid)


def _animate(module, grid, generations, fps):
    out, sleeps = io.StringIO(), []
    final = module.animate(grid.copy(), generations, fps=fps, out=out,
                           sleep=sleeps.append)
    return out.getvalue(), final, sleeps


@pytest.mark.parametrize("fps", [0.0, 4.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_animate_matches_jax(shape, fps):
    grid = _grid(shape, seed=7 + shape[0] * shape[1])
    stream, final, sleeps = _animate(render, grid, 12, fps)
    jax_stream, jax_final, jax_sleeps = _animate(jax_render, grid, 12, fps)
    assert stream == jax_stream
    np.testing.assert_array_equal(final, jax_final)
    assert sleeps == jax_sleeps
    assert stream.startswith("\033[2J")


def test_animate_stops_on_an_empty_grid_as_jax_does():
    grid = np.zeros((8, 8), np.uint8)
    grid[3, 3] = 1  # a lone cell dies after one step
    stream, final, sleeps = _animate(render, grid, 10, 10.0)
    assert (stream, sleeps) == _animate(jax_render, grid, 10, 10.0)[::2]
    assert not final.any()
    assert stream.count("\033[H") == 2  # the initial frame and one step
    assert sleeps == [0.1]
