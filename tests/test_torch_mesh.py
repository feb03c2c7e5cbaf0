"""The port's mesh bookkeeping (gol_tpu_torch.parallel) against the JAX
package's (gol_tpu.parallel.mesh): mesh shapes, default factorizations,
grid validation and their error messages, which must be identical; and the
mesh devices with and without ``GOL_TORCH_MESH_DEVICES``. The port runs on
the CPU; JAX on this suite's 8 virtual CPU devices. Shapes and messages are
compared exactly (tolerance zero), over grids within the JAX package's
temporal width cap, where its default factorization has no port-specific
refinement.
"""

import jax
import numpy as np
import pytest
import torch

from gol_tpu.parallel import mesh as jax_mesh
from gol_tpu_torch import platform_env
from gol_tpu_torch.parallel import collectives, halo
from gol_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("grid", [None, (64, 64), (100, 64), (30, 30), (7, 96),
                                  (48, 1024)])
def test_choose_mesh_shape_matches_jax(n, grid):
    height, width = grid if grid else (None, None)
    assert (tmesh.choose_mesh_shape(n, width, height)
            == jax_mesh.choose_mesh_shape(n, width, height))


@pytest.mark.parametrize(
    "rows,cols",
    [(None, None), (4, 1), (2, 2), (2, 4), (8, 1), (1, 1), (3, None),
     (None, 3), (None, 2), (4, None), (0, 2), (3, 3), (9, 1), (0, None)],
)
def test_make_mesh_matches_jax(rows, cols):
    port = _outcome(lambda: tmesh.make_mesh(rows, cols, width=64, height=64).shape)
    want = _outcome(lambda: tuple(jax_mesh.make_mesh(
        rows, cols, devices=jax.devices()[:8], width=64, height=64).devices.shape))
    assert port == want


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2), (2, 4), (3, 1)])
@pytest.mark.parametrize("grid", [(64, 64), (16, 16), (48, 30), (30, 48)])
def test_validate_grid_matches_jax(shape, grid):
    jt = jax_mesh.Topology(shape, jax_mesh.MESH_TOPOLOGY_AXES if shape != (1, 1) else ())
    tt = tmesh.Topology(shape)
    assert tt.distributed == jt.distributed and tt.num_devices == jt.num_devices
    assert (_outcome(lambda: tmesh.validate_grid(*grid, tt))
            == _outcome(lambda: jax_mesh.validate_grid(*grid, jt)))


def test_topology_for():
    m = tmesh.make_mesh(2, 2)
    assert tmesh.topology_for(m) == tmesh.Topology((2, 2))
    assert tmesh.topology_for(tmesh.make_mesh(1, 1)) == tmesh.SINGLE_DEVICE
    assert tmesh.topology_for(None) == tmesh.SINGLE_DEVICE
    assert not tmesh.SINGLE_DEVICE.distributed


def test_mesh_devices_with_and_without_the_variable(monkeypatch):
    assert platform_env.mesh_devices() == [torch.device("cpu")] * 8
    monkeypatch.delenv("GOL_TORCH_MESH_DEVICES")
    assert platform_env.mesh_devices() == [torch.device("cpu")]
    assert tmesh.make_mesh().shape == (1, 1)
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "3")
    assert tmesh.make_mesh(width=30, height=30).shape == (3, 1)
    for bad in ("0", "x", "-2"):
        monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", bad)
        with pytest.raises(ValueError, match="GOL_TORCH_MESH_DEVICES"):
            platform_env.mesh_devices()
    # Without a card the default device is refused, not replaced.
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "4")
    monkeypatch.delenv("GOL_TORCH_DEVICE")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(platform_env.NoDeviceError):
        platform_env.mesh_devices()


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (2, 4), (1, 3)])
def test_split_gather_and_halo_match_the_torus(shape):
    rng = np.random.default_rng(sum(shape))
    grid = rng.integers(0, 2, (24, 36), dtype=np.uint8)
    mesh = tmesh.make_mesh(*shape)
    shards = tmesh.split(grid, mesh)
    h, w = 24 // shape[0], 36 // shape[1]
    assert all(tuple(s.shape) == (h, w) and s.is_contiguous() for s in shards)
    np.testing.assert_array_equal(tmesh.gather(shards, shape).numpy(), grid)
    # Each shard's exchanged (h+2, w+2) block is its window of the torus
    # padded by one cell, corners included.
    padded = np.pad(grid, 1, mode="wrap")
    for (rows, cols), block in zip(tmesh.windows(24, 36, shape),
                                   halo.exchange(shards, shape)):
        want = padded[rows.start:rows.stop + 2, cols.start:cols.stop + 2]
        np.testing.assert_array_equal(block.numpy(), want)
    # Deep ghost rows are the torus rows above and below the shard.
    for (rows, cols), (top, bot) in zip(tmesh.windows(24, 36, shape),
                                        halo.ghost_slices(shards, shape, 3)):
        extended = grid[np.arange(rows.start - 3, rows.stop + 3) % 24][:, cols]
        np.testing.assert_array_equal(top.numpy(), extended[:3])
        np.testing.assert_array_equal(bot.numpy(), extended[-3:])


def test_votes_are_ors():
    alive = [torch.tensor([0, 1, 0], dtype=torch.int32),
             torch.tensor([0, 0, 1], dtype=torch.int32)]
    assert collectives.any_flag(alive).tolist() == [0, 1, 1]
    assert collectives.all_agree(alive).tolist() == [True, False, False]
    assert bool(collectives.all_agree([torch.tensor(False)] * 4))
    assert bool(collectives.any_flag([torch.tensor(False), torch.tensor(True)]))
