"""Device mesh construction and domain-decomposition bookkeeping.

The port of ``gol_tpu/parallel/mesh.py``. A mesh is an R x C grid of
shards, row-major, each shard its own contiguous tensor on its own device:
a column split of a row-major tensor would be strided, and the kernels take
contiguous rows. Shard ``r*C + c`` holds rows ``[r*h, (r+1)*h)`` and
columns ``[c*w, (c+1)*w)`` of the grid, where ``(h, w) =
validate_grid(...)``. The shards take the slots of
``platform_env.mesh_devices()`` in order (several may share one card).

On a single process every shard is local. In a multi-process run
(``parallel/bootstrap.py``) the slots are the world's, rank by rank, and
each shard belongs to the rank that owns its slot (``Mesh.owners``): a
process builds, steps, reads and writes only its own shards. A sharded
state in a process is the row-major list of its **local** shards, whose
global indices are ``Mesh.local``; the halo exchange (``parallel/halo.py``)
copies between local neighbours and sends to and receives from the others,
and the votes (``parallel/collectives.py``) reduce across the ranks.

The reference requires a perfect-square process count and square grids
divisible by sqrtP (src/game_mpi.c:504, :172); this build takes any R x C
mesh and rectangular grids, and refuses a grid that does not divide.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gol_tpu_torch import platform_env


@dataclasses.dataclass(frozen=True)
class Topology:
    """How the grid is laid out over shards. ``(1, 1)`` is the
    single-device engine: the halo wrap is local and the votes are
    identities. ``owners`` is the rank of each shard (row-major) in a
    multi-process run and None on one process; ``rank`` is this one's."""

    shape: tuple[int, int] = (1, 1)
    owners: tuple[int, ...] | None = None
    rank: int = 0

    @property
    def num_devices(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def distributed(self) -> bool:
        return self.num_devices > 1

    @property
    def multiprocess(self) -> bool:
        return self.owners is not None

    @property
    def local(self) -> tuple[int, ...]:
        """The global indices of this process's shards, ascending."""
        if self.owners is None:
            return tuple(range(self.num_devices))
        return tuple(i for i, r in enumerate(self.owners) if r == self.rank)


SINGLE_DEVICE = Topology()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An R x C mesh. ``devices[i]`` holds this process's i-th shard, whose
    global index is ``local[i]``; on one process that is shard i, (r, c) =
    divmod(i, C). ``owners``: as for ``Topology``."""

    shape: tuple[int, int]
    devices: tuple[torch.device, ...]
    owners: tuple[int, ...] | None = None
    rank: int = 0

    @property
    def local(self) -> tuple[int, ...]:
        return Topology(self.shape, self.owners, self.rank).local


def choose_mesh_shape(
    n_devices: int, width: int | None = None, height: int | None = None
) -> tuple[int, int]:
    """The default R x C factorization of ``n_devices``: row-heaviest.

    Full-width R x 1 shards wrap east/west within themselves, so their
    8-generation pass (K7) needs no column phase in its exchange; a shard
    with mesh columns runs the ghost-plane form of the pass, whose exchange
    also gathers the (h+16) edge columns. Where ``width``/``height`` are known, a factorization whose
    rows divide the height and whose columns divide the width is preferred
    over one ``validate_grid`` would refuse (100 rows on 8 devices: (4, 2)).
    The JAX package also adds columns past its temporal kernel's VMEM width
    cap; the port's kernels have no such cap, so it never does."""

    def divides_grid(r: int, c: int) -> bool:
        if height is not None and height % r:
            return False
        return not (width is not None and width % c)

    candidates = [
        (n_devices // c, c) for c in range(1, n_devices + 1) if n_devices % c == 0
    ]
    pool = [rc for rc in candidates if divides_grid(*rc)] or candidates
    return pool[0]


def make_mesh(
    rows: int | None = None,
    cols: int | None = None,
    devices=None,
    width: int | None = None,
    height: int | None = None,
) -> Mesh:
    """Build an R x C mesh over ``devices`` (``mesh_devices()`` by default:
    in a multi-process run, the world's slots, each shard on its slot's
    rank). ``width``/``height`` only inform the default factorization."""
    owners = None
    if devices is None:
        devices = platform_env.mesh_devices()
        if any(isinstance(d, platform_env.PeerSlot) for d in devices):
            owners = platform_env.slot_owners()
    n = len(devices)
    if rows is None and cols is None:
        rows, cols = choose_mesh_shape(n, width, height)
    elif rows is None:
        if cols <= 0 or n % cols:
            raise ValueError(f"cannot infer mesh rows: {n} devices not divisible by cols={cols}")
        rows = n // cols
    elif cols is None:
        if rows <= 0 or n % rows:
            raise ValueError(f"cannot infer mesh cols: {n} devices not divisible by rows={rows}")
        cols = n // rows
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh axes must be >= 1, got {rows}x{cols}")
    if rows * cols > n:
        raise ValueError(f"mesh {rows}x{cols} needs {rows * cols} devices, have {n}")
    if owners is None:
        return Mesh((rows, cols), tuple(devices[: rows * cols]))
    owners = tuple(owners[: rows * cols])
    rank = platform_env.process_rank()
    idle = sorted(set(platform_env.slot_owners()) - set(owners))
    if idle:
        raise ValueError(
            f"mesh {rows}x{cols} takes the first {rows * cols} of the world's "
            f"{n} shard slots and leaves rank(s) {idle} without a shard; "
            f"every rank of a multi-process run must own one")
    return Mesh((rows, cols), tuple(d for d, r in zip(devices, owners) if r == rank),
                owners, rank)


def topology_for(mesh: Mesh | None) -> Topology:
    if mesh is None or (mesh.shape == (1, 1) and mesh.owners is None):
        return SINGLE_DEVICE
    return Topology(shape=mesh.shape, owners=mesh.owners, rank=mesh.rank)


def validate_grid(height: int, width: int, topology: Topology) -> tuple[int, int]:
    """Check divisibility and return the local shard shape (the reference
    silently truncates, src/game_mpi.c:172; here it is a loud error)."""
    rows, cols = topology.shape
    if height % rows != 0 or width % cols != 0:
        raise ValueError(
            f"grid {height}x{width} does not divide over a {rows}x{cols} mesh; "
            f"height must be a multiple of {rows} and width of {cols}"
        )
    return height // rows, width // cols


def windows(height: int, width: int, shape: tuple[int, int]):
    """The (row slice, column slice) of each shard, row-major."""
    h, w = validate_grid(height, width, Topology(shape))
    return [(slice(r * h, (r + 1) * h), slice(c * w, (c + 1) * w))
            for r in range(shape[0]) for c in range(shape[1])]


def local_windows(height: int, width: int, mesh: Mesh):
    """The (row slice, column slice) of each of this process's shards."""
    every = windows(height, width, mesh.shape)
    return [every[i] for i in mesh.local]


def split(grid, mesh: Mesh) -> list[torch.Tensor]:
    """A host array or a tensor -> this process's shards, each contiguous
    on its device. (A row band of a contiguous tensor stays a view of it.)"""
    if isinstance(grid, np.ndarray):
        grid = torch.from_numpy(grid)
    return [grid[win].contiguous().to(dev)
            for win, dev in zip(local_windows(*grid.shape, mesh), mesh.devices)]


def gather(shards: list[torch.Tensor], shape: tuple[int, int]) -> torch.Tensor:
    """The shards of an R x C mesh -> one tensor on the first shard's device.
    A single process's tool: across processes the gathered lane assembles
    the grid on its lead (``io/sharded.write_gathered``)."""
    rows, cols = shape
    dev = shards[0].device
    return torch.cat([
        torch.cat([s.to(dev) for s in shards[r * cols:(r + 1) * cols]], dim=1)
        for r in range(rows)
    ], dim=0)
