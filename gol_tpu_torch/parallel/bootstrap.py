"""Multi-process bootstrap: the ``MPI_Init`` / ``mpiexec -n`` analog.

The port of ``gol_tpu/parallel/bootstrap.py``. The reference bootstraps its
process group with ``MPI_Init`` and a Cartesian communicator
(src/game_mpi_collective.c:116-133) launched by ``mpiexec -n <x>``; the JAX
package forms the cluster with ``jax.distributed.initialize``. Here it is
``torch.distributed.init_process_group``: one OS process per rank, each
driving its own device, ``cuda:{LOCAL_RANK % device_count}`` (or the CPU
under ``GOL_TORCH_DEVICE=cpu``).

``initialize()`` with no arguments does nothing unless ``GOL_MULTIHOST`` is
``1`` or ``true`` (JAX's explicit opt-in, kept for the same reason: a
launcher's variables alone must not make a plain run form a cluster); with
it, the rank and the rendezvous come from torch's env:// variables as
``torchrun`` sets them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). The explicit triple
rendezvouses at ``tcp://{coordinator_address}``.

The backend follows placement, decided before the group forms and logged
in one line: ``nccl`` only when every local rank has a card of its own
(``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``), with a gloo group
beside it for the host's collectives; ``gloo`` otherwise, on the CPU and
when ranks share a card (NCCL refuses two ranks on one card). Over gloo the
halo and the votes stage through host memory (``parallel/halo.py``,
``parallel/collectives.py``).

After it, ``platform_env.mesh_devices()`` lists the world's shard slots
(each rank's slot count is all-gathered here, once), ``parallel.mesh``
places every shard on the rank that owns its slot, and the file I/O of
``io/sharded.py`` and ``io/packed_io.py`` touches only the local shards'
windows: no rank holds the whole grid but the lead of the gathered lane.

A lost peer ends the others: gloo raises as soon as a peer's socket closes,
and no collective waits longer than ``TIMEOUT_S``.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os

import torch

from gol_tpu_torch import platform_env

logger = logging.getLogger(__name__)

MULTIHOST_ENV = "GOL_MULTIHOST"
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the run."""

    rank: int
    size: int
    backend: str  # "nccl" or "gloo": the transport of the device tensors
    host_group: object = None  # the gloo group of host collectives (None: the default)


_WORLD: World | None = None


def choose_backend(device: torch.device, local_size: int) -> str:
    """``nccl`` when the ranks drive cards and every local rank has its
    own, else ``gloo``."""
    if device.type == "cuda" and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _env_int(name: str, default: int | None = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise ValueError(f"{MULTIHOST_ENV}=1 needs ${name} (torch's env:// "
                             f"launcher variables, as torchrun sets them)")
        return default
    if not value.strip().lstrip("-").isdigit():
        raise ValueError(f"${name} must be an integer, got {value!r}")
    return int(value)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or form) the multi-process run; a no-op unless opted in.

    Safe to call unconditionally at CLI start, and once more in a process
    already initialized (it returns)."""
    global _WORLD
    triple = (coordinator_address, num_processes, process_id)
    if all(x is None for x in triple):
        if os.environ.get(MULTIHOST_ENV, "") not in ("1", "true"):
            return
        rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
        _env_int("MASTER_PORT")
        if not os.environ.get("MASTER_ADDR"):
            raise ValueError(f"{MULTIHOST_ENV}=1 needs $MASTER_ADDR")
        init_method = "env://"
    elif any(x is None for x in triple):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together")
    else:
        rank, size = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    if _WORLD is not None:
        return
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is outside a world of {size}")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_size = _env_int("LOCAL_WORLD_SIZE", size)
    device = platform_env.rank_device(local_rank)
    backend = choose_backend(device, local_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    logger.info("bootstrap: rank %d of %d on %s over %s (%d local rank(s), "
                "%d card(s) on the host)", rank, size, device, backend,
                local_size, torch.cuda.device_count() if device.type == "cuda" else 0)
    import torch.distributed as dist

    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
        init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # The group is torn down before the interpreter's own teardown: left to
    # static destructors, gloo's threads can abort a finished process.
    atexit.register(dist.destroy_process_group)
    host_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    # Every rank's count of shard slots, once: the world's mesh_devices().
    platform_env.set_world(rank)
    mine = torch.tensor([len(platform_env.local_mesh_devices())], dtype=torch.int64)
    counts = [torch.zeros_like(mine) for _ in range(size)]
    dist.all_gather(counts, mine, group=host_group)
    _WORLD = World(rank, size, backend, host_group)
    platform_env.set_world(rank, [int(c) for c in counts])


def world() -> World | None:
    """This process's ``World``, or None on a single process."""
    return _WORLD


def is_multihost() -> bool:
    return process_count() > 1


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.rank
