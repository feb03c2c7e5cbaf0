"""Termination votes over the shards of a mesh, and the host collectives
of a multi-process run.

The port of ``gol_tpu/parallel/collectives.py`` (a ``psum`` over the mesh
axes; the reference's MPI_Allreduce of a 0/1 flag, compared against
comm_sz, src/game_mpi_collective.c:70-81,98-109). The port's kernels store
"similar" negated, as "differs", so both votes are ORs: any shard alive,
and any shard that differs (all agree iff none does). Shards on one device
OR their flags into one buffer; the vote ORs the buffers of the devices.

Across processes (a ``Topology`` whose shards have owners) the local OR is
then all-reduced over the ranks: the flags, 0 or 1 as the kernels set
them, are normalised to 0/1 and reduced with ``MAX``, which gloo and NCCL
both have (NCCL has no bitwise OR). Over gloo the vote is copied to the
host first. ``STATS`` counts the cross-process votes and their host
seconds.

``host_all_agree``, ``process_allgather`` and ``barrier`` are the
counterparts of the JAX package's ``host_all_agree``,
``multihost_utils.process_allgather`` and ``sync_global_devices``: host
values over the bootstrap's host group, used by the file I/O and the
checkpoint protocol between the engine's steps.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from gol_tpu_torch.parallel import bootstrap

# Cross-process votes taken and the host seconds they took.
STATS = {"votes": 0, "seconds": 0.0}


def _reduce_ranks(local: torch.Tensor) -> torch.Tensor:
    """MAX over the ranks of a 0/1 int32 vector: on the device over NCCL,
    on the host over gloo (where the result stays)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    vote = (local != 0).to(torch.int32)
    if bootstrap.world().backend != "nccl":
        vote = vote.cpu()
    dist.all_reduce(vote, op=dist.ReduceOp.MAX)
    STATS["votes"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return vote


def any_flag(flags, topology=None) -> torch.Tensor:
    """Elementwise OR of the shards' int32 (or bool) flags, on the first
    one's device: the alive-anywhere vote, and on "differs" flags the
    negated all-agree vote. With a ``topology`` spanning processes, the OR
    of every rank's shards (0/1 values)."""
    local = functools.reduce(lambda a, b: a | b.to(a.device), flags)
    if topology is None or not topology.multiprocess:
        return local
    return _reduce_ranks(local)


def all_agree(differs, topology=None) -> torch.Tensor:
    """True iff no shard's "differs" flag is set: every shard agrees (the
    ``global_sum == comm_sz`` vote, src/game_mpi_collective.c:80)."""
    return any_flag(differs, topology) == 0


def host_all_agree(flag: bool) -> bool:
    """True iff every process votes True: the per-process vote between
    steps that the checkpoint protocol runs (JAX ``host_all_agree``). On a
    single process the flag itself."""
    if bootstrap.process_count() == 1:
        return bool(flag)
    return bool(process_allgather(np.asarray(bool(flag), np.int32)).all())


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` stacked in rank order, ``(processes,
    *arr.shape)``. Every process must pass the same shape and dtype. On a
    single process ``arr[None]``."""
    arr = np.ascontiguousarray(arr)
    if bootstrap.process_count() == 1:
        return arr[None]
    import torch.distributed as dist

    world = bootstrap.world()
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(raw) for _ in range(world.size)]
    dist.all_gather(parts, raw, group=world.host_group)
    return np.stack([p.numpy().view(arr.dtype).reshape(arr.shape) for p in parts])


def barrier(name: str) -> None:
    """Every process waits here until all have arrived
    (``sync_global_devices(name)``); ``name`` says which in a timeout's
    error. A no-op on a single process."""
    if bootstrap.process_count() == 1:
        return
    import torch.distributed as dist

    try:
        dist.barrier(group=bootstrap.world().host_group)
    except RuntimeError as err:
        raise RuntimeError(f"barrier {name!r}: {err}") from err
