"""Termination votes over the shards of a mesh.

The port of ``gol_tpu/parallel/collectives.py`` (a ``psum`` over the mesh
axes; the reference's MPI_Allreduce of a 0/1 flag, compared against
comm_sz, src/game_mpi_collective.c:70-81,98-109). The port's kernels store
"similar" negated, as "differs", so both votes are ORs: any shard alive,
and any shard that differs (all agree iff none does). Shards on one device
OR their flags into one buffer; the vote ORs the buffers of the devices.
"""

from __future__ import annotations

import functools

import torch


def any_flag(flags) -> torch.Tensor:
    """Elementwise OR of the shards' int32 (or bool) flags, on the first
    one's device: the alive-anywhere vote, and on "differs" flags the
    negated all-agree vote."""
    return functools.reduce(lambda a, b: a | b.to(a.device), flags)


def all_agree(differs) -> torch.Tensor:
    """True iff no shard's "differs" flag is set: every shard agrees (the
    ``global_sum == comm_sz`` vote, src/game_mpi_collective.c:80)."""
    return any_flag(differs) == 0
