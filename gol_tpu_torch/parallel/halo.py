"""Two-phase toroidal halo exchange between the shards of a mesh.

The port of ``gol_tpu/parallel/halo.py``, where the exchange is
``ppermute`` rings inside the compiled step. Here it is explicit copies
from neighbour shards into per-shard ghost tensors, on the receiving
shard's device (a view where the two shards share one):

  phase 1  rows:    each shard's ghost rows are its north neighbour's last
                    rows and its south neighbour's first rows
  phase 2  columns: the same east/west, but over the row-extended (h+2)
                    range, so the received columns already hold the
                    diagonal neighbours' corner cells (the reference's CUDA
                    trick, src/game_cuda.cu:64-74).

Both phases take a depth: 1 for the per-generation kernels, 8 for the
8-generation pass, whose column phase then runs over rows -8..h+7 and hands
over the neighbours' whole edge columns.

On a mesh axis of size 1 the wrap is the shard's own far edge
(src/game_cuda.cu:52-74). Every function reads the shards it is given and
returns new tensors or views of them, never writing a shard, so a pass can
exchange from its input buffers and write its outputs elsewhere. Shards are
row-major lists (``parallel/mesh.py``); ``shape`` is the mesh's (R, C).
"""

from __future__ import annotations

import torch


def _neighbour(i: int, dr: int, dc: int, shape: tuple[int, int]) -> int:
    rows, cols = shape
    r, c = divmod(i, cols)
    return ((r + dr) % rows) * cols + (c + dc) % cols


def ghost_slices(shards, shape: tuple[int, int], depth: int = 1):
    """Per shard ``(ghost_before, ghost_after)``: the ``depth`` rows above
    its first row and below its last, across the torus. ``depth`` 8 is the
    wide ghost zone of the 8-generation pass (shard height >= depth)."""
    out = []
    for i, x in enumerate(shards):
        north = shards[_neighbour(i, -1, 0, shape)]
        south = shards[_neighbour(i, 1, 0, shape)]
        out.append((north[-depth:].to(x.device), south[:depth].to(x.device)))
    return out


def boundary_columns(x: torch.Tensor, top: torch.Tensor, bot: torch.Tensor):
    """West/east boundary columns of a shard over the row-extended range,
    so the ghost rows' corner cells ride along in the column phase."""
    west = torch.cat([top[:, 0], x[:, 0], bot[:, 0]])
    east = torch.cat([top[:, -1], x[:, -1], bot[:, -1]])
    return west, east


def exchange_columns(wests, easts, shape: tuple[int, int]):
    """Column phase: per shard ``(ghost_west, ghost_east)``, its west
    neighbour's east column and its east neighbour's west column."""
    return [
        (easts[_neighbour(i, 0, -1, shape)].to(w.device),
         wests[_neighbour(i, 0, 1, shape)].to(w.device))
        for i, w in enumerate(wests)
    ]


def exchange_parts(shards, shape: tuple[int, int], depth: int = 1):
    """Both phases: per shard ``(top, bot, gwest, geast)``, the (depth, w)
    ghost rows and the (h + 2*depth,) ghost columns over rows
    -depth..h+depth-1."""
    rows = ghost_slices(shards, shape, depth)
    cols = [boundary_columns(x, top, bot) for x, (top, bot) in zip(shards, rows)]
    ghosts = exchange_columns([w for w, _ in cols], [e for _, e in cols], shape)
    return [(top, bot, gw, ge) for (top, bot), (gw, ge) in zip(rows, ghosts)]


def exchange(shards, shape: tuple[int, int]):
    """Per shard the (h+2, w+2) halo-extended block, for the byte ``lax``
    kernel."""
    return [
        torch.cat([gw[:, None], torch.cat([top, x, bot]), ge[:, None]], dim=1)
        for x, (top, bot, gw, ge) in zip(shards, exchange_parts(shards, shape))
    ]
