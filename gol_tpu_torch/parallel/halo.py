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
row-major lists (``parallel/mesh.py``); ``layout`` is the mesh's (R, C), or
its ``Topology``.

Across processes (a ``Topology`` whose shards have owners), the shards
given are this process's, and a neighbour on another rank is reached with
one ``batch_isend_irecv`` per phase (``_swap``): every piece this rank
sends to a peer travels in one message, in an order both sides derive from
the topology alone, and the two phases stay in order, so the column phase
still carries the corner cells. Over gloo the phase's outgoing pieces are
gathered into one device buffer, copied to the host once (a pinned buffer
for a card), exchanged, and the received bytes copied back once; over NCCL
the device buffers travel as they are. ``STATS`` counts the cross-process
phases and their host seconds (the phase's copy to the host waits for the
kernels queued before it, so on a card they hold that device time too).
"""

from __future__ import annotations

import time

import torch

from gol_tpu_torch.parallel.mesh import Topology

# Cross-process phases exchanged and the host seconds they took.
STATS = {"phases": 0, "seconds": 0.0}


def _neighbour(i: int, dr: int, dc: int, shape: tuple[int, int]) -> int:
    rows, cols = shape
    r, c = divmod(i, cols)
    return ((r + dr) % rows) * cols + (c + dc) % cols


def _split_layout(layout):
    """``(shape, topology or None)``: a topology spanning processes is
    kept, anything else is one process's mesh of that shape."""
    if isinstance(layout, Topology):
        return layout.shape, (layout if layout.multiprocess else None)
    return tuple(layout), None


_PINNED: dict = {}


def _host_buffer(key, n: int, dtype) -> torch.Tensor:
    """A pinned host buffer of ``n`` elements, one per key, size and
    dtype: a pass's phases each keep their own, so none is reallocated."""
    key = (key, n, dtype)
    if key not in _PINNED:
        _PINNED[key] = torch.empty(n, dtype=dtype, pin_memory=True)
    return _PINNED[key]


def _swap(send: dict, recv: dict, device: torch.device) -> dict:
    """One phase's point-to-point exchange: ``send`` maps a peer rank to
    the tensors it gets from this rank, ``recv`` a peer rank to templates
    of the tensors it sends here, in the same order on both sides. Returns
    the received tensors per peer, on ``device``."""
    import torch.distributed as dist

    from gol_tpu_torch.parallel import bootstrap

    t0 = time.perf_counter()
    staged = bootstrap.world().backend == "gloo" and device.type == "cuda"
    speers, rpeers = sorted(send), sorted(recv)
    flat = torch.cat([t.reshape(-1).to(device) for p in speers for t in send[p]])
    sizes = {p: sum(t.numel() for t in recv[p]) for p in rpeers}
    dtype = flat.dtype
    if staged:
        out_host = _host_buffer(("send", device), flat.numel(), dtype)
        out_host.copy_(flat)  # the phase's one device->host copy
        flat = out_host
        inbox = _host_buffer(("recv", device), sum(sizes.values()), dtype)
    else:
        inbox = torch.empty(sum(sizes.values()), dtype=dtype, device=device)
    ops, at = [], 0
    for p in speers:
        n = sum(t.numel() for t in send[p])
        ops.append(dist.P2POp(dist.isend, flat[at:at + n], p))
        at += n
    views, at = {}, 0
    for p in rpeers:
        views[p] = inbox[at:at + sizes[p]]
        ops.append(dist.P2POp(dist.irecv, views[p], p))
        at += sizes[p]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        inbox = inbox.to(device)  # the phase's one host->device copy
    got, at = {}, 0
    for p in rpeers:
        pieces = []
        for t in recv[p]:
            pieces.append(inbox[at:at + t.numel()].view(t.shape))
            at += t.numel()
        got[p] = pieces
    STATS["phases"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return got


def _fetch(offers, wants, topology: Topology):
    """Per local shard, the pieces ``wants`` names: ``(dr, dc, k)`` is
    piece k of what its (dr, dc) neighbour offers. ``offers`` lists, per
    local shard, the pieces it offers (every shard offers the same shapes).
    Local neighbours hand over their pieces; the others' come through one
    ``_swap``."""
    owners, me, shape = topology.owners, topology.rank, topology.shape
    pos = {g: i for i, g in enumerate(topology.local)}
    out = [[None] * len(wants) for _ in pos]
    send, recv, slots = {}, {}, {}
    for g, owner in enumerate(owners):
        for j, (dr, dc, k) in enumerate(wants):
            src = _neighbour(g, dr, dc, shape)
            if owner == me and owners[src] == me:
                out[pos[g]][j] = offers[pos[src]][k]
            elif owners[src] == me:
                send.setdefault(owner, []).append(offers[pos[src]][k])
            elif owner == me:
                recv.setdefault(owners[src], []).append(offers[0][k])
                slots.setdefault(owners[src], []).append((pos[g], j))
    if send or recv:
        got = _swap(send, recv, offers[0][0].device)
        for p, where in slots.items():
            for (i, j), t in zip(where, got[p]):
                out[i][j] = t
    return out


def ghost_slices(shards, layout, depth: int = 1):
    """Per shard ``(ghost_before, ghost_after)``: the ``depth`` rows above
    its first row and below its last, across the torus. ``depth`` 8 is the
    wide ghost zone of the 8-generation pass (shard height >= depth)."""
    shape, topology = _split_layout(layout)
    if topology is not None:
        got = _fetch([(x[:depth], x[-depth:]) for x in shards],
                     ((-1, 0, 1), (1, 0, 0)), topology)
        return [(north.to(x.device), south.to(x.device))
                for x, (north, south) in zip(shards, got)]
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


def exchange_columns(wests, easts, layout):
    """Column phase: per shard ``(ghost_west, ghost_east)``, its west
    neighbour's east column and its east neighbour's west column."""
    shape, topology = _split_layout(layout)
    if topology is not None:
        got = _fetch(list(zip(wests, easts)), ((0, -1, 1), (0, 1, 0)), topology)
        return [(gw.to(w.device), ge.to(w.device))
                for w, (gw, ge) in zip(wests, got)]
    return [
        (easts[_neighbour(i, 0, -1, shape)].to(w.device),
         wests[_neighbour(i, 0, 1, shape)].to(w.device))
        for i, w in enumerate(wests)
    ]


def exchange_parts(shards, layout, depth: int = 1):
    """Both phases: per shard ``(top, bot, gwest, geast)``, the (depth, w)
    ghost rows and the (h + 2*depth,) ghost columns over rows
    -depth..h+depth-1."""
    rows = ghost_slices(shards, layout, depth)
    cols = [boundary_columns(x, top, bot) for x, (top, bot) in zip(shards, rows)]
    ghosts = exchange_columns([w for w, _ in cols], [e for _, e in cols], layout)
    return [(top, bot, gw, ge) for (top, bot), (gw, ge) in zip(rows, ghosts)]


def exchange(shards, layout):
    """Per shard the (h+2, w+2) halo-extended block, for the byte ``lax``
    kernel."""
    return [
        torch.cat([gw[:, None], torch.cat([top, x, bot]), ge[:, None]], dim=1)
        for x, (top, bot, gw, ge) in zip(shards, exchange_parts(shards, layout))
    ]
