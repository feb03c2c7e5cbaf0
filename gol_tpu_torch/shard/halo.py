"""Halo extraction + GOLP frame codec for the sharded single-job engine.

The byte-exactness argument that makes ring-only exchange sufficient: the
sparse engine's tile step reads ONLY its neighbors' outermost ring
(engine._assemble_block), and its activation walk triggers ONLY on
ring-live tiles (engine._active_set) — so a remote live tile whose ring is
all-dead is indistinguishable from an absent tile. Per super-step each
worker therefore ships, to each peer, exactly the ring strips of its own
ring-live tiles that are torus-adjacent to a tile the peer owns — the
minimal traffic that is still provably byte-exact, and the direct analog
of ``game_mpi.c``'s halo ``MPI_Sendrecv`` rows/columns (one GOLP frame per
(sender, peer, step) instead of eight point-to-point messages).

A frame with no boundary tiles is STILL sent (zero payload rows): the
receiver's super-step barrier completes on frame ARRIVAL from every peer,
never on guessing whether a peer had anything to say — the deterministic
completion rule a data-dependent sender set needs.

Frames ride io/wire.py verbatim — same header, CRC, and body caps as every
other packed hop, so breakers, deadline budgets, retry budgets, and the
chaos proxy apply to the halo hop without a line of new transport code.

Numpy + wire only (no torch): both worker and coordinator sides import this.
"""

from __future__ import annotations

import typing

import numpy as np

from gol_tpu_torch.io import wire


class Ring(typing.NamedTuple):
    """One tile's outermost ring, the only cells a neighbor's step reads.

    ``left``/``right`` are the full edge COLUMNS stored as length-``tile``
    arrays; corners appear in both the row and the column views (top[0] ==
    left[0], etc.) — engine._assemble_block reads corners from whichever
    view is natural."""

    top: np.ndarray
    bottom: np.ndarray
    left: np.ndarray
    right: np.ndarray


def ring_of(arr: np.ndarray) -> Ring:
    """Extract one tile's ring (copies: the frames outlive the board)."""
    return Ring(arr[0].copy(), arr[-1].copy(),
                arr[:, 0].copy(), arr[:, -1].copy())


def outgoing(board, partition, self_id: str) -> dict[str, dict]:
    """``peer_id -> {coord: Ring}``: what this worker owes each peer for
    the CURRENT board state.

    A tile crosses the wire to peer P iff it is live, its ring is live,
    and at least one of its 8 torus neighbors is owned by P — the exact
    set P's activation walk and block assembly can observe. Both sides
    compute adjacency from the same partition, so the expected-sender map
    is consistent across every ownership boundary by construction."""
    from gol_tpu_torch.sparse.engine import ring_live

    out: dict[str, dict] = {
        wid: {} for wid in partition.worker_ids if wid != self_id
    }
    for coord, arr in board.tiles.items():
        ring = None
        for nb in partition.neighbors(coord):
            own = partition.owner(nb)
            if own == self_id or coord in out[own]:
                continue
            if ring is None:
                if not ring_live(arr):
                    break  # a ring-dead tile crosses no boundary
                ring = ring_of(arr)
            out[own][coord] = ring
    return out


def encode(job: str, step: int, sender: str, entries: dict,
           tile: int) -> bytes:
    """One halo frame: ``entries`` is ``{(ty, tx): Ring}`` (may be empty —
    the barrier-completion frame). Payload stacks 4 rows per tile in
    sorted-coord order: top, bottom, left-as-row, right-as-row."""
    coords = sorted(entries)
    grid = np.zeros((4 * len(coords), tile), np.uint8)
    for i, coord in enumerate(coords):
        ring = entries[coord]
        grid[4 * i] = ring.top
        grid[4 * i + 1] = ring.bottom
        grid[4 * i + 2] = ring.left
        grid[4 * i + 3] = ring.right
    meta = {
        wire.META_KIND: wire.SHARD_HALO_KIND,
        "job": job,
        "step": int(step),
        "from": sender,
        "tile": int(tile),
        "tiles": [[int(ty), int(tx)] for ty, tx in coords],
    }
    return wire.encode_frame(meta, grid=grid)


def decode(raw: bytes) -> tuple[dict, dict]:
    """Inverse of ``encode``: ``(meta, {(ty, tx): Ring})``. Raises
    wire.WireError on anything torn (the CRC pass runs inside
    decode_frame — a corrupted halo hop answers 400 and the sender
    resends, exactly like a corrupted submit)."""
    frame = wire.decode_frame(raw)
    meta = frame.meta
    if meta.get(wire.META_KIND) != wire.SHARD_HALO_KIND:
        raise wire.WireError(
            f"not a shard halo frame (kind={meta.get(wire.META_KIND)!r})"
        )
    for field in ("job", "step", "from", "tile", "tiles"):
        if field not in meta:
            raise wire.WireError(f"halo frame meta missing {field!r}")
    tiles = meta["tiles"]
    tile = int(meta["tile"])
    if frame.width != tile or frame.height != 4 * len(tiles):
        raise wire.WireError(
            f"halo frame geometry {frame.height}x{frame.width} does not "
            f"match {len(tiles)} tiles of edge {tile}"
        )
    grid = frame.grid()
    rings = {}
    for i, (ty, tx) in enumerate(tiles):
        rings[(int(ty), int(tx))] = Ring(
            grid[4 * i], grid[4 * i + 1], grid[4 * i + 2], grid[4 * i + 3]
        )
    return meta, rings


def encode_tiles(job: str, step: int, sender: str, tiles: dict,
                 tile: int) -> bytes:
    """One tile-transfer frame (elastic rebalance): ``tiles`` is
    ``{(ty, tx): (tile, tile) uint8}`` full migrating tiles, stacked as
    ``tile`` rows each in sorted-coord order."""
    coords = sorted(tiles)
    grid = np.zeros((tile * len(coords), tile), np.uint8)
    for i, coord in enumerate(coords):
        grid[i * tile:(i + 1) * tile] = tiles[coord]
    meta = {
        wire.META_KIND: wire.SHARD_TILES_KIND,
        "job": job,
        "step": int(step),
        "from": sender,
        "tile": int(tile),
        "tiles": [[int(ty), int(tx)] for ty, tx in coords],
    }
    return wire.encode_frame(meta, grid=grid)


def decode_tiles(raw: bytes) -> tuple[dict, dict]:
    """Inverse of ``encode_tiles``: ``(meta, {(ty, tx): array})``."""
    frame = wire.decode_frame(raw)
    meta = frame.meta
    if meta.get(wire.META_KIND) != wire.SHARD_TILES_KIND:
        raise wire.WireError(
            f"not a shard tile-transfer frame "
            f"(kind={meta.get(wire.META_KIND)!r})"
        )
    tiles = meta.get("tiles", [])
    tile = int(meta.get("tile", 0))
    if frame.width != tile or frame.height != tile * len(tiles):
        raise wire.WireError(
            f"tile-transfer geometry {frame.height}x{frame.width} does "
            f"not match {len(tiles)} tiles of edge {tile}"
        )
    grid = frame.grid()
    out = {}
    for i, (ty, tx) in enumerate(tiles):
        out[(int(ty), int(tx))] = grid[i * tile:(i + 1) * tile].copy()
    return meta, out
