"""Memoized centered advance: the macrocell RESULT, content-addressed.

The port of ``gol_tpu/macro/advance.py``: the same recursion, memo tiers,
content keys and CAS payloads (a ``--macro-cas`` directory written by
either package hits in the other), with the leaf base case on T1.

``advance(memo, node, t)`` returns the center half-size node exactly
``t`` generations later, for any ``0 <= t <= size/4`` — the light-cone
bound: the center's dependence region grown by ``t`` stays inside the
node, so the answer is a pure function of the node's own cells and
memoizable under content identity alone. Non-power-of-two ``t`` rides
the standard split ``t1 = min(t, size/8), t2 = t - t1`` through the
classic 9-subnode recursion, so the superstep driver never needs a
power-of-two schedule to stay exact.

Two memo tiers, the ``sparse/memo.py`` shape verbatim:

- **object tier** — ``(node, t) -> result`` keyed by node *identity*,
  which hash-consing (node.py) makes equivalent to content identity.
  This is the classic hashlife memo: repeated space AND time collapse
  to dict hits.
- **content tier** — ``MemoryLRU`` over an optional CRC-verified
  ``DiskCAS`` (``cache/store.py``, text payload), keyed by the node's
  ``board_digest`` + ``t`` + leaf size for nodes up to a byte cap. The
  CAS is the cross-restart, cross-job knowledge base: a restarted
  worker re-interns the same tree and hits the results a dead process
  paid for, and ``gc`` budgets the directory like every other CAS.
  Bigger nodes are cheap to recompute from their cached halves, so
  capping the payload size keeps entries small without losing the win.

Leaf base cases (level-1 nodes, one ``2*leaf``-square window) batch
through the tile step runner (``engine.make_tile_step_runner``, padded up
``batcher.pad_batch``'s ladder): the device does every stencil step, the
host does only hashing — the same division of labor as the sparse
engine, one level up. A chunk's windows stay on the device for all of
their steps (``TileStepRunner.advance``: one upload, one readback).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from gol_tpu_torch.cache.store import CacheEntry, DiskCAS, MemoryLRU
from gol_tpu_torch.macro.node import MacroNode, NodeStore
from gol_tpu_torch.obs import registry as obs_registry

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1

_EXIT_TAG = "macro"  # exit_reason marker: this entry is a macro advance

# Content-tier byte cap, as a node cell edge: results of nodes above
# this never enter the LRU/CAS tiers (a 2048^2 operand's result is a
# 1 MB payload — past that, entries crowd out the small results that
# actually repeat, and a big node's advance is 13 memoized sub-advances
# anyway). The object tier has no cap — it holds references, not copies.
CAS_MAX_EDGE = 2048

# Memory-tier budget (the sparse memo's default, same reasoning: the
# byte cap, not the entry count, is what bounds a worker's footprint).
DEFAULT_MEMO_BYTES = 128 << 20
DEFAULT_MEMO_ENTRIES = 8192


@dataclasses.dataclass
class MacroStats:
    """Work accounting of one macro run (SparseStats' deep-time analog:
    achieved work is memoized advances and leaf kernel steps, not
    generations — the whole point is generations >> work)."""

    generations: int = 0
    supersteps: int = 0  # top-level jumps the driver decomposed into
    node_hits: int = 0  # object-tier memo hits
    node_misses: int = 0
    cas_hits: int = 0  # content-tier hits (memory LRU or disk CAS)
    leaf_cases: int = 0  # level-1 base cases computed on device
    leaf_gen_steps: int = 0  # single-generation tile steps dispatched


class MacroMemo:
    """Tiered advance memo bound to one ``NodeStore``.

    The store binding is load-bearing: content-tier hits must land on
    the SAME canonical nodes the live process interns, so payloads are
    re-interned through ``store.from_dense`` on the way in."""

    def __init__(self, store: NodeStore,
                 entries: int = DEFAULT_MEMO_ENTRIES,
                 cas_dir: str | None = None,
                 max_bytes: int = DEFAULT_MEMO_BYTES):
        self.store = store
        self.results: dict[tuple, MacroNode] = {}  # (node, t) -> result
        self.memory = MemoryLRU(entries, max_bytes=max_bytes)
        self.cas = (
            DiskCAS(cas_dir, payload="text", on_evict=self._on_evict)
            if cas_dir else None
        )

    def _on_evict(self, fp: str, reason: str) -> None:
        obs_registry.default().inc("macro_memo_corrupt_evictions_total")

    def key(self, node: MacroNode, t: int) -> str:
        """The content-tier fingerprint of one advance question."""
        leaf = self.store.leaf_size
        return f"m{SCHEMA_VERSION}-{node.digest(leaf)}-{t}-{leaf}"

    def _content_eligible(self, node: MacroNode) -> bool:
        return node.size(self.store.leaf_size) <= CAS_MAX_EDGE

    def get(self, node: MacroNode, t: int,
            stats: MacroStats | None = None) -> MacroNode | None:
        reg = obs_registry.default()
        result = self.results.get((node, t))
        if result is not None:
            reg.inc("macro_node_hits_total")
            if stats:
                stats.node_hits += 1
            return result
        reg.inc("macro_node_misses_total")
        if stats:
            stats.node_misses += 1
        if not self._content_eligible(node):
            return None
        key = self.key(node, t)
        entry = self.memory.get(key)
        if entry is None and self.cas is not None:
            try:
                entry = self.cas.get(key)
            except OSError as err:
                logger.warning("macro memo CAS read failed for %s: %s: %s",
                               key, type(err).__name__, err)
                entry = None
            if entry is not None:
                self.memory.put(key, entry)
        if entry is None:
            reg.inc("macro_memo_misses_total")
            return None
        reg.inc("macro_memo_hits_total")
        if stats:
            stats.cas_hits += 1
        result = self.store.from_dense(entry.grid)
        self.results[(node, t)] = result
        reg.set_gauge("macro_memo_bytes", self.memory.grid_bytes)
        return result

    def put(self, node: MacroNode, t: int, result: MacroNode) -> None:
        self.results[(node, t)] = result
        if not self._content_eligible(node):
            return
        entry = CacheEntry(
            grid=np.ascontiguousarray(
                result.to_dense(self.store.leaf_size)
            ),
            generations=t,
            exit_reason=_EXIT_TAG,
        )
        key = self.key(node, t)
        self.memory.put(key, entry)
        obs_registry.default().set_gauge(
            "macro_memo_bytes", self.memory.grid_bytes
        )
        if self.cas is not None:
            try:
                self.cas.put(key, entry)
            except OSError as err:
                logger.warning(
                    "macro memo CAS write failed for %s (memo still serves "
                    "from memory): %s: %s", key, type(err).__name__, err,
                )


def _sub9(store: NodeStore, n: MacroNode) -> list[list[MacroNode]]:
    """The nine overlapping half-size subnodes of the classic recursion
    (corners, edge-centers, center), each one level down."""
    nw, ne, sw, se = n.nw, n.ne, n.sw, n.se
    return [
        [nw,
         store.node(nw.ne, ne.nw, nw.se, ne.sw),
         ne],
        [store.node(nw.sw, nw.se, sw.nw, sw.ne),
         store.node(nw.se, ne.sw, sw.ne, se.nw),
         store.node(ne.sw, ne.se, se.nw, se.ne)],
        [sw,
         store.node(sw.ne, se.nw, sw.se, se.sw),
         se],
    ]


def _combine4(store: NodeStore, r) -> list[MacroNode]:
    """Stitch the 9 sub-results (which tile the center 3/4 region) into
    the four overlapping half-size windows the second half-jump runs on."""
    return [
        store.node(r[0][0], r[0][1], r[1][0], r[1][1]),
        store.node(r[0][1], r[0][2], r[1][1], r[1][2]),
        store.node(r[1][0], r[1][1], r[2][0], r[2][1]),
        store.node(r[1][1], r[1][2], r[2][1], r[2][2]),
    ]


def _batch_leaf_advance(memo: MacroMemo, nodes: list[MacroNode], t: int,
                        stats: MacroStats | None = None
                        ) -> list[MacroNode]:
    """Advance level-1 nodes (one ``2*leaf`` window each) by ``t``
    generations on device, batched.

    ``t <= leaf/2`` — the zero-halo validity margin: the runner assumes
    a dead ring, so correctness erodes one cell per step from the window
    edge; the center ``leaf``-square stays exact for exactly leaf/2
    steps, which is the level-1 light-cone bound. Distinct uncached
    windows batch through one runner call for all ``t`` generations (one
    T1 launch where a window fits in a CTA's shared memory), padded up
    ``batcher.pad_batch``'s rungs — the same ladder the sparse engine and
    the serve batcher ride."""
    store = memo.store
    L = store.leaf_size
    if t > L // 2:
        raise ValueError(f"leaf advance capped at {L // 2} steps, got {t}")
    out: dict[int, MacroNode] = {}
    pending: list[MacroNode] = []
    seen: set[int] = set()
    for node in nodes:
        if id(node) in out or id(node) in seen:
            continue
        if node.population == 0:
            out[id(node)] = store.empty(0)
            continue
        if t == 0:
            result = memo.get(node, 0, stats)
            if result is None:
                result = store.centered(node)
                memo.put(node, 0, result)
            out[id(node)] = result
            continue
        result = memo.get(node, t, stats)
        if result is not None:
            out[id(node)] = result
        else:
            seen.add(id(node))
            pending.append(node)
    if pending:
        from gol_tpu_torch import engine
        from gol_tpu_torch.serve import batcher

        if stats:
            stats.leaf_cases += len(pending)
        half = L // 2
        for lo in range(0, len(pending), batcher.MAX_BATCH):
            chunk = pending[lo:lo + batcher.MAX_BATCH]
            rung = batcher.pad_batch(len(chunk))
            blocks = np.zeros((rung, 2 * L + 2, 2 * L + 2), np.uint8)
            for i, node in enumerate(chunk):
                blocks[i, 1:-1, 1:-1] = node.to_dense(L)
            runner = engine.make_tile_step_runner(2 * L, rung)
            # Every step reads a dead ring (the runner keeps the windows on
            # the device, each step writing the interior of a stack whose
            # ring stays dead), as a fresh zero-ringed block per step does.
            inner = runner.advance(blocks, t)
            if stats:
                stats.leaf_gen_steps += len(chunk) * t
            for i, node in enumerate(chunk):
                leaf = store.leaf(inner[i, half:half + L, half:half + L])
                memo.put(node, t, leaf)
                out[id(node)] = leaf
    return [out[id(node)] for node in nodes]


def _advance_level2(memo: MacroMemo, node: MacroNode, t: int,
                    stats: MacroStats | None) -> MacroNode:
    """The recursion floor: both half-jumps are level-1 base cases, so
    ALL device work in the whole tree funnels through the two batched
    calls here."""
    store = memo.store
    t1 = min(t, store.leaf_size // 2)
    t2 = t - t1
    subs = _sub9(store, node)
    flat = [n for row in subs for n in row]
    r = _batch_leaf_advance(memo, flat, t1, stats)
    grid = [r[0:3], r[3:6], r[6:9]]
    q = _combine4(store, grid)
    p = _batch_leaf_advance(memo, q, t2, stats)
    return store.node(p[0], p[1], p[2], p[3])


def advance(memo: MacroMemo, node: MacroNode, t: int,
            stats: MacroStats | None = None) -> MacroNode:
    """The centered ``t``-step result of a level >= 2 node,
    ``0 <= t <= size/4`` (``t = 0`` is the centered subnode — the
    geometric no-op the stillness test compares against)."""
    store = memo.store
    if node.level < 2:
        raise ValueError(
            f"advance needs a level >= 2 node, got level {node.level}"
        )
    cap = store.leaf_size << (node.level - 2)
    if not 0 <= t <= cap:
        raise ValueError(
            f"level-{node.level} advance capped at {cap} steps, got {t}"
        )
    if t == 0:
        return store.centered(node)
    if node.population == 0:
        return store.empty(node.level - 1)
    result = memo.get(node, t, stats)
    if result is not None:
        return result
    if node.level == 2:
        result = _advance_level2(memo, node, t, stats)
    else:
        half_cap = cap // 2
        t1 = min(t, half_cap)
        t2 = t - t1
        subs = _sub9(store, node)
        r = [[advance(memo, n, t1, stats) for n in row] for row in subs]
        q = _combine4(store, r)
        result = store.node(*(advance(memo, n, t2, stats) for n in q))
    memo.put(node, t, result)
    return result
