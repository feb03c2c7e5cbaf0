"""Hashlife lane: hash-consed macrocell engine for astronomically deep
time.

The port of ``gol_tpu/macro/``, with the leaf base cases on T1.

Where every other lane is O(generations), this one memoizes the time
axis itself: a hash-consed quadtree over the sparse lane's tiles
(``node``), a content-addressed centered-advance memo whose leaf base
cases batch through the tile step runners (``advance``), and a
superstep driver that reaches arbitrary generation counts — early-exit
parity included — in O(log) guarded jumps (``engine``).
"""

from gol_tpu_torch.macro.advance import MacroMemo, MacroStats, advance
from gol_tpu_torch.macro.engine import (
    MACRO_AUTO_GENS,
    MacroPlaneError,
    MacroResult,
    advance_universe,
    auto_macro,
    simulate_macro,
)
from gol_tpu_torch.macro.node import MacroNode, MacroUniverse, NodeStore

__all__ = [
    "MACRO_AUTO_GENS",
    "MacroMemo",
    "MacroNode",
    "MacroPlaneError",
    "MacroResult",
    "MacroStats",
    "MacroUniverse",
    "NodeStore",
    "advance",
    "advance_universe",
    "auto_macro",
    "simulate_macro",
]
