"""Bit-sliced Game-of-Life arithmetic on packed 32-bit words, in plain torch.

The port of ``gol_tpu/ops/packed_math.py``: the same carry-save adder
network (``row_sums`` once per row, ``combine`` re-ranks the planes by a row
shift; ~28 bitwise ops for 32 cells). Bit j of word w is the cell at column
``w*32 + j``.

Words are carried as ``torch.int32`` holding the uint32 bit pattern: torch
has no ``<<``/``>>``/``~`` for uint32 on the CPU. Left shifts and ``~`` are
the same on both types; right shifts of int32 are arithmetic, so every
right shift here is made logical by a mask. ``words_from_numpy`` and
``words_to_numpy`` carry the JAX package's uint32 word state to and from
these tensors bit for bit. The CUDA kernels (``csrc/stencil_packed.cu``)
read the same storage as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 32
_LOW31 = 0x7FFFFFFF


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-stored words by ``0 < n < 32``."""
    return (x >> n) & (_LOW31 >> (n - 1))


def west(x: torch.Tensor, left_words: torch.Tensor) -> torch.Tensor:
    """Packed west (column-1) neighbors; ``left_words[w]`` is word ``w-1``."""
    return (x << 1) | _srl(left_words, BITS - 1)


def east(x: torch.Tensor, right_words: torch.Tensor) -> torch.Tensor:
    """Packed east (column+1) neighbors; ``right_words[w]`` is word ``w+1``."""
    return _srl(x, 1) | (right_words << (BITS - 1))


def csa3(a, b, c):
    """3:2 compressor: (sum, carry) bitplanes of a+b+c."""
    axb = a ^ b
    return axb ^ c, (a & b) | (c & axb)


def row_sums(x, left, right):
    """Per-row horizontal sums ``(m0, m1, s0, s1)``: ``m = west + east`` and
    ``s = west + center + east``, each as two bitplanes."""
    w = west(x, left)
    e = east(x, right)
    m0 = w ^ e
    m1 = w & e
    s0 = m0 ^ x
    s1 = m1 | (x & m0)
    return m0, m1, s0, s1


def combine(u0, u1, d0, d1, m0, m1, mid):
    """B3/S23 from the up/down triple-sum planes and the mid pair planes:
    alive iff bit 1 of N is set, nothing at weight 4+, and (bit 0 | center)."""
    t0, tc = csa3(u0, d0, m0)
    v0, v1 = csa3(u1, d1, m1)
    b1 = v0 ^ tc
    over = v1 | (v0 & tc)
    return b1 & ~over & (t0 | mid)


def evolve_torus_words(x: torch.Tensor) -> torch.Tensor:
    """One generation of the whole packed torus (any height, any nwords)."""
    m0, m1, s0, s1 = row_sums(
        x, torch.roll(x, 1, dims=1), torch.roll(x, -1, dims=1)
    )
    u0, u1 = torch.roll(s0, 1, dims=0), torch.roll(s1, 1, dims=0)
    d0, d1 = torch.roll(s0, -1, dims=0), torch.roll(s1, -1, dims=0)
    return combine(u0, u1, d0, d1, m0, m1, x)


def evolve_ghost(words, top, bot, gwest, geast) -> torch.Tensor:
    """One generation of an (h, nwords) shard from its ghosts: ``top`` and
    ``bot`` are the (1, nwords) ghost word rows, ``gwest``/``geast`` the
    (h+2,) carry words over rows -1..h, so the corner bits ride along. Only
    bit 31 of ``gwest`` and bit 0 of ``geast`` are read."""
    h = words.shape[0]
    xr = torch.cat([top, words, bot])  # (h+2, nwords)
    left = torch.roll(xr, 1, dims=1)
    left[:, 0] = gwest
    right = torch.roll(xr, -1, dims=1)
    right[:, -1] = geast
    m0, m1, s0, s1 = row_sums(xr, left, right)
    return combine(s0[0:h], s1[0:h], s0[2:h + 2], s1[2:h + 2],
                   m0[1:h + 1], m1[1:h + 1], words)


def encode(grid: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W) cells -> int32 (H, W/32) words (bit j = column w*32+j).

    Bits are ORed in one position at a time, so nothing widens to int64 (a
    ``sum`` of int32 would) and bit 31 lands as the int32 sign bit."""
    height, width = grid.shape
    if width % BITS:
        raise ValueError(f"width {width} is not a multiple of {BITS}")
    bits = grid.reshape(height, width // BITS, BITS)
    words = torch.zeros(
        (height, width // BITS), dtype=torch.int32, device=grid.device
    )
    for j in range(BITS):
        words |= (bits[:, :, j] != 0).to(torch.int32) << j
    return words


def decode(words: torch.Tensor) -> torch.Tensor:
    """int32 (H, W/32) words -> uint8 (H, W) cells."""
    height, nwords = words.shape
    cells = torch.empty(
        (height, nwords, BITS), dtype=torch.uint8, device=words.device
    )
    for j in range(BITS):
        cells[:, :, j] = ((words >> j) & 1).to(torch.uint8)
    return cells.reshape(height, nwords * BITS)


def words_from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words (the JAX package's packed state) -> int32 tensor
    on ``device`` with the same bit pattern."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy words with the same bit pattern."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32).copy()
