"""The host-side bit-packing convention: bit j of word w = column 32w+j.

A copy of ``gol_tpu/io/bitpack.py`` (the port imports nothing of the JAX
package): little bit-order ``np.packbits`` + a little-endian ``uint32``
view, matching ``ops/packed_math.encode``. The tests pin it against the
JAX package's copy, so the two conventions cannot drift apart. Callers gate
on ``sys.byteorder`` themselves where big-endian hosts must take a byte lane
instead.
"""

from __future__ import annotations

import numpy as np

BITS = 32


def pack_words(cells: np.ndarray) -> np.ndarray:
    """(..., W) uint8 {0,1} cells -> (..., W/32) uint32 words.

    ``np.packbits`` little bit-order fills byte k with columns 8k..8k+7,
    and the little-endian uint32 view makes byte k bits 8k..8k+7 of its
    word — so bit j of word w is column 32w+j, exactly the device kernels'
    layout. Packing on the host shrinks transfers 32x and keeps
    encode/decode out of compiled programs.
    """
    width = cells.shape[-1]
    if width % BITS:
        raise ValueError(f"width {width} is not a multiple of {BITS}")
    packed = np.packbits(cells, axis=-1, bitorder="little")
    return (
        np.ascontiguousarray(packed)
        .view(np.uint32)
        .reshape(*cells.shape[:-1], width // BITS)
    )


def unpack_words(words: np.ndarray, width: int | None = None) -> np.ndarray:
    """Inverse of ``pack_words``: (..., W/32) uint32 -> (..., W) uint8."""
    nwords = words.shape[-1]
    as_bytes = (
        np.ascontiguousarray(words)
        .view(np.uint8)
        .reshape(*words.shape[:-1], nwords * 4)
    )
    cells = np.unpackbits(as_bytes, axis=-1, bitorder="little")
    return cells if width is None else cells[..., :width]
