"""The host text codec: '0'/'1' text rows <-> packed uint32 cell words.

The port's copy of ``gol_tpu/native``: ``codec.c`` builds with ``cc`` at
first use into the build directory (``ops/_build.py``) and binds with
ctypes. There is no quiet fallback: if the build fails, ``pack_text`` and
``unpack_text`` raise. ``pack_text_plain``/``unpack_text_plain`` are the
JAX loader's numpy bodies, kept as the plain versions the tests hold the
codec against.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "codec.c"
BITS = 32


def _lib() -> ctypes.CDLL:
    from gol_tpu_torch.ops import _build

    return _build.load_c(SOURCE, _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    ptr = ctypes.c_void_p
    lib.gol_pack_text.argtypes = [ptr, i64, ptr, i64, i64]
    lib.gol_pack_text.restype = None
    lib.gol_unpack_text.argtypes = [ptr, i64, ptr, i64, i64, ctypes.c_int]
    lib.gol_unpack_text.restype = None
    return lib


def load() -> None:
    """Build (at first use) and load the codec ahead of a run."""
    _lib()


def _check_width(width: int) -> None:
    if width % BITS:
        raise ValueError(f"width {width} not a multiple of {BITS}")


def pack_text(text: np.ndarray, width: int,
              out: np.ndarray | None = None) -> np.ndarray:
    """(rows, stride>=width) ASCII bytes -> (rows, width/32) uint32 words,
    in a fresh array or into ``out`` (C-contiguous uint32 of that shape;
    the pipelined read packs straight into pinned memory).

    Only the byte '1' is a live cell (the text_grid contract — any other
    byte, including other odd ones, is dead). Any row stride is fine (the
    memmap view over the newline column layout); the row interior must be
    byte-contiguous.
    """
    _check_width(width)
    rows, stride = text.shape
    if stride < width:
        # Guard the raw-pointer C call: a too-narrow array would be an
        # out-of-bounds read in C rather than a Python error.
        raise ValueError(f"text has {stride} columns, needs >= width {width}")
    if text.dtype != np.uint8 or text.strides[1] != 1:
        raise ValueError("text rows must be byte-contiguous uint8")
    if out is None:
        out = np.empty((rows, width // BITS), dtype=np.uint32)
    elif (out.shape != (rows, width // BITS) or out.dtype != np.uint32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous uint32 "
                         f"{(rows, width // BITS)}, got {out.dtype} {out.shape}")
    _lib().gol_pack_text(text.ctypes.data, text.strides[0], out.ctypes.data,
                         rows, width)
    return out


def unpack_text(words: np.ndarray, out: np.ndarray, width: int,
                newline: bool) -> None:
    """(rows, width/32) uint32 -> ASCII '0'/'1' into out (rows, stride) bytes,
    plus the '\\n' column when ``newline``."""
    _check_width(width)
    rows = words.shape[0]
    # Guard the raw-pointer C call against out-of-bounds writes.
    if words.shape[1] != width // BITS:
        raise ValueError(f"words has {words.shape[1]} columns, needs {width // BITS}")
    if out.shape[0] < rows or out.shape[1] < width + (1 if newline else 0):
        raise ValueError(
            f"out shape {out.shape} too small for {rows} rows x width {width}"
            f"{' + newline' if newline else ''}"
        )
    if (words.dtype != np.uint32 or not words.flags.c_contiguous
            or out.dtype != np.uint8 or out.strides[1] != 1):
        raise ValueError("words must be C-contiguous uint32 and out rows "
                         "byte-contiguous uint8")
    _lib().gol_unpack_text(words.ctypes.data, out.strides[0], out.ctypes.data,
                           rows, width, int(newline))


def pack_text_plain(text: np.ndarray, width: int) -> np.ndarray:
    """numpy version of ``pack_text`` (gol_tpu/native/__init__.py:93-95)."""
    _check_width(width)
    rows = text.shape[0]
    bits = (text[:, :width] == ord("1")).astype(np.uint32).reshape(
        rows, width // BITS, BITS)
    weights = (np.uint32(1) << np.arange(BITS, dtype=np.uint32))[None, None, :]
    return np.sum(bits * weights, axis=-1, dtype=np.uint32)


def unpack_text_plain(words: np.ndarray, out: np.ndarray, width: int,
                      newline: bool) -> None:
    """numpy version of ``unpack_text`` (gol_tpu/native/__init__.py:119-123)."""
    _check_width(width)
    rows = words.shape[0]
    shifts = np.arange(BITS, dtype=np.uint32)[None, None, :]
    bits = (words[:, :, None] >> shifts) & np.uint32(1)
    out[:, :width] = bits.astype(np.uint8).reshape(rows, width) + ord("0")
    if newline:
        out[:, width] = ord("\n")
