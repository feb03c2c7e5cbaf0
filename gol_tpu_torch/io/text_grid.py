"""Text-grid format codec: '0'/'1' cells, newline-terminated rows.

Format contract (README.md:61-63): ``height`` rows of ``width`` ASCII digits,
each row followed by ``'\\n'`` — i.e. the file is a ``height x (width+1)`` byte
matrix whose last column is newlines (exactly how the reference's collective
MPI-IO models it, src/game_mpi_collective.c:180-186). A written output file is
a valid input file (src/game.c:25-40 emits what src/game.c:154-165 parses), a
property the resume path relies on.

The reference's parser consumes any non-'\\n' byte as a cell and only treats
'1' as alive (src/game.c:158-164, src/game.c:83); this codec does the same but
normalizes storage to numeric {0,1} uint8 on the way in (the CUDA variant's
choice, src/game_cuda.cu:176) and back to ASCII on the way out.
"""

from __future__ import annotations

import numpy as np

NEWLINE = 0x0A  # '\n'
ZERO = 0x30  # '0'
ONE = 0x31  # '1'


def create_sized(path: str, size: int) -> None:
    """Create/size a file without zeroing existing contents.

    ``open(path, 'wb')`` truncates to zero, which on a shared filesystem
    races away bytes other hosts already wrote; ``ftruncate`` to the final
    size is idempotent across processes (the reference's MODE_EXCL
    delete-and-retry dance, src/game_mpi_collective.c:429-436, solved the
    same multi-writer problem)."""
    import os

    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        os.ftruncate(fd, size)
    finally:
        os.close(fd)


def row_stride(width: int) -> int:
    """Bytes per row on disk: width cells + the newline column."""
    return width + 1


def decode(
    data: bytes | np.ndarray, width: int, height: int, exact: bool = False
) -> np.ndarray:
    """Parse text-grid bytes into a uint8 {0,1} array of shape (height, width).

    Fast path: the file is exactly the height x (width+1) matrix the format
    contract promises — one reshape, no scan. Fallback: the reference's
    skip-newlines scan (src/game.c:154-165) for files with stray newlines or
    trailing bytes.

    ``exact`` rejects any cell-count mismatch instead of truncating extra
    cells the way the reference's parser does — the serving API's contract
    (a submit body whose ``cells`` disagrees with its declared geometry is
    a client error, never a silently-cropped board), while file readers
    keep the reference's lenient scan.
    """
    raw = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else data
    stride = row_stride(width)
    expected = height * stride
    if raw.size == expected:
        mat = raw.reshape(height, stride)
        if bool((mat[:, width] == NEWLINE).all()) and not bool(
            (mat[:, :width] == NEWLINE).any()
        ):
            return (mat[:, :width] == ONE).astype(np.uint8)
    cells = raw[raw != NEWLINE]
    if cells.size < height * width or (
        exact and cells.size != height * width
    ):
        raise ValueError(
            f"input holds {cells.size} cells; need "
            f"{'exactly ' if exact else ''}{height}x{width}="
            f"{height * width}"
        )
    return (cells[: height * width] == ONE).astype(np.uint8).reshape(height, width)


def _encode_matrix(grid: np.ndarray) -> np.ndarray:
    """The on-disk ``height x (width+1)`` byte matrix of a grid — the ONE
    place the row layout (digits + newline column) is built."""
    grid = np.asarray(grid, dtype=np.uint8)
    height, width = grid.shape
    out = np.empty((height, row_stride(width)), dtype=np.uint8)
    out[:, :width] = grid + ZERO
    out[:, width] = NEWLINE
    return out


def encode(grid: np.ndarray) -> bytes:
    """Serialize a uint8 {0,1} grid to text-grid bytes (src/game.c:25-40)."""
    return _encode_matrix(grid).tobytes()


def read_grid(path: str, width: int, height: int) -> np.ndarray:
    """Read a whole grid file serially (the src/game.c:149-166 path)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, width, height)


def write_grid(path: str, grid: np.ndarray) -> None:
    """Write a whole grid file serially (the src/game.c:25-40 path).

    Same bytes as ``f.write(encode(grid))`` but without materializing the
    intermediate ``bytes`` copy — ``write`` accepts the encoded matrix's
    buffer directly (a 16384^2 grid is 268 MB of text).
    """
    with open(path, "wb") as f:
        f.write(memoryview(_encode_matrix(grid)).cast("B"))


def generate(
    width: int, height: int, density: float = 0.5, seed: int | None = None
) -> np.ndarray:
    """Random initial grid — generate.sh's $RANDOM%2 per cell (generate.sh:6-13).

    The reference script transposes rows/columns (its loops emit ``width`` rows
    of ``height`` chars; both loops even reuse variable ``i``) and is only
    correct for square grids; this emits the contractual height rows x width
    cols.
    """
    rng = np.random.default_rng(seed)
    return (rng.random((height, width)) < density).astype(np.uint8)


def generate_to_file(
    path: str,
    width: int,
    height: int,
    density: float = 0.5,
    seed: int | None = None,
    chunk_rows: int | None = None,
) -> None:
    """Stream a random grid straight to its file, a row block at a time.

    Identical bytes to ``write_grid(path, generate(...))`` (pinned by test)
    but with O(chunk) host memory — at 65536^2 the whole-array route is a
    4 GB text buffer plus the RNG intermediates; the chunk size scales
    inversely with width so the float64 RNG intermediate (the largest
    per-chunk allocation, 8 bytes/cell) stays ~256 MB at any width.
    """
    if chunk_rows is None:
        chunk_rows = max(1, (256 << 20) // max(width * 8, 1))
    rng = np.random.default_rng(seed)
    mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=(height, row_stride(width)))
    for r0 in range(0, height, chunk_rows):
        r1 = min(height, r0 + chunk_rows)
        block = (rng.random((r1 - r0, width)) < density).astype(np.uint8)
        mm[r0:r1, :width] = block + ZERO
        mm[r0:r1, width] = NEWLINE
    mm.flush()
