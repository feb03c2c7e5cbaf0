"""Run-length-encoded pattern codec (the standard ``.rle`` Life format).

The port's copy of ``gol_tpu/io/rle.py``: the same parser and the same
emitter, so a document encoded by either package is byte-identical
(test-pinned).

Pattern libraries (Gosper gun, r-pentomino, spaceships) ship as ``.rle``
files: a header line ``x = W, y = H[, rule = B3/S23]`` followed by a token
stream of ``<count><tag>`` items — ``b`` dead, ``o`` alive, ``$`` end of
row, ``!`` end of pattern — with ``#``-prefixed comment lines above the
header. This codec is the giant-universe input path: a 2^16-square board
with five gliders is a few hundred bytes of RLE, where the dense text-grid
form (io/text_grid.py) would be a 4 GB file that must never be
materialized (``sparse/`` simulates such boards tile-by-tile).

Numpy-only on purpose: the CLI parses patterns before any
engine loads, and sparse boards build straight from the token stream via
``items`` without a dense canvas ever existing.

Dialect notes: counts are unbounded decimals; a missing count means 1;
rows shorter than ``x`` are implicitly dead-padded; ``.`` is accepted as
dead and any other letter as alive (multi-state exports mark live cells
with letters); the rule, when present, must be B3/S23 (``23/3`` in the
legacy survival/birth spelling) — every engine in this tree is B3/S23
(ROADMAP's rule-space generalization is the axis that will relax this).
"""

from __future__ import annotations

import re

import numpy as np

# Dense-materialization guard for `parse`: patterns are meant to be small
# (the universe they are placed into is the big thing). A pattern above
# this cell count is almost certainly a whole-universe dump — parse it
# through the streaming `items` path into a sparse board instead.
MAX_PATTERN_CELLS = 1 << 26

_HEADER_RE = re.compile(
    r"^\s*x\s*=\s*(\d+)\s*,\s*y\s*=\s*(\d+)"
    r"(?:\s*,\s*rule\s*=\s*(.+?))?\s*$",
    re.IGNORECASE,
)
_ITEM_RE = re.compile(r"(\d*)([A-Za-z.$!])")

# Accepted spellings of the one rule this tree implements, compared after
# lowercasing and stripping ALL whitespace: exporters disagree on case
# (``b3/s23``), spacing (``B3 / S23``), and B/S order (``S23/B3``), and
# the legacy survival/birth form spells it ``23/3``. An unsupported rule
# is still a loud error naming the rule — silently running a HighLife
# pattern under Conway semantics would corrupt results, not degrade them.
_B3S23 = frozenset({"b3/s23", "s23/b3", "23/3"})


def _check_rule(rule: str | None) -> None:
    if rule is None:
        return
    canonical = re.sub(r"\s+", "", rule).lower()
    if canonical not in _B3S23:
        raise ValueError(
            f"RLE rule {rule!r} is not B3/S23; only Conway's Life is "
            "implemented (rule-space generalization is a roadmap item)"
        )


def split_header(text: str) -> tuple[int, int, str | None, str]:
    """``(width, height, rule, body)`` of an RLE document.

    ``#`` comment lines (and blank lines) above the header are skipped;
    everything after the header line is the token body."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        m = _HEADER_RE.match(stripped)
        if not m:
            raise ValueError(
                f"RLE header expected (x = W, y = H[, rule = ...]); "
                f"got {stripped[:60]!r}"
            )
        width, height = int(m.group(1)), int(m.group(2))
        rule = m.group(3)
        _check_rule(rule)
        if width <= 0 or height <= 0:
            raise ValueError(
                f"RLE extents must be positive, got x={width}, y={height}"
            )
        return width, height, rule, "\n".join(lines[i + 1:])
    raise ValueError("RLE document has no header line")


def items(body: str):
    """Yield ``(count, tag)`` runs from an RLE token body.

    ``tag`` is ``'o'`` (alive), ``'b'`` (dead), ``'$'`` (end of row) or
    ``'!'`` (end of pattern; iteration stops there — trailing bytes after
    ``!`` are comment territory by convention and ignored). Any letter
    other than ``b`` maps to alive; ``.`` maps to dead. Garbage between
    tokens raises."""
    pos = 0
    for line in body.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        pos = 0
        while pos < len(line):
            if line[pos].isspace():
                pos += 1
                continue
            m = _ITEM_RE.match(line, pos)
            if not m:
                raise ValueError(
                    f"malformed RLE token at {line[pos:pos + 12]!r}"
                )
            count = int(m.group(1)) if m.group(1) else 1
            if count < 1:
                raise ValueError(f"RLE run count must be >= 1, got {count}")
            tag = m.group(2)
            if tag == "!":
                yield count, "!"
                return
            if tag == "$":
                yield count, "$"
            elif tag in ("b", "."):
                yield count, "b"
            else:
                yield count, "o"
            pos = m.end()
    # A missing '!' is tolerated (several generators omit it on the last
    # line); the pattern simply ends with the body.


def live_runs(text: str):
    """Stream ``(row, col, length)`` live runs of an RLE document, plus its
    extents: returns ``((width, height), iterator)``.

    The geometry-first path: nothing dense is ever built, so a
    whole-universe RLE (a sparse result round-tripping back in) costs
    O(live runs) regardless of the universe area. Runs never cross row
    boundaries; overruns past the declared extents raise."""
    width, height, _rule, body = split_header(text)

    def gen():
        row = col = 0
        for count, tag in items(body):
            if tag == "!":
                return
            if tag == "$":
                row += count
                col = 0
                continue
            if col + count > width:
                raise ValueError(
                    f"RLE row {row} overruns x={width} (run of {count} "
                    f"at column {col})"
                )
            if tag == "o":
                if row >= height:
                    raise ValueError(
                        f"RLE content at row {row} overruns y={height}"
                    )
                yield row, col, count
            col += count

    return (width, height), gen()


def parse(text: str, max_cells: int = MAX_PATTERN_CELLS) -> np.ndarray:
    """Parse an RLE document into a dense uint8 {0,1} array of shape
    ``(height, width)`` — the pattern-stamping form.

    Refuses documents whose declared area exceeds ``max_cells``: a
    whole-universe dump must go through ``live_runs`` into a sparse board,
    never through a dense canvas."""
    (width, height), runs = live_runs(text)
    if width * height > max_cells:
        raise ValueError(
            f"RLE pattern is {height}x{width} = {width * height} cells, "
            f"above the dense-parse cap of {max_cells}; build a sparse "
            "board from live_runs() instead"
        )
    grid = np.zeros((height, width), np.uint8)
    for row, col, count in runs:
        grid[row, col:col + count] = 1
    return grid


def read_file(path: str, max_cells: int = MAX_PATTERN_CELLS) -> np.ndarray:
    """Read + parse one ``.rle`` pattern file."""
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read(), max_cells=max_cells)


def _row_runs(row: np.ndarray):
    """``(start, end)`` live runs of one dense row."""
    padded = np.zeros(row.size + 2, np.int8)
    padded[1:-1] = row != 0
    d = np.diff(padded)
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return list(zip(starts.tolist(), ends.tolist()))


def encode_rows(rows, width: int, height: int,
                comments: tuple[str, ...] = ()) -> str:
    """Serialize ``(row_index, [(start, end), ...])`` live-run rows to an
    RLE document (rows in ascending order, runs sorted and disjoint).

    The ONE emitter both the dense ``encode`` and the sparse board's
    ``to_rle`` ride, so the two can never drift — and the output is
    deterministic byte-for-byte (journaled sparse results and byte-gate
    tests compare these strings directly)."""
    tokens: list[str] = []

    def emit(count: int, tag: str) -> None:
        if count < 1:
            return
        tokens.append((str(count) if count > 1 else "") + tag)

    prev_row = None
    for row, runs in rows:
        if not runs:
            continue
        if prev_row is None:
            emit(row, "$")
        else:
            emit(row - prev_row, "$")
        prev_row = row
        col = 0
        for start, end in runs:
            emit(start - col, "b")
            emit(end - start, "o")
            col = end
    tokens.append("!")
    lines = [f"#C {c}" for c in comments]
    lines.append(f"x = {width}, y = {height}, rule = B3/S23")
    line = ""
    for tok in tokens:
        if line and len(line) + len(tok) > 70:
            lines.append(line)
            line = ""
        line += tok
    if line:
        lines.append(line)
    return "\n".join(lines) + "\n"


def encode(grid: np.ndarray, comments: tuple[str, ...] = ()) -> str:
    """Serialize a dense uint8 {0,1} grid to an RLE document."""
    grid = np.asarray(grid, dtype=np.uint8)
    if grid.ndim != 2:
        raise ValueError(f"grid must be 2D, got shape {grid.shape}")
    height, width = grid.shape
    rows = ((r, _row_runs(grid[r])) for r in range(height))
    return encode_rows(rows, width, height, comments)


def write_file(path: str, grid: np.ndarray,
               comments: tuple[str, ...] = ()) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(encode(grid, comments))
