"""VT100 terminal renderer: the reference's unused ``show()`` made usable.

The port's copy of ``gol_tpu/render.py``. The serial reference carries a
VT100 renderer that nothing calls (src/game.c:42-58): cursor-home,
reverse-video double-space for a live cell, plain double-space for dead,
next-line code per row. This module reproduces that escape-code output for
``gol show``, with optional live animation on the host oracle.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from gol_tpu_torch import oracle

_HOME = "\033[H"
_LIVE = "\033[07m  \033[m"  # reverse video, two spaces (src/game.c:51)
_DEAD = "  "
_NEXT_LINE = "\033[E"
_CLEAR = "\033[2J"


def frame(grid: np.ndarray) -> str:
    """One grid as the reference's escape-code string (src/game.c:42-58)."""
    rows = [
        "".join(_LIVE if cell else _DEAD for cell in row) + _NEXT_LINE
        for row in np.asarray(grid)
    ]
    return _HOME + "".join(rows)


def show(grid: np.ndarray, out=None) -> None:
    out = out or sys.stdout
    out.write(frame(grid))
    out.flush()


def animate(
    grid: np.ndarray,
    generations: int,
    fps: float = 10.0,
    out=None,
    sleep=time.sleep,
) -> np.ndarray:
    """Render ``generations`` oracle steps live; returns the final grid."""
    out = out or sys.stdout
    out.write(_CLEAR)
    show(grid, out)
    delay = 1.0 / fps if fps > 0 else 0.0
    for _ in range(generations):
        grid = oracle.evolve(grid)
        if delay:
            sleep(delay)
        show(grid, out)
        if not grid.any():
            break
    return grid
