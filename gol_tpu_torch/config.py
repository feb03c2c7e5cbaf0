"""Runtime configuration.

The reference uses a two-tier config system: argv (width, height, input path,
with 30x30 defaults — src/game.c:224-236) plus compile-time #defines requiring
recompilation (GEN_LIMIT=1000, CHECK_SIMILARITY, SIMILARITY_FREQUENCY=3 —
src/game.c:6-9, README.md:65; THREADS=4 src/game_openmp.c:11; BLOCK_SIZE=32
src/game_cuda.cu:4). Here the compile-time tier is promoted to runtime flags
with the same names and defaults.
"""

from __future__ import annotations

import dataclasses

# Reference compile-time constants (src/game.c:6-9).
GEN_LIMIT = 1000
SIMILARITY_FREQUENCY = 3

# Reference argv defaults (src/game.c:233-236).
DEFAULT_WIDTH = 30
DEFAULT_HEIGHT = 30


class Convention:
    """Loop-accounting conventions present in the reference.

    ``C``: generation counter starts at 1; emptiness is checked at the top of
    every generation on the *current* grid (src/game.c:177); the similarity
    early-exit breaks without incrementing the counter; the reported count is
    ``generation - 1`` (src/game.c:202).

    ``CUDA``: counter starts at 0 and the loop bound is exclusive
    (src/game_cuda.cu:213,222); emptiness is checked *after* evolve on the new
    grid and breaks before the buffer swap (src/game_cuda.cu:259-268), so an
    empty-exit reports one generation fewer than C and writes the last
    non-empty generation; the reported count is un-decremented
    (src/game_cuda.cu:294).
    """

    C = "c"
    CUDA = "cuda"


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Simulation parameters shared by every engine and the oracle."""

    gen_limit: int = GEN_LIMIT
    check_similarity: bool = True  # presence of #define CHECK_SIMILARITY, src/game.c:8
    similarity_frequency: int = SIMILARITY_FREQUENCY
    convention: str = Convention.C

    def __post_init__(self):
        if self.gen_limit < 0:
            raise ValueError(f"gen_limit must be >= 0, got {self.gen_limit}")
        if self.similarity_frequency <= 0:
            raise ValueError(
                f"similarity_frequency must be > 0, got {self.similarity_frequency}"
            )
        if self.convention not in (Convention.C, Convention.CUDA):
            raise ValueError(f"unknown convention: {self.convention!r}")


DEFAULT_CONFIG = GameConfig()
