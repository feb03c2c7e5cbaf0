"""Sparse tiled engine: O(live-area) simulation for giant universes.

The port of ``gol_tpu/sparse/``, with the batched tile step on T1.

- ``board``  — the tiled occupancy index (numpy-only, geometry-first)
- ``engine`` — the host loop: activation, halo assembly, batched tile steps
- ``memo``   — tile-result memoization on the result cache's CAS machinery
- ``serve``  — the sparse job lane of the serving stack
"""

from gol_tpu_torch.sparse.board import (  # noqa: F401
    DEFAULT_TILE,
    MAX_DENSE_CELLS,
    SparseBoard,
    dense_cells_guard,
)
from gol_tpu_torch.sparse.engine import (  # noqa: F401
    SPARSE_AUTO_AREA,
    SparseResult,
    SparseStats,
    auto_engine,
    simulate_sparse,
)
from gol_tpu_torch.sparse.memo import TileMemo  # noqa: F401
