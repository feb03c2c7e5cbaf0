"""The port's macrocell lane (gol_tpu_torch.macro, its leaf steps on the
CPU through T1's plain version) against the JAX package's and against the
port's own sparse engine, at tolerance 0: interning and digests, boards,
generation counts and exit reasons in both conventions (the stillness and
emptiness bisections included), the plane refusal, the content tier's keys
and ``--macro-cas`` directories written by either package and read by the
other, ``auto_macro`` and the serve lane's ``run_job``.
"""

import os

import numpy as np
import pytest

from gol_tpu.config import GameConfig as JaxGameConfig
from gol_tpu.macro import MacroMemo as JaxMacroMemo
from gol_tpu.macro import NodeStore as JaxNodeStore
from gol_tpu.macro import MacroUniverse as JaxUniverse
from gol_tpu.macro import auto_macro as jax_auto_macro
from gol_tpu.macro import serve as jax_macro_serve
from gol_tpu.macro import simulate_macro as jax_simulate_macro
from gol_tpu.serve.jobs import new_job as jax_new_job
from gol_tpu.sparse import SparseBoard as JaxBoard
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.macro import (MacroMemo, MacroPlaneError, MacroUniverse,
                                 NodeStore, auto_macro, simulate_macro)
from gol_tpu_torch.macro import serve as macro_serve
from gol_tpu_torch.serve.jobs import new_job
from gol_tpu_torch.sparse import SparseBoard, simulate_sparse

PATTERNS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "patterns")
CONVENTIONS = [Convention.C, Convention.CUDA]
GLIDER_RLE = "x = 3, y = 3, rule = B3/S23\nbob$2bo$3o!"
PRE_BLOCK_RLE = "x = 2, y = 2, rule = B3/S23\n2o$ob!"


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _pattern(name: str) -> str:
    with open(os.path.join(PATTERNS_DIR, name + ".rle"), encoding="utf-8") as f:
        return f.read()


def _boards(rle, size, tile, at):
    return (SparseBoard.from_rle(rle, size, size, tile, x=at, y=at),
            JaxBoard.from_rle(rle, size, size, tile, x=at, y=at))


def _parity(rle, size, tile, at, checkpoints=(), memos=(None, None), **cfg):
    """Port macro vs JAX macro (boards, counts, reasons, work stats, every
    checkpoint) and vs the port's sparse loop (board, count, reason)."""
    board, jboard = _boards(rle, size, tile, at)
    seen, jseen = {}, {}
    got = simulate_macro(board, GameConfig(**cfg), memos[0], checkpoints,
                         lambda g, b: seen.__setitem__(g, b.to_rle()))
    want = jax_simulate_macro(jboard, JaxGameConfig(**cfg), memos[1], checkpoints,
                              lambda g, b: jseen.__setitem__(g, b.to_rle()))
    assert (got.generations, got.exit_reason) == (want.generations, want.exit_reason)
    assert got.board.to_rle() == want.board.to_rle()
    assert seen == jseen
    assert (got.stats.supersteps, got.stats.leaf_cases, got.stats.leaf_gen_steps,
            got.stats.node_hits, got.stats.node_misses, got.stats.cas_hits) == (
        want.stats.supersteps, want.stats.leaf_cases, want.stats.leaf_gen_steps,
        want.stats.node_hits, want.stats.node_misses, want.stats.cas_hits)
    sparse = simulate_sparse(_boards(rle, size, tile, at)[0], GameConfig(**cfg))
    assert (sparse.generations, sparse.exit_reason) == (got.generations,
                                                        got.exit_reason)
    assert sparse.board == got.board
    return got


# ---------------------------------------------------------------------------
# Interning


def test_nodes_intern_and_digest_as_jax():
    rng = np.random.default_rng(4)
    grid = (rng.random((64, 64)) < 0.3).astype(np.uint8)
    store, jstore = NodeStore(8), JaxNodeStore(8)
    node, jnode = store.from_dense(grid), jstore.from_dense(grid)
    assert node.digest(8) == jnode.digest(8)
    assert (node.level, node.population, node.bbox(8)) == \
        (jnode.level, jnode.population, jnode.bbox(8))
    assert store.interned_nodes() == jstore.interned_nodes()
    assert store.centered(node).digest(8) == jstore.centered(jnode).digest(8)
    # Two stamps of one subtree are one object.
    assert store.from_dense(grid) is node
    board, jboard = _boards(_pattern("gosper_gun"), 256, 8, 100)
    u = MacroUniverse.from_board(store, board)
    ju = JaxUniverse.from_board(jstore, jboard)
    assert (u.oy, u.ox, u.root.level, u.bbox_cells()) == \
        (ju.oy, ju.ox, ju.root.level, ju.bbox_cells())
    assert u.expanded().to_board() == board


@pytest.mark.parametrize("call", [
    lambda m: m.NodeStore(2),
    lambda m: m.NodeStore(9),
    lambda m: m.NodeStore(8).leaf(np.ones((4, 4), np.uint8)),
    lambda m: m.NodeStore(8).from_dense(np.ones((24, 24), np.uint8)),
])
def test_store_refusals_match_jax(call):
    import gol_tpu.macro as jax_macro
    import gol_tpu_torch.macro as macro

    with pytest.raises(ValueError) as want:
        call(jax_macro)
    with pytest.raises(ValueError) as got:
        call(macro)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# simulate_macro


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("case", [
    ("glider", GLIDER_RLE, 128, 8, 60, 137, (1, 30, 64, 100, 137)),
    ("gosper", _pattern("gosper_gun"), 256, 8, 100, 210, (31, 137, 210, 1000)),
    ("r_pentomino", _pattern("r_pentomino"), 256, 16, 110, 150, (100, 150)),
], ids=lambda c: c[0])
def test_macro_checkpoints_match_jax_and_sparse(case, convention):
    _, rle, size, tile, at, gens, checkpoints = case
    _parity(rle, size, tile, at, checkpoints, gen_limit=gens,
            convention=convention)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("gens", [0, 1, 5, 100])
def test_tiny_generation_counts_match_jax(convention, gens):
    _parity(GLIDER_RLE, 64, 8, 30, gen_limit=gens, convention=convention)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("gens", [129, 130, 131, 400])
def test_diehard_empty_exit_matches_jax(convention, gens):
    got = _parity(_pattern("diehard"), 256, 8, 100, gen_limit=gens,
                  convention=convention)
    if gens >= 130:
        assert got.exit_reason == "empty"


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("frequency", [1, 2, 5])
def test_still_life_similar_exit_matches_jax(convention, frequency):
    for gens in (0, 1, 4, 5, 60):
        _parity(PRE_BLOCK_RLE, 64, 8, 30, gen_limit=gens, convention=convention,
                similarity_frequency=frequency)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_similarity_disabled_matches_jax(convention):
    got = _parity(PRE_BLOCK_RLE, 64, 8, 30, gen_limit=50, convention=convention,
                  check_similarity=False)
    assert got.exit_reason == "gen_limit"


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("frequency", [1, 3])
def test_initially_empty_universe_matches_jax(convention, frequency):
    for gens in (0, 1, 10):
        cfg = dict(gen_limit=gens, convention=convention,
                   similarity_frequency=frequency)
        got = simulate_macro(SparseBoard(64, 64, 8), GameConfig(**cfg))
        want = jax_simulate_macro(JaxBoard(64, 64, 8), JaxGameConfig(**cfg))
        assert (got.generations, got.exit_reason) == (want.generations,
                                                      want.exit_reason)
        assert got.board.to_rle() == want.board.to_rle()


def test_plane_error_matches_jax():
    board, jboard = _boards(GLIDER_RLE, 32, 4, 1)
    import gol_tpu.macro as jax_macro

    with pytest.raises(jax_macro.MacroPlaneError) as want:
        jax_simulate_macro(jboard, JaxGameConfig(gen_limit=200))
    with pytest.raises(MacroPlaneError) as got:
        simulate_macro(board, GameConfig(gen_limit=200))
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


# ---------------------------------------------------------------------------
# The content tier: keys and --macro-cas directories in both directions


def test_memo_keys_equal_jax():
    board, jboard = _boards(GLIDER_RLE, 32, 8, 14)
    memo, jmemo = MacroMemo(NodeStore(8)), JaxMacroMemo(JaxNodeStore(8))
    u = MacroUniverse.from_board(memo.store, board)
    ju = JaxUniverse.from_board(jmemo.store, jboard)
    for t in (1, 2, 7):
        assert memo.key(u.root, t) == jmemo.key(ju.root, t)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_macro_cas_written_by_either_package_hits_in_the_other(tmp_path, writer):
    cas = str(tmp_path / "cas")
    cfg = dict(gen_limit=210)
    rle = _pattern("gosper_gun")
    board, jboard = _boards(rle, 256, 8, 100)
    if writer == "jax":
        cold = jax_simulate_macro(jboard, JaxGameConfig(**cfg),
                                  JaxMacroMemo(JaxNodeStore(8), cas_dir=cas))
        warm = simulate_macro(board, GameConfig(**cfg),
                              MacroMemo(NodeStore(8), cas_dir=cas))
    else:
        cold = simulate_macro(board, GameConfig(**cfg),
                              MacroMemo(NodeStore(8), cas_dir=cas))
        warm = jax_simulate_macro(jboard, JaxGameConfig(**cfg),
                                  JaxMacroMemo(JaxNodeStore(8), cas_dir=cas))
    assert os.listdir(cas)
    assert warm.board.to_rle() == cold.board.to_rle()
    assert (warm.generations, warm.exit_reason) == (cold.generations,
                                                    cold.exit_reason)
    assert cold.stats.cas_hits == 0 and cold.stats.leaf_gen_steps > 0
    assert warm.stats.cas_hits > 0
    assert warm.stats.leaf_gen_steps == 0


# ---------------------------------------------------------------------------
# auto_macro and the serve lane


@pytest.mark.parametrize("args", [
    (4096, 4096, 256, 20000, (2000, 2000, 2010, 2040)),
    (4096, 4096, 256, 5000, (2000, 2000, 2010, 2040)),
    (4096, 4096, 256, 20000, (10, 2000, 20, 2040)),
    (4096, 4096, 255, 20000, (2000, 2000, 2010, 2040)),
    (4096, 4096, 256, 20000, None),
])
def test_auto_macro_picks_as_jax(args):
    assert auto_macro(*args) == jax_auto_macro(*args)
    assert auto_macro(*args, gens_threshold=100) == \
        jax_auto_macro(*args, gens_threshold=100)


def test_run_job_matches_jax():
    kw = dict(rle=_pattern("gosper_gun"), place_x=100, place_y=100, tile=8,
              macro=True, gen_limit=150)
    macro_serve.configure()
    jax_macro_serve.configure()
    got = macro_serve.run_job(new_job(256, 256, None, **kw))
    want = jax_macro_serve.run_job(jax_new_job(256, 256, None, **kw))
    for field in ("grid", "generations", "exit_reason", "rle", "population",
                  "universe", "tiles_simulated", "cell_updates", "occupancy"):
        assert getattr(got, field) == getattr(want, field), field
