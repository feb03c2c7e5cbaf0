"""The port's RLE codec (gol_tpu_torch.io.rle) and sparse board
(gol_tpu_torch.sparse.board) against the JAX package's, at tolerance 0:
parsed cells, live runs, headers and encoded bytes over ``patterns/*.rle``
and numpy-seeded random grids, the refusals' types and messages, and the
board's RLE, dense view and guard.
"""

from pathlib import Path

import numpy as np
import pytest

from gol_tpu.io import rle as jax_rle
from gol_tpu.sparse import board as jax_board
from gol_tpu_torch.io import rle
from gol_tpu_torch.sparse import board

PATTERNS = sorted((Path(__file__).resolve().parent.parent / "patterns").glob("*.rle"))


@pytest.mark.parametrize("path", PATTERNS, ids=lambda p: p.stem)
def test_pattern_files_parse_and_encode_as_jax(path):
    text = path.read_text()
    assert rle.split_header(text) == jax_rle.split_header(text)
    got, want = rle.read_file(str(path)), jax_rle.read_file(str(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    (pw, runs), (jw, jruns) = rle.live_runs(text), jax_rle.live_runs(text)
    assert (pw, list(runs)) == (jw, list(jruns))
    comments = ("generations 7 exit gen_limit", path.stem)
    assert rle.encode(got, comments) == jax_rle.encode(want, comments)


@pytest.mark.parametrize("shape,density", [
    ((1, 1), 1.0), ((3, 200), 0.5), ((17, 33), 0.3), ((64, 64), 0.05),
    ((40, 120), 0.97), ((9, 71), 0.0),
])
def test_random_grids_encode_and_round_trip_as_jax(shape, density, tmp_path):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    grid = (rng.random(shape) < density).astype(np.uint8)
    text = rle.encode(grid)
    assert text == jax_rle.encode(grid)
    np.testing.assert_array_equal(rle.parse(text), grid)
    rle.write_file(str(tmp_path / "p.rle"), grid, ("a", "b c"))
    jax_rle.write_file(str(tmp_path / "j.rle"), grid, ("a", "b c"))
    assert (tmp_path / "p.rle").read_bytes() == (tmp_path / "j.rle").read_bytes()


def test_encode_rows_wraps_and_merges_as_jax():
    """Long run lists cross the 70-column wrap; empty rows are skipped."""
    rows = [(0, [(0, 3), (5, 9)]), (1, []), (4, [(i * 3, i * 3 + 1)
                                                 for i in range(60)]),
            (900, [(2, 1000)])]
    assert rle.encode_rows(rows, 1200, 1000, ("x",)) == \
        jax_rle.encode_rows(rows, 1200, 1000, ("x",))


@pytest.mark.parametrize("text", [
    "x = 3, y = 3, rule = B36/S23\nbo$2bo$3o!",
    "x = 3, y = 3\nbo$2bo$4o!",
    "x = 3, y = 2\nbo$2bo$3o!",
    "x = 3, y = 3\nbo$2b%o$3o!",
    "#C no header\nbo$2bo!",
    "x = 0, y = 3\n!",
    "x = 3, y = 3\n0b!",
])
def test_refusals_match_jax(text):
    with pytest.raises(ValueError) as want:
        jax_rle.parse(text)
    with pytest.raises(ValueError) as got:
        rle.parse(text)
    assert str(got.value) == str(want.value)


def test_dense_parse_cap_matches_jax():
    text = "x = 5000, y = 5000\no!"
    with pytest.raises(ValueError) as want:
        jax_rle.parse(text, max_cells=1 << 20)
    with pytest.raises(ValueError) as got:
        rle.parse(text, max_cells=1 << 20)
    assert str(got.value) == str(want.value)


def test_tolerated_dialects_match_jax():
    """Legacy rule spelling, '.' as dead, letters as alive, a missing '!'
    and trailing bytes after it."""
    for text in ("x = 4, y = 2, rule = 23/3\n.A2o$bo!", "x = 4, y = 2\n3o$o",
                 "x = 2, y = 1\n2o! trailing junk", "x=2,y=2,rule=S23/B3\n2o$2o!"):
        np.testing.assert_array_equal(rle.parse(text), jax_rle.parse(text))


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_sparse_board_views_match_jax(tile):
    rng = np.random.default_rng(tile)
    grid = (rng.random((64, 48)) < 0.04).astype(np.uint8)
    grid[16:32, :] = 0  # whole dead tile rows are elided
    b, jb = board.SparseBoard.from_dense(grid, tile), \
        jax_board.SparseBoard.from_dense(grid, tile)
    assert sorted(b.tiles) == sorted(jb.tiles)
    assert (b.live_tiles, b.population(), b.occupancy()) == \
        (jb.live_tiles, jb.population(), jb.occupancy())
    assert b.to_rle(("c",)) == jb.to_rle(("c",))
    np.testing.assert_array_equal(b.to_dense(), grid)
    text = b.to_rle()
    again = board.SparseBoard.from_rle(text, tile=tile)
    assert again == b
    assert repr(again) == repr(jax_board.SparseBoard.from_rle(text, tile=tile)).replace(
        "gol_tpu.", "gol_tpu_torch.")


def test_from_pattern_and_owned_runs_match_jax():
    pattern = jax_rle.read_file(str(PATTERNS[0].parent / "gosper_gun.rle"))
    b = board.SparseBoard.from_pattern(pattern, 30, 5, 64, 96, 8)
    jb = jax_board.SparseBoard.from_pattern(pattern, 30, 5, 64, 96, 8)
    assert b.to_rle() == jb.to_rle()
    text = rle.encode(pattern)
    owned = lambda coord: (coord[0] + coord[1]) % 2 == 0  # noqa: E731
    b = board.SparseBoard.from_rle(text, 64, 96, 8, x=29, y=7, owned=owned)
    jb = jax_board.SparseBoard.from_rle(text, 64, 96, 8, x=29, y=7, owned=owned)
    assert sorted(b.tiles) == sorted(jb.tiles)
    assert b.to_rle() == jb.to_rle()


@pytest.mark.parametrize("call", [
    lambda m: m.SparseBoard(64, 64, 3),
    lambda m: m.SparseBoard(0, 64, 8),
    lambda m: m.SparseBoard(60, 64, 8),
    lambda m: m.SparseBoard(64, 64, 8).place(np.ones((3, 3), np.uint8), 62, 0),
    lambda m: m.SparseBoard.from_rle("x = 3, y = 3\n3o!", 8, 8, 4, x=6),
    lambda m: m.SparseBoard(16, 16, 8).set_tile((2, 0), np.ones((8, 8), np.uint8)),
    lambda m: m.SparseBoard(16, 16, 8).set_tile((0, 0), np.ones((4, 8), np.uint8)),
    lambda m: m.SparseBoard(1 << 16, 1 << 16, 256).to_dense(),
    lambda m: m.dense_cells_guard(1 << 16, 1 << 16, what="universe"),
    lambda m: m.dense_cells_guard(40000, 30000),
])
def test_board_refusals_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jax_board)
    with pytest.raises(ValueError) as got:
        call(board)
    assert str(got.value) == str(want.value)
