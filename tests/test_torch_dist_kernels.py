"""The port's mesh-shard kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode.

K5 ``_dist_band_plain`` against ``_dist_step_pallas``, K6
``stencil_pallas._dist_band_plain`` against ``stencil_pallas._dist_step``,
K7/K8 ``_bandtrow_plain`` against ``_step_trow_fast``/``_step_trow``, and
the ghost-plane form ``_bandtg_plain`` (it replaces K9-K13) against
``_step_tgb`` (K13) and against the split-edge compositions ``_step_tsplit``
(K11 + K12) and ``_step_tsplit_fast`` (K9 + K10) and their parts.
Each shard is the top-left window of a larger torus (the "world"), and its
ghosts are cut from the world with numpy: the port takes them as the halo
exchange produces them, JAX in its ``assemble_band_ghosts`` form. The carry
columns are the neighbours' whole word columns, so both sides must read
only bit 31 (west) and bit 0 (east). New states, alive and similar flags
must be identical (tolerance zero), and the state must equal the world's
own evolution in that window. Multi-band shapes shrink JAX's band target so
that its band grid has several steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.ops import packed_math as jpm
from gol_tpu.ops import stencil_packed as jsp
from gol_tpu.ops import stencil_pallas as jspl
from gol_tpu.parallel import halo as jhalo
from gol_tpu_torch import oracle
from gol_tpu_torch.ops import packed_math as tpm
from gol_tpu_torch.ops import stencil_packed as tsp
from gol_tpu_torch.ops import stencil_pallas as tspl

T = tsp.TEMPORAL_GENS
KINDS = ("soup", "dead", "still", "death", "onset", "corner")


def _world(kind: str, h: int, w: int, H: int, W: int, seed: int) -> np.ndarray:
    """An (H, W) torus whose top-left (h, w) window is the shard; patterns
    sit in the shard's middle, or ("corner") across its north-west corner,
    where every cell but the one it gives birth to lies in a neighbour."""
    rng = np.random.default_rng(seed)
    if kind == "soup":
        return rng.integers(0, 2, (H, W), dtype=np.uint8)
    g = np.zeros((H, W), np.uint8)
    r, c = h // 2, w // 2
    cells = {"dead": [], "still": [(r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)],
             "death": [(r, c), (r, c + 1)],
             "onset": [(r, c), (r + 1, c), (r, c + 1)],
             "corner": [(-1, -1), (0, -1), (-1, 0)]}[kind]
    for rr, cc in cells:
        g[rr % H, cc % W] = 1
    return g


def _ext(n: int, depth: int, size: int) -> np.ndarray:
    """Torus row indices -depth .. n+depth-1 of a world axis of ``size``."""
    return np.arange(-depth, n + depth) % size


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return tpm.words_from_numpy(a, "cpu") if a.dtype == np.uint32 else torch.from_numpy(a)


@pytest.fixture
def band_target():
    """Run JAX's packed kernels with the given band target, then restore."""
    def set_target(target):
        jsp.set_band_target_override(target)
    yield set_target
    jsp.set_band_target_override(None)


def _packed_world(kind, h, nw, H_rows, NW, seed):
    cells = _world(kind, h, 32 * nw, H_rows, 32 * NW, seed)
    return cells, np.asarray(jpm.encode(jnp.asarray(cells)))


# (h, nwords, world rows, world words, JAX band target in bytes or None)
K5_SHAPES = [(8, 1, 16, 2, None), (16, 2, 24, 3, None), (40, 3, 56, 5, 8 * 512)]


@pytest.mark.parametrize("h,nw,H,NW,target", K5_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_k5_matches_jax_dist_step(kind, h, nw, H, NW, target, band_target):
    band_target(target)
    cells, words = _packed_world(kind, h, nw, H, NW, seed=h + nw)
    shard = words[:h, :nw]
    e = _ext(h, 1, H)
    top, bot = words[H - 1:H, :nw], words[h % H:h % H + 1, :nw]
    gwest, geast = words[e, NW - 1], words[e, nw % NW]
    new, flags = tsp._dist_band_plain(_t(shard), _t(top), _t(bot), _t(gwest),
                                      _t(geast))
    band = jsp._pick_band(h, nw)
    assert target is None or h // band > 1  # the multi-band case has bands
    g8 = jhalo.assemble_band_ghosts(*(jnp.asarray(a) for a in (top, bot, gwest, geast)),
                                    band)
    jnew, jalive, jsimilar = jsp._dist_step_pallas(jnp.asarray(shard), *g8,
                                                   interpret=True)
    np.testing.assert_array_equal(tpm.words_to_numpy(new), np.asarray(jnew))
    assert flags.tolist() == [int(jalive), 1 - int(jsimilar)]
    want = oracle.evolve(cells)[:h, :32 * nw]
    np.testing.assert_array_equal(tpm.decode(new).numpy(), want)


# (h, w, world rows, world cols, JAX byte band bytes or None)
K6_SHAPES = [(8, 128, 16, 256, None), (24, 128, 40, 384, 8 * 128)]


@pytest.mark.parametrize("h,w,H,W,band_bytes", K6_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_k6_matches_jax_dist_step(kind, h, w, H, W, band_bytes, monkeypatch):
    if band_bytes is not None:
        monkeypatch.setattr(jspl, "_BAND_BYTES", band_bytes)
    world = _world(kind, h, w, H, W, seed=h + w)
    shard = world[:h, :w]
    e = _ext(h, 1, H)
    top, bot = world[H - 1:H, :w], world[h % H:h % H + 1, :w]
    gwest, geast = world[e, W - 1], world[e, w % W]
    new, flags = tspl._dist_band_plain(_t(shard), _t(top), _t(bot), _t(gwest),
                                       _t(geast))
    band = jspl._pick_band(h, w)
    assert band_bytes is None or h // band > 1
    gtop8, gbot8, gmid, gwrap = jhalo.assemble_band_ghosts(
        *(jnp.asarray(a) for a in (top, bot, gwest, geast)), band)
    jnew, jalive, jsimilar = jspl._dist_step(
        jnp.asarray(shard), gtop8, gbot8, gmid, gwrap.astype(jnp.int32),
        interpret=True)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    assert flags.tolist() == [int(jalive), 1 - int(jsimilar)]
    np.testing.assert_array_equal(new.numpy(), oracle.evolve(world)[:h, :w])


# (h, nwords, world rows, JAX band target in bytes or None)
K78_SHAPES = [(8, 1, 16, None), (16, 2, 40, None), (48, 3, 64, 8 * 512)]


@pytest.mark.parametrize("h,nw,H,target", K78_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_k7_k8_match_jax_step_trow(kind, h, nw, H, target, band_target):
    band_target(target)
    cells, words = _packed_world(kind, h, nw, H, nw, seed=3 * h + nw)
    shard = words[:h]
    gtop, gbot = words[_ext(0, T, H)[:T]], words[np.arange(h, h + T) % H]
    args = [_t(a) for a in (shard, gtop, gbot)]
    jargs = [jnp.asarray(a) for a in (shard, gtop, gbot)]
    if target is not None:
        assert h // jsp._pick_band(h, nw, jsp._bandt_target(h, nw)) > 1

    # K8 and _step_trow: exact per-generation flags.
    new8, exact = tsp._bandtrow_plain(*args, exact=True)
    jnew8, jalive8, jsimilar8 = jsp._step_trow(*jargs, interpret=True)
    np.testing.assert_array_equal(tpm.words_to_numpy(new8), np.asarray(jnew8))
    assert exact.tolist() == (np.asarray(jalive8).tolist()
                              + [1 - s for s in np.asarray(jsimilar8).tolist()])

    # K7 and _step_trow_fast: the summary, derived or replayed from K8.
    new7, summary = tsp._bandtrow_plain(*args, exact=False)
    alive, similar = tsp._derive_or_replay(
        summary.tolist(),
        lambda: (exact.tolist()[:T], [1 - d for d in exact.tolist()[T:]]))
    jnew7, jalive7, jsimilar7 = jsp._step_trow_fast(*jargs, interpret=True)
    np.testing.assert_array_equal(tpm.words_to_numpy(new7), np.asarray(jnew7))
    assert (alive, similar) == (np.asarray(jalive7).tolist(),
                                np.asarray(jsimilar7).tolist())
    assert summary.tolist() == [int(shard.any()), exact.tolist()[T - 1],
                                exact.tolist()[2 * T - 1], exact.tolist()[T]]

    want = cells
    for _ in range(T):
        want = oracle.evolve(want)
    np.testing.assert_array_equal(tpm.decode(new7).numpy(), want[:h])


# ---------------------------------------------------------------------------
# The ghost-plane form of the 8-generation pass against K9-K13.

PLANE_KINDS = ("soup", "death", "onset", "glider")
# The split-edge compositions are plain Python over jitted kernels; under
# one jit each traces (its replay branch included) once per shape.
_J_TSPLIT = jax.jit(functools.partial(jsp._step_tsplit, interpret=True))
_J_TSPLIT_FAST = jax.jit(functools.partial(jsp._step_tsplit_fast, interpret=True))


def _plane_cells(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """A shard's cells: a soup, a domino that dies inside the pass, an
    L-tromino that becomes still inside it, and a glider that crosses the
    east/west seam during it."""
    if kind == "soup":
        return np.random.default_rng(seed).integers(0, 2, (h, w), dtype=np.uint8)
    g = np.zeros((h, w), np.uint8)
    r, c = h // 2, w // 2
    cells = {"death": [(r, c), (r, c + 1)],
             "onset": [(r, c), (r + 1, c), (r, c + 1)],
             "glider": [(r, w - 2), (r + 1, w - 1), (r + 2, w - 3), (r + 2, w - 2),
                        (r + 2, w - 1)]}[kind]
    for rr, cc in cells:
        g[rr, cc] = 1
    return g


def _plane_operands(words: np.ndarray, ghosts: str, seed: int):
    """``(gtop, gbot, G_ext)`` as numpy: the ghosts a one-shard torus
    exchanges (cut by JAX's own operand functions), or every ghost bit random."""
    h, nw = words.shape
    if ghosts == "random":
        rng = np.random.default_rng(seed)
        rand = lambda *shape: rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
        return rand(T, nw), rand(T, nw), rand(h + 2 * T, 2)
    jw = jnp.asarray(words)
    if nw >= 2:
        gtop, gbot, cols4, G_ext = jsp._tsplit_operands(jw, jsp.SINGLE_DEVICE_TOPOLOGY)
        np.testing.assert_array_equal(
            np.asarray(cols4), np.concatenate([words[:, :2], words[:, nw - 2:]], axis=1))
    else:
        gtop, gbot, G_ext = jsp.deep_ghost_operands(jw, jsp.SINGLE_DEVICE_TOPOLOGY)
    # The port's exchange over a one-shard mesh cuts the same ghosts.
    mine = tsp.deep_ghost_operands([_t(words)], (1, 1))[0]
    for got, want in zip(mine, (gtop, gbot, G_ext[:, 0], G_ext[:, 1])):
        np.testing.assert_array_equal(tpm.words_to_numpy(got), np.asarray(want))
    return np.asarray(gtop), np.asarray(gbot), np.asarray(G_ext)


def _exact_list(jalive, jsimilar) -> list:
    """JAX's per-generation vectors in the port's flag layout."""
    return (np.asarray(jalive).tolist()
            + [1 - s for s in np.asarray(jsimilar).tolist()])


def _eight_generations(cells: np.ndarray) -> np.ndarray:
    for _ in range(T):
        cells = oracle.evolve(cells)
    return cells


@pytest.mark.parametrize("h,nw", [(16, 1), (24, 3)])
@pytest.mark.parametrize("ghosts", ["torus", "random"])
@pytest.mark.parametrize("kind", PLANE_KINDS)
def test_plane_form_matches_jax_step_tgb(kind, ghosts, h, nw):
    cells = _plane_cells(kind, h, 32 * nw, seed=h + nw)
    words = np.asarray(jpm.encode(jnp.asarray(cells)))
    gtop, gbot, G_ext = _plane_operands(words, ghosts, seed=7 * h + nw)
    args = [_t(a) for a in (words, gtop, gbot, G_ext[:, 0], G_ext[:, 1])]
    new, exact = tsp._bandtg_plain(*args, exact=True)
    jnew, jalive, jsimilar = jsp._step_tgb(
        *(jnp.asarray(a) for a in (words, gtop, gbot, G_ext)), interpret=True)
    np.testing.assert_array_equal(tpm.words_to_numpy(new), np.asarray(jnew))
    assert exact.tolist() == _exact_list(jalive, jsimilar)
    # The JAX signature over the same plain version.
    snew, salive, ssimilar = tsp._step_tgb(*args[:3], _t(G_ext))
    assert torch.equal(snew, new)
    assert salive.tolist() + [1 - s for s in ssimilar.tolist()] == exact.tolist()
    if ghosts == "torus":
        np.testing.assert_array_equal(tpm.decode(new).numpy(),
                                      _eight_generations(cells))


@pytest.mark.parametrize("h,nw", [(16, 2), (24, 4)])
@pytest.mark.parametrize("ghosts", ["torus", "random"])
@pytest.mark.parametrize("kind", PLANE_KINDS)
def test_plane_form_matches_jax_split_edge(kind, ghosts, h, nw):
    cells = _plane_cells(kind, h, 32 * nw, seed=3 * h + nw)
    words = np.asarray(jpm.encode(jnp.asarray(cells)))
    gtop, gbot, G_ext = _plane_operands(words, ghosts, seed=5 * h + nw)
    cols4 = np.concatenate([words[:, :2], words[:, nw - 2:]], axis=1)
    args = [_t(a) for a in (words, gtop, gbot, G_ext[:, 0], G_ext[:, 1])]
    jw, jgtop, jgbot, jcols4, jG = (jnp.asarray(a) for a in
                                    (words, gtop, gbot, cols4, G_ext))

    # Exact flags: K11 + K12 (_step_tsplit), and K11's own edge columns.
    new, exact = tsp._bandtg_plain(*args, exact=True)
    jnew, jalive, jsimilar = _J_TSPLIT(jw, jgtop, jgbot, jcols4, jG)
    np.testing.assert_array_equal(tpm.words_to_numpy(new), np.asarray(jnew))
    assert exact.tolist() == _exact_list(jalive, jsimilar)
    folded, F, Lo = jsp._fold_strip(jw, jgtop, jgbot, jcols4, jG)
    w0_col, wn_col = jsp._unfold_edge_cols(
        jsp._step_strip(folded, interpret=True)[0], h, F, Lo)
    got = tpm.words_to_numpy(new)
    np.testing.assert_array_equal(got[:, 0], np.asarray(w0_col)[:, 0])
    np.testing.assert_array_equal(got[:, nw - 1], np.asarray(wn_col)[:, 0])

    # Summary flags: the OR/AND join of K9's and K10's summaries.
    new_f, summary = tsp._bandtg_plain(*args, exact=False)
    folded_T, summ_s = jsp._step_strip_fast(folded, interpret=True)
    jnew_f, summ_m = jsp._step_trow_stitch_fast(
        jw, jgtop, jgbot, *jsp._unfold_edge_cols(folded_T, h, F, Lo), interpret=True)
    summ_s, summ_m = np.asarray(summ_s)[0], np.asarray(summ_m)[0]
    joint = [max(summ_m[0], summ_s[0]), max(summ_m[1], summ_s[1]),
             min(summ_m[2], summ_s[2]), min(summ_m[3], summ_s[3])]
    np.testing.assert_array_equal(tpm.words_to_numpy(new_f), np.asarray(jnew_f))
    assert summary.tolist() == [joint[0], joint[1], 1 - joint[2], 1 - joint[3]]

    # The JAX signatures: derived (or replayed) vectors of K9 + K10.
    jnew2, jalive2, jsimilar2 = _J_TSPLIT_FAST(jw, jgtop, jgbot, jcols4, jG)
    snew, salive, ssimilar = tsp._step_tsplit_fast(*args[:3], _t(cols4), _t(G_ext))
    np.testing.assert_array_equal(tpm.words_to_numpy(snew), np.asarray(jnew2))
    assert (salive.tolist(), ssimilar.tolist()) == (
        np.asarray(jalive2).tolist(), np.asarray(jsimilar2).tolist())
    xnew, xalive, xsimilar = tsp._step_tsplit(*args[:3], _t(cols4), _t(G_ext))
    assert torch.equal(xnew, new)
    assert xalive.tolist() + [1 - s for s in xsimilar.tolist()] == exact.tolist()
    if ghosts == "torus":
        np.testing.assert_array_equal(tpm.decode(new).numpy(),
                                      _eight_generations(cells))


def test_shard_wrappers_check_their_ghosts():
    w = torch.zeros((8, 2), dtype=torch.int32)
    flags = torch.zeros(16, dtype=torch.int32)
    row, col = torch.zeros((1, 2), dtype=torch.int32), torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="gwest"):
        tsp._distributed_step_into(w, row, row, col[:9], col, torch.empty_like(w), flags)
    with pytest.raises(ValueError, match="top"):
        tsp._distributed_step_into(w, row.to(torch.int64), row, col, col,
                                   torch.empty_like(w), flags)
    deep = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at least 8 rows"):
        tsp._step_trow_into(w[:7], deep, deep, torch.empty_like(w[:7]), flags)
    with pytest.raises(ValueError, match="gbot"):
        tsp._step_trow_fast_into(w, deep, deep[:4], torch.empty_like(w), flags)
    b = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="geast"):
        tspl._distributed_step_into(b, b[:1], b[:1], torch.zeros(6, dtype=torch.uint8),
                                    torch.zeros(5, dtype=torch.uint8),
                                    torch.empty_like(b), flags)
    plane = torch.zeros(24, dtype=torch.int32)
    with pytest.raises(ValueError, match="gwest"):
        tsp._step_tg_into(w, deep, deep, plane[:10], plane, torch.empty_like(w), flags)
    with pytest.raises(ValueError, match="at least 8 rows"):
        tsp._step_tg_fast_into(w[:7], deep, deep, plane[:23], plane[:23],
                               torch.empty_like(w[:7]), flags)
    with pytest.raises(ValueError, match="G_ext"):
        tsp._step_tgb(w, deep, deep, plane)
    with pytest.raises(ValueError, match="cols4"):
        tsp._step_tsplit(w, deep, deep, torch.ones((8, 4), dtype=torch.int32),
                         torch.zeros((24, 2), dtype=torch.int32))
    # The plain path counts no launches.
    before = dict(tsp.LAUNCHES)
    tsp._distributed_step_into(w, row, row, col, col, torch.empty_like(w), flags)
    tsp._step_tg_into(w, deep, deep, plane, plane, torch.empty_like(w), flags)
    assert tsp.LAUNCHES == before
