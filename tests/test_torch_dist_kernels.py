"""The port's mesh-shard kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode.

K5 ``_dist_band_plain`` against ``_dist_step_pallas``, K6
``stencil_pallas._dist_band_plain`` against ``stencil_pallas._dist_step``,
and K7/K8 ``_bandtrow_plain`` against ``_step_trow_fast``/``_step_trow``.
Each shard is the top-left window of a larger torus (the "world"), and its
ghosts are cut from the world with numpy: the port takes them as the halo
exchange produces them, JAX in its ``assemble_band_ghosts`` form. The carry
columns are the neighbours' whole word columns, so both sides must read
only bit 31 (west) and bit 0 (east). New states, alive and similar flags
must be identical (tolerance zero), and the state must equal the world's
own evolution in that window. Multi-band shapes shrink JAX's band target so
that its band grid has several steps.
"""

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
    # The plain path counts no launches.
    before = dict(tsp.LAUNCHES)
    tsp._distributed_step_into(w, row, row, col, col, torch.empty_like(w), flags)
    assert tsp.LAUNCHES == before
