"""The port's packed word network (gol_tpu_torch.ops.packed_math) against the
JAX package's (gol_tpu.ops.packed_math), bit for bit.

Inputs are made with numpy from a seed and handed to both as uint32 words;
the port carries them as int32 tensors with the same bit pattern. Results
are integers, so the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.io import bitpack as jax_bitpack
from gol_tpu.ops import packed_math as jpm
from gol_tpu_torch.io import bitpack
from gol_tpu_torch.ops import packed_math as tpm

NWORDS = (1, 2, 5)


def _words(nwords: int, height: int = 6, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + nwords)
    w = rng.integers(0, 2**32, size=(height, nwords), dtype=np.uint64)
    w = w.astype(np.uint32)
    w[0, 0] |= np.uint32(0x80000000)  # bit 31 set somewhere, always
    w[-1, -1] = np.uint32(0xFFFFFFFF)
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    return tpm.words_from_numpy(a, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return tpm.words_to_numpy(t)


@pytest.mark.parametrize("nwords", NWORDS)
def test_west_east_match_jax(nwords):
    x, nb = _words(nwords), _words(nwords, seed=7)
    for jfn, tfn in ((jpm.west, tpm.west), (jpm.east, tpm.east)):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(nb)))
        np.testing.assert_array_equal(_np(tfn(_t(x), _t(nb))), want)


@pytest.mark.parametrize("nwords", NWORDS)
def test_csa3_row_sums_combine_match_jax(nwords):
    a, b, c = (_words(nwords, seed=s) for s in (1, 2, 3))
    ja = [jnp.asarray(v) for v in (a, b, c)]
    ta = [_t(v) for v in (a, b, c)]
    for jv, tv in zip(jpm.csa3(*ja), tpm.csa3(*ta)):
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    for jv, tv in zip(jpm.row_sums(*ja), tpm.row_sums(*ta)):
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    planes = [_words(nwords, seed=s) for s in range(10, 17)]
    want = np.asarray(jpm.combine(*[jnp.asarray(p) for p in planes]))
    np.testing.assert_array_equal(_np(tpm.combine(*[_t(p) for p in planes])), want)


@pytest.mark.parametrize("height,nwords", [(1, 1), (5, 2), (9, 5)])
def test_evolve_torus_words_matches_jax(height, nwords):
    x = _words(nwords, height=height, seed=height)
    j, t = jnp.asarray(x), _t(x)
    for _ in range(4):
        j, t = jpm.evolve_torus_words(j), tpm.evolve_torus_words(t)
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("nwords", NWORDS)
def test_encode_decode_match_jax(nwords):
    rng = np.random.default_rng(nwords)
    grid = rng.integers(0, 2, size=(7, 32 * nwords), dtype=np.uint8)
    grid[:, 31] = 1  # bit 31 of every first word: the int32 sign bit
    words = tpm.encode(torch.from_numpy(grid))
    assert words.dtype == torch.int32
    want = np.asarray(jpm.encode(jnp.asarray(grid)))
    np.testing.assert_array_equal(_np(words), want)
    np.testing.assert_array_equal(bitpack.pack_words(grid), want)
    np.testing.assert_array_equal(jax_bitpack.pack_words(grid), want)
    back = tpm.decode(words).numpy()
    np.testing.assert_array_equal(back, np.asarray(jpm.decode(jnp.asarray(want))))
    np.testing.assert_array_equal(back, grid)
    np.testing.assert_array_equal(bitpack.unpack_words(want), grid)


def test_encode_rejects_unpacked_width():
    with pytest.raises(ValueError, match="multiple of 32"):
        tpm.encode(torch.zeros((2, 33), dtype=torch.uint8))


@pytest.mark.parametrize("nwords", NWORDS)
def test_words_numpy_round_trip_is_bit_exact(nwords):
    w = _words(nwords)
    w[2, 0] = np.uint32(0x80000000)
    w[3, 0] = np.uint32(0x7FFFFFFF)
    t = tpm.words_from_numpy(w, "cpu")
    assert t.dtype == torch.int32 and t.shape == w.shape
    back = tpm.words_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, w)
