"""The port's packed kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode.

K1 ``_step_t_fast``, K2 ``_step_t`` and K3 ``_step`` of
gol_tpu_torch.ops.stencil_packed must give the same words, alive flags and
similar flags as gol_tpu.ops.stencil_packed's, bit for bit (the tolerance is
zero), on every kind of pass: random soup, all dead, already still, death
inside the pass and stillness onset inside the pass (the last two replay
K2). Shapes the JAX Pallas gate refuses (heights not a multiple of 8) are
held against iterated ``packed_math.evolve_torus_words`` instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.ops import packed_math as jpm
from gol_tpu.ops import stencil_packed as jsp
from gol_tpu_torch import oracle
from gol_tpu_torch.ops import packed_math as tpm
from gol_tpu_torch.ops import stencil_packed as tsp

T = tsp.TEMPORAL_GENS
KINDS = ("soup", "dead", "still", "death", "onset")


def _grid(kind: str, height: int, width: int, seed: int = 0) -> np.ndarray:
    g = np.zeros((height, width), np.uint8)
    r, c = height // 2, width // 2
    if kind == "soup":
        g = np.random.default_rng(seed).integers(0, 2, (height, width),
                                                 dtype=np.uint8)
    elif kind == "still":  # block: already still, sim1 == 1
        g[r % height, c] = g[r % height, c + 1] = 1
        g[(r + 1) % height, c] = g[(r + 1) % height, c + 1] = 1
    elif kind == "death":  # domino: dies at generation 1
        g[r, c:c + 2] = 1
    elif kind == "onset":  # L-tromino -> block at generation 1
        g[r % height, c] = g[(r + 1) % height, c] = g[r % height, c + 1] = 1
    return g


def _words(kind, height, nwords):
    return np.asarray(jpm.encode(jnp.asarray(_grid(kind, height, 32 * nwords))))


def _t(words: np.ndarray) -> torch.Tensor:
    return tpm.words_from_numpy(words, "cpu")


def _ints(v) -> list:
    return np.asarray(v).astype(np.int64).reshape(-1).tolist()


# Shapes (height, nwords) the JAX Pallas kernels accept.
PALLAS_SHAPES = [(16, 1), (32, 3), (64, 2)]


@pytest.mark.parametrize("height,nwords", PALLAS_SHAPES)
def test_step_matches_pallas(height, nwords):
    for kind in KINDS:
        w = _words(kind, height, nwords)
        jn, ja, js = jsp._step(jnp.asarray(w), interpret=True)
        tn, ta, ts = tsp._step(_t(w))
        np.testing.assert_array_equal(tpm.words_to_numpy(tn), np.asarray(jn),
                                      err_msg=kind)
        assert (bool(ta), bool(ts)) == (bool(ja), bool(js)), kind


@pytest.mark.parametrize("height,nwords", PALLAS_SHAPES)
def test_step_t_matches_pallas(height, nwords):
    for kind in KINDS:
        w = _words(kind, height, nwords)
        jn, ja, js = jsp._step_t(jnp.asarray(w), interpret=True)
        tn, ta, ts = tsp._step_t(_t(w))
        np.testing.assert_array_equal(tpm.words_to_numpy(tn), np.asarray(jn),
                                      err_msg=kind)
        assert _ints(ta) == _ints(ja), kind
        assert _ints(ts) == _ints(js), kind


@pytest.mark.parametrize("height,nwords", PALLAS_SHAPES)
def test_step_t_fast_matches_pallas(height, nwords):
    for kind in KINDS:
        w = _words(kind, height, nwords)
        jn, ja, js = jsp._step_t_fast(jnp.asarray(w), interpret=True)
        tn, ta, ts = tsp._step_t_fast(_t(w))
        np.testing.assert_array_equal(tpm.words_to_numpy(tn), np.asarray(jn),
                                      err_msg=kind)
        assert _ints(ta) == _ints(ja), kind
        assert _ints(ts) == _ints(js), kind


def test_summary_replay_fires_only_on_transitions():
    # The summary is (in_alive, out_alive, diffT, diff1).
    assert tsp.summary_needs_replay([1, 0, 0, 1])  # death inside the pass
    assert tsp.summary_needs_replay([1, 1, 0, 1])  # stillness onset inside
    assert not tsp.summary_needs_replay([1, 1, 1, 1])  # soup
    assert not tsp.summary_needs_replay([0, 0, 0, 0])  # dead all along
    assert not tsp.summary_needs_replay([1, 1, 0, 0])  # still all along
    calls = []
    alive, similar = tsp._derive_or_replay(
        [1, 1, 1, 1], lambda: calls.append(1))
    assert (alive, similar, calls) == ([1] * T, [0] * T, [])


def _iterate(words: np.ndarray, gens: int):
    """JAX word network, generation by generation: the states g_1..g_gens."""
    states, x = [], jnp.asarray(words)
    for _ in range(gens):
        x = jpm.evolve_torus_words(x)
        states.append(np.asarray(x))
    return states


@pytest.mark.parametrize("height", [1, 5, 13])
@pytest.mark.parametrize("nwords", [1, 2])
def test_heights_pallas_refuses_match_word_network(height, nwords):
    for kind in KINDS:
        w = _words(kind, height, nwords)
        states = _iterate(w, T)
        prevs = [w] + states[:-1]
        want_alive = [int(s.any()) for s in states]
        want_similar = [int(np.array_equal(s, p)) for s, p in zip(states, prevs)]
        for fn in (tsp._step, tsp.packed_step):
            n1, a1, s1 = fn(_t(w))
            np.testing.assert_array_equal(tpm.words_to_numpy(n1), states[0])
            assert (int(a1), int(s1)) == (want_alive[0], want_similar[0]), kind
        for fn in (tsp._step_t, tsp._step_t_fast, tsp.packed_step_multi):
            n, a, s = fn(_t(w))
            np.testing.assert_array_equal(tpm.words_to_numpy(n), states[-1])
            assert _ints(a) == want_alive, (kind, fn.__name__)
            assert _ints(s) == want_similar, (kind, fn.__name__)


def test_state_carries_across_frameworks():
    # N generations in JAX, M more in the port == N + M in JAX.
    w = _words("soup", 32, 3)
    jax_n = np.asarray(jsp._step_t(jnp.asarray(w), interpret=True)[0])
    port = _t(jax_n)
    port = tsp._step_t_fast(port)[0]
    for _ in range(3):
        port = tsp._step(port)[0]
    want = _iterate(w, T + T + 3)[-1]
    np.testing.assert_array_equal(tpm.words_to_numpy(port), want)
    # ... and the decoded cells agree with the port's oracle.
    cells = _grid("soup", 32, 96)
    for _ in range(T + T + 3):
        cells = oracle.evolve(cells)
    np.testing.assert_array_equal(tpm.decode(port).numpy(), cells)


def test_wrappers_check_their_operands():
    w = _t(_words("soup", 16, 1))
    flags = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="alias"):
        tsp._step_t_into(w, w, flags)
    with pytest.raises(ValueError, match="int32"):
        tsp._step_into(w.to(torch.int64), torch.empty_like(w), flags)
    with pytest.raises(ValueError, match="flags"):
        tsp._step_t_into(w, torch.empty_like(w), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 32"):
        tsp.packed_step(torch.zeros((4, 0), dtype=torch.int32))
    # The plain path counts no launches: the counters are for the card.
    before = dict(tsp.LAUNCHES)
    tsp._step_t_fast(w)
    assert tsp.LAUNCHES == before
