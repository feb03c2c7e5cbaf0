"""The port's CUDA kernels on the card, against their plain torch versions,
and the CLI lanes that launch them against the oracle.

Marked ``cuda``: each test skips (inside a fixture, so every worker collects
the same tests) where torch sees no CUDA card. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``. Words, flags and
generation counts must match exactly.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from gol_tpu_torch import cli, engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_batch as sb
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.ops import stencil_pallas as spl

pytestmark = pytest.mark.cuda

# The card runs these with --noconftest, so the suite's private plan cache
# is set here: no plan cached on the machine may reroute the runners.
os.environ["GOL_PLAN_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="gol_cuda_plans_"), "plans.json")

# bandt_kernel's tile: a strip of TILE_WORDS interior words per warp, split
# into bands of at least TILE_ROWS rows (test_tile_shapes_surround_the_strip
# holds them to the built library). TILE_SHAPES surround it: heights TH - 1,
# TH and TH + 1 (one band) and 2 TH + 17 (two, split 41 + 40); nwords 1, 2,
# 31, 61 and 37, none a multiple of TILE_WORDS.
TILE_ROWS, TILE_WORDS = 32, 30
TILE_SHAPES = [(TILE_ROWS - 1, 1), (TILE_ROWS + 1, 2), (2 * TILE_ROWS + 17, 31),
               (TILE_ROWS, 61), (TILE_ROWS + 1, TILE_WORDS + 7)]
# band_kernel (K3, K5) takes rows of whole uint4s (nwords % 4 == 0, 16-byte
# aligned) four words to a lane, others one: BAND_SHAPES are of the first
# kind (one lane; a strip of 32 lanes and one of one) and height 2.
BAND_SHAPES = [(2, 1), (33, 4), (40, 132)]
SHAPES = [(1, 1), (7, 1), (16, 2), (17, 5), (200, 33)] + TILE_SHAPES + BAND_SHAPES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    sp.load_kernels()
    spl.load_kernels()
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(height, nwords, seed=0):
    rng = np.random.default_rng(seed + height * 31 + nwords)
    soup = rng.integers(0, 2**32, size=(height, nwords), dtype=np.uint64)
    die = np.zeros((height, nwords * 32), np.uint8)
    die[height // 2, 5:7] = 1
    onset = np.zeros((height, nwords * 32), np.uint8)
    onset[0, 0] = onset[1 % height, 0] = onset[0, nwords * 32 - 1] = 1
    return {
        "soup": soup.astype(np.uint32),
        "die": pm.words_to_numpy(pm.encode(torch.from_numpy(die))),
        "onset": pm.words_to_numpy(pm.encode(torch.from_numpy(onset))),
    }


@pytest.mark.parametrize("height,nwords", SHAPES)
@pytest.mark.parametrize("kernel", ["bandt_fast", "bandt", "band"])
def test_kernel_matches_plain(card, kernel, height, nwords):
    into, nflags = {
        "bandt_fast": (sp._step_t_fast_into, sp.SUMMARY_FLAGS),
        "bandt": (sp._step_t_into, sp.EXACT_FLAGS),
        "band": (sp._step_into, sp.STEP_FLAGS),
    }[kernel]
    for name, words in _inputs(height, nwords).items():
        x = pm.words_from_numpy(words, card)
        out = torch.empty_like(x)
        flags = torch.zeros(nflags, dtype=torch.int32, device=card)
        before = sp.LAUNCHES[kernel]
        into(x, out, flags)
        torch.cuda.synchronize(card)
        assert sp.LAUNCHES[kernel] == before + 1
        if kernel == "band":
            want, want_flags = sp._band_plain(x)
        else:
            want, want_flags = sp._bandt_plain(x, exact=kernel == "bandt")
        assert torch.equal(out, want), name
        assert flags.tolist() == want_flags.tolist(), name


def _one_word_off(t):
    """A copy of ``t`` starting one word past a 16-byte boundary."""
    base = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = base[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", ["words", "out", "top", "bot"])
def test_one_generation_kernels_take_any_alignment(card, which):
    # nwords % 4 == 0 but one row pointer off a 16-byte boundary (a shard
    # that is a slice): K3 and K5 take the one-word form, same words, flags.
    g = {k: pm.words_from_numpy(v, card)
         for k, v in _shard_ghosts(19, 36, seed=5).items()}
    x = _one_word_off(g["x"]) if which == "words" else g["x"]
    ghosts = [_one_word_off(g[k]) if k == which else g[k]
              for k in ("top", "bot", "gwest", "geast")]
    for kernel in ("band", "dist_band"):
        if kernel == "band" and which in ("top", "bot"):
            continue
        out = torch.empty_like(x)
        if which == "out":
            out = _one_word_off(out)
        flags = torch.zeros(sp.STEP_FLAGS, dtype=torch.int32, device=card)
        if kernel == "band":
            sp._step_into(x, out, flags)
            want, want_flags = sp._band_plain(x)
        else:
            sp._distributed_step_into(x, *ghosts, out, flags)
            want, want_flags = sp._dist_band_plain(x, *ghosts)
        torch.cuda.synchronize(card)
        assert torch.equal(out, want), kernel
        assert flags.tolist() == want_flags.tolist(), kernel


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
def test_engine_on_the_card_matches_oracle(card, convention):
    grids = [text_grid.generate(64, 64, seed=1)]
    patch = np.zeros((32, 64), np.uint8)
    patch[12:17, 28:33] = np.random.default_rng(203).integers(0, 2, (5, 5),
                                                              dtype=np.uint8)
    grids.append(patch)  # dies at generation 44: K2 and empty-exit replays
    for grid in grids:
        for limit in (1000, 37):
            config = GameConfig(convention=convention, gen_limit=limit)
            want = oracle.run(grid, config)
            got = engine.simulate(grid, config, device=card)
            assert got.generations == want.generations
            np.testing.assert_array_equal(got.grid, want.grid)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 2), dtype=torch.int32, device=card)
    flags = torch.zeros(16, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="alias"):
        sp._step_t_into(x, x, flags)
    with pytest.raises(ValueError, match="contiguous"):
        sp._step_into(x.t(), torch.empty_like(x.t()), flags)
    with pytest.raises(ValueError, match="is on"):
        sp._step_into(x, torch.empty_like(x), flags.cpu())


BYTE_SHAPES = [(1, 1), (7, 3), (16, 128), (17, 161), (1000, 225), (64, 4096)]


@pytest.mark.parametrize("height,width", BYTE_SHAPES)
def test_byte_kernel_matches_plain(card, height, width):
    rng = np.random.default_rng(height * 7 + width)
    die = np.zeros((height, width), np.uint8)
    die[height // 2, width // 2] = die[height // 2, (width // 2 + 1) % width] = 1
    onset = np.zeros((height, width), np.uint8)
    onset[0, 0] = onset[1 % height, 0] = onset[0, width - 1] = 1
    grids = {"soup": (rng.random((height, width)) < 0.5).astype(np.uint8),
             "die": die, "onset": onset}
    for name, g in grids.items():
        x = torch.from_numpy(g).to(card)
        # An offset view: the kernel's byte path for unaligned pointers.
        for src in (x, torch.cat([torch.zeros(1, dtype=torch.uint8, device=card),
                                  x.reshape(-1)])[1:].reshape(height, width)):
            out = torch.full_like(src, 7)
            flags = torch.zeros(2, dtype=torch.int32, device=card)
            before = spl.LAUNCHES["byte_band"]
            spl._step_into(src, out, flags)
            torch.cuda.synchronize(card)
            assert spl.LAUNCHES["byte_band"] == before + 1
            want, want_flags = spl._band_plain(src)
            assert torch.equal(out, want), name
            assert flags.tolist() == want_flags.tolist(), name


def _cli_on_card(monkeypatch, tmp_path, capsys, grid, args):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cuda")
    height, width = grid.shape
    path = tmp_path / "in.txt"
    text_grid.write_grid(str(path), grid)
    out = tmp_path / "out.txt"
    rc = cli.main([str(width), str(height), str(path), *args, "--output", str(out)])
    stdout = capsys.readouterr().out
    assert rc == 0, stdout
    gens = int(stdout.split("Generations:\t")[1].split()[0])
    return gens, text_grid.read_grid(str(out), width, height)


@pytest.mark.parametrize("variant", ["game", "cuda"])
@pytest.mark.parametrize("lane", ["pallas", "packed_io"])
def test_cli_lanes_on_the_card_match_oracle(card, lane, variant, monkeypatch,
                                            tmp_path, capsys):
    args = ["--variant", variant] + (
        ["--kernel", "pallas"] if lane == "pallas" else ["--packed-io"])
    patch = np.zeros((32, 64), np.uint8)
    patch[12:17, 28:33] = np.random.default_rng(203).integers(0, 2, (5, 5),
                                                              dtype=np.uint8)
    grids = [text_grid.generate(64, 64, seed=1), patch]
    if lane == "pallas":
        grids.append(text_grid.generate(30, 30, seed=2))
    convention = Convention.CUDA if variant == "cuda" else Convention.C
    for grid in grids:
        want = oracle.run(grid, GameConfig(convention=convention))
        gens, got = _cli_on_card(monkeypatch, tmp_path, capsys, grid, args)
        assert gens == want.generations
        np.testing.assert_array_equal(got, want.grid)


# ---------------------------------------------------------------------------
# The mesh-shard kernels K5-K8 on the card, and a mesh run against 1x1.

SHARD_SHAPES = [(1, 1), (8, 1), (17, 5), (200, 33)] + TILE_SHAPES + BAND_SHAPES


def _shard_ghosts(height, nwords, seed):
    """Random words of a shard and random ghosts of the shapes K5, K7, K8
    and the ghost-plane forms take (every bit random: the kernels must read
    only what they own)."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)

    return {"x": words(height, nwords), "top": words(1, nwords),
            "bot": words(1, nwords), "gwest": words(height + 2),
            "geast": words(height + 2), "gtop": words(8, nwords),
            "gbot": words(8, nwords), "gwest8": words(height + 16),
            "geast8": words(height + 16)}


@pytest.mark.parametrize(
    "kernel,height,nwords",
    [(k, h, nw) for k in ("dist_band", "bandtrow_fast", "bandtrow")
     for h, nw in SHARD_SHAPES if k == "dist_band" or h >= 8],  # K7/K8: h >= 8
)
def test_shard_kernel_matches_plain(card, kernel, height, nwords):
    for seed in range(3):
        g = {k: pm.words_from_numpy(v, card)
             for k, v in _shard_ghosts(height, nwords, seed).items()}
        if seed == 2:  # a dead shard in dead surroundings
            g = {k: torch.zeros_like(v) for k, v in g.items()}
        x, out = g["x"], torch.empty_like(g["x"])
        before = sp.LAUNCHES[kernel]
        if kernel == "dist_band":
            flags = torch.zeros(sp.STEP_FLAGS, dtype=torch.int32, device=card)
            ghosts = [g[k] for k in ("top", "bot", "gwest", "geast")]
            sp._distributed_step_into(x, *ghosts, out, flags)
            want, want_flags = sp._dist_band_plain(x, *ghosts)
        else:
            exact = kernel == "bandtrow"
            flags = torch.zeros(sp.EXACT_FLAGS if exact else sp.SUMMARY_FLAGS,
                                dtype=torch.int32, device=card)
            into = sp._step_trow_into if exact else sp._step_trow_fast_into
            into(x, g["gtop"], g["gbot"], out, flags)
            want, want_flags = sp._bandtrow_plain(x, g["gtop"], g["gbot"], exact)
        torch.cuda.synchronize(card)
        assert sp.LAUNCHES[kernel] == before + 1
        assert torch.equal(out, want), seed
        assert flags.tolist() == want_flags.tolist(), seed


@pytest.mark.parametrize("height,nwords",
                         [(8, 1), (17, 1), (16, 2), (17, 5), (200, 33), (130, 70)]
                         + TILE_SHAPES)
@pytest.mark.parametrize("kernel", ["bandtg_fast", "bandtg"])
def test_plane_kernel_matches_plain(card, kernel, height, nwords):
    # The ghost-plane forms of the 8-generation pass (K9+K10; K11+K12+K13).
    exact = kernel == "bandtg"
    into = sp._step_tg_into if exact else sp._step_tg_fast_into
    for seed in range(3):
        g = {k: pm.words_from_numpy(v, card)
             for k, v in _shard_ghosts(height, nwords, seed).items()}
        if seed == 2:  # a dead shard in dead surroundings
            g = {k: torch.zeros_like(v) for k, v in g.items()}
        ghosts = [g[k] for k in ("gtop", "gbot", "gwest8", "geast8")]
        x, out = g["x"], torch.empty_like(g["x"])
        flags = torch.zeros(sp.EXACT_FLAGS if exact else sp.SUMMARY_FLAGS,
                            dtype=torch.int32, device=card)
        before = sp.LAUNCHES[kernel]
        into(x, *ghosts, out, flags)
        torch.cuda.synchronize(card)
        assert sp.LAUNCHES[kernel] == before + 1
        want, want_flags = sp._bandtg_plain(x, *ghosts, exact)
        assert torch.equal(out, want), seed
        assert flags.tolist() == want_flags.tolist(), seed
    with pytest.raises(ValueError, match="geast"):
        into(x, *ghosts[:3], ghosts[3][:-1], out, flags)


@pytest.mark.parametrize("height,width", [(1, 1), (7, 3), (17, 161), (64, 4096)])
def test_shard_byte_kernel_matches_plain(card, height, width):
    rng = np.random.default_rng(height + width)
    for seed in range(2):
        def cells(*shape):
            return torch.from_numpy(rng.integers(0, 2, shape, dtype=np.uint8)).to(card)

        x, ghosts = cells(height, width), [cells(1, width), cells(1, width),
                                           cells(height + 2), cells(height + 2)]
        if seed == 1:
            x, ghosts = torch.zeros_like(x), [torch.zeros_like(t) for t in ghosts]
        out = torch.full_like(x, 7)
        flags = torch.zeros(2, dtype=torch.int32, device=card)
        before = spl.LAUNCHES["dist_byte_band"]
        spl._distributed_step_into(x, *ghosts, out, flags)
        torch.cuda.synchronize(card)
        assert spl.LAUNCHES["dist_byte_band"] == before + 1
        want, want_flags = spl._dist_band_plain(x, *ghosts)
        assert torch.equal(out, want)
        assert flags.tolist() == want_flags.tolist()


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
def test_mesh_on_the_card_matches_single_device(card, convention, monkeypatch):
    from gol_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "4")
    patch = np.zeros((64, 256), np.uint8)
    patch[14:19, 120:125] = np.random.default_rng(203).integers(0, 2, (5, 5),
                                                                dtype=np.uint8)
    for grid in (text_grid.generate(256, 64, seed=4), patch):
        config = GameConfig(convention=convention)
        want = engine.simulate(grid, config, device=card)
        for shape in ((4, 1), (2, 2), (1, 4)):
            for kernel in ("auto", "pallas"):
                before = {**sp.LAUNCHES, **spl.LAUNCHES}
                got = engine.simulate(grid, config, kernel=kernel,
                                      mesh=make_mesh(*shape))
                launched = {k: n - before[k]
                            for k, n in {**sp.LAUNCHES, **spl.LAUNCHES}.items()}
                assert got.generations == want.generations, (shape, kernel)
                np.testing.assert_array_equal(got.grid, want.grid)
                key = ("dist_byte_band" if kernel == "pallas" else
                       "bandtrow_fast" if shape == (4, 1) else "bandtg_fast")
                assert launched[key] > 0, (shape, kernel, launched)
                assert not any(launched[k] for k in ("bandt_fast", "bandt", "band"))


@pytest.mark.parametrize("lane", [[], ["--packed-io"]], ids=["cells", "packed_io"])
def test_mesh_lanes_on_the_card_match_oracle(card, lane, monkeypatch, tmp_path,
                                             capsys):
    # --packed-io, --snapshot-every and --resume-gen over --mesh 2x2; 64^2
    # has one-word shards, 128^2 two-word shards.
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "4")
    for n in (64, 128):
        grid = text_grid.generate(n, n, seed=n)
        want = oracle.run(grid, GameConfig())
        snaps = tmp_path / f"snaps{n}"
        args = ["--variant", "tpu", "--mesh", "2x2", *lane]
        gens, got = _cli_on_card(monkeypatch, tmp_path, capsys, grid,
                                 args + ["--snapshot-every", "100",
                                         "--snapshot-dir", str(snaps)])
        assert gens == want.generations
        np.testing.assert_array_equal(got, want.grid)
        at300 = oracle.run(grid, GameConfig(gen_limit=300)).grid
        np.testing.assert_array_equal(
            text_grid.read_grid(str(snaps / "gen_000300.out"), n, n), at300)
        gens, got = _cli_on_card(monkeypatch, tmp_path, capsys, at300,
                                 args + ["--resume-gen", "300"])
        assert gens == want.generations
        np.testing.assert_array_equal(got, want.grid)


@pytest.mark.parametrize("height,nwords", SHAPES + [(16384, 512)])
def test_noflags_kernel_matches_plain(card, height, nwords):
    """K14 at the one-tile and ragged shapes, and at the main path's
    16384^2: its words equal its plain version's and K2's."""
    for name, words in _inputs(height, nwords).items():
        x = pm.words_from_numpy(words, card)
        out = torch.empty_like(x)
        before = sp.LAUNCHES["bandt_noflags"]
        sp._step_t_noflags_into(x, out)
        torch.cuda.synchronize(card)
        assert sp.LAUNCHES["bandt_noflags"] == before + 1
        assert torch.equal(out, sp._bandt_noflags_plain(x)), name
        assert torch.equal(out, sp._step_t(x)[0]), name


def test_profiler_reads_the_kernel_device_time(card):
    from gol_tpu_torch.obs import profiler

    x = pm.words_from_numpy(_inputs(1024, 64)["soup"], card)
    out = torch.empty_like(x)
    ms = profiler.kernel_device_ms(lambda: sp._step_t_noflags_into(x, out), 10,
                                   ("bandt_kernel",))
    assert 0 < ms < 100
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        profiler.kernel_device_ms(lambda: sp._step_t_noflags_into(x, out), 2,
                                  ("no_such_kernel",))


def test_tile_shapes_surround_the_strip(card):
    rows, words, ghost_rows = sp.bandt_tile()
    assert (rows, words, ghost_rows) == (TILE_ROWS, TILE_WORDS, sp.TEMPORAL_GENS)
    assert sp.bandt_bands(TILE_ROWS - 1, 1) == (TILE_ROWS - 1, 1)
    assert sp.bandt_bands(TILE_ROWS + 1, 2) == (TILE_ROWS + 1, 1)
    assert sp.bandt_bands(2 * TILE_ROWS + 17, 31) == (TILE_ROWS + 9, 2)


@pytest.mark.parametrize("height,nwords", [(16384, 512), (4096, 512), (8192, 256),
                                           (65536, 2048), (16384, 1)])
def test_bands_fill_one_wave(card, height, nwords):
    """K1's bands: every strip's rows in equal bands of at least TILE_ROWS
    rows, no more bands than the card's resident warps hold at once."""
    rows, bands = sp.bandt_bands(height, nwords)
    assert (bands - 1) * rows < height <= bands * rows
    assert rows >= TILE_ROWS
    strips = -(-nwords // TILE_WORDS)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert strips * bands <= max(strips, sms * 64)  # at most 64 warps per SM


def test_roofline_reads_the_tile_and_checks_what_it_timed(card):
    from gol_tpu_torch.tools import roofline

    rows, words, ghost_rows = sp.bandt_tile()
    assert ghost_rows == sp.TEMPORAL_GENS and rows > 0 and words > 0
    report = roofline.report([1024])
    assert report["tile"] == {"rows": rows, "words": words,
                              "ghost_rows": ghost_rows}
    (size,) = report["sizes"]
    band_rows, bands = sp.bandt_bands(1024, 32)
    assert size["bands"] == {"rows": band_rows, "per_strip": bands}
    assert size["tile_overfetch"] == roofline.tile_overfetch(band_rows, words,
                                                             ghost_rows)
    for name in ("K1", "K2", "K14"):
        assert size["checks"][name] == {"words": 1024 * 32,
                                        "words_differing": 0,
                                        "flags_differing": 0}


def test_host_snapshot_waits_for_the_boundary_and_lands_on_the_host(card):
    """The async writer's snapshot: the boundary state is still being
    computed on the compute stream (behind a delay) when the snapshot is
    taken, and the next segment overwrites it in place right after the
    snapshot returns. The side-stream copy must wait for the boundary
    (its event) and be on the host when the constructor returns."""
    from gol_tpu_torch.pipeline.snapshot import HostSnapshot, SnapshotBuffers

    x = pm.words_from_numpy(_inputs(4096, 512)["soup"], card)
    want = sp._bandt_noflags_plain(x).cpu()
    shards = [torch.empty_like(x), torch.empty_like(x)]
    torch.cuda.synchronize(card)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of clock cycles on the stream
    sp._step_t_noflags_into(x, shards[0])  # the boundary state, queued
    shards[1].copy_(shards[0])
    snap = HostSnapshot(shards, SnapshotBuffers())
    for s in shards:  # the next segment, writing the state's buffers
        s.bitwise_not_()
    assert all(h.device.type == "cpu" and h.is_pinned() for h in snap.state)
    assert torch.equal(snap.state[0], want) and torch.equal(snap.state[1], want)
    torch.cuda.synchronize(card)
    assert torch.equal(shards[0].cpu(), ~want)


# ---------------------------------------------------------------------------
# The batch lane's kernels (B1, B2) and the batched engine.


# (boards, height, nwords) for B1: one-word boards (32x32, the trio's
# bucket), one-row boards, several blocks a board, the serving bucket.
BATCH_PACKED = [(3, 32, 1), (2, 1, 1), (4, 17, 5), (3, 200, 33), (64, 256, 8)]
# (canvas height, width, extents) for B2: mixed extents, the byte mode,
# the serving bucket of 250^2 boards.
BATCH_MASKED = [(32, 32, [(30, 30), (18, 24), (10, 13), (1, 1)]),
                (33, 20, [(33, 20)] * 2),
                (130, 40, [(130, 40), (129, 33)]),
                (256, 256, [(250, 250)] * 64)]


def _batch_steps(batch, card):
    return torch.tensor([3 if b % 2 == 0 else 1 for b in range(batch)],
                        dtype=torch.int32, device=card)


@pytest.mark.parametrize("gen", [0, 2])
@pytest.mark.parametrize("batch,height,nwords", BATCH_PACKED)
def test_batch_packed_kernel_matches_plain(card, batch, height, nwords, gen):
    rng = np.random.default_rng(batch + height + nwords)
    words = pm.words_from_numpy(rng.integers(0, 2**32, (batch, height, nwords),
                                             dtype=np.uint64).astype(np.uint32), card)
    steps = _batch_steps(batch, card)
    out = torch.empty_like(words)
    flags = torch.zeros((batch, 2), dtype=torch.int32, device=card)
    before = sb.LAUNCHES["batch_packed_wide"]
    sb.batch_packed_step_into(words, out, flags, steps, gen)
    torch.cuda.synchronize(card)
    assert sb.LAUNCHES["batch_packed_wide"] == before + 1
    want, want_flags = sb._batch_packed_plain(words, steps, gen)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)


def _block_steps(batch, t, card):
    """Board b runs t, 1, 0 or t + 2 (clamped to t) generations, cycling."""
    return torch.tensor([(t, 1, 0, t + 2)[b % 4] for b in range(batch)],
                        dtype=torch.int32, device=card)


def _form_launches(card, batch, height, nwb, t, kind):
    """The launches a block call of t generations makes, by shape: one of
    the block form where a board's two copies fit in a CTA's shared memory,
    else ceil(t / t') of the banded form where the plan keeps whole rows,
    or of the column-cut form."""
    if height * nwb <= sb.block_max_words(card.index):
        return {f"batch_{kind}_block": 1}
    per, _, cols = sb.band_plan(card.index, batch, height, nwb, t)
    form = "band" if cols == nwb else "wide"
    return {f"batch_{kind}_{form}": -(-t // per)}


def _launched_forms(before, kind):
    return {k: n - before[k] for k, n in sb.LAUNCHES.items()
            if k.startswith(f"batch_{kind}") and n != before[k]}


# Past the block form: (2, 1024, 64) and 4e's 1024^2 pair (65,536 and
# 32,768 words a board) take the banded form in one launch a block; 725
# words a row hold 40 rows a copy, too few for whole-row bands at t = 16,
# and 9,675 words a row (309,600 cells) is past even a band of one row:
# they and a 2,048-word row take the column-cut form, one launch a block
# (whole-row bands still run t = 1 at 725 and 2,048 words).
BATCH_PACKED_PAST = [(2, 1024, 64), (2, 1024, 32), (2, 64, 725), (1, 32, 9675),
                     (2, 16, 2048)]


@pytest.mark.parametrize("t", [1, 16, 18])
@pytest.mark.parametrize("batch,height,nwords", BATCH_PACKED + BATCH_PACKED_PAST)
def test_batch_packed_block_matches_plain(card, batch, height, nwords, t):
    """B1 over a whole block, in the form its shape takes
    (``_form_launches``), equal to the plain version."""
    rng = np.random.default_rng(batch + height + nwords + t)
    words = pm.words_from_numpy(rng.integers(0, 2**32, (batch, height, nwords),
                                             dtype=np.uint64).astype(np.uint32), card)
    kept = words.clone()
    steps = _block_steps(batch, t, card)
    out = torch.empty_like(words)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32, device=card)
    before = dict(sb.LAUNCHES)
    sb.batch_packed_block_into(words, out, flags, steps, t)
    torch.cuda.synchronize(card)
    assert _launched_forms(before, "packed") == _form_launches(
        card, batch, height, nwords, t, "packed")
    want, want_flags = sb._batch_packed_block_plain(words, steps, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(words, kept)


@pytest.mark.parametrize("gen", [0, 2])
@pytest.mark.parametrize("height,width,extents", BATCH_MASKED,
                         ids=["mixed", "byte", "tall", "serving"])
def test_batch_masked_kernel_matches_plain(card, height, width, extents, gen):
    rng = np.random.default_rng(height + width)
    batch = len(extents)
    canvas = np.zeros((batch, height, width), np.uint8)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = rng.integers(0, 2, (h, w), dtype=np.uint8)
    cells = torch.from_numpy(canvas).to(card)
    heights = torch.tensor([h for h, _ in extents], dtype=torch.int32, device=card)
    widths = torch.tensor([w for _, w in extents], dtype=torch.int32, device=card)
    steps = _batch_steps(batch, card)
    out = torch.empty_like(cells)
    flags = torch.zeros((batch, 2), dtype=torch.int32, device=card)
    before = sb.LAUNCHES["batch_masked_wide"]
    sb.batch_masked_step_into(cells, out, flags, steps, heights, widths, gen)
    torch.cuda.synchronize(card)
    assert sb.LAUNCHES["batch_masked_wide"] == before + 1
    want, want_flags = sb._batch_masked_plain(cells, steps, heights, widths, gen)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)


# B2 past the block form, as BATCH_PACKED_PAST: 4e's 1000^2 pair in a
# 1024^2 canvas (banded), a short board and a narrow one in the same canvas
# (their bands' ghost rows repeat; whole bands of padding), a canvas of 725
# words a row and one of 309,600 cells a row (column-cut).
BATCH_MASKED_PAST = [(1024, 1024, [(1000, 1000), (1024, 1024)]),
                     (1024, 1024, [(5, 1024), (1024, 3), (1, 1)]),
                     (64, 23200, [(64, 23200), (61, 23171)]),
                     (32, 309600, [(30, 309590)])]


@pytest.mark.parametrize("t", [1, 16, 18])
@pytest.mark.parametrize("height,width,extents", BATCH_MASKED + BATCH_MASKED_PAST,
                         ids=["mixed", "byte", "tall", "serving", "past_opt_in",
                              "short_and_narrow", "cut_725_words", "cut_9675_words"])
def test_batch_masked_block_matches_plain(card, height, width, extents, t):
    """B2 over a whole block, in the form its shape takes
    (``_form_launches``); random, dying and still boards with 0/1 noise in
    their padding, steps t/1/0/t+2."""
    rng = np.random.default_rng(height + width + t)
    batch = len(extents)
    canvas = rng.integers(0, 2, (batch, height, width), dtype=np.uint8)
    for b, (h, w) in enumerate(extents):
        board = np.zeros((h, w), np.uint8)
        if b % 3 == 0:
            board = rng.integers(0, 2, (h, w), dtype=np.uint8)
        elif b % 3 == 1:
            board[h // 2, w // 2] = 1  # dies
        else:
            board[:2, :2] = 1  # still where it fits
        canvas[b, :h, :w] = board
    cells = torch.from_numpy(canvas).to(card)
    kept = cells.clone()
    heights = torch.tensor([h for h, _ in extents], dtype=torch.int32, device=card)
    widths = torch.tensor([w for _, w in extents], dtype=torch.int32, device=card)
    steps = _block_steps(batch, t, card)
    out = torch.empty_like(cells)
    flags = torch.zeros((t, batch, 2), dtype=torch.int32, device=card)
    before = dict(sb.LAUNCHES)
    sb.batch_masked_block_into(cells, out, flags, steps, heights, widths, t)
    torch.cuda.synchronize(card)
    assert _launched_forms(before, "masked") == _form_launches(
        card, batch, height, -(-width // 32), t, "masked")
    want, want_flags = sb._batch_masked_block_plain(cells, steps, heights, widths, t)
    assert torch.equal(out, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(cells, kept)


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
@pytest.mark.parametrize("shape", [(32, 32), (30, 27)], ids=["packed", "masked"])
def test_simulate_batch_on_the_card_matches_the_cpu(card, convention, shape):
    height, width = shape
    boards = [text_grid.generate(width, height, seed=s) for s in (1, 2, 3)]
    dies = np.zeros((height, width), np.uint8)
    for k in range(3):
        dies[2 + k, 3 + k] = 1  # dies at generation 2: the CUDA replay
    boards.append(dies)
    configs = [GameConfig(gen_limit=n, convention=convention) for n in (5, 17, 60, 40)]
    key = "batch_packed_block" if shape == (32, 32) else "batch_masked_block"
    before = sb.LAUNCHES[key]
    got = engine.simulate_batch(boards, configs, padded_shape=(32, 32),
                                pad_batch_to=8, device=card)
    assert sb.LAUNCHES[key] > before
    want = engine.simulate_batch(boards, configs, padded_shape=(32, 32),
                                 pad_batch_to=8, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.grid, w.grid)
        assert (g.generations, g.exit_reason) == (w.generations, w.exit_reason)
        assert (g.words is None) == (w.words is None)


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_server_serves_the_trio_on_the_card(card, pipeline_depth, monkeypatch,
                                            tmp_path):
    """The trio (dies, still life, a soup at its limit) through an
    in-process ``GolServer`` on the card, both conventions, as JSON and as
    a packed frame: each result equals the oracle and B1 launched."""
    import json
    import time
    import urllib.request

    from gol_tpu_torch.io import wire
    from gol_tpu_torch.serve.server import GolServer

    monkeypatch.setenv("GOL_TORCH_DEVICE", "cuda")
    dies = np.zeros((32, 32), np.uint8)
    dies[4, 4] = 1
    still = np.zeros((32, 32), np.uint8)
    still[3:5, 3:5] = 1
    trio = [(dies, "empty"), (still, "similar"),
            (text_grid.generate(32, 32, seed=7), "gen_limit")]
    before = sb.LAUNCHES["batch_packed_block"]
    srv = GolServer(port=0, journal_dir=str(tmp_path / "journal"),
                    flush_age=0.01, pipeline_depth=pipeline_depth)
    srv.start()
    try:
        jobs = []
        for convention in (Convention.C, Convention.CUDA):
            for board, reason in trio:
                body = json.dumps({
                    "width": 32, "height": 32, "gen_limit": 60,
                    "convention": convention,
                    "cells": text_grid.encode(board).decode("ascii")}).encode()
                req = urllib.request.Request(
                    f"{srv.url}/jobs", data=body, method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    jobs.append((json.loads(resp.read())["id"], board,
                                 convention, reason))
        deadline = time.perf_counter() + 60
        while any(srv.scheduler.job(j).state != "done" for j, *_ in jobs):
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        for job_id, board, convention, reason in jobs:
            want = oracle.run(board, GameConfig(convention=convention, gen_limit=60))
            with urllib.request.urlopen(f"{srv.url}/result/{job_id}") as resp:
                got = json.loads(resp.read())
            grid = text_grid.decode(got["grid"].encode("ascii"), 32, 32)
            assert np.array_equal(grid, want.grid)
            assert (got["generations"], got["exit_reason"]) == (want.generations, reason)
            req = urllib.request.Request(f"{srv.url}/result/{job_id}",
                                         headers={"Accept": wire.CONTENT_TYPE})
            with urllib.request.urlopen(req) as resp:
                frame = wire.decode_frame(resp.read())
            assert np.array_equal(frame.grid(), want.grid)
    finally:
        srv.shutdown()
    assert sb.LAUNCHES["batch_packed_block"] > before


# ---------------------------------------------------------------------------
# The resident ring and the tuner's temporal depth on the card.


def _ring_stagings(card, n, batch, side, gen_limit, seed):
    boards = [[text_grid.generate(side, side, seed=seed + batch * i + k)
               for k in range(batch)] for i in range(n)]
    config = GameConfig(gen_limit=gen_limit)
    return [engine.stage_batch(b, config, padded_shape=(256, 256),
                               pad_batch_to=batch) for b in boards]


def _same_results(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g.grid, w.grid)
        assert (g.generations, g.exit_reason) == (w.generations, w.exit_reason)


@pytest.mark.parametrize("side", [256, 250], ids=["packed", "masked"])
def test_ring_drain_equals_dispatch_batch_per_slot(card, side):
    """A drain of 3 filled slots of a 4-ring: one batched loop over 3 x 8
    boards (B1 or B2 once per 16-generation block), each slot equal to its
    own ``dispatch_batch`` on the card."""
    key = "batch_packed_block" if side == 256 else "batch_masked_block"
    stagings = _ring_stagings(card, 3, 8, side, 40, seed=11)
    runner = engine.RingRunner((256, 256), 8, 4, mode=stagings[0].mode,
                               device=card)
    before = sb.LAUNCHES[key]
    slots = engine.complete_ring(engine.dispatch_ring(
        engine.stage_ring(stagings, 4, runner=runner)))
    # 40 generations, all slots: blocks of 16, 16 and 8.
    assert sb.LAUNCHES[key] - before == 3
    runner.close()
    for slot, s in zip(slots, stagings):
        _same_results(slot, engine.complete_batch(engine.dispatch_batch(s, card)))


def test_refill_overlapping_a_running_drain_leaves_its_results(card):
    """Drain A runs (64 boards, 1000 generations) while B is refilled into
    the other storage and dispatched, and C's refill of A's storage waits
    for A: every drain equals its batch's own run."""
    stagings = _ring_stagings(card, 3, 64, 256, 1000, seed=21)
    runner = engine.RingRunner((256, 256), 64, 1, mode="packed", device=card)
    rings = [engine.stage_ring([s], 1, runner=runner) for s in stagings]
    inflight = [engine.dispatch_ring(rings[0])]
    assert not inflight[0].done.is_set()  # dispatch returned mid-drain
    inflight += [engine.dispatch_ring(r) for r in rings[1:]]
    results = [engine.complete_ring(i)[0] for i in inflight]
    runner.close()
    for got, s in zip(results, stagings):
        _same_results(got, engine.complete_batch(engine.dispatch_batch(s, card)))


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
def test_temporal_depth_2_equals_depth_8_at_512(card, convention):
    from gol_tpu_torch.tune.space import EnginePlan

    config = GameConfig(gen_limit=100, convention=convention)
    grid = text_grid.generate(512, 512, seed=5)
    outs = {}
    for depth in (2, 8):
        runner = engine._build_runner(
            (512, 512), config, "packed", card, segmented=False,
            packed_state=False, plan=EnginePlan("packed", depth, 16))
        before = dict(sp.LAUNCHES)
        final, gens = runner(engine.put_grid(grid, card))
        launched = {k: sp.LAUNCHES[k] - before[k] for k in before}
        outs[depth] = (final.cpu().numpy(), gens)
        if depth == 2:
            assert launched["band"] >= 96 and launched["bandt_fast"] == 0
        else:
            assert launched["bandt_fast"] > 0
    assert np.array_equal(outs[2][0], outs[8][0]) and outs[2][1] == outs[8][1]
    want = oracle.run(grid, config)
    assert np.array_equal(outs[2][0], want.grid)
    assert outs[2][1] == want.generations


# ---------------------------------------------------------------------------
# T1 (the sparse and macro lanes' tile step) and the lanes over it


@pytest.fixture
def tile_card(card):
    from gol_tpu_torch.ops import stencil_tile

    stencil_tile.load_kernels()
    return card


def _tile_blocks(batch, tile, seed):
    """Soup, a still block, a dead interior born from its ring, and an
    all-zero padding row last."""
    rng = np.random.default_rng(seed)
    p = tile + 2
    out = np.zeros((batch, p, p), np.uint8)
    for b in range(batch - 1):
        if b % 3 == 0:
            out[b] = rng.random((p, p)) < 0.45
        elif b % 3 == 1:
            out[b, 2:4, 2:4] = 1
        else:
            out[b, 0, 1:4] = 1
    return out


@pytest.mark.parametrize("form", ["compact", "padded"])
@pytest.mark.parametrize("batch,tile", [(3, 4), (5, 9), (4, 33), (64, 256), (8, 512)])
def test_tile_step_kernel_matches_plain(tile_card, batch, tile, form):
    from gol_tpu_torch.ops import stencil_tile as st

    blocks = torch.from_numpy(_tile_blocks(batch, tile, batch + tile))
    want, want_flags = st._tile_steps_plain(blocks, 1)
    x = blocks.to(tile_card)
    out = (torch.full((batch, tile, tile), 5, dtype=torch.uint8, device=tile_card)
           if form == "compact" else torch.full_like(x, 5))
    flags = torch.zeros((batch, 2), dtype=torch.int32, device=tile_card)
    before = st.LAUNCHES["tile_step"]
    st.tile_step_into(x, out, flags)
    torch.cuda.synchronize()
    assert st.LAUNCHES["tile_step"] == before + 1
    got = out if form == "compact" else out[:, 1:-1, 1:-1]
    assert torch.equal(got.cpu(), want)
    assert torch.equal(flags.cpu(), want_flags)
    if form == "padded":
        ring = out.cpu().clone()
        ring[:, 1:-1, 1:-1] = 5
        assert bool((ring == 5).all())


@pytest.mark.parametrize("n", [2, 7, 128])
@pytest.mark.parametrize("form", ["compact", "padded"])
@pytest.mark.parametrize("batch,tile", [(3, 4), (5, 9), (4, 33), (64, 512), (2, 1024)])
def test_tile_steps_kernel_matches_plain(tile_card, batch, tile, form, n):
    """T1 over n generations: one launch of the whole-window form where the
    window fits in a CTA's shared memory, else n launches of the banded
    form (1024^2: 33,858 words)."""
    from gol_tpu_torch.ops import stencil_tile as st

    if tile == 1024 and n == 128:
        n = 3  # the banded form, once a generation
    blocks = torch.from_numpy(_tile_blocks(batch, tile, batch + tile + n))
    x = blocks.to(tile_card)
    want, want_flags = st._tile_steps_plain(x, n)  # plain torch, on the card
    out = (torch.full((batch, tile, tile), 5, dtype=torch.uint8, device=tile_card)
           if form == "compact" else torch.full_like(x, 5))
    flags = torch.zeros((batch, 2), dtype=torch.int32, device=tile_card)
    before = dict(st.LAUNCHES)
    st.tile_step_into(x, out, flags, n)
    torch.cuda.synchronize()
    window = st.window_words(tile) <= st.window_max_words(tile_card.index)
    assert st.LAUNCHES["tile_window"] - before["tile_window"] == window
    assert st.LAUNCHES["tile_step"] - before["tile_step"] == (0 if window else n)
    got = out if form == "compact" else out[:, 1:-1, 1:-1]
    assert torch.equal(got, want)
    assert torch.equal(flags, want_flags)
    assert torch.equal(x.cpu(), blocks)
    if form == "padded":
        ring = out.cpu().clone()
        ring[:, 1:-1, 1:-1] = 5
        assert bool((ring == 5).all())


@pytest.mark.parametrize("convention", [Convention.C, Convention.CUDA])
def test_sparse_and_macro_lanes_on_the_card_match_the_cpu(tile_card, convention,
                                                          monkeypatch):
    """The sparse and macro engines on the card (T1) against the same runs
    on the CPU (T1's plain version): the same RLE, generations and exit."""
    from gol_tpu_torch.macro import simulate_macro
    from gol_tpu_torch.ops import stencil_tile as st
    from gol_tpu_torch.sparse import SparseBoard, TileMemo, simulate_sparse

    gun = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "patterns", "gosper_gun.rle")).read()
    config = GameConfig(gen_limit=300, convention=convention)
    runs = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setenv("GOL_TORCH_DEVICE", device)
        before = sum(st.LAUNCHES.values())
        board = lambda: SparseBoard.from_rle(gun, 1024, 1024, 16, x=400, y=400)  # noqa: E731
        sparse = simulate_sparse(board(), config, TileMemo())
        macro = simulate_macro(board(), config)
        runs[device] = [(r.board.to_rle(), r.generations, r.exit_reason)
                        for r in (sparse, macro)]
        launched = sum(st.LAUNCHES.values()) - before
        assert (launched > 0) == (device == "cuda")
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][0] == runs["cuda"][1]


# ---------------------------------------------------------------------------
# The fleet and the sharded lane: worker processes sharing the card.


def test_fleet_and_shard_job_on_the_card_match_the_cpu(card, monkeypatch,
                                                       tmp_path):
    """Two ``serve`` workers spawned on the card behind the router: jobs of
    both buckets (B1 and B2) and both conventions equal the oracle, and a
    sharded job over the two (T1 in each) equals the CPU's LocalCluster."""
    import json
    import time
    import urllib.request

    from gol_tpu_torch.fleet.router import RouterServer
    from gol_tpu_torch.fleet.workers import Fleet
    from gol_tpu_torch.shard.coordinator import LocalCluster, ShardCoordinator

    gun = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "patterns", "gosper_gun.rle")).read()
    spec = {"rle": gun, "x": 400, "y": 400, "width": 1024, "height": 1024,
            "tile": 256, "convention": Convention.C, "gen_limit": 60,
            "check_similarity": True, "similarity_frequency": 1}
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    want_shard = ShardCoordinator("job", spec, LocalCluster(
        ["w0", "w1"], journal_root=str(tmp_path / "local")).participants()).run()

    def http(method, url, body=None):
        req = urllib.request.Request(
            url, method=method, data=json.dumps(body).encode() if body else None,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def wait_done(base, job_id):
        deadline = time.perf_counter() + 300
        while http("GET", f"{base}/jobs/{job_id}")["state"] != "done":
            assert time.perf_counter() < deadline
            time.sleep(0.05)

    monkeypatch.setenv("GOL_TORCH_DEVICE", "cuda")
    fleet = Fleet(str(tmp_path / "fleet"), serve_args=["--flush-age", "0.01"])
    fleet.spawn_fleet(2)
    router = RouterServer(fleet, port=0)
    router.start()
    try:
        jobs = []
        for side in (32, 30):
            for convention in (Convention.C, Convention.CUDA):
                board = text_grid.generate(side, side, seed=side + len(jobs))
                job = http("POST", f"{router.url}/jobs", {
                    "width": side, "height": side, "gen_limit": 60,
                    "convention": convention,
                    "cells": text_grid.encode(board).decode("ascii")})
                jobs.append((job["id"], board, convention))
        for job_id, board, convention in jobs:
            wait_done(router.url, job_id)
            got = http("GET", f"{router.url}/result/{job_id}")
            want = oracle.run(board, GameConfig(convention=convention, gen_limit=60))
            grid = text_grid.decode(got["grid"].encode("ascii"), got["width"],
                                    got["height"])
            assert np.array_equal(grid, want.grid)
            assert got["generations"] == want.generations
        job = http("POST", f"{router.url}/jobs", {"shard": True, **spec})
        wait_done(router.url, job["id"])
        got = http("GET", f"{router.url}/result/{job['id']}")
        assert (got["rle"], got["generations"], got["exit_reason"],
                got["ownership"]) == (want_shard["rle"], want_shard["generations"],
                                      want_shard["exit_reason"],
                                      want_shard["ownership"])
    finally:
        router.shutdown(cascade=True)


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--mesh", "2x2", "--packed-io"],
                                   ["--mesh", "2x1", "--kernel", "pallas"]],
                         ids=["2x1", "2x2 packed-io", "2x1 pallas"])
def test_multihost_ranks_on_the_card_match_the_oracle(card, tmp_path, flags):
    """Two ranks of ``python -m gol_tpu_torch`` on the one card over gloo
    (NCCL takes a card per rank): every rank prints the oracle's
    Generations, the shared output file holds its bytes, and every rank
    launched its kernels on the card (its exit stats)."""
    import glob
    import json
    import socket
    import subprocess
    import sys

    grid = text_grid.generate(256, 256, seed=5)
    text_grid.write_grid(str(tmp_path / "in.txt"), grid)
    want = oracle.run(grid, GameConfig(gen_limit=300))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    slots = "2" if "2x2" in flags else "1"
    procs = []
    for rank in range(2):
        env = {**os.environ, "GOL_TORCH_DEVICE": "cuda", "GOL_MULTIHOST": "1",
               "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "GOL_TORCH_MESH_DEVICES": slots,
               "GOL_TORCH_EXIT_STATS": str(tmp_path / "stats"),
               "PYTHONPATH": os.pathsep.join(filter(None, [repo, os.environ.get(
                   "PYTHONPATH")]))}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gol_tpu_torch", "256", "256",
             str(tmp_path / "in.txt"), "--variant", "tpu", *flags, "--gen-limit",
             "300", "--output", str(tmp_path / "out.txt")],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert f"Generations:\t{want.generations}\n" in out
        assert "over gloo" in err
    assert (tmp_path / "out.txt").read_bytes() == text_grid.encode(want.grid)
    docs = [json.load(open(f)) for f in glob.glob(str(tmp_path / "stats" / "run-*.json"))]
    assert sorted(d["rank"] for d in docs) == [0, 1]
    kernel = "dist_byte_band" if "pallas" in flags else (
        "bandtg_fast" if "2x2" in flags else "bandtrow_fast")
    codec = 0 if "pallas" in flags or "--packed-io" in flags else 1
    for d in docs:
        assert d["backend"] == "gloo" and d["launches"][kernel] > 0
        # E1 and D1 once for each rank's one shard on the byte-state lane.
        assert d["launches"]["encode"] == d["launches"]["decode"] == codec


# ---------------------------------------------------------------------------
# E1 and D1 (the byte-state lanes' cell <-> word codec)

CODEC_SHAPES = [(1, 32), (7, 96), (17, 160), (1000, 224), (64, 4096)]


def _codec_bytes(height, width, seed):
    """Random bytes (not only 0/1), a third of them 0."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (height, width), dtype=np.uint8)
    cells[rng.random((height, width)) < 0.33] = 0
    return torch.from_numpy(cells)


@pytest.mark.parametrize("height,width", CODEC_SHAPES)
def test_codec_kernels_match_plain(card, height, width):
    cells = _codec_bytes(height, width, seed=height + width).to(card)
    before = dict(sp.LAUNCHES)
    words = sp.encode(cells)
    assert sp.LAUNCHES["encode"] == before["encode"] + 1
    assert torch.equal(words, pm.encode(cells))
    back = sp.decode(words)
    assert sp.LAUNCHES["decode"] == before["decode"] + 1
    assert torch.equal(back, pm.decode(words))
    assert torch.equal(back, (cells != 0).to(torch.uint8))


def test_codec_wrappers_refuse_on_the_card(card):
    flat = torch.zeros(1 + 2 * 64, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="16-byte boundary"):
        sp.encode(flat[1:].view(2, 64))
    cells = torch.zeros((4, 64), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="are on"):
        sp._encode_into(cells, torch.empty((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        sp.encode(torch.zeros((4, 128), dtype=torch.uint8, device=card)[:, 32:96])


@pytest.mark.parametrize("mesh_shape", [None, (4, 1), (2, 2)])
def test_auto_runner_launches_the_codec_once_per_shard(card, mesh_shape,
                                                       monkeypatch):
    from gol_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "4")
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    grid = text_grid.generate(256, 64, seed=9)
    config = GameConfig(gen_limit=300)
    run = engine.make_runner((64, 256), config, kernel="auto", device=card,
                             mesh=mesh)
    before = dict(sp.LAUNCHES)
    final, gens = run(engine.put_grid(grid, card, mesh))
    shards = 1 if mesh is None else 4
    assert sp.LAUNCHES["encode"] - before["encode"] == shards
    assert sp.LAUNCHES["decode"] - before["decode"] == shards
    if mesh is not None:
        from gol_tpu_torch.parallel.mesh import gather

        final = gather(final, mesh_shape)
    want = oracle.run(grid, config)
    assert int(gens) == want.generations
    np.testing.assert_array_equal(final.cpu().numpy(), want.grid)


def test_profile_capture_holds_every_kernel_from_the_first(card, tmp_path):
    # A body that launches at once, E1 then D1 fifty times on a 4x1 shard
    # of 16384^2: every capture must hold all of them, the first included.
    import json

    from gol_tpu_torch.obs import profiler

    cells = _codec_bytes(4096, 16384, seed=3).to(card)
    words, back = sp.encode(cells), torch.empty_like(cells)
    torch.cuda.synchronize()
    for i in range(10):
        pdir = tmp_path / f"capture{i}"
        with profiler.capture(str(pdir), card):
            for _ in range(50):
                sp._encode_into(cells, words)
                sp._decode_into(words, back)
        events = json.loads((pdir / "trace.json").read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        regions = [e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == profiler.CAPTURE_REGION]
        got = (sum("pack_cells_kernel" in k for k in kernels),
               sum("unpack_words_kernel" in k for k in kernels))
        assert got == (50, 50) and len(kernels) == 100, (i, got, len(kernels))
        assert len(regions) == 1


@pytest.mark.parametrize("mesh_shape,height", [(None, 8200), ((2, 2), 64), ((4, 1), 64)],
                         ids=["one_edge_chunk", "2x2", "4x1"])
def test_zarr_store_round_trips_card_state(card, tmp_path, monkeypatch, mesh_shape,
                                           height):
    """A state on the card written through the pipelined copies (two
    depths) holds the same chunk files as its CPU copy's store, and reads
    back onto the card word for word."""
    from gol_tpu_torch.io import ts_store
    from gol_tpu_torch.parallel.mesh import make_mesh, split

    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "4")
    rng = np.random.default_rng(height)
    words = rng.integers(-2**31, 2**31, (height, 8), dtype=np.int64).astype(np.int32)
    words[rng.random(words.shape) < 0.9] = 0
    host = torch.from_numpy(words)
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    cpu_state = host if mesh is None else split(host, make_mesh(*mesh_shape, devices=[
        torch.device("cpu")] * 4))
    state = host.to(card) if mesh is None else split(host, mesh)
    ts_store.write_words(str(tmp_path / "cpu"), cpu_state, 256, mesh)
    for depth in ("1", "3"):
        monkeypatch.setenv("GOL_D2H_DEPTH", depth)
        path = tmp_path / f"card{depth}"
        ts_store.write_words(str(path), state, 256, mesh)
        assert sorted(os.listdir(path)) == sorted(os.listdir(tmp_path / "cpu"))
        for name in os.listdir(path):
            assert (path / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()
        back = ts_store.read_words(str(path), 256, height, mesh, device=card)
        for got, want in zip(back if mesh else [back], state if mesh else [state]):
            assert got.device.type == "cuda" and torch.equal(got, want)
