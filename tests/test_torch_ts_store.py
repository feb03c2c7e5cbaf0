"""The port's zarr word store (gol_tpu_torch/io/ts_store.py over the blosc
codec of gol_tpu_torch/native/) against the JAX package's TensorStore
store (gol_tpu/io/ts_store.py), on the CPU.

- A counterpart of each test of ``tests/test_ts_store.py``, each held
  against JAX's store on the same words.
- Both ways: TensorStore reads every store the port writes, and the port
  reads every store TensorStore writes (random, mostly zero, edge chunks,
  no mesh and 2x2/4x1 meshes, a deleted chunk), word for word; the
  ``.zarray`` and the chunk file names equal JAX's for the same mesh.
- The codec: the C codec against its plain version and TensorStore on
  TensorStore's chunks, on frames of every form, under a hypothesis fuzz,
  and on corrupt frames, which raise ``ValueError`` and never crash.
- The size of a glider's store at 4096^2 against TensorStore's.

Words are made from numpy seeds; comparisons are exact.
"""

import json
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import tensorstore
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gol_tpu import cli as jax_cli
from gol_tpu.io import ts_store as jax_ts
from gol_tpu.io.packed_io import words_sharding
from gol_tpu.parallel import make_mesh as jax_make_mesh
from gol_tpu.resilience import faults as jax_faults
from gol_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from gol_tpu_torch import cli, oracle
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.io import bitpack, text_grid, ts_store
from gol_tpu_torch.native import blosc
from gol_tpu_torch.parallel import bootstrap, collectives
from gol_tpu_torch.parallel.mesh import gather, make_mesh, split
from gol_tpu_torch.pipeline.snapshot import HostSnapshot
from gol_tpu_torch.resilience import faults
from gol_tpu_torch.resilience.faults import FaultPlan


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _words(seed, width=64, height=32) -> np.ndarray:
    return bitpack.pack_words(text_grid.generate(width, height, seed=seed))


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jax_state(words: np.ndarray, mesh):
    if mesh is None:
        return jax.numpy.asarray(words)
    return jax.device_put(words, words_sharding(jax_make_mesh(*mesh)))


def _port_state(words: np.ndarray, mesh):
    if mesh is None:
        return _t(words), None
    m = make_mesh(*mesh)
    return split(_t(words), m), m


def _ts_read(path) -> np.ndarray:
    """The store as TensorStore itself reads it."""
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": str(path)}}
    return np.asarray(tensorstore.open(spec).result().read().result())


def _layout(path) -> tuple:
    """What the two packages' stores share byte for byte: the ``.zarray``
    and the chunk file names."""
    return (open(os.path.join(path, ".zarray"), "rb").read(),
            sorted(os.listdir(path)))


def _size(path) -> int:
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))


# ---------------------------------------------------------------------------
# Counterparts of tests/test_ts_store.py


def test_round_trip_single_device(tmp_path):
    words = _words(5)
    port, jax_path = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    ts_store.write_words(port, _t(words), 64)
    jax_ts.write_words(jax_path, jax.numpy.asarray(words), 64)
    assert np.array_equal(_u32(ts_store.read_words(port, 64, 32)), words)
    assert _layout(port) == _layout(jax_path)
    assert np.array_equal(np.asarray(jax_ts.read_words(port, 64, 32)), words)
    assert np.array_equal(_u32(ts_store.read_words(jax_path, 64, 32)), words)


def test_round_trip_mesh_shard_aligned_chunks(tmp_path):
    words = _words(6, width=128, height=32)
    state, mesh = _port_state(words, (2, 2))
    port, jax_path = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    ts_store.write_words(port, state, 128, mesh)
    jax_ts.write_words(jax_path, _jax_state(words, (2, 2)), 128)
    assert _layout(port) == _layout(jax_path)
    assert json.loads(_layout(port)[0])["chunks"] == [16, 2]
    # Read back onto a DIFFERENT mesh factorization: the store is
    # topology-independent (elastic reconfiguration for checkpoints).
    other = make_mesh(1, 4)
    back = ts_store.read_words(port, 128, 32, other)
    assert np.array_equal(_u32(gather(back, (1, 4))), words)
    assert np.array_equal(_u32(ts_store.read_words(port, 128, 32)), words)
    assert np.array_equal(
        np.asarray(jax_ts.read_words(port, 128, 32, jax_make_mesh(1, 4))), words)


def test_shape_mismatch_rejected(tmp_path):
    words = _words(7, width=32, height=16)
    messages = []
    for tag, write, read in (("jax", jax_ts.write_words, jax_ts.read_words),
                             ("port", ts_store.write_words, ts_store.read_words)):
        path = str(tmp_path / tag / "state.zarr")
        write(path, _t(words) if tag == "port" else jax.numpy.asarray(words), 32)
        with pytest.raises(ValueError, match="stored shape") as err:
            read(path, 64, 16)
        messages.append(str(err.value).replace(str(tmp_path / tag), "<dir>"))
    assert messages[0] == messages[1]


def test_cli_zarr_snapshots_resume_exactly(tmp_path, monkeypatch, capsys):
    """--snapshot-format zarr mid-run state resumed via a .zarr input file
    reproduces the uninterrupted run's count and output bytes, as JAX's;
    on the 8-shard default mesh each snapshot's chunks are JAX's, and each
    package resumes from the other's snapshot."""
    monkeypatch.chdir(tmp_path)
    g = text_grid.generate(128, 128, seed=8)
    text_grid.write_grid("in.txt", g)
    assert cli.main(["128", "128", "in.txt", "--variant", "tpu", "--packed-io",
                     "--gen-limit", "40"]) in (0, None)
    capsys.readouterr()
    whole = open("tpu_output.out", "rb").read()
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        assert main(["128", "128", "in.txt", "--variant", "tpu", "--packed-io",
                     "--gen-limit", "40", "--snapshot-every", "15",
                     "--snapshot-format", "zarr", "--snapshot-dir", tag]) in (0, None)
        capsys.readouterr()
        assert os.path.isdir(f"{tag}/gen_000015.zarr")
    assert _layout("port/gen_000015.zarr") == _layout("jax/gen_000015.zarr")
    assert json.loads(_layout("port/gen_000015.zarr")[0])["chunks"] == [16, 4]
    want = oracle.run(g, GameConfig(gen_limit=40))
    for snaps in ("jax", "port"):
        for main in (jax_cli.main, cli.main):
            os.remove("tpu_output.out")
            assert main(["128", "128", f"{snaps}/gen_000015.zarr", "--variant",
                         "tpu", "--packed-io", "--gen-limit", "40",
                         "--resume-gen", "15"]) in (0, None)
            out = capsys.readouterr().out
            gens = int([line for line in out.splitlines()
                        if line.startswith("Generations")][0].split("\t")[1])
            assert gens == want.generations
            assert open("tpu_output.out", "rb").read() == whole


def test_zarr_flags_rejected_off_packed_lane(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    text_grid.write_grid("in.txt", text_grid.generate(32, 32, seed=9))
    errs = []
    for main in (jax_cli.main, cli.main):
        assert main(["32", "32", "in.txt", "--variant", "game",
                     "--snapshot-every", "5", "--snapshot-format", "zarr"]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "--packed-io" in errs[1]


def test_overwrite_crash_preserves_prior_store(tmp_path):
    path = str(tmp_path / "state.zarr")
    w1, w2 = _words(40), _words(41)
    ts_store.write_words(path, _t(w1), 64)
    faults.install(FaultPlan(ts_write_fail=1))
    with pytest.raises(OSError, match=r"shard indices \[0\]"):
        ts_store.write_words(path, _t(w2), 64)
    faults.clear()
    # The failed overwrite went to a staging sibling; the prior store is
    # intact.
    assert np.array_equal(_u32(ts_store.read_words(path, 64, 32)), w1)
    assert np.array_equal(_ts_read(path), w1)
    # A healthy rewrite then commits and sweeps the staging path.
    ts_store.write_words(path, _t(w2), 64)
    assert np.array_equal(_u32(ts_store.read_words(path, 64, 32)), w2)
    leftovers = [n for n in os.listdir(tmp_path)
                 if n.endswith((".inprogress", ".replaced"))]
    assert leftovers == []


def test_overwrite_transient_faults_heal(tmp_path):
    """The open and a shard write both hiccup and both heal, with the
    retries the JAX store takes (its retry counter moves alike)."""
    from gol_tpu.obs import registry as jax_registry
    from gol_tpu_torch.obs import registry

    retries = []
    for tag, write, read, install, plan, reg in (
            ("jax", jax_ts.write_words, jax_ts.read_words, jax_faults.install,
             JaxFaultPlan, jax_registry),
            ("port", ts_store.write_words, ts_store.read_words, faults.install,
             FaultPlan, registry)):
        path = str(tmp_path / tag / "state.zarr")
        w1, w2 = _words(42), _words(43)
        state = (lambda w: _t(w)) if tag == "port" else jax.numpy.asarray
        write(path, state(w1), 64)
        before = reg.default().counter("retry_attempts_total")
        install(plan(ts_write_fail=1, ts_write_error="transient",
                     ts_open_transient=1))
        write(path, state(w2), 64)
        retries.append(reg.default().counter("retry_attempts_total") - before)
        back = read(path, 64, 32)
        assert np.array_equal(_u32(back) if tag == "port" else np.asarray(back), w2)
    assert retries[0] == retries[1] == 1  # the open's; the shard write retries itself


def test_mesh_write_awaits_all_shards_and_names_failures(tmp_path):
    words = _words(44, width=128, height=32)
    state, mesh = _port_state(words, (2, 2))
    messages = []
    faults.install(FaultPlan(ts_write_fail=3))
    with pytest.raises(OSError, match=r"shard indices \[2\]") as err:
        ts_store.write_words(str(tmp_path / "s.zarr"), state, 128, mesh)
    messages.append(str(err.value))
    jax_faults.install(JaxFaultPlan(ts_write_fail=3))
    with pytest.raises(OSError) as err:
        jax_ts.write_words(str(tmp_path / "j.zarr"), _jax_state(words, (2, 2)), 128)
    messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_read_words_recovers_displaced_store(tmp_path):
    """A crash between _swap_in's two renames leaves only path.replaced;
    read_words must recover it instead of failing the resume, for JAX's
    stores too."""
    for tag, write in (("port", lambda p, w: ts_store.write_words(p, _t(w), 64)),
                       ("jax", lambda p, w: jax_ts.write_words(
                           p, jax.numpy.asarray(w), 64))):
        path = str(tmp_path / f"{tag}.zarr")
        w1 = _words(45)
        write(path, w1)
        os.rename(path, path + ".replaced")
        assert np.array_equal(_u32(ts_store.read_words(path, 64, 32)), w1)
        assert os.path.isdir(path) and not os.path.exists(path + ".replaced")


def test_multihost_staged_write_failure_votes_before_commit_barrier(
    tmp_path, monkeypatch
):
    """One process's failed shard writes must vote the cluster out of the
    staged overwrite BEFORE the commit barrier, not exit write_words alone
    and leave peers parked there until the collective's timeout."""
    path = str(tmp_path / "state.zarr")
    w1, w2 = _words(46), _words(47)
    ts_store.write_words(path, _t(w1), 64)

    barriers, votes = [], []
    monkeypatch.setattr(bootstrap, "process_count", lambda: 2)
    monkeypatch.setattr(bootstrap, "process_index", lambda: 0)
    monkeypatch.setattr(collectives, "barrier", lambda name: barriers.append(name))
    monkeypatch.setattr(collectives, "process_allgather", lambda x: np.asarray([x]))
    monkeypatch.setattr(collectives, "host_all_agree",
                        lambda flag: votes.append(flag) or flag)
    faults.install(FaultPlan(ts_write_fail=1))
    with pytest.raises(OSError, match=r"shard indices \[0\]"):
        ts_store.write_words(path, _t(w2), 64)
    # create vote passed, then the failing process voted False and raised
    assert votes == [True, False]
    assert barriers and not any("commit" in b for b in barriers)
    faults.clear()
    # The live store was never touched by the abandoned overwrite.
    assert np.array_equal(_u32(ts_store.read_words(path, 64, 32)), w1)


# ---------------------------------------------------------------------------
# Both ways: TensorStore reads the port's stores, the port reads TensorStore's


def _kind(kind: str, height: int, nwords: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (height, nwords), dtype=np.uint64).astype(np.uint32)
    if kind == "sparse":
        words[rng.random((height, nwords)) < 0.98] = 0
    return words


KINDS = [("random", 64, 4, None), ("sparse", 64, 4, None), ("random", 64, 4, (2, 2)),
         ("sparse", 64, 4, (4, 1)), ("edge", 4100, 3, None), ("sparse", 8200, 2, None)]
KIND_IDS = ["random", "sparse", "random_2x2", "sparse_4x1", "edge_4100", "sparse_3_chunks"]


@pytest.mark.parametrize("kind,height,nwords,mesh", KINDS, ids=KIND_IDS)
def test_tensorstore_reads_the_ports_stores(tmp_path, kind, height, nwords, mesh):
    words = _kind(kind, height, nwords, seed=height + nwords)
    state, port_mesh = _port_state(words, mesh)
    port, jax_path = str(tmp_path / "port.zarr"), str(tmp_path / "jax.zarr")
    ts_store.write_words(port, state, nwords * 32, port_mesh)
    jax_ts.write_words(jax_path, _jax_state(words, mesh), nwords * 32)
    assert np.array_equal(_ts_read(port), words)
    assert _layout(port) == _layout(jax_path)


@pytest.mark.parametrize("kind,height,nwords,mesh", KINDS, ids=KIND_IDS)
def test_port_reads_tensorstores_stores(tmp_path, kind, height, nwords, mesh):
    words = _kind(kind, height, nwords, seed=height * nwords)
    path = str(tmp_path / "jax.zarr")
    jax_ts.write_words(path, _jax_state(words, mesh), nwords * 32)
    assert np.array_equal(_u32(ts_store.read_words(path, nwords * 32, height)), words)
    for read_mesh in ((2, 2), (4, 1)):
        if nwords % read_mesh[1] == 0:
            m = make_mesh(*read_mesh)
            back = ts_store.read_words(path, nwords * 32, height, m)
            assert np.array_equal(_u32(gather(back, read_mesh)), words)


def test_a_deleted_chunk_reads_as_zeros(tmp_path):
    words = _kind("random", 8200, 2, seed=3)
    want = words.copy()
    want[4096:8192] = 0
    for tag, write in (("port", lambda p: ts_store.write_words(p, _t(words), 64)),
                       ("jax", lambda p: jax_ts.write_words(
                           p, jax.numpy.asarray(words), 64))):
        path = tmp_path / f"{tag}.zarr"
        write(str(path))
        os.remove(path / "1.0")
        assert np.array_equal(_u32(ts_store.read_words(str(path), 64, 8200)), want)
        assert np.array_equal(_ts_read(path), want)


@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["one", "2x2"])
def test_a_host_snapshot_writes_the_same_store(tmp_path, mesh):
    words = _kind("sparse", 64, 4, seed=11)
    state, port_mesh = _port_state(words, mesh)
    ts_store.write_words(str(tmp_path / "live"), state, 128, port_mesh)
    ts_store.write_words(str(tmp_path / "snap"), HostSnapshot(state), 128, port_mesh)
    assert _layout(tmp_path / "live") == _layout(tmp_path / "snap")
    for name in os.listdir(tmp_path / "live"):
        assert (tmp_path / "live" / name).read_bytes() == \
            (tmp_path / "snap" / name).read_bytes()


def test_object_store_paths_are_refused(tmp_path):
    for call in (lambda: ts_store.write_words("gs://bucket/s.zarr", _t(_words(1)), 64),
                 lambda: ts_store.read_words("s3://bucket/s.zarr", 64, 32)):
        with pytest.raises(ValueError, match="needs a network"):
            call()


def test_a_switched_off_store_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(ts_store, "HAVE_STORE", False)
    with pytest.raises(RuntimeError, match="switched off"):
        ts_store.write_words(str(tmp_path / "s.zarr"), _t(_words(1)), 64)


def test_a_glider_store_is_at_most_twice_tensorstores(tmp_path):
    """A 4096^2 state dead but for one glider: the port's store is at most
    2x TensorStore's (JAX's stores of sparse boards are ~250x under raw)."""
    grid = np.zeros((4096, 4096), dtype=np.uint8)
    for r, c in ((1, 2), (2, 3), (3, 1), (3, 2), (3, 3)):
        grid[2000 + r, 3000 + c] = 1
    words = bitpack.pack_words(grid)
    ts_store.write_words(str(tmp_path / "port"), _t(words), 4096)
    jax_ts.write_words(str(tmp_path / "jax"), jax.numpy.asarray(words), 4096)
    port, theirs = _size(tmp_path / "port"), _size(tmp_path / "jax")
    assert port <= 2 * theirs and port < words.nbytes // 100
    assert np.array_equal(_ts_read(tmp_path / "port"), words)


# ---------------------------------------------------------------------------
# The codec against its plain version and TensorStore


def _ts_chunks(tmp_path, words, chunks, cname="lz4", shuffle=-1):
    """TensorStore's chunk files of ``words`` under blosc ``cname``."""
    path = str(tmp_path / f"{cname}{shuffle}.zarr")
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path},
            "metadata": {"shape": list(words.shape), "chunks": list(chunks),
                         "dtype": "<u4", "compressor": {
                             "id": "blosc", "cname": cname, "clevel": 5,
                             "shuffle": shuffle}}}
    store = tensorstore.open(spec, create=True, delete_existing=True).result()
    store.write(words).result()
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path)) if not n.startswith(".")}


@pytest.mark.parametrize("cname", ["lz4", "lz4hc"])
def test_codec_decodes_tensorstore_chunks(tmp_path, cname):
    """Every chunk form TensorStore writes (memcpyed random words, split
    LZ4 blocks with a short last block, edge chunks) decodes alike in the
    C codec and its plain version; lz4hc writes the LZ4 format too."""
    rng = np.random.default_rng(12)
    words = np.zeros((600, 512), dtype=np.uint32)
    words[rng.random(words.shape) < 0.05] = 7
    words[:40] = rng.integers(0, 2 ** 32, (40, 512), dtype=np.uint64)
    forms = set()
    for name, frame in _ts_chunks(tmp_path, words, (256, 512), cname).items():
        i = int(name.split(".")[0])
        want = np.zeros((256, 512), dtype=np.uint32)
        part = words[i * 256:(i + 1) * 256]
        want[:len(part)] = part
        got = np.empty_like(want)
        blosc.decode(frame, got)
        assert np.array_equal(got, want)
        assert np.array_equal(blosc.decode_plain(frame, want.nbytes).view(np.uint32),
                              want.reshape(-1))
        forms.add(frame[2])
    assert forms == {0x21}
    random = _ts_chunks(tmp_path, words[:40].copy(), (40, 512), cname)["0.0"]
    assert random[2] == 0x23  # memcpyed
    got = np.empty((40, 512), dtype=np.uint32)
    blosc.decode(random, got)
    assert np.array_equal(got, words[:40])


@pytest.mark.parametrize("cname,shuffle,needle", [
    ("zstd", -1, "codec 4 (zstd"), ("zlib", -1, "codec 3 (zlib"),
    ("lz4", 2, "flag 0x04 (bitshuffle"),
], ids=["zstd", "zlib", "bitshuffle"])
def test_unsupported_frames_raise_naming_the_flag(tmp_path, cname, shuffle, needle):
    words = np.zeros((256, 64), dtype=np.uint32)
    words[::7, ::3] = 5
    frame = _ts_chunks(tmp_path, words, words.shape, cname, shuffle)["0.0"]
    for decode in (lambda: blosc.decode(frame, np.empty_like(words)),
                   lambda: blosc.decode_plain(frame, words.nbytes)):
        with pytest.raises(ValueError, match=needle.replace("(", r"\(")):
            decode()


def test_header_faults_raise_alike():
    words = np.zeros((256, 64), dtype=np.uint32)
    frame = blosc.encode(words).tobytes()
    cases = {
        "version": (bytes([1]) + frame[1:], "version 1"),
        "torn": (frame[:-3], "torn chunk"),
        "short": (frame[:9], "shorter than"),
        "size": (frame, "decodes to"),
    }
    for name, (bad, needle) in cases.items():
        nbytes = words.nbytes * (2 if name == "size" else 1)
        for decode in (lambda: blosc.decode(bad, np.empty(nbytes, np.uint8)),
                       lambda: blosc.decode_plain(bad, nbytes)):
            with pytest.raises(ValueError, match=needle):
                decode()


def _ts_reads_frame(frame: np.ndarray, words: np.ndarray) -> bool:
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "s"))
        with open(os.path.join(d, "s", ".zarray"), "wb") as f:
            f.write(ts_store.metadata(words.shape, words.shape))
        with open(os.path.join(d, "s", "0.0"), "wb") as f:
            f.write(frame.tobytes())
        return np.array_equal(_ts_read(os.path.join(d, "s")), words)


@st.composite
def chunks(draw):
    """A chunk of uint32 words: runs of zeros, of one repeated word, of a
    short repeating pattern, and of random words."""
    rows = draw(st.integers(1, 96))
    cols = draw(st.sampled_from([1, 3, 8, 64, 300]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    flat = np.zeros(rows * cols, dtype=np.uint32)
    pos = 0
    while pos < flat.size:
        n = int(rng.integers(1, max(2, flat.size // 3)))
        kind = draw(st.sampled_from(["zero", "same", "pattern", "random"]))
        run = slice(pos, min(flat.size, pos + n))
        size = run.stop - run.start
        if kind == "same":
            flat[run] = rng.integers(0, 2 ** 32, dtype=np.uint64)
        elif kind == "pattern":
            flat[run] = np.resize(rng.integers(0, 2 ** 32, int(rng.integers(1, 9)),
                                               dtype=np.uint64), size)
        elif kind == "random":
            flat[run] = rng.integers(0, 2 ** 32, size, dtype=np.uint64)
        pos = run.stop
    return flat.reshape(rows, cols)


FUZZ = settings(max_examples=40, deadline=None, derandomize=True,
                suppress_health_check=[HealthCheck.too_slow])


@FUZZ
@given(chunks())
def test_codec_fuzz_round_trip(words):
    """C encode -> C decode, plain decode and TensorStore all give the words
    back; frames never grow past a memcpyed frame."""
    frame = blosc.encode(words)
    assert frame.size <= words.nbytes + blosc.HEADER
    got = np.empty_like(words)
    blosc.decode(frame, got)
    assert np.array_equal(got, words)
    assert np.array_equal(blosc.decode_plain(frame, words.nbytes),
                          words.reshape(-1).view(np.uint8))
    assert _ts_reads_frame(frame, words)


@FUZZ
@given(chunks(), st.booleans(), st.booleans(), st.sampled_from(["lz4", "raw"]))
def test_codec_fuzz_plain_frames(words, memcpy, split, stream):
    """Every frame form the plain encoder builds (memcpyed; split or not;
    LZ4 literal runs or stored streams) decodes in the C codec and in
    TensorStore."""
    frame = blosc.encode_plain(words, memcpy=memcpy, split=split, stream=stream)
    got = np.empty_like(words)
    blosc.decode(frame, got)
    assert np.array_equal(got, words)
    assert _ts_reads_frame(frame, words)


def _outcome(decode):
    try:
        return decode()
    except ValueError as err:
        return ("ValueError", str(err).split(":")[0])


@FUZZ
@given(chunks(), st.data())
def test_corrupt_frames_raise_and_never_crash(words, data):
    """A torn, truncated or bit-flipped frame: the C codec and its plain
    version both raise ``ValueError`` (never a crash or an out-of-bounds
    access), or both decode the same bytes (a flip inside a literal)."""
    frame = bytearray(blosc.encode(words).tobytes())
    how = data.draw(st.sampled_from(["flip", "truncate", "field", "offset"]))
    if how == "flip":
        at = data.draw(st.integers(0, len(frame) - 1))
        frame[at] ^= 1 << data.draw(st.integers(0, 7))
    elif how == "truncate":
        frame = frame[:data.draw(st.integers(0, len(frame) - 1))]
    elif how == "field":
        at = data.draw(st.sampled_from([4, 8, 12]))
        frame[at:at + 4] = data.draw(st.integers(0, 2 ** 32 - 1)).to_bytes(4, "little")
    elif len(frame) >= 20:
        at = data.draw(st.integers(16, len(frame) - 4))
        frame[at:at + 4] = data.draw(st.integers(0, 2 ** 32 - 1)).to_bytes(4, "little")
    frame = bytes(frame)

    def c_decode():
        out = np.empty(words.nbytes, dtype=np.uint8)
        blosc.decode(frame, out)
        return out.tobytes()

    got = _outcome(c_decode)
    plain = _outcome(lambda: blosc.decode_plain(frame, words.nbytes).tobytes())
    assert got == plain
