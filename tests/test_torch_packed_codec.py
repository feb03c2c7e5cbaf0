"""The cell <-> word codec of the byte-state lanes: E1 (``stencil_packed
.encode``) and D1 (``stencil_packed.decode``) on the CPU, against the JAX
package's ``packed_math.encode``/``decode``, and the ``--kernel auto``
runner that crosses them against JAX's.

- the wrappers' CPU route (their plain versions) against JAX's jnp encode
  and decode on numpy-seeded 0/1 grids, and on the shards ``put_grid``
  makes for 2x2 and 4x1 meshes (tolerance 0);
- ``engine.make_runner(kernel="auto")`` against JAX's ``make_runner``:
  bytes and generations, both conventions, on one device and a 2x2 mesh;
- the wrappers' refusals (dtype, ``W % 32``, non-contiguous views, shape
  and device of the words), and no launch counted on the CPU;
- the kernels' CUDA source (``csrc/packed_codec.cu``) compiled with the
  host compiler against ``tests/cuda_emulation/cuda_runtime.h`` and driven
  through its C entries on random bytes (not only 0/1): E1 against the
  plain ``packed_math.encode`` (bit = cell != 0), D1 against
  ``packed_math.decode``, ``D1(E1(x)) == (x != 0)``, and no misaligned
  16-byte load. The card runs the same source in ``tests/test_torch_cuda.py``
  and ``chip_smoke.py``.
"""

import ctypes
import platform
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu import engine as jax_engine
from gol_tpu.ops import packed_math as jax_pm
from gol_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.parallel.mesh import make_mesh
from test_torch_bandt_emulated import emulated_source

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "gol_tpu_torch" / "csrc" / "packed_codec.cu"
EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
SHAPES = [(1, 32), (7, 96), (17, 160), (64, 1024)]
CONVENTIONS = (Convention.C, Convention.CUDA)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")


def _cells(height, width, seed):
    return np.random.default_rng(seed).integers(0, 2, (height, width), dtype=np.uint8)


def _jax_words(cells: np.ndarray) -> np.ndarray:
    return np.asarray(jax_pm.encode(jnp.asarray(cells)))


@pytest.mark.parametrize("height,width", SHAPES)
def test_encode_decode_match_jax(height, width):
    cells = _cells(height, width, seed=height * 7 + width)
    before = dict(sp.LAUNCHES)
    words = sp.encode(torch.from_numpy(cells))
    assert words.dtype == torch.int32 and tuple(words.shape) == (height, width // 32)
    want = _jax_words(cells)
    np.testing.assert_array_equal(pm.words_to_numpy(words), want)
    back = sp.decode(words)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_pm.decode(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), cells)
    assert sp.LAUNCHES == before  # the CPU route launches nothing


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_encode_decode_shards_match_jax(mesh_shape):
    rows, cols = mesh_shape
    cells = _cells(24, 256, seed=rows * 10 + cols)
    shards = engine.put_grid(cells, mesh=make_mesh(rows, cols))
    h, w = 24 // rows, 256 // cols
    for i, shard in enumerate(shards):
        r, c = divmod(i, cols)
        window = cells[r * h:(r + 1) * h, c * w:(c + 1) * w]
        words = sp.encode(shard)
        np.testing.assert_array_equal(pm.words_to_numpy(words), _jax_words(window))
        np.testing.assert_array_equal(sp.decode(words).numpy(), window)


def _runner_cases(height, width):
    still = np.zeros((height, width), np.uint8)
    still[3:5, 30:32] = 1  # a block across a word edge
    dying = np.zeros((height, width), np.uint8)
    dying[height - 1, width - 1] = 1
    return {"random": text_grid.generate(width, height, seed=height + width),
            "still": still, "dying": dying}


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("mesh_shape", [None, (2, 2)], ids=["one_device", "2x2"])
def test_auto_runner_matches_jax(convention, mesh_shape):
    height, width = 32, 128
    config = GameConfig(convention=convention, gen_limit=200)
    mesh = jmesh = None
    if mesh_shape is not None:
        mesh, jmesh = make_mesh(*mesh_shape), jax_make_mesh(*mesh_shape)
    run = engine.make_runner((height, width), config, kernel="auto", device="cpu",
                             mesh=mesh)
    jrun = jax_engine.make_runner((height, width), config, jmesh, kernel="auto")
    for name, grid in _runner_cases(height, width).items():
        before = dict(sp.LAUNCHES)
        final, gens = run(engine.put_grid(grid, "cpu", mesh))
        assert sp.LAUNCHES == before
        if mesh is not None:
            assert len(final) == 4 and all(s.dtype == torch.uint8 for s in final)
            final = torch.cat([torch.cat(final[0:2], dim=1),
                               torch.cat(final[2:4], dim=1)])
        jfinal, jgens = jrun(jax_engine.put_grid(grid, jmesh))
        want = oracle.run(grid, config)
        assert int(gens) == int(jgens) == want.generations, name
        np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal), err_msg=name)
        np.testing.assert_array_equal(final.numpy(), want.grid, err_msg=name)


def test_codec_refusals():
    cells = torch.from_numpy(_cells(8, 128, seed=1))
    words = sp.encode(cells)
    for bad, match in (
        (cells.to(torch.int32), "2D uint8"),
        (cells.bool(), "2D uint8"),
        (cells[0], "2D uint8"),
        (cells[:, :40], "multiple of 32"),
        (torch.zeros((4, 48), dtype=torch.uint8), "multiple of 32"),
        (cells[:, 32:96], "contiguous"),
        (cells[::2], "contiguous"),
    ):
        with pytest.raises(ValueError, match=match):
            sp.encode(bad)
    for bad, match in ((words.to(torch.int64), "2D int32"),
                       (words[:, 1:3], "contiguous"),
                       (words.t(), "contiguous")):
        with pytest.raises(ValueError, match=match):
            sp.decode(bad)
    with pytest.raises(ValueError, match=r"words must be \(8, 4\)"):
        sp._encode_into(cells, torch.empty((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="no packed kernel for device meta"):
        sp.encode(torch.empty((2, 32), dtype=torch.uint8, device="meta"))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or platform.machine() != "x86_64":
        pytest.skip("needs a host C++ compiler on x86-64 (the lanes' stack switch)")
    work = tmp_path_factory.mktemp("codec_emulated")
    src = work / "packed_codec_emulated.cpp"
    src.write_text(emulated_source(SOURCE.read_text()))
    so = work / "libcodec_emulated.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for entry in (lib.gol_pack_cells, lib.gol_unpack_words):
        entry.argtypes = [p, p, ll, i, p]
    lib.emu_misaligned.argtypes, lib.emu_misaligned.restype = [], i
    return lib


def _bytes(height, width, seed):
    """Random bytes, a third of them 0, and each single set bit somewhere."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (height, width), dtype=np.uint8)
    cells[rng.random((height, width)) < 0.33] = 0
    flat = cells.reshape(-1)
    flat[:8] = 1 << np.arange(8, dtype=np.uint8)
    return torch.from_numpy(cells)


@pytest.mark.parametrize("height,width", SHAPES + [(3, 32 * 300)])
def test_emulated_kernels_match_plain(lib, height, width):
    cells = _bytes(height, width, seed=height + width)
    n = height * width // 32
    words = torch.full((height, width // 32), 7, dtype=torch.int32)
    assert lib.gol_pack_cells(cells.data_ptr(), words.data_ptr(), n, 0, None) == 0
    assert torch.equal(words, pm.encode(cells))
    out = torch.full((height, width), 9, dtype=torch.uint8)
    assert lib.gol_unpack_words(words.data_ptr(), out.data_ptr(), n, 0, None) == 0
    assert torch.equal(out, pm.decode(words))
    assert torch.equal(out, (cells != 0).to(torch.uint8))
    assert lib.emu_misaligned() == 0
