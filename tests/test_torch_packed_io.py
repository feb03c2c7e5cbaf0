"""The port's host codec and packed/sharded file I/O (on the CPU) against the
JAX package's: words, bytes and file names must be identical.

- ``gol_tpu_torch.native`` (its own build of codec.c) against
  ``gol_tpu.native`` and against its own plain numpy versions, including
  the strict-'1' rule and a strided window over the newline column;
- ``io/packed_io.read_packed`` words against JAX's (as numpy uint32), and
  ``write_packed`` bytes against JAX's, with the ``.inprogress`` staging
  file gone after the write; over a mesh, each shard's words against the
  shards of JAX's sharded array, and the file written from the shards;
- the pipelined read (forced on the CPU, chunks of a few rows) against
  JAX's ``read_packed``, and the fetch-ahead write at ``GOL_D2H_DEPTH`` 1,
  2, 4 and a malformed value, on one device and a 2x2 mesh, against JAX's
  ``write_packed``;
- ``io/sharded`` (the distributed variants' one-device I/O) against JAX's
  with no mesh: the exact-size refusal and the read by position.
"""

import os

import numpy as np
import pytest
import torch

from gol_tpu import native as jax_native
from gol_tpu.io import packed_io as jax_packed_io
from gol_tpu.io import sharded as jax_sharded
from gol_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gol_tpu_torch import native
from gol_tpu_torch.io import packed_io, sharded, text_grid
from gol_tpu_torch.ops import packed_math as pm
from gol_tpu_torch.parallel.mesh import make_mesh


def _text(rows: int, width: int, seed: int, odd: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 2, (rows, width), dtype=np.uint8) + ord("0")
    if odd:  # bytes that are neither '0' nor '1' read as dead cells
        text[rng.random((rows, width)) < 0.2] = ord("3")
        text[0, :4] = (ord("1") | 0x80, 0x31 - 0x10, 0xFF, ord("\n"))
    return text


@pytest.mark.parametrize("odd", [False, True], ids=["digits", "odd_bytes"])
@pytest.mark.parametrize("rows,width", [(1, 32), (5, 96), (16, 256)])
def test_pack_text_matches_jax_and_plain(rows, width, odd):
    text = _text(rows, width, seed=rows + width, odd=odd)
    words = native.pack_text(text, width)
    np.testing.assert_array_equal(words, jax_native.pack_text(text, width))
    np.testing.assert_array_equal(words, native.pack_text_plain(text, width))


def test_pack_text_strict_one():
    text = np.full((1, 32), ord("0"), np.uint8)
    text[0, 0] = ord("1")
    text[0, 1] = ord("3")
    assert native.pack_text(text, 32)[0, 0] == 1
    assert native.pack_text_plain(text, 32)[0, 0] == 1


def test_pack_text_strided_window():
    # The memmap layout: rows of width cells plus the newline column, and a
    # window that starts one word in.
    text = np.full((8, 129), ord("\n"), np.uint8)
    text[:, :128] = _text(8, 128, seed=2)
    window = text[:, 32:128]
    assert window.strides == (129, 1)
    words = native.pack_text(window, 96)
    np.testing.assert_array_equal(words, jax_native.pack_text(window, 96))
    np.testing.assert_array_equal(words, native.pack_text_plain(window, 96))


@pytest.mark.parametrize("newline", [True, False])
def test_unpack_text_matches_jax_and_plain(newline):
    words = np.random.default_rng(3).integers(
        0, 2**32, (6, 3), dtype=np.uint64).astype(np.uint32)
    outs = [np.full((6, 100), ord("x"), np.uint8) for _ in range(3)]
    native.unpack_text(words, outs[0], 96, newline)
    jax_native.unpack_text(words, outs[1], 96, newline)
    native.unpack_text_plain(words, outs[2], 96, newline)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_codec_refuses_what_c_would_overrun():
    with pytest.raises(ValueError, match="multiple of 32"):
        native.pack_text(np.zeros((1, 40), np.uint8), 40)
    with pytest.raises(ValueError, match="needs >= width"):
        native.pack_text(np.zeros((1, 32), np.uint8), 64)
    with pytest.raises(ValueError, match="byte-contiguous"):
        native.pack_text(np.zeros((2, 64), np.uint8)[:, ::2], 32)
    with pytest.raises(ValueError, match="too small"):
        native.unpack_text(np.zeros((2, 1), np.uint32),
                           np.zeros((2, 32), np.uint8), 32, True)


def _grid_file(tmp_path, height, width, seed, name="grid.txt"):
    g = text_grid.generate(width, height, seed=seed)
    path = tmp_path / name
    text_grid.write_grid(str(path), g)
    return g, str(path)


@pytest.mark.parametrize("height,width", [(1, 32), (37, 128), (64, 64)])
def test_read_packed_matches_jax(tmp_path, height, width):
    g, path = _grid_file(tmp_path, height, width, seed=height)
    words = packed_io.read_packed(path, width, height, "cpu")
    assert words.dtype == torch.int32 and words.shape == (height, width // 32)
    want = np.asarray(jax_packed_io.read_packed(path, width, height))
    np.testing.assert_array_equal(pm.words_to_numpy(words), want)
    np.testing.assert_array_equal(pm.decode(words).numpy(), g)


@pytest.mark.parametrize("height,width", [(1, 32), (37, 128), (64, 64)])
def test_write_packed_matches_jax(tmp_path, height, width):
    g, path = _grid_file(tmp_path, height, width, seed=height + 1)
    words = packed_io.read_packed(path, width, height, "cpu")
    port_out, jax_out = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    packed_io.write_packed(port_out, words, width)
    jax_packed_io.write_packed(jax_out, jax_packed_io.read_packed(path, width, height),
                               width)
    data = open(port_out, "rb").read()
    assert data == open(jax_out, "rb").read() == open(path, "rb").read()
    assert sorted(os.listdir(tmp_path)) == ["grid.txt", "jax.out", "port.out"]
    assert not os.path.exists(port_out + packed_io.STAGING_SUFFIX)


def test_packed_io_chunked_paths(tmp_path, monkeypatch):
    # Chunks of a few rows, so both pools see several chunks on a small grid.
    monkeypatch.setattr(packed_io, "_READ_CHUNK_BYTES", 5 * 129)
    monkeypatch.setattr(packed_io, "_WRITE_CHUNK_BYTES", 3 * 16)
    monkeypatch.setattr(packed_io, "_WORKERS", 2)
    g, path = _grid_file(tmp_path, 37, 128, seed=9)
    words = packed_io.read_packed(path, 128, 37, "cpu")
    np.testing.assert_array_equal(pm.decode(words).numpy(), g)
    out = str(tmp_path / "out.txt")
    open(out, "wb").write(b"an older, longer file" * 1000)
    packed_io.write_packed(out, words, 128)
    assert open(out, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("height,width", [(37, 128), (64, 64), (2, 32), (1, 64)])
def test_pipelined_read_matches_jax(tmp_path, monkeypatch, height, width):
    # Chunks of three rows, each packed into its rows of the one tensor.
    monkeypatch.setattr(packed_io, "_READ_CHUNK_BYTES", 3 * (width + 1))
    monkeypatch.setattr(packed_io, "_WORKERS", 3)
    packed = []
    pack_text = native.pack_text

    def spy(text, width, out=None):
        assert out is not None  # straight into the tensor, no host array
        packed.append(text.shape[0])
        return pack_text(text, width, out=out)

    monkeypatch.setattr(native, "pack_text", spy)
    g, path = _grid_file(tmp_path, height, width, seed=height * 3 + width)
    words = packed_io.read_packed(path, width, height, "cpu")
    chunk = min(3, -(-height // 3))
    assert sorted(packed) == sorted(min(chunk, height - r0)
                                    for r0 in range(0, height, chunk))
    assert words.dtype == torch.int32 and words.shape == (height, width // 32)
    want = np.asarray(jax_packed_io.read_packed(path, width, height))
    np.testing.assert_array_equal(pm.words_to_numpy(words), want)
    np.testing.assert_array_equal(pm.decode(words).numpy(), g)


@pytest.mark.parametrize("value,depth", [(None, 2), ("1", 1), ("2", 2), ("4", 4),
                                         ("x", 2), ("0", 1), ("-3", 1)])
def test_d2h_depth(monkeypatch, value, depth):
    if value is None:
        monkeypatch.delenv("GOL_D2H_DEPTH", raising=False)
    else:
        monkeypatch.setenv("GOL_D2H_DEPTH", value)
    assert packed_io.d2h_depth() == depth


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)], ids=["one_device", "2x2"])
@pytest.mark.parametrize("depth", ["1", "2", "4", "x"])
def test_fetch_ahead_write_matches_jax(tmp_path, monkeypatch, depth, mesh_shape):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    monkeypatch.setenv("GOL_D2H_DEPTH", depth)
    monkeypatch.setattr(packed_io, "_WRITE_CHUNK_BYTES", 2 * 32)  # 2-4 rows a chunk
    monkeypatch.setattr(packed_io, "_WORKERS", 3)
    height, width = 26, 256
    g, path = _grid_file(tmp_path, height, width, seed=len(depth) + 40)
    mesh = jmesh = None
    if mesh_shape is not None:
        mesh, jmesh = make_mesh(*mesh_shape), jax_make_mesh(*mesh_shape)
    words = packed_io.read_packed(path, width, height, "cpu", mesh=mesh)
    port_out, jax_out = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    open(port_out, "wb").write(b"an older, longer file" * 1000)
    packed_io.write_packed(port_out, words, width, mesh)
    jax_packed_io.write_packed(
        jax_out, jax_packed_io.read_packed(path, width, height, jmesh), width)
    data = open(port_out, "rb").read()
    assert data == open(jax_out, "rb").read() == open(path, "rb").read()
    assert sorted(os.listdir(tmp_path)) == ["grid.txt", "jax.out", "port.out"]


@pytest.mark.parametrize("rows,cols", [(2, 2), (1, 4), (4, 2)])
def test_packed_io_over_a_mesh_matches_jax(tmp_path, monkeypatch, rows, cols):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    monkeypatch.setattr(packed_io, "_WRITE_CHUNK_BYTES", 3 * 8)  # several chunks
    height, width = 24, 256
    g, path = _grid_file(tmp_path, height, width, seed=rows + cols)
    mesh, jmesh = make_mesh(rows, cols), jax_make_mesh(rows, cols)
    shards = packed_io.read_packed(path, width, height, mesh=mesh)
    jwords = jax_packed_io.read_packed(path, width, height, jmesh)
    whole = np.asarray(jwords)
    h, n = height // rows, width // 32 // cols
    assert len(shards) == rows * cols
    for i, shard in enumerate(shards):
        r, c = divmod(i, cols)
        assert shard.dtype == torch.int32 and tuple(shard.shape) == (h, n)
        np.testing.assert_array_equal(
            pm.words_to_numpy(shard), whole[r * h:(r + 1) * h, c * n:(c + 1) * n])
    port_out, jax_out = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    open(port_out, "wb").write(b"an older, longer file" * 1000)
    packed_io.write_packed(port_out, shards, width, mesh)
    jax_packed_io.write_packed(jax_out, jwords, width)
    data = open(port_out, "rb").read()
    assert data == open(jax_out, "rb").read() == open(path, "rb").read()
    assert not os.path.exists(port_out + packed_io.STAGING_SUFFIX)
    with pytest.raises(ValueError, match="shards"):
        packed_io.write_packed(port_out, shards[:-1], width, mesh)


def test_packed_io_refusals_match_jax(tmp_path):
    _, path = _grid_file(tmp_path, 16, 64, seed=4)
    for width, height in ((48, 16), (64, 17)):
        errors = []
        for read in (lambda: packed_io.read_packed(path, width, height, "cpu"),
                     lambda: jax_packed_io.read_packed(path, width, height)):
            with pytest.raises(ValueError) as info:
                read()
            errors.append(str(info.value))
        assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="words x 32"):
        packed_io.write_packed(str(tmp_path / "x"), torch.zeros((2, 2), dtype=torch.int32), 96)


def test_packed_io_mesh_width_refusal_matches_jax(tmp_path, monkeypatch):
    # 96 cells divide over 2 mesh columns, but not into whole words.
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    _, path = _grid_file(tmp_path, 16, 96, seed=4)
    errors = []
    for read in (lambda: packed_io.read_packed(path, 96, 16, mesh=make_mesh(2, 2)),
                 lambda: jax_packed_io.read_packed(path, 96, 16, jax_make_mesh(2, 2))):
        with pytest.raises(ValueError) as info:
            read()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert errors[0] == "packed I/O needs width (96) divisible by 32 x mesh cols (2)"


def _misplaced_newline(tmp_path, height, width):
    """A right-sized file whose first row is one cell short and whose second
    row is one cell long: the serial scan and the read by position differ."""
    g = text_grid.generate(width, height, seed=7)
    data = bytearray(text_grid.encode(g))
    del data[width - 1]
    data.insert(2 * (width + 1) - 1, ord("1"))
    path = tmp_path / "shifted.txt"
    path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("parallel", [False, True])
def test_read_sharded_matches_jax(tmp_path, parallel):
    for height, width in ((8, 16), (30, 30)):
        _, path = _grid_file(tmp_path, height, width, seed=width)
        for p in (path, _misplaced_newline(tmp_path, height, width)):
            got = sharded.read_sharded(p, width, height, "cpu", parallel=parallel)
            want = np.asarray(jax_sharded.read_sharded(p, width, height, None))
            np.testing.assert_array_equal(got.numpy(), want)
    # The serial scan reads the shifted file differently.
    shifted = _misplaced_newline(tmp_path, 8, 16)
    assert not np.array_equal(sharded.read_gathered(shifted, 16, 8, "cpu").numpy(),
                              sharded.read_sharded(shifted, 16, 8, "cpu").numpy())


def test_read_sharded_size_refusal_matches_jax(tmp_path):
    _, path = _grid_file(tmp_path, 48, 48, seed=1)
    errors = []
    for read in (lambda: sharded.read_sharded(path, 30, 30, "cpu"),
                 lambda: jax_sharded.read_sharded(path, 30, 30, None)):
        with pytest.raises(ValueError) as info:
            read()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "sharded I/O requires the exact height x (width+1) layout" in errors[0]


@pytest.mark.parametrize("parallel", [False, True])
def test_write_sharded_and_gathered_match_jax(tmp_path, parallel):
    import jax.numpy as jnp

    g = text_grid.generate(30, 17, seed=11)
    outs = {}
    for name, write in (
        ("port_sharded", lambda p: sharded.write_sharded(p, torch.from_numpy(g),
                                                          parallel=parallel)),
        ("jax_sharded", lambda p: jax_sharded.write_sharded(p, jnp.asarray(g),
                                                             parallel=parallel)),
        ("port_gathered", lambda p: sharded.write_gathered(p, torch.from_numpy(g))),
        ("jax_gathered", lambda p: jax_sharded.write_gathered(p, jnp.asarray(g))),
    ):
        path = str(tmp_path / name)
        open(path, "wb").write(b"x" * 5000)  # an older, longer file is replaced
        write(path)
        outs[name] = open(path, "rb").read()
    assert len(set(outs.values())) == 1
    assert outs["port_sharded"] == text_grid.encode(g)
