"""The port's packed wire format (gol_tpu_torch/io/wire.py) against the JAX
package's (gol_tpu/io/wire.py).

For the same input both packages must encode the same frame bytes, and a
frame from either must decode in the other: that is what lets a client of
one package talk to a server of the other, and a CAS sidecar written by
one be read by the other. Inputs come from a numpy seed; comparisons are
exact. Each refusal must raise JAX's exception type and message.
"""

import struct
import zlib

import numpy as np
import pytest

from gol_tpu.io import wire as jax_wire
from gol_tpu_torch.io import wire

SHAPES = [(1, 1), (3, 31), (8, 32), (5, 33), (30, 30), (17, 64), (9, 100)]
METAS = [{}, {"gen_limit": 12, "convention": "cuda"},
         {"id": "abc", "generations": 7, "exit_reason": "similar",
          "cached": "memory", "note": "ünïcode"}]
PACKAGES = {"jax": jax_wire, "port": wire}


def _board(shape, seed=0):
    rng = np.random.default_rng(seed + 101 * shape[0] + shape[1])
    return rng.integers(0, 2, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("meta", METAS, ids=["empty", "submit", "result"])
def test_frames_equal_jax_bytes_and_decode_in_both(shape, meta):
    board = _board(shape)
    frame = wire.encode_frame(meta, grid=board)
    assert frame == jax_wire.encode_frame(meta, grid=board)
    for reader in PACKAGES.values():
        got = reader.decode_frame(frame)
        assert (got.width, got.height, got.meta) == (shape[1], shape[0], meta)
        np.testing.assert_array_equal(got.grid(), board)
        np.testing.assert_array_equal(got.words, wire.pack_grid(board))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_words_lane_equals_grid_lane_and_jax(shape):
    board = _board(shape, seed=3)
    words = jax_wire.pack_grid(board)
    np.testing.assert_array_equal(wire.pack_grid(board), words)
    np.testing.assert_array_equal(wire.unpack_grid(words, shape[1]), board)
    meta = {"id": "x"}
    frame = wire.encode_frame(meta, words=words, width=shape[1], height=shape[0])
    assert frame == wire.encode_frame(meta, grid=board)
    assert frame == jax_wire.encode_frame(meta, words=words, width=shape[1],
                                          height=shape[0])


@pytest.mark.parametrize("shape", [(0, 5), (4, 0), (0, 0)])
def test_zero_area_frames_match(shape):
    board = np.zeros(shape, np.uint8)
    assert wire.encode_frame({}, grid=board) == jax_wire.encode_frame({}, grid=board)
    np.testing.assert_array_equal(wire.pack_grid(board), jax_wire.pack_grid(board))


def test_peek_and_payload_crc_match_jax():
    frame = jax_wire.encode_frame({"gen_limit": 3}, grid=_board((6, 40)))
    assert wire.peek(frame) == jax_wire.peek(frame)
    assert wire.payload_crc(frame) == jax_wire.payload_crc(frame)


def test_constants_and_header_helpers_match_jax():
    for name in ("CONTENT_TYPE", "CONTENT_TYPE_FAMILY", "MAGIC", "VERSION",
                 "HEADER_SIZE", "MAX_BODY_TEXT", "MAX_BODY_PACKED",
                 "META_KIND", "SHARD_HALO_KIND", "SHARD_TILES_KIND"):
        assert getattr(wire, name) == getattr(jax_wire, name), name
    for value in (None, "", "application/json", "Application/X-Gol-Packed; v=1",
                  "application/x-gol-packed", "text/plain"):
        for fn in ("content_type_of", "is_packed", "max_body_bytes"):
            assert getattr(wire, fn)(value) == getattr(jax_wire, fn)(value)
        assert wire.accepts_packed(value) == jax_wire.accepts_packed(value)
    for payload in ({"error": "payload CRC mismatch: x"}, {"error": "other"},
                    "crc", None):
        assert wire.is_crc_error(payload) == jax_wire.is_crc_error(payload)
    for width in (0, 1, 31, 32, 33, 64, 65):
        assert wire.words_per_row(width) == jax_wire.words_per_row(width)


def _corruptions():
    good = jax_wire.encode_frame({"k": 1}, grid=_board((5, 40)))
    newer = bytearray(good)
    newer[4:6] = (jax_wire.VERSION + 1).to_bytes(2, "little")
    flagged = bytearray(good)
    flagged[6:8] = (1).to_bytes(2, "little")
    poisoned = bytearray(good)
    poisoned[-1] ^= 0x01
    payload = jax_wire.pack_grid(_board((2, 8))).tobytes()

    def framed(meta: bytes) -> bytes:
        return struct.pack("<4sHHIIII", b"GOLP", 1, 0, 8, 2, len(meta),
                           zlib.crc32(payload)) + meta + payload

    return {
        "short_header": good[:10],
        "short_meta": good[:jax_wire.HEADER_SIZE + 2],
        "truncated_payload": good[:-3],
        "trailing_garbage": good + b"\0",
        "bad_magic": b"NOPE" + good[4:],
        "newer_version": bytes(newer),
        "unknown_flags": bytes(flagged),
        "crc_poisoned": bytes(poisoned),
        "meta_not_object": framed(b"[1]"),
        "meta_not_json": framed(b"{x}"),
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_refusals_raise_jax_type_and_message(case):
    data = _corruptions()[case]
    with pytest.raises(jax_wire.WireError) as want:
        jax_wire.decode_frame(data)
    with pytest.raises(wire.WireError) as got:
        wire.decode_frame(data)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    if isinstance(want.value, jax_wire.UnsupportedWire):
        assert isinstance(got.value, wire.UnsupportedWire)


@pytest.mark.parametrize("kwargs", [
    {},
    {"grid": np.zeros((2, 3), np.uint8), "words": np.zeros((2, 1), np.uint32)},
    {"words": np.zeros((2, 1), np.uint32)},
    {"words": np.zeros((2, 2), np.uint32), "width": 3, "height": 2},
    {"grid": np.zeros((2, 3, 1), np.uint8)},
], ids=["none", "both", "words_no_geometry", "words_shape", "grid_3d"])
def test_encode_refusals_match_jax(kwargs):
    with pytest.raises(jax_wire.WireError) as want:
        jax_wire.encode_frame({}, **kwargs)
    with pytest.raises(wire.WireError) as got:
        wire.encode_frame({}, **kwargs)
    assert str(got.value) == str(want.value)


def test_meta_must_be_a_dict_as_in_jax():
    with pytest.raises(jax_wire.WireError) as want:
        jax_wire.encode_frame([1], grid=np.zeros((1, 1), np.uint8))
    with pytest.raises(wire.WireError) as got:
        wire.encode_frame([1], grid=np.zeros((1, 1), np.uint8))
    assert str(got.value) == str(want.value)
