"""Blosc-1/LZ4 chunk frames: the codec of the port's zarr word store.

``zarr_codec.c`` builds with ``cc`` at first use into the build directory
(``ops/_build.py``) and binds with ctypes, as the text codec does; there
is no fallback, so a failed build raises. The C source's header describes
the frame. ``encode``/``decode`` run the C codec; ``encode_plain`` and
``decode_plain`` are the plain Python versions that the tests and
``chip_smoke.py`` hold it against. Both decoders check the header with
``_header`` and raise the same ``ValueError`` for it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "zarr_codec.c"
HEADER = 16
SHUFFLE, MEMCPYED, BITSHUFFLE, DELTA, NOSPLIT = 0x01, 0x02, 0x04, 0x08, 0x10
LZ4_FORMAT = 1
_MAX_SPLITS, _MIN_BUFFERSIZE = 16, 128
_FORMATS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
# The C codec's error codes (zarr_codec.c), for the ones the header check
# has not already named.
_ERRORS = {
    -1: "torn frame (its size disagrees with its header)",
    -7: "block or type size does not fit the frame",
    -8: "a block offset lies outside the frame",
    -9: "a stream size lies outside the frame",
    -10: "a corrupt LZ4 stream",
    -11: "out of memory",
    -12: "bad arguments",
}


def _lib() -> ctypes.CDLL:
    from gol_tpu_torch.ops import _build

    return _build.load_c(SOURCE, _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.gol_blosc_encode.argtypes = [ptr, i64, i64, ptr, i64]
    lib.gol_blosc_encode.restype = i64
    lib.gol_blosc_decode.argtypes = [ptr, i64, ptr, i64]
    lib.gol_blosc_decode.restype = ctypes.c_int
    return lib


def load() -> None:
    """Build (at first use) and load the codec ahead of a write or read."""
    _lib()


@dataclasses.dataclass(frozen=True)
class Header:
    version: int
    codec_version: int
    flags: int
    typesize: int
    nbytes: int
    blocksize: int
    cbytes: int


def _header(frame, nbytes: int) -> Header:
    """The frame's header, checked against the frame's length and the
    chunk's ``nbytes``; a flag or codec the store cannot decode raises a
    ``ValueError`` naming it."""
    if len(frame) < HEADER:
        raise ValueError(f"blosc frame of {len(frame)} bytes is shorter than "
                         f"its {HEADER}-byte header (torn chunk?)")
    h = Header(*struct.unpack_from("<BBBBIII", frame))
    if h.version != 2:
        raise ValueError(f"blosc frame format version {h.version} is not 2")
    if h.cbytes != len(frame):
        raise ValueError(f"blosc frame header says {h.cbytes} bytes, the "
                         f"chunk holds {len(frame)} (torn chunk?)")
    if h.nbytes != nbytes:
        raise ValueError(f"blosc frame decodes to {h.nbytes} bytes, the "
                         f"chunk is {nbytes}")
    if h.flags & BITSHUFFLE:
        raise ValueError(f"blosc frame flag 0x04 (bitshuffle; flags "
                         f"0x{h.flags:02x}) is not supported, only byte "
                         f"shuffle (0x01)")
    if h.flags & DELTA:
        raise ValueError(f"blosc frame flag 0x08 (delta; flags "
                         f"0x{h.flags:02x}) is not supported")
    fmt = h.flags >> 5
    if not h.flags & MEMCPYED and (fmt != LZ4_FORMAT or h.codec_version != 1):
        raise ValueError(
            f"blosc frame codec {fmt} ({_FORMATS.get(fmt, 'unknown')}; flags "
            f"0x{h.flags:02x}, bits 5-7, codec version {h.codec_version}) is "
            f"not LZ4 (1): only lz4 and lz4hc frames are read")
    return h


def _bytes(arr: np.ndarray) -> np.ndarray:
    if not arr.flags.c_contiguous:
        raise ValueError("the chunk's buffer must be C-contiguous")
    return arr.reshape(-1).view(np.uint8)


def encode(raw: np.ndarray, typesize: int = 4) -> np.ndarray:
    """A chunk's raw bytes (any C-contiguous array) -> one blosc frame
    (uint8): byte shuffle and LZ4, memcpyed where that does not shrink it."""
    src = _bytes(raw)
    out = np.empty(src.size + HEADER, dtype=np.uint8)
    n = _lib().gol_blosc_encode(src.ctypes.data, src.size, typesize,
                                out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"blosc encode failed: {_ERRORS.get(n, n)}")
    return out[:n]


def decode(frame, out: np.ndarray) -> None:
    """One blosc frame -> ``out``'s bytes (C-contiguous, exactly the
    frame's raw size). Raises ``ValueError`` on a frame it cannot read
    and on a torn or corrupt one; it never reads or writes out of bounds."""
    dst = _bytes(out)
    src = np.frombuffer(frame, dtype=np.uint8)
    _header(src, dst.size)
    code = _lib().gol_blosc_decode(src.ctypes.data, src.size,
                                   dst.ctypes.data, dst.size)
    if code:
        raise ValueError(f"corrupt blosc frame: {_ERRORS.get(code, code)}")


# -- the plain versions -----------------------------------------------------


def blocksize(nbytes: int, typesize: int) -> int:
    """c-blosc 1.x's block size at clevel 5 for LZ4 (``blocksize_for`` in
    the C codec)."""
    if nbytes < typesize:
        return 1
    bs = 32 * 1024 * 4 if nbytes >= 32 * 1024 else nbytes
    if typesize <= _MAX_SPLITS and bs // typesize >= _MIN_BUFFERSIZE:
        bs = min(max(min(bs, 1 << 18) * typesize, 1 << 16), 1 << 20)
    bs = min(bs, nbytes)
    return bs // typesize * typesize if bs > typesize else bs


def _shuffle(block: np.ndarray, typesize: int, inverse: bool) -> np.ndarray:
    q = block.size // typesize
    out = block.copy()
    body = block[:q * typesize]
    out[:q * typesize] = (body.reshape(typesize, q).T if inverse
                          else body.reshape(q, typesize).T).reshape(-1)
    return out


def _length(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def _literals(data: bytes) -> bytes:
    """One LZ4 block holding ``data`` as a single literal run."""
    n = len(data)
    token = bytes([min(n, 15) << 4])
    return token + (_length(n - 15) if n >= 15 else b"") + data


def encode_plain(raw: np.ndarray, typesize: int = 4, *, memcpy: bool = True,
                 split: bool = True, stream: str = "lz4") -> np.ndarray:
    """Python version of ``encode``: c-blosc's block size and split rule,
    byte shuffle, each stream one LZ4 literal run (``stream="lz4"``) or
    stored raw (``"raw"``). Literal runs never shrink a chunk, so with
    ``memcpy`` (c-blosc's rule) the frame is memcpyed; the tests pass
    ``memcpy=False`` (and ``split=False``) to build every other frame form."""
    src = _bytes(raw)
    nbytes = src.size
    bs = blocksize(nbytes, typesize)
    splits = split and typesize <= _MAX_SPLITS and bs // typesize >= _MIN_BUFFERSIZE
    flags = (LZ4_FORMAT << 5) | (SHUFFLE if typesize > 1 else 0) | (
        0 if splits else NOSPLIT)
    if memcpy or nbytes < _MIN_BUFFERSIZE:
        return np.frombuffer(struct.pack("<BBBBIII", 2, 1, flags | MEMCPYED,
                                         typesize, nbytes, bs, nbytes + HEADER)
                             + src.tobytes(), dtype=np.uint8)
    nblocks = -(-nbytes // bs)
    blocks = []
    for j in range(nblocks):
        block = src[j * bs:(j + 1) * bs]
        if typesize > 1:
            block = _shuffle(block, typesize, inverse=False)
        nsplits = typesize if splits and block.size == bs else 1
        neblock = block.size // nsplits
        parts = []
        for s in range(nsplits):
            part = block[s * neblock:(s + 1) * neblock].tobytes()
            body = part if stream == "raw" else _literals(part)
            parts.append(struct.pack("<i", len(body)) + body)
        blocks.append(b"".join(parts))
    offsets, pos = [], HEADER + 4 * nblocks
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    head = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, bs, pos)
    return np.frombuffer(head + struct.pack(f"<{nblocks}I", *offsets)
                         + b"".join(blocks), dtype=np.uint8)


def _lz4_decode_plain(src: bytes, n: int) -> bytes:
    out = bytearray()
    i = 0

    def length(i: int, v: int) -> tuple[int, int]:
        while True:
            if i >= len(src):
                raise ValueError("corrupt blosc frame: a corrupt LZ4 stream")
            b = src[i]
            i += 1
            v += b
            if b != 255:
                return i, v

    while True:
        if i >= len(src):
            raise ValueError("corrupt blosc frame: a corrupt LZ4 stream")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            i, lit = length(i, lit)
        if lit > len(src) - i or lit > n - len(out):
            raise ValueError("corrupt blosc frame: a corrupt LZ4 stream")
        out += src[i:i + lit]
        i += lit
        if i == len(src):
            return bytes(out)
        if len(src) - i < 2:
            raise ValueError("corrupt blosc frame: a corrupt LZ4 stream")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        match = token & 15
        if match == 15:
            i, match = length(i, match)
        match += 4
        if off == 0 or off > len(out) or match > n - len(out):
            raise ValueError("corrupt blosc frame: a corrupt LZ4 stream")
        start = len(out) - off
        period = bytes(out[start:])
        out += (period * (match // off + 1))[:match]


def decode_plain(frame, nbytes: int) -> np.ndarray:
    """Python version of ``decode``: the frame's ``nbytes`` raw bytes."""
    frame = bytes(frame)
    h = _header(frame, nbytes)
    if h.flags & MEMCPYED:
        if h.cbytes != nbytes + HEADER:
            raise ValueError(f"corrupt blosc frame: {_ERRORS[-1]}")
        return np.frombuffer(frame, dtype=np.uint8, count=nbytes,
                             offset=HEADER).copy()
    if h.typesize < 1 or h.blocksize < 1:
        raise ValueError(f"corrupt blosc frame: {_ERRORS[-7]}")
    out = np.empty(nbytes, dtype=np.uint8)
    nblocks = -(-nbytes // h.blocksize)
    first = HEADER + 4 * nblocks
    if first > h.cbytes:
        raise ValueError(f"corrupt blosc frame: {_ERRORS[-8]}")
    offsets = struct.unpack_from(f"<{nblocks}I", frame, HEADER)
    for j, pos in enumerate(offsets):
        bsize = min(h.blocksize, nbytes - j * h.blocksize)
        if not first <= pos < h.cbytes:
            raise ValueError(f"corrupt blosc frame: {_ERRORS[-8]}")
        nsplits = h.typesize if not h.flags & NOSPLIT and bsize == h.blocksize else 1
        if bsize % nsplits:
            raise ValueError(f"corrupt blosc frame: {_ERRORS[-7]}")
        neblock = bsize // nsplits
        parts = []
        for _ in range(nsplits):
            if h.cbytes - pos < 4:
                raise ValueError(f"corrupt blosc frame: {_ERRORS[-9]}")
            (csize,) = struct.unpack_from("<i", frame, pos)
            pos += 4
            if not 0 < csize <= h.cbytes - pos:
                raise ValueError(f"corrupt blosc frame: {_ERRORS[-9]}")
            body = frame[pos:pos + csize]
            part = body if csize == neblock else _lz4_decode_plain(body, neblock)
            if len(part) != neblock:
                raise ValueError(f"corrupt blosc frame: {_ERRORS[-10]}")
            parts.append(part)
            pos += csize
        block = np.frombuffer(b"".join(parts), dtype=np.uint8)
        if h.flags & SHUFFLE and h.typesize > 1:
            block = _shuffle(block, h.typesize, inverse=True)
        out[j * h.blocksize:j * h.blocksize + bsize] = block
    return out
