"""The packed binary wire format: boards on the wire at 1 bit per cell.

The port's copy of ``gol_tpu/io/wire.py`` (numpy only; it differs in its
imports): for the same input a frame's bytes equal the JAX package's, so a
client of either package talks to a server of the other, and a CAS sidecar
written by one reads in the other.

Text moves boards at ~8.5 bytes per cell once JSON framing and the newline
column are counted. This module defines the ONE binary frame every hop
speaks instead — client submit, CAS payload, result response — built on
the single bit-packing convention (``io/bitpack.py``: bit j of word w =
column 32w+j, the layout the packed kernels compute on).

Frame layout (all integers little-endian)::

    offset  size  field
    0       4     magic  b"GOLP"
    4       2     version (=1; unknown versions are rejected as
                  UnsupportedWire so clients can degrade to text)
    6       2     flags (reserved, must be 0)
    8       4     width  (cells)
    12      4     height (cells)
    16      4     meta_len (bytes of UTF-8 JSON following the header)
    20      4     CRC32 of the words payload bytes
    24      ...   meta JSON object (meta_len bytes)
    ...     ...   payload: height rows x ceil(width/32) uint32 words

The payload is exactly the host-staging word array the engine's packed
kernels consume — a packed submit can be staged without re-packing, and a
packed result can be encoded without a text round trip. Widths that are
not a multiple of 32 pad the final word of each row with dead (zero) bits;
``decode`` crops them back off. The meta JSON carries whatever the hop
needs (submit fields minus ``cells``/``width``/``height``; result fields
minus ``grid``) — geometry always rides the header, authoritatively.

Truncated frames, trailing garbage, CRC mismatches, bad magic, and
non-object meta all raise ``WireError`` loudly: a frame either parses
whole or not at all.

Content negotiation (``serve/server.py``):
``POST /jobs`` with ``Content-Type: application/x-gol-packed`` submits a
frame; ``GET /result/<id>`` with that token in ``Accept`` answers one.
Text/JSON stays the compat default and is byte-identical to pre-wire
behavior when chosen (test-pinned).
"""

from __future__ import annotations

import dataclasses
import json
import struct
import sys
import zlib

import numpy as np

from gol_tpu_torch.io import bitpack

CONTENT_TYPE = "application/x-gol-packed"
# Unknown members of the family (a future v2 content type, say) answer 415
# — the signal a packed client degrades to text on.
CONTENT_TYPE_FAMILY = "application/x-gol-"

MAGIC = b"GOLP"
VERSION = 1

# -- shard frame meta convention (gol_tpu/shard/halo.py) --------------------
#
# The sharded single-job engine's worker↔worker hops ride this exact frame
# format; the ``kind`` meta key names which shard payload the rows carry so
# a halo frame can never be mistaken for a board submit (a submit's meta
# never carries ``kind``). ``shard-halo`` stacks 4 ring rows (top, bottom,
# left-as-row, right-as-row) per boundary tile; ``shard-tiles`` stacks
# ``tile`` full rows per migrating tile (the elastic-rebalance transfer).
# Both list their tile coords under the ``tiles`` meta key, in row-major
# order matching the payload stacking.
META_KIND = "kind"
SHARD_HALO_KIND = "shard-halo"
SHARD_TILES_KIND = "shard-tiles"

_HEADER = struct.Struct("<4sHHIIII")
HEADER_SIZE = _HEADER.size  # 24 bytes

# -- body caps (shared by worker and router so the two tiers agree) ---------
#
# The 64 MiB text/JSON cap predates this module and is sized for text's
# ~8.5x inflation; it stays byte-identical for text bodies (test-pinned). The packed cap bounds the SAME universe of board areas,
# not the same byte count: a board that fits the text cap packs to ~1/8 of
# its text bytes, so capping packed bodies at the text byte count would
# accept boards 8x the area text can carry — an asymmetric DoS surface and
# an accidental format-dependent feature. Exactly TEXT/8 — header + meta
# count against the same budget text's newline column and JSON framing
# consume, which makes both caps flip at the same square-board side
# (8192^2, boundary-pinned by tests); degenerate aspect ratios can only
# diverge in the conservative direction (row-padding makes packed
# stricter, never looser).
MAX_BODY_TEXT = 64 << 20
MAX_BODY_PACKED = MAX_BODY_TEXT // 8


class WireError(ValueError):
    """A frame that does not parse whole: truncated, torn, CRC-poisoned,
    wrong magic, malformed meta. Maps to HTTP 400."""


class UnsupportedWire(WireError):
    """A frame (or content type) from a NEWER wire revision than this
    process speaks. Maps to HTTP 415 — the retry-as-text signal."""


def content_type_of(header_value: str | None) -> str:
    """Normalize a Content-Type header value to its media type (parameters
    such as ``; charset=`` stripped, lowercased); '' when absent."""
    if not header_value:
        return ""
    return header_value.split(";", 1)[0].strip().lower()


def is_packed(header_value: str | None) -> bool:
    return content_type_of(header_value) == CONTENT_TYPE


def accepts_packed(accept_header: str | None) -> bool:
    """Whether an ``Accept`` header asks for the packed format. Plain
    substring membership on the media-type token: clients send either our
    exact type or generic ``application/json``/``*/*`` forms."""
    return bool(accept_header) and CONTENT_TYPE in accept_header


def is_crc_error(payload) -> bool:
    """Whether a 400 error payload reports a frame CRC mismatch — i.e.
    the frame was corrupted on THAT hop and a resend of the same bytes is
    both safe (a 400 created no job) and likely to heal it. The ONE
    definition both transparent-recovery lanes (the router's forward
    retry and the client's packed resend) key off, so neither can drift
    from the error text this module raises."""
    return (isinstance(payload, dict)
            and "crc" in str(payload.get("error", "")).lower())


def max_body_bytes(content_type: str | None) -> int:
    """The request-body byte cap for a Content-Type header value: both
    formats accept the same universe of board AREAS (boundary-pinned by
    tests), so the cap is format-aware rather than one byte count."""
    return MAX_BODY_PACKED if is_packed(content_type) else MAX_BODY_TEXT


def words_per_row(width: int) -> int:
    """uint32 words per payload row (final word zero-padded)."""
    return (width + 31) // 32


def _require_little_endian() -> None:
    # Same gate as engine.resolve_batch_mode: the word payload is defined
    # as little-endian uint32 and the numpy fast paths view native memory.
    if sys.byteorder != "little":
        raise WireError(
            "the packed wire format requires a little-endian host; "
            "use the text format on this machine"
        )


def pack_grid(grid: np.ndarray) -> np.ndarray:
    """(H, W) uint8 {0,1} cells -> (H, words_per_row) uint32 payload words.

    Pads the width up to the next multiple of 32 with dead cells, then
    defers to the one bit-order rule in ``io/bitpack.py``."""
    _require_little_endian()
    grid = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
    if grid.ndim != 2:
        raise WireError(f"grid must be 2-D, got shape {grid.shape}")
    height, width = grid.shape
    wpr = words_per_row(width)
    if height == 0 or width == 0:
        return np.zeros((height, wpr), np.uint32)
    if width % 32:
        padded = np.zeros((height, wpr * 32), np.uint8)
        padded[:, :width] = grid
        grid = padded
    return bitpack.pack_words(grid)


def unpack_grid(words: np.ndarray, width: int) -> np.ndarray:
    """Inverse of ``pack_grid``: payload words -> (H, width) uint8 cells."""
    _require_little_endian()
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    height = words.shape[0]
    if height == 0 or width == 0:
        return np.zeros((height, width), np.uint8)
    return np.ascontiguousarray(bitpack.unpack_words(words, width))


@dataclasses.dataclass
class Frame:
    """One decoded wire frame: geometry + meta + the payload words."""

    width: int
    height: int
    meta: dict
    words: np.ndarray  # (height, words_per_row) uint32

    def grid(self) -> np.ndarray:
        """The decoded (height, width) uint8 board."""
        return unpack_grid(self.words, self.width)


def encode_frame(
    meta: dict,
    *,
    grid: np.ndarray | None = None,
    words: np.ndarray | None = None,
    width: int | None = None,
    height: int | None = None,
) -> bytes:
    """Serialize one frame from cells OR pre-packed words.

    ``words`` (with explicit ``width``/``height``) is the zero-re-encode
    lane: a result whose packed words are already in hand — engine output,
    CAS payload — goes to the wire without ever materializing cells. The
    two lanes are byte-identical for the same board (test-pinned)."""
    _require_little_endian()
    if (grid is None) == (words is None):
        raise WireError("pass exactly one of grid/words")
    if not isinstance(meta, dict):
        raise WireError(f"meta must be a dict, got {type(meta).__name__}")
    if grid is not None:
        grid = np.ascontiguousarray(np.asarray(grid, dtype=np.uint8))
        if grid.ndim != 2:
            raise WireError(f"grid must be 2-D, got shape {grid.shape}")
        height, width = (int(x) for x in grid.shape)
        words = pack_grid(grid)
    else:
        if width is None or height is None:
            raise WireError("words needs explicit width/height")
        width, height = int(width), int(height)
        words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
        if words.shape != (height, words_per_row(width)):
            raise WireError(
                f"words shape {words.shape} does not match "
                f"{height}x{width} (need (H, ceil(W/32)))"
            )
    payload = words.tobytes()
    meta_blob = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    header = _HEADER.pack(
        MAGIC, VERSION, 0, width, height, len(meta_blob),
        zlib.crc32(payload),
    )
    return header + meta_blob + payload


def peek(data: bytes) -> tuple[int, int, dict]:
    """(width, height, meta) from the header + meta section ONLY.

    The router's placement parse: no payload read, no CRC pass, no unpack —
    a packed submit is placed from ~24 bytes + the meta JSON and forwarded
    as the same raw buffer. The worker's full ``decode_frame`` stays the
    authoritative validator."""
    if len(data) < HEADER_SIZE:
        raise WireError(
            f"truncated frame: {len(data)} bytes < {HEADER_SIZE}-byte header"
        )
    magic, version, flags, width, height, meta_len, _crc = _HEADER.unpack(
        data[:HEADER_SIZE]
    )
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise UnsupportedWire(
            f"wire version {version} is newer than this process "
            f"(speaks {VERSION}); resend as text"
        )
    if flags != 0:
        raise UnsupportedWire(f"unknown wire flags {flags:#06x}")
    if len(data) < HEADER_SIZE + meta_len:
        raise WireError(
            f"truncated frame: meta section needs {meta_len} bytes, "
            f"{len(data) - HEADER_SIZE} present"
        )
    try:
        meta = json.loads(data[HEADER_SIZE:HEADER_SIZE + meta_len])
    except (ValueError, UnicodeDecodeError) as err:
        raise WireError(f"malformed meta JSON: {err}") from None
    if not isinstance(meta, dict):
        raise WireError(
            f"meta must be a JSON object, got {type(meta).__name__}"
        )
    return int(width), int(height), meta


def payload_crc(data: bytes) -> int:
    """The header's declared payload CRC32 — read, not recomputed (the
    router's no-unpack routing key; the worker's full decode verifies)."""
    if len(data) < HEADER_SIZE:
        raise WireError(
            f"truncated frame: {len(data)} bytes < {HEADER_SIZE}-byte header"
        )
    return _HEADER.unpack(data[:HEADER_SIZE])[6]


def decode_frame(data: bytes) -> Frame:
    """Parse + verify one frame whole; any defect raises ``WireError``."""
    _require_little_endian()
    width, height, meta = peek(data)
    _magic, _v, _f, _w, _h, meta_len, crc = _HEADER.unpack(data[:HEADER_SIZE])
    payload = data[HEADER_SIZE + meta_len:]
    expected = height * words_per_row(width) * 4
    if len(payload) != expected:
        raise WireError(
            f"payload of {len(payload)} bytes does not match the declared "
            f"{height}x{width} board ({expected} bytes); frame is "
            "truncated or carries trailing garbage"
        )
    if zlib.crc32(payload) != crc:
        raise WireError("payload CRC mismatch: frame corrupted in transit")
    words = np.frombuffer(payload, dtype="<u4").astype(np.uint32)
    words = words.reshape(height, words_per_row(width))
    return Frame(width=width, height=height, meta=meta, words=words)
