"""Result fingerprints: the cache key of one simulation question.

The port's copy of ``gol_tpu/cache/fingerprint.py``. Every key equals the
JAX package's for the same job, body or packed body (test-pinned), so CAS
entries move between the packages.

A result is reusable iff the *question* matches exactly: the board, the
loop-accounting convention, the generation limit, and the similarity-exit
configuration. Everything else — padding bucket, batch slot, kernel flavor,
pipeline depth, which worker ran it — is decomposition: the engine contract
(test-pinned) makes the answer bit-identical across all of them,
so none of it may reach the key. Two properties follow:

- **decomposition independence** — the board digest reuses the checkpoint
  identity's positional limb math (``resilience/checkpoint.positional_
  digest``: each cell contributes ``value * mix(row, col)``, summed mod
  2^64), so the SAME board digests identically whether it arrives as a
  plain ndarray, a C- or F-ordered view, a tensor or a mesh's shards — and
  a job padded into different buckets still hits.
- **collision hardening** — a 64-bit positional sum alone is too weak to
  gate byte-identity on, so the digest also folds in the CRC32 of the
  canonical row-major cell bytes. The CAS layer re-verifies a stored
  payload's CRC on every read regardless (a colliding OR corrupted entry
  is evicted loudly and the engine re-runs).

``body_fingerprint`` computes the same key from a raw ``POST /jobs`` JSON
body, without a device, as a fleet router ranks workers by it.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.resilience.checkpoint import positional_digest, state_blocks

SCHEMA_VERSION = 1


def board_digest(board, mesh_shape=(1, 1)) -> str:
    """Decomposition-independent digest of a board's cells.

    ``board`` may be a numpy array, a tensor, or a mesh's list of shard
    tensors laid over ``mesh_shape`` — sharded forms digest block-by-block
    through the same positional math (``checkpoint.state_blocks``), so the
    digest never depends on how the caller happened to lay the cells out.
    """
    if not isinstance(board, (torch.Tensor, list, tuple)):
        board = torch.from_numpy(np.ascontiguousarray(board))
    blocks = state_blocks(board, mesh_shape)
    positional = positional_digest(blocks)
    # Canonical row-major bytes for the CRC fold: reassemble sharded forms.
    if len(blocks) == 1 and blocks[0][0][0] == 0 and blocks[0][0][2] == 0:
        cells = blocks[0][1]
    else:
        h, w = blocks[-1][0][1], blocks[-1][0][3]
        cells = np.zeros((h, w), np.uint8)
        for (r0, r1, c0, c1), piece in blocks:
            cells[r0:r1, c0:c1] = piece
    crc = zlib.crc32(np.ascontiguousarray(cells, dtype=np.uint8).tobytes())
    return f"{positional & ((1 << 64) - 1):016x}{crc:08x}"


def result_fingerprint(
    board,
    convention: str = Convention.C,
    gen_limit: int = GameConfig().gen_limit,
    check_similarity: bool = True,
    similarity_frequency: int = GameConfig().similarity_frequency,
) -> str:
    """The cache key: board digest + every config axis that changes the
    answer. Geometry is part of the key (two boards with equal digests but
    different declared extents must never alias); the schema version makes
    any future key-rule change a clean fleet-wide miss."""
    h, w = board.shape
    sim = f"s{int(similarity_frequency)}" if check_similarity else "nosim"
    return (
        f"v{SCHEMA_VERSION}-{board_digest(board)}-{h}x{w}"
        f"-{convention}-g{int(gen_limit)}-{sim}"
    )


def job_fingerprint(job) -> str:
    """``result_fingerprint`` of a serve ``Job`` (the scheduler's consult)."""
    return result_fingerprint(
        job.board,
        convention=job.convention,
        gen_limit=job.gen_limit,
        check_similarity=job.check_similarity,
        similarity_frequency=job.similarity_frequency,
    )


def body_fingerprint(body: dict) -> str:
    """The same key from a raw ``POST /jobs`` body (router-side, no device).

    Applies the worker's own field defaults (``Job`` / ``GameConfig``) so
    router and worker derive identical keys for identical submissions.
    Raises ``ValueError``/``TypeError``/``KeyError`` on bodies too
    malformed to key — callers fall back to bucket routing (the worker's
    full validation still answers the client).
    """
    from gol_tpu_torch.io import text_grid

    width, height = int(body["width"]), int(body["height"])
    if width <= 0 or height <= 0:
        raise ValueError(f"dimensions must be positive, got {height}x{width}")
    check = body.get("check_similarity", True)
    if not isinstance(check, bool):
        raise TypeError(
            f"check_similarity must be a JSON boolean, got "
            f"{type(check).__name__}"
        )
    board = text_grid.decode(
        str(body["cells"]).encode("ascii"), width, height
    )
    return result_fingerprint(
        board,
        convention=str(body.get("convention", Convention.C)),
        gen_limit=int(body.get("gen_limit", GameConfig().gen_limit)),
        check_similarity=check,
        similarity_frequency=int(
            body.get("similarity_frequency", GameConfig().similarity_frequency)
        ),
    )


def packed_body_fingerprint(raw: bytes) -> str:
    """A routing key from a raw PACKED ``POST /jobs`` body — WITHOUT
    unpacking the payload.

    The packed lane of ``body_fingerprint``: the router's ``--cache-route``
    needs a deterministic per-(board, config) label to rank workers by, and
    the whole point of the packed format is that the router never decodes
    boards — so the board's contribution is the frame's own payload CRC +
    byte length (read from the header and the body size; the words are a
    deterministic function of the cells, so every packed resend of a board
    keys identically) instead of the cell-level positional digest.

    The key is therefore format-scoped (``v1p-`` prefix): a board submitted
    packed and the SAME board submitted as text may rank onto different
    workers — a one-time locality miss, never a correctness issue, since
    the worker-side cache fingerprints the DECODED board identically for
    both formats. Raises ``ValueError`` (via ``wire.WireError``) on frames
    too malformed to key — callers fall back to bucket routing.
    """
    from gol_tpu_torch.io import wire

    width, height, meta = wire.peek(raw)
    if width <= 0 or height <= 0:
        raise ValueError(f"dimensions must be positive, got {height}x{width}")
    check = meta.get("check_similarity", True)
    if not isinstance(check, bool):
        raise TypeError(
            f"check_similarity must be a JSON boolean, got "
            f"{type(check).__name__}"
        )
    crc = wire.payload_crc(raw)
    sim = (
        f"s{int(meta.get('similarity_frequency', GameConfig().similarity_frequency))}"
        if check else "nosim"
    )
    # The board's contribution is the payload CRC alone: the payload LENGTH
    # is already pinned by the height/width axes below, and folding the
    # frame length would smuggle meta-only fields (priority, deadline_s —
    # QoS, which body_fingerprint pins OUT of the key) into the routing
    # key, re-routing exactly the repeat traffic --cache-route exists for.
    return (
        f"v{SCHEMA_VERSION}p-{crc:08x}-{height}x{width}"
        f"-{meta.get('convention', Convention.C)}"
        f"-g{int(meta.get('gen_limit', GameConfig().gen_limit))}-{sim}"
    )
