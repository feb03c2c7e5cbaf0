"""Bucket -> worker placement: the fleet's process-to-node mapping.

The reference's MPI ranks get their neighbors from ``MPI_Cart_create`` —
a *pre-planned, deterministic* topology every rank derives independently,
no negotiation per message. The fleet asks the same question one level up
(the PAPERS process-to-node-mapping framing): which worker owns a padding
bucket? The answer must be

- **deterministic** — router restarts, or two routers over the same fleet,
  place a bucket identically without shared state;
- **stable under membership change** — losing one worker must move only
  that worker's buckets (every bucket that moves pays a fresh XLA compile
  on its new worker, so minimal movement IS the compile-budget story);
- **orderable** — when the first-choice worker is down or shedding, the
  spillover target must be just as deterministic.

Highest-random-weight (rendezvous) hashing gives all three: every
(bucket, worker) pair gets a score from one stable hash, and a bucket's
preference list is its workers sorted by score. Removing a worker deletes
one entry from every list and moves nothing else; the second-ranked worker
is the canonical spillover.

Placement keys are computed router-side WITHOUT importing the engine (the
router owns no device, so this package imports no torch): extents round up to
``PLACEMENT_QUANTUM`` (the serve batcher's built-in quantum). When a tuned
plan widens the worker-side quantum, one serve bucket can span several
placement keys — a locality coarsening that costs at most a duplicate
compile on a second worker, never correctness (workers re-bucket every job
themselves; placement only decides WHERE).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

# The serve batcher's built-in PAD_QUANTUM, restated here so the router
# never imports the torch-loading serve stack. The port's fleet tests pin
# the two constants equal.
PLACEMENT_QUANTUM = 32


@dataclasses.dataclass(frozen=True)
class PlacementKey:
    """The router's view of a padding bucket (a coarsening of the serve
    ``BucketKey``: kernel flavor is a worker-side decision and every job
    that shares a serve bucket shares this key)."""

    height: int
    width: int
    convention: str
    check_similarity: bool = True
    similarity_frequency: int = 3

    def label(self) -> str:
        return (
            f"{self.height}x{self.width}/{self.convention}"
            + ("" if self.check_similarity
               else f"/nosim/{self.similarity_frequency}")
            + (f"/sim{self.similarity_frequency}"
               if self.check_similarity and self.similarity_frequency != 3
               else "")
        )

    @property
    def max_edge(self) -> int:
        return max(self.height, self.width)


def pad_dim(n: int) -> int:
    """Round an extent up to the placement quantum (>= one quantum)."""
    q = PLACEMENT_QUANTUM
    return max(q, -(-int(n) // q) * q)


def key_for(body: dict) -> PlacementKey:
    """Placement key from a submit body (the same JSON POST /jobs takes).

    Only the placement-relevant fields are touched; full validation stays
    with the worker's ``Job.__post_init__`` (the router forwards the body
    verbatim). Raises ValueError/TypeError on fields too malformed to
    place — the router maps those to HTTP 400 exactly as a worker would.
    """
    width, height = int(body["width"]), int(body["height"])
    if width <= 0 or height <= 0:
        raise ValueError(f"dimensions must be positive, got {height}x{width}")
    check = body.get("check_similarity", True)
    if not isinstance(check, bool):
        raise TypeError(
            f"check_similarity must be a JSON boolean, got "
            f"{type(check).__name__}"
        )
    return PlacementKey(
        height=pad_dim(height),
        width=pad_dim(width),
        convention=str(body.get("convention", "c")),
        check_similarity=check,
        similarity_frequency=int(body.get("similarity_frequency", 3)),
    )


def _score(bucket_label: str, worker_id: str) -> tuple[int, str]:
    digest = hashlib.sha1(
        f"{bucket_label}|{worker_id}".encode("utf-8")
    ).digest()
    # The worker id tiebreaks identical digests (not reachable with sha1,
    # but determinism must not rest on that).
    return int.from_bytes(digest[:8], "big"), worker_id


def rank(bucket_label: str, worker_ids) -> list[str]:
    """Worker ids by descending rendezvous score for this bucket: [0] is
    the owner, [1] the canonical spillover, and so on. Deterministic in
    the (bucket, ids) pair alone."""
    return sorted(worker_ids, key=lambda w: _score(bucket_label, w),
                  reverse=True)


def _weighted_score(bucket_label: str, worker_id: str,
                    weight: float) -> tuple[float, str]:
    """Logarithm-method weighted rendezvous score (Thaler/Ravishankar):
    map the hash to h in (0, 1) and score ``-weight / ln(h)``. The score
    distribution makes each bucket's owner worker ``i`` with probability
    w_i / sum(w) while keeping HRW's minimal-disruption property — and
    because the score is strictly increasing in h at any fixed weight,
    EQUAL weights order exactly like the raw hash, i.e. like ``rank``."""
    digest, _ = _score(bucket_label, worker_id)
    # (digest + 0.5) / 2^64 keeps h strictly inside (0, 1): ln(0) and
    # ln(1) are both poles of the formula.
    h = (digest + 0.5) / float(1 << 64)
    return -weight / math.log(h), worker_id


def rank_weighted(bucket_label: str, weights: dict[str, float]) -> list[str]:
    """``rank`` with per-worker capacity weights (the affinity layer,
    fleet/affinity.py): a worker with twice the weight owns about
    twice the buckets. Deterministic in (bucket, weights) alone; changing
    one worker's weight only moves buckets between that worker and the
    rest (never reshuffles third parties — the weighted-rendezvous
    analog of the minimal-disruption property, test-pinned).

    All-equal weights DELEGATE to plain ``rank`` — not just
    order-equivalent but the same code path, so ``--affinity`` with
    no weights configured is byte-identical to affinity off (pinned).
    Non-positive weights are treated as the 1.0 default (a zero weight
    would be "never place here", which is membership's job, not
    placement's)."""
    ids = list(weights)
    cleaned = {w: (float(weights[w]) if float(weights[w]) > 0 else 1.0)
               for w in ids}
    if len(set(cleaned.values())) <= 1:
        return rank(bucket_label, ids)
    return sorted(
        ids,
        key=lambda w: _weighted_score(bucket_label, w, cleaned[w]),
        reverse=True,
    )
