"""Affinity-aware placement: capacity weights for the weighted-HRW layer.

Plain rendezvous placement (fleet/placement.rank) treats every worker as
interchangeable — correct for N identical processes on N identical core
slices, and exactly wrong for the fleets the autoscaler builds: a worker
pinned to 2 cores next to one pinned to 8, a mesh-capable big-lane host
next to packed small-bucket workers, an attached remote whose device kind
differs from the local pool's. The PAPERS process-to-node-mapping framing
applies one level up: placement is an optimization problem over MEASURED
capacity, not hash rank alone.

This module is the policy half of that layer (the mechanism is
``placement.rank_weighted``):

- every ``Worker`` carries an optional **pinned weight** (set at spawn
  time — ``gol fleet --cores-per-worker N`` pins worker k to its own
  N-core ``taskset`` slice and weights it N — or recovered from the
  manifest, so two routers over one fleet agree);
- a worker with no pinned weight may **advertise** one: ``GET /healthz``
  reports the tuner-persisted marginal kernel rates of the worker's own
  plan cache folded to one number (``GolServer.advertised_weight`` — the
  measured marginal rate, cells/s), and the fleet health loop adopts it. A host whose measured
  kernels run at half the rate takes proportionally fewer buckets;
- ``weights_for`` folds both into the weight map ``rank_weighted``
  consumes. Weights are RELATIVE (rendezvous scores scale linearly), so
  cores and cells/s never mix units inside one fleet as long as one
  source dominates — pinned weights win over advertised ones fleet-wide
  whenever any worker has one, keeping the map comparable.

Default OFF: without ``--affinity`` the router never builds a weight map
and ranks through plain HRW, byte-identically (test-pinned). With
``--affinity`` but all-equal weights, ``rank_weighted`` delegates to
plain ``rank`` — the same bytes again, so turning the flag on is safe
before any weight exists to act on.

Jax-free like the rest of the package: weights arrive as numbers (CLI
flags, manifest fields, /healthz payloads), never from a device probe.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

DEFAULT_WEIGHT = 1.0


def weights_for(workers) -> dict[str, float]:
    """The weighted-HRW map for one candidate pool: worker id -> weight.

    Pinned weights (``Worker.weight``) win over advertised ones
    (``Worker.advertised_weight``); if ANY worker in the pool is pinned,
    advertised values are ignored for the whole pool (cores and measured
    cells/s are different units — mixing them would weight a 4-core
    worker against a 10^8-cells/s one). Workers with neither get
    ``DEFAULT_WEIGHT``. An all-default map still ranks byte-identically
    to plain HRW via ``rank_weighted``'s equal-weight delegation."""
    pool = list(workers)
    pinned = any(_positive(w.weight) for w in pool)
    out: dict[str, float] = {}
    for worker in pool:
        if pinned:
            out[worker.id] = _positive(worker.weight) or DEFAULT_WEIGHT
        else:
            out[worker.id] = (_positive(worker.advertised_weight)
                              or DEFAULT_WEIGHT)
    return out


def _positive(w) -> float | None:
    try:
        w = float(w)
    except (TypeError, ValueError):
        return None
    return w if w > 0 else None


__all__ = ["DEFAULT_WEIGHT", "weights_for"]
