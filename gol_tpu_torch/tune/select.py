"""Runtime plan selection: the engine and the serve batcher ask here.

The port of ``gol_tpu/tune/select.py``, the sparse and macro crossovers
of ``--engine auto`` included. The consult contract, pinned by
tests/test_torch_tune.py against the JAX package's:

- **no plan cached → None/defaults**, and the callers' hard-coded ladders
  run byte-identically to the pre-tune codebase;
- a cached plan is served only when its fingerprint matches *exactly*
  (schema, torch and CUDA versions, shape, convention, family, mesh, device —
  ``plans.fingerprint``), and is validity-checked again at the consumer
  (``engine._apply_plan``, ``space.valid_serve_plan``) so a hand-edited or
  stale-but-addressable entry degrades loudly instead of crashing a server.

Plans load once per process (the store caches its file read); a tuner
writing plans while a server runs takes effect on the server's next
restart — or after ``reset()``, which drops the cached store (tests, and
an in-process tune followed by ``serve``).
"""

from __future__ import annotations

import logging

from gol_tpu_torch.tune import plans, space
from gol_tpu_torch.tune.space import DEFAULT_SERVE_PLAN, EnginePlan, ServePlan

logger = logging.getLogger(__name__)

_STORE: plans.PlanStore | None = None


def _store() -> plans.PlanStore:
    global _STORE
    if _STORE is None:
        _STORE = plans.PlanStore()
    return _STORE


def reset() -> None:
    """Drop the cached store so the next consult re-reads the cache file."""
    global _STORE
    _STORE = None


def engine_fingerprint(shape, config, mesh=None, packed_state=False,
                       device=None) -> str:
    """The cache key of a solo-engine run context — shared by the consult
    below and the writer (``tune``), so a written plan is addressable by
    construction."""
    ctx = space.context_for(shape, config, mesh, packed_state, device)
    return plans.fingerprint(
        "engine", ctx.height, ctx.width, ctx.convention, ctx.family,
        ctx.mesh_shape, ctx.device_kind,
    )


def engine_plan(shape, config, mesh=None, packed_state=False,
                device=None) -> EnginePlan | None:
    """The measured plan for this exact run context, or None (= built-in
    ladder). Called by ``engine._build_runner`` on the auto-selected lanes."""
    ctx = space.context_for(shape, config, mesh, packed_state, device)
    store = _store()
    fp = plans.fingerprint(
        "engine", ctx.height, ctx.width, ctx.convention, ctx.family,
        ctx.mesh_shape, ctx.device_kind,
    )
    entry = store.get(fp)
    if entry is None:
        entry = store.get_default("engine")
    if not entry:
        return None
    try:
        plan = EnginePlan.from_dict(entry)
    except (TypeError, ValueError) as err:
        logger.warning("unusable engine plan for %s (%s: %s); using the "
                       "built-in ladder", fp, type(err).__name__, err)
        return None
    if plan == EnginePlan():
        return None
    logger.info("tuned engine plan %s for %dx%d/%s/%s", plan.label(),
                ctx.height, ctx.width, ctx.convention, ctx.family)
    return plan


def serve_fingerprint() -> str:
    """Serve plans cover the whole bucket space, so the grid/convention/
    family fields are wildcarded — the geometry depends on the device and
    versions, not on any one request shape."""
    return plans.fingerprint("serve", 0, 0, "any", "any", (1, 1),
                             plans.device_kind())


def serve_plan(max_batch: int = 64) -> ServePlan:
    """The batcher's geometry plan; always returns something valid (the
    built-in quantum-32 / full-ladder plan when nothing measured exists)."""
    store = _store()
    entry = store.get(serve_fingerprint())
    if entry is None:
        entry = store.get_default("serve")
    if not entry:
        return DEFAULT_SERVE_PLAN
    try:
        plan = ServePlan.from_dict(entry)
    except (TypeError, ValueError, KeyError) as err:
        logger.warning("unusable serve plan (%s: %s); using the built-in "
                       "bucket geometry", type(err).__name__, err)
        return DEFAULT_SERVE_PLAN
    if not space.valid_serve_plan(plan, max_batch):
        logger.warning(
            "serve plan %s violates the bucket invariants (quantum %% 32, "
            "ladder 1..%d ascending); using the built-in geometry",
            plan.label(), max_batch,
        )
        return DEFAULT_SERVE_PLAN
    if plan != DEFAULT_SERVE_PLAN:
        logger.info("tuned serve plan %s", plan.label())
    return plan


def marginal_rates() -> dict[str, float]:
    """The tuned serve plan's recorded marginal kernel rates: sanitized
    bucket label (``obs.registry.metric_label`` spelling) -> cell-updates/s.
    The serving dispatch-gap monitor (obs/sampler.py) divides achieved
    bucket rates by these to export the live gap ratio. Empty
    when nothing measured exists — the monitor then reports rates only,
    the usual absent-cache degradation."""
    entry = _store().get(serve_fingerprint())
    if not entry:
        return {}
    recorded = entry.get("marginal")
    if not isinstance(recorded, dict):
        return {}
    out = {}
    for label, rate in recorded.items():
        try:
            rate = float(rate)
        except (TypeError, ValueError):
            continue
        if rate > 0:
            out[str(label)] = rate
    return out


def sparse_fingerprint() -> str:
    """The sparse-engine crossover covers the whole universe space on one
    device — grid/convention/family wildcarded like the serve geometry."""
    return plans.fingerprint("sparse", 0, 0, "any", "any", (1, 1),
                             plans.device_kind())


# The admissible crossover band: below 2^16 cells even a lone glider's
# dense canvas is trivial; above 2^36 the dense lane is ruled out by the
# cells guard long before the threshold matters. A cached value outside
# the band is a corrupt/hand-edited entry and degrades loudly.
SPARSE_AREA_FLOOR = 1 << 16
SPARSE_AREA_CEIL = 1 << 36


def sparse_auto_area(default: int) -> int:
    """The measured dense/sparse crossover area for `--engine auto`
    (``run --pattern``): the plan-cached value this host measured
    (``tune --sparse-crossover``), else the bundled default, else
    ``default`` (the engine's shipped constant). Invalid entries are
    rejected loudly — a corrupt cache must not flip giant universes onto
    the dense lane."""
    entry = _store().get(sparse_fingerprint())
    if entry is None:
        entry = _store().get_default("sparse")
    if not entry:
        return default
    try:
        area = int(entry["auto_area"])
        if not SPARSE_AREA_FLOOR <= area <= SPARSE_AREA_CEIL:
            raise ValueError(f"auto_area {area} outside "
                             f"[{SPARSE_AREA_FLOOR}, {SPARSE_AREA_CEIL}]")
    except (KeyError, TypeError, ValueError) as err:
        logger.warning("unusable sparse crossover plan (%s: %s); using the "
                       "built-in threshold", type(err).__name__, err)
        return default
    if area != default:
        logger.info("tuned sparse auto threshold: %d cells", area)
    return area


def macro_fingerprint() -> str:
    """The macro-engine crossover is one number per host, like the sparse
    one — grid/convention/family wildcarded."""
    return plans.fingerprint("macro", 0, 0, "any", "any", (1, 1),
                             plans.device_kind())


# The admissible sparse/macro crossover band: below 2^6 generations the
# tree build alone dwarfs any per-generation loop; above 2^40 the macro
# lane would effectively never engage, which defeats recording a plan at
# all. Outside the band = corrupt/hand-edited entry, degrade loudly.
MACRO_GENS_FLOOR = 1 << 6
MACRO_GENS_CEIL = 1 << 40


def macro_auto_gens(default: int) -> int:
    """The measured sparse/macro generation-count crossover for
    ``--engine auto``: the plan-cached value this host measured, else the
    bundled default, else ``default`` (the macro engine's shipped
    constant). Invalid entries are rejected loudly — a corrupt cache must
    not route shallow runs onto the tree engine."""
    entry = _store().get(macro_fingerprint())
    if entry is None:
        entry = _store().get_default("macro")
    if not entry:
        return default
    try:
        gens = int(entry["auto_gens"])
        if not MACRO_GENS_FLOOR <= gens <= MACRO_GENS_CEIL:
            raise ValueError(f"auto_gens {gens} outside "
                             f"[{MACRO_GENS_FLOOR}, {MACRO_GENS_CEIL}]")
    except (KeyError, TypeError, ValueError) as err:
        logger.warning("unusable macro crossover plan (%s: %s); using the "
                       "built-in threshold", type(err).__name__, err)
        return default
    if gens != default:
        logger.info("tuned macro auto threshold: %d generations", gens)
    return gens


def warm_entries() -> list[dict]:
    """Shapes recorded by the offline tuner for server warmup: each entry is
    ``{"height", "width", "convention", ...}`` — ``serve --warm-plans``
    builds and launches their bucket runners at boot so the first request
    of each tuned shape pays no kernel build."""
    entry = _store().get(serve_fingerprint())
    if not entry:
        return []
    warm = entry.get("warm")
    if not isinstance(warm, list):
        return []
    return [w for w in warm if isinstance(w, dict)
            and {"height", "width"} <= set(w)]
