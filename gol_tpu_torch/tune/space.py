"""The declarative search space: every tunable the engine and batcher expose.

The port of ``gol_tpu/tune/space.py``: the same axes, dataclasses and
validity filter. A *plan* is a point in this space; a *candidate* is a plan
the filter admits for a concrete (height, width, convention, mesh shape,
device) context:

- kernel flavor      — the port's kernels: ``packed`` (K1 or K3), ``pallas``
                       (K4, a candidate on the card only, as JAX offers
                       ``pallas`` only on a TPU) and byte ``lax``; there is
                       no ``packed-jnp``;
- temporal depth     — generations per multi-generation pass, in
                       {1, 2, 4, 8} (``ops.with_temporal_depth``);
- termination block  — generations per flag readback of the blocked loop
                       (``engine._TERMINATION_BLOCK``'s measured override);
- packed vs byte carried state — which runner family a plan describes;
- serve padding quantum, batch-size ladder and batched depth — the
                       batcher's bucket geometry.

JAX's Pallas band target (``band_bytes``) is a TPU VMEM knob: the field is
kept so plans round-trip, but no candidate carries it.
"""

from __future__ import annotations

import dataclasses

from gol_tpu_torch import ops
from gol_tpu_torch.parallel.mesh import Topology

# Axis domains. Kept small and explicit — the space is searched exhaustively
# per shape, so every value here multiplies measurement time.
TEMPORAL_DEPTHS = (1, 2, 4, 8)
TERMINATION_BLOCKS = (8, 16, 32, 64)
# Serve batcher geometry: board extents round up to the quantum; request
# counts round up the ladder. Every quantum is a multiple of 32 so exact-fit
# buckets keep the bit-packed fast path; every ladder ends at the batcher's
# hard cap so scheduler/server admission bounds stay invariant.
PAD_QUANTA = (32, 64, 128)
BATCH_LADDERS = (
    (1, 2, 4, 8, 16, 32, 64),
    (1, 4, 16, 64),
    (1, 8, 64),
)
# Batched temporal depth: generations per while iteration of the batch/ring
# programs (engine.make_batch_runner temporal_depth — bit-exact at any
# depth, so purely a measured axis). Crossed with the quanta but not the
# ladders: depth amortizes the per-iteration cross-board sync, which
# interacts with the canvas (quantum) and not with how request counts
# round — the full 3-way cross would triple search time for candidates
# that cannot differ.
SERVE_TEMPORAL_DEPTHS = (1, 2, 4, 8)
# Sparse-engine tile edges (``sparse/``): bit-exact at any admissible
# value — the tile size trades per-tile dispatch amortization against
# elision granularity (smaller tiles skip more dead area; larger tiles
# batch better), so it is a measured axis like the serve geometry. The
# sparse lane's tile-batch counts already round up the serve plan's
# BATCH_LADDERS via batcher.pad_batch, so a tuned ladder applies to tile
# batching with no extra plumbing.
SPARSE_TILES = (128, 256, 512)


def valid_sparse_tile(tile: int, height: int, width: int) -> bool:
    """A tile edge is admissible for a universe iff the extents tile
    evenly (the sparse board's own constructor invariant)."""
    return tile >= 4 and height % tile == 0 and width % tile == 0


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """A point in the solo-engine space; ``None`` fields mean "built-in".

    Doubles as the runtime plan object ``engine._build_runner`` applies —
    the search measures exactly what selection later builds.
    """

    kernel: str | None = None  # ops registry name; None = the auto ladder
    temporal_depth: int | None = None  # generations per fused_multi pass
    termination_block: int | None = None  # generations per flag readback
    band_bytes: int | None = None  # JAX's Pallas band target; never searched

    def label(self) -> str:
        parts = [self.kernel or "auto"]
        if self.temporal_depth:
            parts.append(f"T{self.temporal_depth}")
        if self.termination_block:
            parts.append(f"K{self.termination_block}")
        if self.band_bytes:
            parts.append(f"band{self.band_bytes >> 10}K")
        return "/".join(parts)

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, data: dict) -> "EnginePlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key not in fields or value is None:
                continue
            kwargs[key] = str(value) if key == "kernel" else int(value)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Serve-batcher geometry: one plan covers the whole fleet's buckets.

    ``temporal_depth`` is the batched engine's generations-per-while-
    iteration (bit-exact at any value), applied to
    every bucket program the batcher builds; depth 1 is the pre-tune
    behavior, byte-identically."""

    pad_quantum: int = 32
    batch_ladder: tuple[int, ...] = BATCH_LADDERS[0]
    temporal_depth: int = 1

    def label(self) -> str:
        label = f"q{self.pad_quantum}/ladder{'-'.join(map(str, self.batch_ladder))}"
        if self.temporal_depth != 1:
            label += f"/T{self.temporal_depth}"
        return label

    def to_dict(self) -> dict:
        out = {
            "pad_quantum": self.pad_quantum,
            "batch_ladder": list(self.batch_ladder),
        }
        # Only when tuned off the default: older caches (and their pinned
        # goldens) stay byte-stable.
        if self.temporal_depth != 1:
            out["temporal_depth"] = self.temporal_depth
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "ServePlan":
        return cls(
            pad_quantum=int(data["pad_quantum"]),
            batch_ladder=tuple(int(x) for x in data["batch_ladder"]),
            temporal_depth=int(data.get("temporal_depth", 1)),
        )


# The behavior the hard-coded ladders implement today: these plans are what
# "no plan" means, and the bundled default_plans.json encodes them — so a
# cold machine (or a torn cache file) gets exactly the pre-tune ladders.
DEFAULT_SERVE_PLAN = ServePlan()


def valid_serve_plan(plan: ServePlan, max_batch: int) -> bool:
    """Admission gate for serve plans, shared by the candidate generator and
    the runtime consult (a stale/hand-edited cache entry must not be able to
    change the server's admission invariants)."""
    ladder = plan.batch_ladder
    return (
        plan.pad_quantum >= 32
        and plan.pad_quantum % 32 == 0
        and len(ladder) >= 1
        and ladder[0] == 1
        and ladder[-1] == max_batch
        and all(a < b for a, b in zip(ladder, ladder[1:]))
        # Any depth is bit-exact, but the engine caps the axis (and a
        # hand-edited 10^6 would hang every program in useless no-op
        # sub-steps after the batch converges).
        and 1 <= plan.temporal_depth <= 64
    )


@dataclasses.dataclass(frozen=True)
class TuneContext:
    """Everything the validity filter (and the plan fingerprint) keys on."""

    height: int
    width: int
    convention: str
    packed_state: bool  # carried-state family: words vs uint8 grid
    mesh_shape: tuple[int, int] = (1, 1)
    device_kind: str = "cpu"

    @property
    def family(self) -> str:
        return "packed" if self.packed_state else "byte"

    @property
    def topology(self) -> Topology:
        return Topology(shape=self.mesh_shape)

    @property
    def local_shape(self) -> tuple[int, int]:
        return (self.height // self.mesh_shape[0],
                self.width // self.mesh_shape[1])

    @property
    def on_card(self) -> bool:
        """A CUDA card (its name), not the CPU lane."""
        return self.device_kind != "cpu"


def context_for(shape, config, mesh=None, packed_state=False,
                device=None) -> TuneContext:
    """Derive the tuning context of a concrete run: the device is the
    mesh's first, else ``device``, else the platform default."""
    from gol_tpu_torch.tune import plans

    mesh_shape = (1, 1)
    if mesh is not None:
        mesh_shape = tuple(mesh.shape)
        device = mesh.devices[0]
    return TuneContext(
        height=int(shape[0]),
        width=int(shape[1]),
        convention=config.convention,
        packed_state=packed_state,
        mesh_shape=mesh_shape,
        device_kind=plans.device_kind(device),
    )


def default_engine_plan(ctx: TuneContext) -> EnginePlan:
    """The plan the hard-coded ladder picks for this context today: the
    search's baseline candidate, and the ratio denominator in reports."""
    local_h, local_w = ctx.local_shape
    kernel = (
        "packed" if ctx.packed_state
        else ops.resolve_kernel("auto", local_h, local_w, ctx.topology).name
    )
    kobj = ops.get_kernel(kernel)
    depth = (
        kobj.multi_gens
        if kobj.fused_multi is not None
        and kobj.supports_multi(local_h, local_w, ctx.topology)
        else 1
    )
    return EnginePlan(kernel=kernel, temporal_depth=depth,
                      termination_block=16)


def engine_candidates(ctx: TuneContext, quick: bool = False) -> list[EnginePlan]:
    """Every engine plan valid for ``ctx``, default candidate first.

    Kernel flavors come from the ops registry filtered by their own
    ``supports`` gates: ``packed`` only where the width packs, the byte
    ``pallas`` kernel (K4) only on a card — on the CPU it would run its
    plain version, a measurement of nothing, as JAX keeps it off non-TPU
    backends — and ``lax``. JAX's ``packed-jnp`` (its Mosaic fallback) has
    no counterpart. Depth needs a fused pass (byte ``lax`` has none).

    ``quick`` prunes the depth and block axes to their extremes.
    """
    local_h, local_w = ctx.local_shape
    topo = ctx.topology
    if ctx.packed_state:
        kernel_names = ["packed"]
    else:
        kernel_names = ["packed", "lax"]
        if ctx.on_card:
            kernel_names.insert(1, "pallas")
    all_depths = (1, TEMPORAL_DEPTHS[-1]) if quick else TEMPORAL_DEPTHS
    all_blocks = (16, TERMINATION_BLOCKS[-1]) if quick else TERMINATION_BLOCKS
    candidates = [default_engine_plan(ctx)]
    for name in kernel_names:
        kobj = ops.get_kernel(name)
        if not kobj.supports(local_h, local_w, topo):
            continue
        depths = all_depths if kobj.fused is not None else (1,)
        for depth in depths:
            blocks = all_blocks if kobj.fused is not None else (16,)
            for block in blocks:
                cand = EnginePlan(kernel=name, temporal_depth=depth,
                                  termination_block=block)
                if cand not in candidates:
                    candidates.append(cand)
    return candidates


def serve_candidates(max_batch: int = 64) -> list[ServePlan]:
    """Every serve plan, default first: the geometry axes (quantum x
    ladder, at depth 1) plus the batched temporal-depth axis (depth x
    quantum, at the default ladder — see SERVE_TEMPORAL_DEPTHS for why the
    ladder is not crossed)."""
    candidates = [DEFAULT_SERVE_PLAN]
    for quantum in PAD_QUANTA:
        for ladder in BATCH_LADDERS:
            cand = ServePlan(pad_quantum=quantum, batch_ladder=ladder)
            if valid_serve_plan(cand, max_batch) and cand not in candidates:
                candidates.append(cand)
    for quantum in PAD_QUANTA:
        for depth in SERVE_TEMPORAL_DEPTHS:
            cand = ServePlan(pad_quantum=quantum, temporal_depth=depth)
            if valid_serve_plan(cand, max_batch) and cand not in candidates:
                candidates.append(cand)
    return candidates
