"""Compute kernels of the port: the byte ``lax`` stencil, the byte
``pallas`` kernels and the ``packed`` word kernels.

The port of ``gol_tpu/ops/__init__.py``. Every callable takes the state as
a row-major list of shards (one for a single device) and the
``Topology``; on a mesh each exchanges its ghosts and runs one kernel per
shard. ``auto`` resolves on the local shard's shape: ``packed`` wherever
its width packs into 32-bit words, ``lax`` otherwise; ``pallas`` (K4, K6
on a mesh) runs only when named, as JAX's ``auto`` never reaches it off a
TPU and prefers the packed kernel on one.

The packed kernel's 8-generation pass runs where ``supports_multi`` admits
it: on one device (K1, K2 replayed) and on every mesh with shards of at
least 8 rows — K7 with K8 replayed on R x 1 meshes, and on meshes with
columns the ghost-plane form of the same tile kernel, which replaces the
JAX package's split-edge kernels K9-K12 and its one-word-shard kernel K13
(stencil_packed.py:1441-1452). The engine drops the pass for shorter
shards, and a block then runs K5 once per generation. ``pallas`` and
``lax`` take every R x C mesh with their own per-generation forms.

``with_temporal_depth`` regroups a kernel's generations per pass (the
tuner's depth axis): depth 1 runs the packed kernel's one-generation step
(K3) every generation, 2 and 4 compose that many of its launches into one
pass, 8 is the built-in pass (K1).

There is no fallback ladder: a kernel that fails to build or to launch
raises, and the run stops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gol_tpu_torch.ops import stencil_lax, stencil_packed, stencil_pallas
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import SINGLE_DEVICE, Topology


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A named evolve implementation over a (sharded) state.

    ``step(shards, topology) -> shards`` is the per-generation form of a
    kernel without fused flags. The fused forms ``(src, dst, flags,
    topology)`` write into caller-owned shard buffers and OR their flags
    into caller-zeroed int32 buffers, one per shard (shards on one device
    may share one; see ``stencil_packed``): ``fused`` one generation with
    ``(alive, differs)``, ``fused_multi`` ``multi_gens`` generations with
    the pass summary, ``exact_multi`` the same pass with per-generation
    flags. ``supports``/``supports_multi`` gate a local shard shape on a
    topology. ``encode``/``decode`` carry a uint8 shard to the kernel's own
    state (packed words) and back, once per run.
    """

    name: str
    step: Callable | None = None
    fused: Callable | None = None
    fused_multi: Callable | None = None
    exact_multi: Callable | None = None
    multi_gens: int = 1
    supports: Callable = lambda height, width, topology: True
    supports_multi: Callable = lambda height, width, topology: False
    encode: Callable | None = None
    decode: Callable | None = None
    load: Callable | None = None  # builds/loads the card's kernels


def lax_evolve(shards, topology: Topology):
    """One byte generation: the torus rolls on one device, the halo
    exchange and the padded stencil per shard on a mesh."""
    if not topology.distributed:
        return [stencil_lax.evolve_torus(shards[0])]
    return [stencil_lax.evolve_padded(p) for p in halo.exchange(shards, topology)]


_KERNELS = {
    "lax": Kernel(name="lax", step=lax_evolve),
    "pallas": Kernel(
        name="pallas",
        fused=stencil_pallas.pallas_step_into,
        supports=stencil_pallas.supports,
        load=stencil_pallas.load_kernels,
    ),
    "packed": Kernel(
        name="packed",
        fused=stencil_packed.packed_step_into,
        fused_multi=stencil_packed.packed_step_multi_into,
        exact_multi=stencil_packed.packed_step_exact_into,
        multi_gens=stencil_packed.TEMPORAL_GENS,
        supports=stencil_packed.supports,
        supports_multi=stencil_packed.supports_multi,
        encode=stencil_packed.encode,
        decode=stencil_packed.decode,
        load=stencil_packed.load_kernels,
    ),
}


def _composed_pass(fused: Callable, depth: int, exact: bool) -> Callable:
    """``depth`` one-generation ``fused`` launches as one multi-generation
    pass ``(src, dst, flags, topology)``: the intermediate generations go
    into fresh buffers and their ``(alive, differs)`` flags into a
    per-device buffer, from which the pass ORs into each shard's ``flags``
    either the summary ``[in_alive, out_alive, diffT, diff1]`` or, with
    ``exact``, ``alive[0:T] + differs[T:2T]`` (``stencil_packed``'s
    layouts)."""
    step = stencil_packed.STEP_FLAGS

    def run(src, dst, flags, topology: Topology) -> None:
        gens = {x.device: torch.zeros(step * depth, dtype=torch.int32,
                                      device=x.device) for x in src}
        cur = src
        for i in range(depth):
            out = dst if i == depth - 1 else [torch.empty_like(x) for x in cur]
            fused(cur, out, [gens[x.device][step * i:step * (i + 1)]
                             for x in cur], topology)
            cur = out
        for x, f in zip(src, flags):
            g = gens[x.device]
            if exact:
                f[:depth] |= g[0::step]
                f[depth:2 * depth] |= g[1::step]
            else:
                f[:stencil_packed.SUMMARY_FLAGS] |= torch.stack([
                    x.ne(0).any().to(torch.int32), g[-step], g[-step + 1], g[1]])

    return run


def with_temporal_depth(kernel: Kernel, depth: int) -> Kernel:
    """A depth-``T`` temporally-grouped variant of ``kernel`` (the JAX
    package's ``ops.with_temporal_depth``).

    The blocked loops consume ``fused_multi`` at whatever ``multi_gens`` the
    kernel declares, and the replay is oblivious to the grouping
    (``engine._block_generations``), so any depth is bit-exact with the
    per-generation loop — depth is a performance knob, a tunable axis
    (``tune/space.py``):

    - ``depth == kernel.multi_gens`` with a native ``fused_multi`` returns
      the kernel unchanged (the packed kernel's 8-generation pass, K1);
    - ``depth == 1`` strips ``fused_multi``: one fused launch per generation
      (K3 for the packed kernel), flags recorded per step;
    - other depths compose ``depth`` one-generation launches into one
      ``fused_multi`` call (and the matching ``exact_multi``), valid
      wherever the per-step kernel runs (``supports_multi`` becomes the
      per-step ``supports``).

    Kernels without a fused pass (byte ``lax``) admit depth 1 only.
    """
    if depth < 1:
        raise ValueError(f"temporal depth must be >= 1, got {depth}")
    if depth == kernel.multi_gens and kernel.fused_multi is not None:
        return kernel
    if depth == 1:
        if kernel.fused_multi is None:
            return kernel
        return dataclasses.replace(
            kernel, fused_multi=None, exact_multi=None, multi_gens=1,
            supports_multi=lambda height, width, topology: False,
        )
    if kernel.fused is None:
        raise ValueError(
            f"kernel {kernel.name!r} has no fused pass; temporal depth "
            f"{depth} needs one (only depth 1 is valid)"
        )
    return dataclasses.replace(
        kernel,
        fused_multi=_composed_pass(kernel.fused, depth, exact=False),
        exact_multi=_composed_pass(kernel.fused, depth, exact=True),
        multi_gens=depth, supports_multi=kernel.supports,
    )


def get_kernel(name: str) -> Kernel:
    """An explicitly named kernel (``auto`` goes through ``resolve_kernel``)."""
    if name not in _KERNELS:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(_KERNELS)}")
    return _KERNELS[name]


def resolve_kernel(name: str, height: int, width: int,
                   topology: Topology = SINGLE_DEVICE) -> Kernel:
    """``auto`` -> ``packed`` where the local shard shape packs, else
    ``lax``."""
    if name != "auto":
        return get_kernel(name)
    packed = _KERNELS["packed"]
    return packed if packed.supports(height, width, topology) else _KERNELS["lax"]
