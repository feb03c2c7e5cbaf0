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

There is no fallback ladder: a kernel that fails to build or to launch
raises, and the run stops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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
    return [stencil_lax.evolve_padded(p) for p in halo.exchange(shards, topology.shape)]


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
