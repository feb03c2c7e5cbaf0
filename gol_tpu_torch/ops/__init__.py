"""Compute kernels of the port: the byte ``lax`` stencil, the byte
``pallas`` kernel and the ``packed`` word kernels.

The port of ``gol_tpu/ops/__init__.py`` for one device. ``auto`` resolves to
``packed`` wherever the width packs into 32-bit words and to ``lax``
otherwise; ``pallas`` (K4) runs only when named, as JAX's ``auto`` never
reaches it off a TPU and prefers the packed kernel on one. There is no
fallback ladder: a kernel that fails to build or to launch raises, and the
run stops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from gol_tpu_torch.ops import stencil_lax, stencil_packed, stencil_pallas


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A named evolve implementation.

    ``step`` (cells -> cells) is the per-generation form of a kernel without
    fused flags. The fused forms write into caller-owned buffers and OR
    their flags into a caller-zeroed int32 buffer (see ``stencil_packed``):
    ``fused`` one generation with ``(alive, differs)``, ``fused_multi``
    ``multi_gens`` generations with the pass summary, ``exact_multi`` the
    same pass with per-generation flags. ``encode``/``decode`` carry the
    uint8 grid to the kernel's own state (packed words) and back, once per
    run.
    """

    name: str
    step: Callable | None = None
    fused: Callable | None = None
    fused_multi: Callable | None = None
    exact_multi: Callable | None = None
    multi_gens: int = 1
    supports: Callable = lambda height, width: True
    encode: Callable | None = None
    decode: Callable | None = None
    load: Callable | None = None  # builds/loads the card's kernels


_KERNELS = {
    "lax": Kernel(name="lax", step=stencil_lax.evolve_torus),
    "pallas": Kernel(
        name="pallas",
        fused=stencil_pallas._step_into,
        supports=stencil_pallas.supports,
        load=stencil_pallas.load_kernels,
    ),
    "packed": Kernel(
        name="packed",
        fused=stencil_packed._step_into,
        fused_multi=stencil_packed._step_t_fast_into,
        exact_multi=stencil_packed._step_t_into,
        multi_gens=stencil_packed.TEMPORAL_GENS,
        supports=stencil_packed.supports,
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


def resolve_kernel(name: str, height: int, width: int) -> Kernel:
    """``auto`` -> ``packed`` where the shape packs, else ``lax``."""
    if name != "auto":
        return get_kernel(name)
    packed = _KERNELS["packed"]
    return packed if packed.supports(height, width) else _KERNELS["lax"]
