"""Crash safety: atomic checkpoints, auto-resume, fault injection and the
unified retry policy.

The port's counterpart of ``gol_tpu/resilience/``. ``faults``, ``retry``,
``fsio`` and ``diskguard`` are copies of the JAX package's JAX-free
modules; ``checkpoint`` is ported onto the port's state (one tensor, or
the row-major list of a mesh's shards) and is imported lazily by its
callers, so it is not re-exported here.
"""

from gol_tpu_torch.resilience.faults import FaultPlan, InjectedCrash
from gol_tpu_torch.resilience.retry import (DEFAULT_IO_RETRY, RetryPolicy,
                                            is_transient_io)

# Two-phase-commit staging suffixes, shared by every writer that stages an
# overwrite (io/packed_io) and by the checkpoint GC that sweeps stale
# leftovers (resilience/checkpoint._gc): one definition, or the sweep
# silently stops matching the writers.
STAGING_SUFFIX = ".inprogress"
REPLACED_SUFFIX = ".replaced"

__all__ = [
    "DEFAULT_IO_RETRY",
    "FaultPlan",
    "InjectedCrash",
    "REPLACED_SUFFIX",
    "RetryPolicy",
    "STAGING_SUFFIX",
    "is_transient_io",
]
