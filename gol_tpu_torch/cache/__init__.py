"""Content-addressed result cache: repeat traffic answered in O(1).

The port's copy of ``gol_tpu/cache/``. Every finished result is keyed by a
decomposition-independent fingerprint of the *question* —
``fingerprint(board, convention, gen_limit, similarity config)``, equal to
the JAX package's for the same job — and repeats are served from a tiered
data plane:

1. **in-process LRU** (``store.MemoryLRU``) — bounded, O(1), dies with the
   process;
2. **on-disk CAS** (``store.DiskCAS``) — content-addressed files committed
   with the atomic staging discipline (temp + fsync + ``os.replace``),
   CRC-gated on read: a torn or corrupted entry is loudly evicted and the
   engine re-runs. The directory layout is the JAX package's, so a CAS
   written by one package reads in the other. ``gc`` keeps it under a byte
   budget (``cache/gc.py``).

Durability contract: the cache is an **accelerator, never a source of
truth**. A cache hit is journaled as a normal DONE record (exactly-once and
replay semantics unchanged); losing any cache tier costs re-computation,
never correctness — journal replay always wins.
"""

from gol_tpu_torch.cache.fingerprint import (  # noqa: F401
    board_digest,
    body_fingerprint,
    result_fingerprint,
)
from gol_tpu_torch.cache.store import CacheEntry, DiskCAS, MemoryLRU  # noqa: F401
from gol_tpu_torch.cache.tiered import ResultCache  # noqa: F401

__all__ = [
    "CacheEntry",
    "DiskCAS",
    "MemoryLRU",
    "ResultCache",
    "board_digest",
    "body_fingerprint",
    "result_fingerprint",
]
