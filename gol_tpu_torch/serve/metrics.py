"""Serving metrics: a thin façade over the obs registry.

The port's copy of ``gol_tpu/serve/metrics.py``: ``Metrics`` (prefix
``gol_serve``), exported by the server as ``snapshot()`` JSON and
``prometheus()`` text. Both output contracts are byte-stable and equal the
JAX package's for the same series (test-pinned).

Latency sources are ``time.perf_counter()`` exclusively.
"""

from __future__ import annotations

from gol_tpu_torch.obs.registry import QUANTILES, Registry, _fmt  # noqa: F401
from gol_tpu_torch.obs.registry import Histogram as _Histogram  # noqa: F401


class Metrics(Registry):
    """Registry of named counters, gauges, and histograms (serving prefix)."""

    def __init__(self, prefix: str = "gol_serve"):
        super().__init__(prefix=prefix)
