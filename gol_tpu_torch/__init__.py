"""gol_tpu_torch — the PyTorch/CUDA port of gol_tpu, for NVIDIA H100 cards.

The same CLI contract, text grid format, B3/S23 toroidal semantics and
early-exit accounting as the JAX package, which stays beside it as the
reference, on one card or over a mesh of shards (``parallel/``), with the
crash-safe checkpoint lane (``resilience/``, ``pipeline/``, ``obs/``). Every
TPU kernel of the repo (K1-K14) is a hand-written CUDA kernel for Hopper
(``csrc/``), built with nvcc at first use and bound with ctypes; each has a
plain torch version that the CPU path runs. K14 serves the flag-cost
roofline (``tools/roofline.py``). The packed-I/O text codec
(``native/codec.c``) builds the same way with cc. The serving stack
(``serve/``: the batcher, journal, scheduler and HTTP server, on the
port's batched kernels B1 and B2), the result cache (``cache/``) and the
packed wire format (``io/wire.py``) speak the JAX package's formats, so
journals, CAS directories and clients move between the packages. The port
imports neither ``jax`` nor ``gol_tpu``.
"""

from gol_tpu_torch.config import DEFAULT_CONFIG, GEN_LIMIT, SIMILARITY_FREQUENCY, GameConfig
from gol_tpu_torch.oracle import Result, evolve as oracle_evolve, run as oracle_run

__version__ = "0.1.0"

__all__ = [
    "GameConfig",
    "DEFAULT_CONFIG",
    "GEN_LIMIT",
    "SIMILARITY_FREQUENCY",
    "oracle_evolve",
    "oracle_run",
    "Result",
]
