"""Autotuning and the persistent plan cache: measured kernel and layout
choices.

The port of ``gol_tpu/tune/``. The choices the engine and the serve batcher
otherwise take from built-in ladders — kernel flavor, temporal depth,
termination block, the batcher's padding quantum, batch-size ladder and
batched depth — become measured ones, made once offline (``python -m
gol_tpu_torch tune``) and reused:

- ``space``   — the declarative search space, validity-filtered per
  (shape, convention, mesh, device);
- ``measure`` — timed trials (``perf_counter`` only, warmup and
  outlier-trimmed medians) behind a byte-exact correctness gate;
- ``plans``   — the persistent JSON plan cache: stable fingerprints (torch,
  CUDA and the device's name in place of JAX's version), atomic writes,
  bundled defaults; the file's schema is the JAX package's, and either
  package keeps the other's entries;
- ``select``  — the runtime consult: the engine and the serve batcher ask
  here (bit-identical behavior when no plan exists).

``plans`` and ``select`` are stdlib/torch-only; ``measure`` pulls the
engine and is imported only by the `tune` subcommand.
"""
