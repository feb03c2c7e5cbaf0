"""The serving stack's offline half: the job model, its journal and the
padding-bucket batcher.

The port of ``gol_tpu/serve/`` so far:

- ``jobs``       — the ``Job`` record, its QUEUED -> ... -> DONE state
                   machine, and the crash-safe append-only journal (the
                   JAX package's on-disk format);
- ``compaction`` — journal segmentation and snapshot compaction (the
                   ``compact`` subcommand);
- ``batcher``    — groups compatible jobs into padding buckets and drives
                   the batched engine (``engine.simulate_batch``; the
                   ``batch`` subcommand).

The scheduler, the HTTP server, the resident ring and the metrics are not
ported yet (ROADMAP.md Queue 1 item 4). ``jobs`` and ``compaction`` are
numpy/stdlib-only; torch comes in with ``batcher``.
"""
