"""The serving stack: the job model, its journal, the padding-bucket
batcher, the scheduler and the HTTP server.

The port of ``gol_tpu/serve/``:

- ``jobs``       — the ``Job`` record, its QUEUED -> ... -> DONE state
                   machine, and the crash-safe append-only journal (the
                   JAX package's on-disk format);
- ``compaction`` — journal segmentation and snapshot compaction (the
                   ``compact`` subcommand);
- ``batcher``    — groups compatible jobs into padding buckets and drives
                   the batched engine (``engine.simulate_batch``, on the
                   batched kernels B1 and B2; the ``batch`` subcommand);
- ``metrics``    — the serving registry (``gol_serve_*``), byte-stable in
                   Prometheus text;
- ``scheduler``  — admission, flush by size/age/deadline/drain, dispatch
                   order, cancel, the result cache's consult and in-flight
                   coalescing, per-batch retry, worker pools and the
                   pipelined dispatcher/completer pair;
- ``resident``   — the resident ring lanes (``serve --resident-ring R``):
                   per-bucket rings of preallocated slots over
                   ``engine.RingRunner``, refilled on a copy stream while a
                   drain runs on the lane's thread;
- ``server``     — the stdlib HTTP API over the scheduler (the ``serve``
                   subcommand; ``submit`` is its client).

``jobs``, ``compaction`` and ``metrics`` are numpy/stdlib-only; torch
comes in with ``batcher``.
"""
