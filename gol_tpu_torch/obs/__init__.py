"""Observability for the port: the counterpart of ``gol_tpu/obs/``.

- ``obs.registry``: the process's counters, gauges and histograms (copied);
- ``obs.trace``: span tracing into a ring buffer, Chrome trace export
  (copied); the CLI's ``--trace DIR`` arms it, with JAX's span names on
  JAX's sites and the engine's own ``engine.run`` span a runner call.
  While a ``torch.profiler`` capture records, every span is also a
  profiler range, and ``trace.range`` opens ranges alone (the engine's
  ``engine.launch``, ``engine.readback`` and ``engine.replay`` a block),
  on the clock of the device's kernels;
- ``obs.recorder``: the flight recorder's post-mortem dumps (copied);
- ``obs.profiler``: device fences, the CLI's guarded ``--profile``
  capture (``torch.profiler``), and the kernel device-time readings of
  the roofline tool (ported);
- ``obs.report``: ``gol trace-report``'s rendering of a trace export or a
  flight dump (copied);
- ``obs.history``: the durable metrics-history ring and ``gol
  history-report``'s rendering (copied);
- ``obs.slo``: service-level objectives and ``gol slo-report``'s
  rendering (copied);
- ``obs.sampler``: the server's background SLO and dispatch-gap ticks,
  ``obs.timeline``: a job's milestones and segments, ``obs.propagate``:
  the trace and deadline headers (copied);
- ``obs.top``: ``gol top``'s live dashboard over a server's ``/metrics``
  and ``/slo`` (copied), and ``obs.fleettrace``: ``gol fleet-trace``'s one
  timeline stitched from every process's ring (copied, over the port's
  HTTP client).
"""
