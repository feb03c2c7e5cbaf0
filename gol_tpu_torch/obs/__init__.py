"""Observability for the port: the counterpart of ``gol_tpu/obs/``.

- ``obs.registry``: the process's counters, gauges and histograms (copied);
- ``obs.trace``: span tracing into a ring buffer, Chrome trace export
  (copied); the CLI's ``--trace DIR`` arms it, with JAX's span names on
  JAX's sites;
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
  the trace and deadline headers (copied).

Not ported yet, as they only read a live fleet: top (``gol top``) and
fleettrace (``gol fleet-trace``).
"""
