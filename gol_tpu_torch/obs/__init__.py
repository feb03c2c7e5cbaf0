"""Observability for the port: the counterpart of ``gol_tpu/obs/``.

- ``obs.registry``: the process's counters, gauges and histograms (copied);
- ``obs.trace``: span tracing into a ring buffer, Chrome trace export
  (copied);
- ``obs.recorder``: the flight recorder's post-mortem dumps (copied);
- ``obs.profiler``: device fences, ``torch.profiler`` capture and the
  kernel device-time readings of the roofline tool (ported).

The rest of the JAX package's ``obs/`` (timeline, SLOs, sampler, history,
reports, the CLI's ``--profile``) is not ported yet.
"""
