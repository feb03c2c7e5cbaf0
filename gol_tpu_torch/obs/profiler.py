"""Device fences, ``torch.profiler`` capture and kernel device times.

The port's counterpart of ``gol_tpu/obs/profiler.py`` and of
``tools/measure.py``'s ``_device_time_per_pass``:

- ``fence(*tensors)``: block until the work queued on the tensors' devices
  is done. PyTorch returns before the card finishes, so a host clock read
  without a fence times the enqueue.
- ``capture(dir)``: a ``torch.profiler`` capture with CUDA activity; with a
  directory, the Chrome trace lands in it (open in Perfetto).
- ``kernel_device_ms(fn, n, names)``: the summed device time of the CUDA
  kernels whose names contain one of ``names``, per call of ``fn``, over
  ``n`` calls in one capture. Where the JAX package's extraction is best
  effort and returns None, this raises when the capture holds no matching
  kernel: a measurement that read nothing must stop the tool, not carry
  on without its number.
- ``graph_ms(fn, x, y, pairs)``: ``2 * pairs`` ping-pong calls of a kernel
  wrapper captured in one CUDA graph and replayed between two CUDA events,
  so the card and not the host's launch rate sets the time
  (``chip_smoke.py`` phase 5 and ``tools/roofline.py`` share it);
  ``ring_graph_ms`` the same over a ring of shards, each with its own
  buffers, launched in turn as a mesh launches them — so that where the
  shards together exceed the L2 cache, no launch finds its input there
  from its own previous launch.

Every timing here needs a card and raises without one.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def fence(*tensors) -> None:
    """Synchronize every CUDA device that holds one of ``tensors`` (nested
    lists and tuples allowed); CPU tensors and other values are ready."""
    devices = set()

    def walk(values):
        for v in values:
            if isinstance(v, (list, tuple)):
                walk(v)
            elif isinstance(v, torch.Tensor) and v.device.type == "cuda":
                devices.add(v.device)

    walk(tensors)
    for device in devices:
        torch.cuda.synchronize(device)


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card; torch sees none")


@contextlib.contextmanager
def capture(profile_dir: str | None = None):
    """``with capture(dir) as prof: ...``: a ``torch.profiler`` capture of
    CPU and CUDA activity. With ``profile_dir`` the Chrome trace is
    written to ``<profile_dir>/trace.json`` when the block ends cleanly."""
    _require_card()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def kernel_device_ms(fn, n: int, names, profile_dir: str | None = None) -> float:
    """Device ms per call of ``fn`` summed over the kernels named like
    ``names``, from one capture of ``n`` calls after one warm call.
    Raises if the capture holds no such kernel."""
    _require_card()
    fn()
    torch.cuda.synchronize()
    from torch.autograd import DeviceType

    with capture(profile_dir) as prof:
        for _ in range(n):
            fn()
    kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and any(name in e.name for name in names)]
    if not kernel_us:
        raise RuntimeError(
            f"the profiler captured no CUDA kernel named like {list(names)} "
            f"over {n} calls; no device time to report")
    return sum(kernel_us) / 1e3 / n


def graph_ms(fn, x: torch.Tensor, y: torch.Tensor, pairs: int) -> tuple[float, float]:
    """``(ms, wrapper_ms)`` per call of ``fn(src, dst)``: ``2 * pairs``
    ping-pong calls captured in one CUDA graph on the stream the wrappers
    launch on, then replayed between two events, so the host issues one
    launch for all of them and the card sets the time. While capturing
    nothing runs, so the host's time per call there is the wrapper's own
    (its checks and the ctypes call)."""
    return ring_graph_ms(lambda i, a, b: fn(a, b), [x], [y], 2 * pairs)


def run_ring(fn, srcs, dsts, rounds: int) -> None:
    """``rounds`` rounds of ``fn(i, src, dst)`` over a ring of shards: each
    round calls it once per shard ``i`` in order, from ``srcs[i]`` into
    ``dsts[i]``, and the next round runs back (the two swap), as a mesh's
    generations do."""
    a, b = srcs, dsts
    for _ in range(rounds):
        for i in range(len(a)):
            fn(i, a[i], b[i])
        a, b = b, a


def ring_graph_ms(fn, srcs, dsts, rounds: int) -> tuple[float, float]:
    """``(ms, wrapper_ms)`` per call of ``fn(i, src, dst)`` over
    ``run_ring``'s calls, timed as ``graph_ms``."""
    _require_card()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t0 = time.perf_counter()
        run_ring(fn, srcs, dsts, rounds)
        wrapper_ms = (time.perf_counter() - t0) * 1e3 / (rounds * len(srcs))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(srcs)), wrapper_ms
