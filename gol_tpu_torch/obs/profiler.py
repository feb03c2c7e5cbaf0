"""Device fences, ``torch.profiler`` capture and kernel device times.

The port's counterpart of ``gol_tpu/obs/profiler.py`` and of
``tools/measure.py``'s ``_device_time_per_pass``:

- ``fence(*tensors)``: block until the work queued on the tensors' devices
  is done. PyTorch returns before the card finishes, so a host clock read
  without a fence times the enqueue.
- ``capture(dir, device)``: the CLI's ``--profile DIR``, a guarded
  ``torch.profiler`` capture with JAX's contract (``gol_tpu/obs/
  profiler.py``): a falsy directory is a no-op; a start that fails logs
  and the run goes on unprofiled; stop runs once, also when the body
  raises; a body that raises sweeps what the capture created and keeps
  what was there. It records CPU activity, and CUDA activity where the
  run's device is a card; the Chrome trace lands in ``<dir>/trace.json``
  (JAX writes xplane there: each package writes its own format).
- ``kernel_device_ms(fn, n, names)``: the device time of the CUDA
  kernels whose names contain one of ``names``, per call of ``fn``, over
  ``n`` calls in one capture (taken again where CUPTI dropped kernel
  events). Where the JAX package's extraction is best effort and returns
  None, this raises when no capture holds a matching kernel: a
  measurement that read nothing must stop the tool, not carry on without
  its number.
- ``graph_ms(fn, x, y, pairs)``: ``2 * pairs`` ping-pong calls of a kernel
  wrapper captured in one CUDA graph and replayed between two CUDA events,
  so the card and not the host's launch rate sets the time
  (``chip_smoke.py`` phase 5 and ``tools/roofline.py`` share it);
  ``ring_graph_ms`` the same over a ring of shards, each with its own
  buffers, launched in turn as a mesh launches them — so that where the
  shards together exceed the L2 cache, no launch finds its input there
  from its own previous launch.

Every timing here needs a card and raises without one; ``capture``
follows the device it is given.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import time

import torch

logger = logging.getLogger(__name__)

# The range ``capture`` records around its body (a ``user_annotation``
# event in the Chrome trace): the profiled run's window, without the
# guard on either side of it.
CAPTURE_REGION = "gol.profiled_run"
CAPTURE_GUARD_S = 0.05
# The captures ``kernel_device_ms`` takes at most to find every kernel.
KERNEL_CAPTURES = 3


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
def capture(profile_dir: str | None, device):
    """Guarded ``torch.profiler`` capture of a run on ``device`` into
    ``profile_dir``: yields the profiler, or None when the directory is
    falsy or the capture failed to start. Guarantees, as JAX's:

    - a failing start degrades to an unprofiled run with a logged warning,
      never a crashed one;
    - stop runs exactly once, even when the body raises;
    - a body that raises leaves no torn capture: what the capture created
      is swept, entries that were there before stay.

    The body runs inside the ``CAPTURE_REGION`` range. On a card the
    capture is fenced and idles ``CAPTURE_GUARD_S`` before the body and
    after it (``_guard``), and the body's work is fenced before the stop,
    so every kernel it launched is in the trace."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # Entries already present (several runs pointed at one parent
    # directory) are not ours to sweep on failure.
    preexisting = set(os.listdir(profile_dir)) if os.path.isdir(profile_dir) else set()
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as err:  # noqa: BLE001 - profiling is best-effort
        logger.warning(
            "profiler capture into %s failed to start (%s: %s); "
            "running unprofiled", profile_dir, type(err).__name__, err,
        )
        prof = None
    guarded = prof is not None and device.type == "cuda"
    try:
        if guarded:
            _guard(device)
        region = (torch.profiler.record_function(CAPTURE_REGION)
                  if prof is not None else contextlib.nullcontext())
        with region:
            yield prof
            if guarded:
                torch.cuda.synchronize(device)
        if guarded:
            _guard(device)
    except BaseException:
        if prof is not None:
            try:
                prof.stop()
            except Exception:  # noqa: BLE001 - already on the error path
                pass
            _sweep_partial(profile_dir, preexisting)
        raise
    if prof is not None:
        try:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        except Exception as err:  # noqa: BLE001 - capture is best-effort
            logger.warning(
                "profiler capture into %s failed to stop cleanly "
                "(%s: %s); the trace may be incomplete",
                profile_dir, type(err).__name__, err,
            )
            _sweep_partial(profile_dir, preexisting)


def _guard(device) -> None:
    """Fence the card and let ``CAPTURE_GUARD_S`` pass, between the
    capture's start and the body's first launch and between the body's
    last kernel and the stop, so that every kernel of the body runs well
    inside the capture. Without it a capture of a mesh run was seen to
    hold all but its first dozen kernels, whose first kernel runs 1-3 ms
    after the start. The guard lies outside ``CAPTURE_REGION``."""
    torch.cuda.synchronize(device)
    time.sleep(CAPTURE_GUARD_S)


def _sweep_partial(profile_dir: str, preexisting: set) -> None:
    """Remove the entries a failed capture created (and the directory
    itself when the failed capture was its only content)."""
    try:
        for name in os.listdir(profile_dir):
            if name in preexisting:
                continue
            path = os.path.join(profile_dir, name)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        if not preexisting and not os.listdir(profile_dir):
            os.rmdir(profile_dir)
        logger.warning("profiler: swept torn capture from %s", profile_dir)
    except OSError:
        pass


def kernel_device_ms(fn, n: int, names, profile_dir: str | None = None) -> float:
    """Device ms per call of ``fn``, which launches one kernel named like
    ``names``: the mean device time of those kernels in a capture of ``n``
    calls after one warm call. CUPTI on the card has been seen to drop
    part or all of a capture's kernel events: a capture short of ``n`` of
    them is taken again, up to KERNEL_CAPTURES captures, and the fullest
    is read (and exported to ``profile_dir``). Raises if no capture holds
    such a kernel."""
    _require_card()
    fn()
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for capture in range(1, KERNEL_CAPTURES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(name in e.name for name in names)]
        if best is None or len(kernel_us) > len(best[1]):
            best = (prof, kernel_us)
        if len(kernel_us) >= n:
            break
        logger.warning("profiler: captured %d of the %d kernels named like %s "
                       "(capture %d of %d)", len(kernel_us), n,
                       list(names), capture, KERNEL_CAPTURES)
    prof, kernel_us = best
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    if not kernel_us:
        raise RuntimeError(
            f"the profiler captured no CUDA kernel named like {list(names)} "
            f"over {n} calls in {KERNEL_CAPTURES} captures; no device time "
            "to report")
    return sum(kernel_us) / len(kernel_us) / 1e3


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
