"""Flight recorder: the last N spans/events, dumped when something dies.

The port's copy of ``gol_tpu/obs/recorder.py``, same dump format.

The reference leaves NOTHING behind when a run hangs or crashes — four
numbers print at the end or never. This module gives every entry point a
post-mortem story: armed with ``install(dir)``, the process dumps its recent
trace ring (obs/trace.py) plus the global metrics registry (obs/registry.py)
as one JSONL file

- on **crash** — an uncaught exception reaching ``sys.excepthook``
  (including ``resilience.faults.InjectedCrash``, which no library layer
  may catch);
- on **fault-injection trigger** — ``resilience/faults.py`` calls
  ``trigger()`` right before it kills the process (covers ``kill_mode=
  sigkill``, where no Python unwinding ever happens);
- on **SIGUSR1** — a live, non-fatal dump: ``kill -USR1 <pid>`` answers
  "what is that hung server doing?" without stopping it.

Dump format (one JSON object per line, torn-tail tolerant like the job
journal): a header record ``{"record": "header", ...}`` with the reason and
the tracer anchors, one ``{"record": "span", ...}`` per retained span, one
``{"record": "state", "name": ..., ...}`` per registered state provider
(live subsystem snapshots — e.g. the async checkpoint writer's queue, so a
post-mortem shows whether a payload write was in flight), and a final
``{"record": "registry", ...}`` carrying the counter snapshot.
``gol trace-report`` renders these files directly.

File naming is wall-clock-free (the package-wide lint ban): ``flight-<pid>-
<seq>.jsonl``, the sequence a process-local counter — repeated SIGUSR1
dumps of one process never overwrite each other.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading

from gol_tpu_torch.obs import registry, trace

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_dir: str | None = None
_seq = 0
_prev_excepthook = None
# Hook installation is tracked separately from arming: uninstall() only
# disarms (_dir = None) and leaves the hooks chained — a re-install that
# keyed "first" off _dir would chain sys.excepthook to ITSELF, and the next
# uncaught exception would recurse through the hook dumping files forever.
_hooks_installed = False
# Live-state providers: name -> zero-arg callable returning a JSON-able
# dict, snapshotted into every dump (each guarded — a provider that raises
# mid-crash is skipped, never allowed to abort the dump documenting the
# crash). Subsystems with in-flight state the registry's scalars cannot
# carry (the async checkpoint writer's pending generation) register here.
_state_providers: dict[str, object] = {}


def add_state_provider(name: str, fn) -> None:
    """Register ``fn`` to contribute a ``{"record": "state"}`` line to every
    dump. Last registration under a name wins (a fresh writer replaces a
    stale one's entry)."""
    with _lock:
        _state_providers[name] = fn


def remove_state_provider(name: str) -> None:
    with _lock:
        _state_providers.pop(name, None)


def armed() -> bool:
    return _dir is not None


def install(directory: str) -> None:
    """Arm the recorder: dumps land in ``directory``; the excepthook chain
    and (when possible) the SIGUSR1 handler are installed once per process
    (re-arming after ``uninstall`` just updates the directory)."""
    global _dir, _prev_excepthook, _hooks_installed
    os.makedirs(directory, exist_ok=True)
    with _lock:
        _dir = directory
        if _hooks_installed:
            return
        _hooks_installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    try:
        import signal

        # Only the main thread may install signal handlers; embedders that
        # arm the recorder from a worker just do without the SIGUSR1 lane.
        signal.signal(signal.SIGUSR1, _on_sigusr1)
    except (ValueError, OSError, AttributeError):  # non-main thread / platform
        logger.debug("flight recorder: SIGUSR1 handler not installed")


def uninstall() -> None:
    """Disarm (tests). The excepthook chain stays; it no-ops unarmed."""
    global _dir
    with _lock:
        _dir = None


def trigger(reason: str) -> str | None:
    """Dump now (fault-injection trigger, or any caller-decided moment).
    Returns the dump path, or None when unarmed. Never raises: a failing
    dump must not mask the crash it is trying to document."""
    global _seq
    with _lock:
        directory = _dir
        if directory is None:
            return None
        _seq += 1
        path = os.path.join(directory, f"flight-{os.getpid()}-{_seq}.jsonl")
    try:
        return _dump(path, reason)
    except Exception as err:  # noqa: BLE001 - the crash path must survive us
        logger.error("flight recorder dump failed: %s: %s",
                     type(err).__name__, err)
        return None


def _dump(path: str, reason: str) -> str:
    t = trace.tracer()
    with open(path, "w", encoding="utf-8") as f:
        header = {
            "record": "header",
            "reason": reason,
            **t.metadata(),
        }
        f.write(json.dumps(header) + "\n")
        for span in t.snapshot():
            f.write(json.dumps({"record": "span", **span}) + "\n")
        with _lock:
            providers = dict(_state_providers)
        for name, fn in providers.items():
            try:
                f.write(json.dumps(
                    {"record": "state", "name": name, **fn()}) + "\n")
            except Exception:  # noqa: BLE001 - a provider must not kill a dump
                logger.debug("flight recorder: state provider %r failed", name)
        f.write(json.dumps({
            "record": "registry",
            **registry.default().snapshot(),
        }) + "\n")
        f.flush()
        os.fsync(f.fileno())
    logger.warning("flight recorder: dumped %s (%s)", path, reason)
    return path


def _excepthook(exc_type, exc, tb):
    if armed() and exc_type is not SystemExit:
        trigger(f"crash: {exc_type.__name__}: {exc}")
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _on_sigusr1(signum, frame):
    trigger("SIGUSR1")


def read_dump(path: str) -> list[dict]:
    """Parse a flight-recorder JSONL file, dropping a torn tail line (the
    dump may itself have died mid-write — the journal's leniency rule)."""
    records = []
    with open(path, "rb") as f:
        for line in f.read().split(b"\n"):
            if not line:
                continue
            try:
                records.append(json.loads(line.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue
    return records
