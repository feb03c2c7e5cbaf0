"""Trace-context propagation: one trace id across the router/worker hop.

The port's copy of ``gol_tpu/obs/propagate.py`` (stdlib only). Each
process has a span ring and ties a job's lifecycle to its batch spans
with flow events, but every id is process-local, so a fleet trace
stitched from N processes shows N disconnected lanes. This module defines
the ONE wire contract that joins them:

- the router stamps an ``X-Gol-Trace`` header onto every forwarded
  ``POST /jobs`` **while tracing is enabled** (``gol fleet --trace``) and
  records a flow *start* under the carried trace id at forward time;
- a worker whose tracing is enabled adopts the header's trace id as the
  job's flow id (``Job.trace``, process-local like the perf_counter
  stamps), so its claim/finish flow points and batch spans chain onto the
  router's — one Perfetto arrow from the router's placement decision into
  the worker slice that served the job.

Degradation is the contract's other half, pinned by tests:

- tracing disabled (the default): the router adds NO header and allocates
  nothing; the worker never looks past a dict ``.get`` — byte-identical
  requests and responses to the pre-propagation tree;
- new router -> old worker: the unknown header is ignored by stdlib HTTP
  servers; the forwarded body is the client's bytes verbatim either way;
- old client -> new worker: no header, ``extract`` returns None, the job
  flows under its own id exactly as before;
- a malformed header value (anything outside the token grammar below) is
  DROPPED, never an error: propagation is telemetry, and telemetry must
  not be able to 400 a job.

The header value is ``<trace>/<parent>``: ``trace`` the flow id shared by
every process on the job's path, ``parent`` the sender's span label (the
router stamps ``router-<pid>``) — carried as a span attribute on the
adopting side, never parsed further.
"""

from __future__ import annotations

import os
import re
import uuid

TRACE_HEADER = "X-Gol-Trace"

# -- deadline propagation ----------------------------------------------------
#
# ``X-Gol-Deadline`` carries a job's REMAINING latency budget in seconds —
# stamped by `gol submit --timeout`, decremented by the router for its own
# elapsed time before each forward hop, enforced at router forward, worker
# admission, and batch dispatch (serve/scheduler). It rides this module
# because it is the same kind of contract as X-Gol-Trace: a hop-by-hop
# header whose ABSENCE must be byte-identical to the pre-header tree
# (old client -> new server: no header, no budget, today's behavior;
# new client -> old server: the unknown header is ignored by stdlib HTTP
# servers) and whose malformed values DROP silently — a deadline is an
# optimization contract, and a corrupt header must never 400 a job.
# The value is a plain decimal seconds-remaining (not an absolute time):
# wall clocks across a fleet disagree, but "you have 1.25s left" survives
# any hop unskewed modulo network transit, which only ever shortens it.

DEADLINE_HEADER = "X-Gol-Deadline"


def encode_deadline(seconds: float) -> str:
    """The header value for a remaining budget of ``seconds``."""
    return f"{float(seconds):.6f}"


def decode_deadline(value) -> float | None:
    """Header value -> remaining seconds, or None for anything absent or
    malformed (the degrade-to-nothing rule; negative and zero values are
    VALID — they mean "already expired")."""
    if not value or not isinstance(value, str):
        return None
    try:
        budget = float(value.strip())
    except ValueError:
        return None
    if budget != budget or budget in (float("inf"), float("-inf")):
        return None
    return budget

# Token grammar for each half of the header value. Deliberately tight:
# these strings end up as Perfetto flow ids and span attributes, and a
# hostile/corrupt value must degrade to "no context", not ride into
# exports.
_TOKEN = re.compile(r"[A-Za-z0-9._-]{1,64}")


def new_trace_id() -> str:
    """A fresh fleet-wide trace id (one per routed submit)."""
    return uuid.uuid4().hex[:16]


def encode(trace_id: str, parent: str | None = None) -> str:
    """The header value carrying ``trace_id`` (and the sender label)."""
    if not _TOKEN.fullmatch(trace_id):
        raise ValueError(f"trace id {trace_id!r} is not a valid token")
    if parent is None:
        return trace_id
    if not _TOKEN.fullmatch(parent):
        raise ValueError(f"parent {parent!r} is not a valid token")
    return f"{trace_id}/{parent}"


def decode(value) -> tuple[str, str | None] | None:
    """Parse a header value -> (trace_id, parent), or None for anything
    absent or malformed (the degrade-to-nothing rule)."""
    if not value or not isinstance(value, str):
        return None
    trace_id, sep, parent = value.partition("/")
    if not _TOKEN.fullmatch(trace_id):
        return None
    if not sep:
        return trace_id, None
    if not _TOKEN.fullmatch(parent):
        return None
    return trace_id, parent


def sender_label() -> str:
    """The ``parent`` token a forwarding process stamps (the router)."""
    return f"router-{os.getpid()}"


__all__ = ["DEADLINE_HEADER", "TRACE_HEADER", "decode", "decode_deadline",
           "encode", "encode_deadline", "new_trace_id", "sender_label"]
