"""Per-job timelines: the milestone/segment vocabulary of the serving path.

The port's copy of ``gol_tpu/obs/timeline.py`` (stdlib only). The
reference instruments whole-program phases (include/timestamp.h wraps
read/execute/write once per run); spans instrument *regions* of the
server. Neither answers the operator's question for ONE request: *where did
this job's latency go?* This module defines the causal decomposition every
``Job`` carries from ``POST /jobs`` to its journaled DONE:

milestones (``time.perf_counter()`` stamps, process-local, stamped by the
scheduler identically across the classic depth-1, pipelined
(``--pipeline-depth``), and resident-ring lanes)::

    accepted        admission succeeded (journal submit record durable)
    claimed         a forming batch took the job (batch formation ended)
    stage_start     host staging began (stack + packbits)
    staged          host staging done
    dispatched      async device dispatch posted
    readback_start  the completer began blocking on device results
    completed       device results fetched and cropped
    done            job transitioned DONE (results visible to clients)
    journaled       the terminal journal record hit disk (may trail ``done``
                    in resident mode, where journaling rides a writer thread)

segments are the gaps between consecutive *present* milestones — jobs on an
injected ``run_batch`` (no stage/dispatch split) simply have fewer — so the
segment sum from ``accepted`` to ``done`` equals the measured end-to-end
latency *exactly*, by construction (test-pinned). The ``journal`` segment
sits past ``done`` and is reported separately as ``journal_lag_seconds``.

Served as ``GET /jobs/<id>/timeline``, printed by ``gol submit`` on
completion, and (with tracing on) mirrored into the Chrome export as flow
events (``obs.trace.flow``) tying each job to the batch spans it rode.
"""

from __future__ import annotations

# Milestone order IS the contract: stamps must be monotonic along this list
# (a retry re-stamps its dispatch/readback milestones, still before `done`).
MILESTONES = (
    "accepted",
    "claimed",
    "stage_start",
    "staged",
    "dispatched",
    "readback_start",
    "completed",
    "done",
    "journaled",
)

# The segment *ending* at each milestone (the time since the previous
# present milestone). Names follow the latency decomposition: queue-wait,
# batch-formation wait, stage, dispatch, device, readback, finalize, journal.
SEGMENT_ENDING_AT = {
    "claimed": "queue_wait",
    "stage_start": "batch_form",
    "staged": "stage",
    "dispatched": "dispatch",
    "readback_start": "device",
    "completed": "readback",
    "done": "finalize",
    "journaled": "journal",
}


def segments(timeline: dict) -> dict[str, float]:
    """Decompose a milestone dict into named segments (seconds).

    Only consecutive *present* milestones produce a segment, so partial
    timelines (in-flight jobs, injected engines with no split) stay
    well-formed and the sum of the segments up to ``done`` always equals
    ``done - accepted``.
    """
    out: dict[str, float] = {}
    prev = None
    for name in MILESTONES:
        t = timeline.get(name)
        if t is None:
            continue
        if prev is not None:
            out[SEGMENT_ENDING_AT[name]] = t - prev
        prev = t
    return out


def summary(timeline: dict) -> dict:
    """The JSON-able view ``GET /jobs/<id>/timeline`` serves.

    Milestones are reported relative to ``accepted`` (perf_counter values
    are process-local and meaningless on the wire); ``total_seconds`` is the
    end-to-end latency (accepted -> done) and ``journal_lag_seconds`` how
    far the durable done record trailed it (0 inline, > 0 on the resident
    lanes' journal writer thread)."""
    t0 = timeline.get("accepted")
    out: dict = {
        "milestones": (
            {n: timeline[n] - t0 for n in MILESTONES if n in timeline}
            if t0 is not None
            else {}
        ),
        "segments": segments(timeline),
    }
    done = timeline.get("done")
    if t0 is not None and done is not None:
        out["total_seconds"] = done - t0
    journaled = timeline.get("journaled")
    if done is not None and journaled is not None:
        out["journal_lag_seconds"] = max(0.0, journaled - done)
    return out
