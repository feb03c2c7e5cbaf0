"""engine.turnaround_ms_per_sim (ms): the card with nothing queued because
the engine's host loop has not yet handed it the next block: the mean
``turnaround_s`` of the program's ``engine.run`` spans (one a runner call:
from each flag readback the loop acts on to the next block's enqueue, or
to the call's end) over the window's simulations after the profiled head.
The window's spans are the last ones, one a simulation; the set-up's
calls come before them, and a ring that lost its oldest spans still ends
with the window's last."""


def read(r):
    n = len(r.sim_s)
    runs = [s for s in r.spans if s["name"] == "engine.run"][-n:] if n else []
    first = n - len(runs)  # the simulation of runs[0]
    untraced = runs[max(0, r.traced_sims - first):]
    if not untraced:
        return None
    return 1e3 * sum(s["attrs"]["turnaround_s"] for s in untraced) / len(untraced)
