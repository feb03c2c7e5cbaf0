"""engine.launch_ms_per_sim (ms): the engine's host time enqueueing its
blocks a simulation: the mean ``launch_s`` of the program's ``engine.run``
spans (one a runner call: the host time from each block's flag fill
through its last pass or tail launch) over the window's simulations after
the profiled head. The window's spans are the last ones, one a
simulation; the set-up's calls come before them, and a ring that lost its
oldest spans still ends with the window's last."""


def read(r):
    n = len(r.sim_s)
    runs = [s for s in r.spans if s["name"] == "engine.run"][-n:] if n else []
    first = n - len(runs)  # the simulation of runs[0]
    untraced = runs[max(0, r.traced_sims - first):]
    if not untraced:
        return None
    return 1e3 * sum(s["attrs"]["launch_s"] for s in untraced) / len(untraced)
