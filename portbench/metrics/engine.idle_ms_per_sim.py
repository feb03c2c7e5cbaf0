"""engine.idle_ms_per_sim (ms): the card waiting on the engine's host loop
(flag readbacks, replays, launches) a simulation: the mean host time of
the window's simulations that ran after the profiled head, less the mean
device busy time inside a profiled one. The host time is taken without
the profiler, whose own host work would count as idle; the device time
can only come from its trace."""


def read(r):
    t, host = r.trace, r.untraced_sim_s()
    if t is None or not t.sim_device_s or not host:
        return None
    device = sum(t.sim_device_s) / len(t.sim_device_s)
    return 1e3 * (sum(host) / len(host) - device)
