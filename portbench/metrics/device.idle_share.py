"""device.idle_share (%): the share of a simulation in which no kernel,
copy or set ran on the card: 1 - the mean device busy time inside a
profiled simulation over the mean host time of the simulations that ran
after the profiled head (without the profiler's own host work)."""


def read(r):
    t, host = r.trace, r.untraced_sim_s()
    if t is None or not t.sim_device_s or not host:
        return None
    device = sum(t.sim_device_s) / len(t.sim_device_s)
    return 100 * (1 - device / (sum(host) / len(host)))
