"""kernels.roofline_share (%): a simulation's least time on the card
(``portbench/roofline.py``, from its shape and generations) over the
device's busy time per traced simulation."""

from portbench import roofline


def read(r):
    t = r.trace
    if t is None or not r.generations or not any(t.sim_device_s):
        return None
    gens = sum(r.generations) / len(r.generations)
    least, _ = roofline.least_seconds(r.height, r.width, gens)
    return 100 * least / (sum(t.sim_device_s) / len(t.sim_device_s))
