"""engine.readbacks_per_sim (count): the engine's host reads of device
flags a simulation, each a sync that drains the card's queue: the
program's ``engine_readbacks_total`` counter over the window, per
simulation."""


def read(r):
    readbacks = r.counters.get("engine_readbacks_total")
    if readbacks is None or not r.generations:
        return None
    return readbacks / len(r.generations)
