"""ops.launches_per_sim (count): the program's kernel launches
(``gol_tpu_torch.ops.stencil_packed.LAUNCHES``) over the window, per
simulation."""


def read(r):
    if not r.generations or not r.launches:
        return None
    return sum(r.launches.values()) / len(r.generations)
