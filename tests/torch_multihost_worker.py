"""Worker process of the port's multi-process tests (tests/test_torch_multihost.py).

The port's counterpart of ``tests/multihost_worker.py``: each OS process
joins the run through ``gol_tpu_torch.parallel.bootstrap.initialize`` (the
``MPI_Init`` analog, gloo over the CPU), contributes its shard slots
(``GOL_TORCH_MESH_DEVICES`` of them, default one) to an R x C mesh, reads
only its own windows of the input, runs the engine (halo exchanges and votes
crossing processes), and writes only its own windows of the shared output
files. Lanes ``lax``, ``packed``, ``mpi`` (the gathered lane) and
``packedio`` under the C convention, as JAX's worker runs them, and ``lax``
and ``packed`` under the CUDA convention; then unit checks of the
cross-process halo exchange and votes against their single-process forms
on the same shards, and the zarr store's lane (each rank writing its own
shards, a sharded read-back, and a staged overwrite whose shard write fails
on rank 1 only), written to ``units-<rank>.json``.

    python tests/torch_multihost_worker.py <port> <rank> <ranks> <workdir> <rows> <cols>
"""

from __future__ import annotations

import json
import os
import sys


def _lanes(workdir: str, mesh, rank: int):
    """Run the lanes; the packed lane's final word shards."""
    from gol_tpu_torch import engine
    from gol_tpu_torch.config import Convention, GameConfig
    from gol_tpu_torch.io import packed_io, sharded

    height = width = 64
    src = os.path.join(workdir, "input.txt")

    def record(lane: str, generations: int) -> None:
        if rank == 0:
            with open(os.path.join(workdir, f"torch_gens_{lane}.txt"), "w") as f:
                f.write(str(generations))

    for convention, tag in ((Convention.C, ""), (Convention.CUDA, "_cuda")):
        config = GameConfig(gen_limit=40, convention=convention)
        for kernel in ("lax", "packed"):
            grid = sharded.read_sharded(src, width, height, mesh=mesh)
            runner = engine.make_runner((height, width), config, kernel, mesh=mesh)
            final, gens = runner(grid)
            sharded.write_sharded(os.path.join(workdir, f"torch_out_{kernel}{tag}.txt"),
                                  final, mesh=mesh)
            record(kernel + tag, gens)

    config = GameConfig(gen_limit=40)
    grid = sharded.read_gathered(src, width, height, mesh=mesh)
    final, gens = engine.make_runner((height, width), config, "packed", mesh=mesh)(grid)
    sharded.write_gathered(os.path.join(workdir, "torch_out_mpi.txt"), final, mesh)
    record("mpi", gens)

    words = packed_io.read_packed(src, width, height, mesh=mesh)
    final, gens = engine.make_packed_runner((height, width), config, mesh=mesh)(words)
    packed_io.write_packed(os.path.join(workdir, "torch_out_packedio.txt"), final,
                           width, mesh)
    record("packedio", gens)
    return final


def _zarr(workdir: str, mesh, rank: int, words) -> dict:
    """The zarr store's multi-writer discipline under real processes (JAX's
    worker writes ``out_words.zarr`` and ``out_tsstore.txt`` alike): the
    lead creates, every rank writes only its shards, then a sharded
    read-back unpacked through the codec. Then a staged overwrite whose
    first shard write fails on rank 1 only: every rank must leave through
    the vote (rank 1 with its own error, the others naming the peer), and
    the live store must stay as it was."""
    import torch

    from gol_tpu_torch.io import packed_io, ts_store
    from gol_tpu_torch.resilience import faults

    height = width = 64
    store = os.path.join(workdir, "torch_out_words.zarr")
    ts_store.write_words(store, words, width, mesh)
    back = ts_store.read_words(store, width, height, mesh)
    packed_io.write_packed(os.path.join(workdir, "torch_out_tsstore.txt"), back,
                           width, mesh)
    if rank == 1:
        faults.install(faults.FaultPlan(ts_write_fail=1))
    err = ""
    try:
        ts_store.write_words(store, [torch.zeros_like(s) for s in words], width, mesh)
    except OSError as e:
        err = str(e)
    faults.clear()
    again = ts_store.read_words(store, width, height, mesh)
    want = "shard indices [0]" if rank == 1 else "a peer process failed"
    return {"zarr overwrite failure voted": want in err,
            "zarr live store kept": all(torch.equal(a, b) for a, b in zip(again, back))}


def _units(mesh, rank: int) -> dict:
    """Cross-process halo and votes against the single-process forms over
    every shard of the same grid (each rank builds all of them)."""
    import numpy as np
    import torch

    from gol_tpu_torch.parallel import collectives, halo
    from gol_tpu_torch.parallel.mesh import Mesh, split, topology_for

    topology = topology_for(mesh)
    everyone = Mesh(mesh.shape, (torch.device("cpu"),) * (mesh.shape[0] * mesh.shape[1]))
    out = {}
    rng = np.random.default_rng(11)
    grid = rng.integers(0, 2, (8 * mesh.shape[0] * 2, 8 * mesh.shape[1]),
                        dtype=np.uint8)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (16 * mesh.shape[0],
                                                        3 * mesh.shape[1]),
                                          dtype=np.int64).astype(np.int32))
    for what, state in (("cells", torch.from_numpy(grid)), ("words", words)):
        full = split(state, everyone)
        mine = split(state, mesh)
        for depth in (1, 8):
            want = halo.exchange_parts(full, mesh.shape, depth)
            got = halo.exchange_parts(mine, topology, depth)
            out[f"exchange_parts {what} depth {depth}"] = all(
                all(torch.equal(a, b) for a, b in zip(got[k], want[i]))
                for k, i in enumerate(mesh.local))
        want = halo.exchange(full, mesh.shape)
        got = halo.exchange(mine, topology)
        out[f"exchange {what}"] = all(torch.equal(got[k], want[i])
                                      for k, i in enumerate(mesh.local))
    # Votes: shard g's flags are (g == 1, g == 0); every shard differs but
    # the last.
    n = mesh.shape[0] * mesh.shape[1]
    flags = [torch.tensor([int(g == 1), int(g == 0), 0], dtype=torch.int32)
             for g in mesh.local]
    out["any_flag"] = collectives.any_flag(flags, topology).tolist() == [1, 1, 0]
    differs = [torch.tensor(g != n - 1) for g in mesh.local]
    out["all_agree false"] = not bool(collectives.all_agree(differs, topology))
    out["all_agree true"] = bool(collectives.all_agree(
        [torch.tensor(False)] * len(mesh.local), topology))
    out["host_all_agree true"] = collectives.host_all_agree(True)
    out["host_all_agree false"] = not collectives.host_all_agree(rank != 0)
    gathered = collectives.process_allgather(np.asarray([rank, 7 * rank], np.int64))
    out["process_allgather"] = gathered.tolist() == [[r, 7 * r] for r in
                                                     range(gathered.shape[0])]
    return out


def main() -> int:
    port, rank, ranks, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    rows, cols = int(sys.argv[5]), int(sys.argv[6])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["GOL_TORCH_DEVICE"] = "cpu"

    from gol_tpu_torch.parallel import bootstrap
    from gol_tpu_torch.parallel.mesh import make_mesh

    bootstrap.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=ranks, process_id=rank)
    assert bootstrap.process_count() == ranks and bootstrap.is_multihost()
    mesh = make_mesh(rows, cols)
    words = _lanes(workdir, mesh, rank)
    units = {**_units(mesh, rank), **_zarr(workdir, mesh, rank, words)}
    with open(os.path.join(workdir, f"units-{rank}.json"), "w") as f:
        json.dump(units, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
