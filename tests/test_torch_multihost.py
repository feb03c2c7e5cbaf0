"""The port's multi-process runs on gloo over the CPU, held to gol_tpu's.

Real OS processes form one run through ``gol_tpu_torch.parallel.bootstrap``
(tests/torch_multihost_worker.py, the port's counterpart of
tests/multihost_worker.py): each contributes its shard slots to the mesh,
the halo exchanges and the votes cross processes, and each reads and writes
only its own windows of the shared files. The lanes ``lax``, ``packed``,
``mpi`` and ``packedio`` must give the bytes and generation counts of JAX's
own worker run directly in as many processes (one JAX run per count, shared
by the module) and of the oracle; the cross-process exchange and votes must
equal their single-process forms. The zarr store each run's ranks write
holds JAX's words (and on JAX's mesh its ``.zarray`` and chunk names), and
a shard-write failure on one rank ends in a vote on every rank. Tolerance
zero.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gol_tpu import oracle
from gol_tpu.config import Convention, GameConfig
from gol_tpu.io import text_grid

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
LANES = ("lax", "packed", "mpi", "packedio")
# (mesh rows, mesh cols, ranks, shard slots per rank)
CONFIGS = {
    "1x2": (1, 2, 2, 1),
    "2x1": (2, 1, 2, 1),
    "2x2": (2, 2, 4, 1),
    "4x1 two slots per rank": (4, 1, 2, 2),
    "2x2 two slots per rank": (2, 2, 2, 2),
}
UNITS = [f"exchange_parts {what} depth {d}" for what in ("cells", "words")
         for d in (1, 8)] + ["exchange cells", "exchange words", "any_flag",
                             "all_agree false", "all_agree true",
                             "host_all_agree true", "host_all_agree false",
                             "process_allgather", "zarr overwrite failure voted",
                             "zarr live store kept"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(argvs, envs) -> list:
    return [subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv, env in zip(argvs, envs)]


def _finish(procs, timeout: float = 240) -> None:
    """Wait for every rank; fail with a rank's output if any exits
    non-zero. Every rank is killed in the end, so none outlives the test
    blocked in a collective."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{out[-3000:]}"


def _grid():
    return text_grid.generate(64, 64, seed=3)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's worker (tests/multihost_worker.py) run directly in 2 and in 4
    processes (1x2 and 2x2 meshes, one CPU device per process), both
    started at once when the module's first port run starts, and run
    beside it; ``jax_runs(n)`` waits for the n-process run."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    started = {}
    for n in (2, 4):
        work = tmp_path_factory.mktemp(f"jax{n}")
        text_grid.write_grid(str(work / "input.txt"), _grid())
        port = _free_port()
        started[n] = (work, _start_ranks(
            [[sys.executable, str(TESTS / "multihost_worker.py"), str(port),
              str(rank), str(n), str(work)] for rank in range(n)], [env] * n))
    done = set()

    def wait(n: int) -> Path:
        work, procs = started[n]
        if n not in done:
            _finish(procs, timeout=360)
            done.add(n)
        return work

    yield wait
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", params=list(CONFIGS))
def port_run(request, tmp_path_factory, jax_runs):
    """The port's worker in its ranks, over gloo on the CPU."""
    rows, cols, ranks, slots = CONFIGS[request.param]
    work = tmp_path_factory.mktemp("torch" + request.param.replace(" ", "_"))
    text_grid.write_grid(str(work / "input.txt"), _grid())
    # One thread per rank: the ranks share the CPU with each other.
    env = {**os.environ, "GOL_TORCH_DEVICE": "cpu",
           "GOL_TORCH_MESH_DEVICES": str(slots), "OMP_NUM_THREADS": "1"}
    env.pop("GOL_MULTIHOST", None)
    port = _free_port()
    _finish(_start_ranks(
        [[sys.executable, str(TESTS / "torch_multihost_worker.py"), str(port),
          str(rank), str(ranks), str(work), str(rows), str(cols)]
         for rank in range(ranks)], [env] * ranks))
    return request.param, ranks, work


def _read(work: Path, name: str):
    return (np.asarray(text_grid.read_grid(str(work / f"{name}.txt"), 64, 64)),
            (work / f"{name}.txt").read_bytes())


def test_port_lanes_equal_jax_and_oracle(port_run, jax_runs):
    """Against JAX's run in as many processes, and the oracle."""
    _, ranks, work = port_run
    jax_work = jax_runs(ranks)
    expect = oracle.run(_grid(), GameConfig(gen_limit=40))
    for lane in LANES:
        grid, raw = _read(work, f"torch_out_{lane}")
        np.testing.assert_array_equal(grid, expect.grid)
        assert raw == (jax_work / f"out_{lane}.txt").read_bytes(), lane
        gens = int((work / f"torch_gens_{lane}.txt").read_text())
        assert gens == expect.generations == int(
            (jax_work / f"gens_{lane}.txt").read_text()), lane


def test_port_cuda_convention_lanes_equal_oracle(port_run):
    _, _, work = port_run
    expect = oracle.run(_grid(), GameConfig(gen_limit=40, convention=Convention.CUDA))
    for lane in ("lax", "packed"):
        grid, _ = _read(work, f"torch_out_{lane}_cuda")
        np.testing.assert_array_equal(grid, expect.grid)
        assert int((work / f"torch_gens_{lane}_cuda.txt").read_text()) == \
            expect.generations


def test_port_zarr_store_equals_jax(port_run, jax_runs):
    """The store the ranks wrote holds the words of the store JAX's worker
    wrote in as many processes (TensorStore reads both), and its read-back
    unpacks to JAX's bytes; on JAX's own mesh (1x2 on 2 ranks, 2x2 on 4)
    the ``.zarray`` and the chunk file names are JAX's."""
    import tensorstore

    config, ranks, work = port_run
    jax_work = jax_runs(ranks)
    stores = [work / "torch_out_words.zarr", jax_work / "out_words.zarr"]
    words = [np.asarray(tensorstore.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(s)}}).result().read().result()) for s in stores]
    assert np.array_equal(*words)
    assert (work / "torch_out_tsstore.txt").read_bytes() == \
        (jax_work / "out_tsstore.txt").read_bytes()
    if config in ("1x2", "2x2"):
        layouts = [((s / ".zarray").read_bytes(), sorted(p.name for p in s.iterdir()))
                   for s in stores]
        assert layouts[0] == layouts[1]


@pytest.mark.parametrize("unit", UNITS)
def test_cross_process_halo_and_votes(port_run, unit):
    """Every rank's exchange over its own shards equals the single-process
    exchange of the same shards, and the votes count every rank."""
    _, ranks, work = port_run
    for rank in range(ranks):
        units = json.loads((work / f"units-{rank}.json").read_text())
        assert units[unit], f"rank {rank}: {unit}"


@pytest.mark.parametrize("n", [2, 4])
def test_jax_cluster_matches_oracle(n, jax_runs):
    work = jax_runs(n)
    expect = oracle.run(_grid(), GameConfig(gen_limit=40))
    for lane in LANES:
        np.testing.assert_array_equal(_read(work, f"out_{lane}")[0], expect.grid)
        assert int((work / f"gens_{lane}.txt").read_text()) == expect.generations


def test_bootstrap_opt_in_and_backend_choice(monkeypatch):
    import torch

    from gol_tpu_torch.parallel import bootstrap

    monkeypatch.delenv("GOL_MULTIHOST", raising=False)
    bootstrap.initialize()  # no opt-in: nothing happens
    assert bootstrap.world() is None and bootstrap.process_count() == 1
    assert bootstrap.process_index() == 0 and not bootstrap.is_multihost()
    with pytest.raises(ValueError, match="together"):
        bootstrap.initialize(coordinator_address="127.0.0.1:1")
    monkeypatch.setenv("GOL_MULTIHOST", "1")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=r"\$RANK"):
        bootstrap.initialize()
    assert bootstrap.choose_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert bootstrap.choose_backend(torch.device("cuda", 0), 4) == "nccl"
    assert bootstrap.choose_backend(torch.device("cuda", 0), 5) == "gloo"
