"""``python -m gol_tpu_torch`` in N ranks on gloo over the CPU.

Each rank is started with ``GOL_MULTIHOST=1`` and torch's env:// variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), as
``torchrun`` starts them. Every rank must print the single-process port's
lines on the same mesh (milliseconds masked; that run is itself held to
``gol_tpu`` by tests/test_torch_cli.py) and the output file must hold its
bytes. The distributed variants all take the C convention; the CUDA
convention's mesh loop is held in tests/test_torch_multihost.py. The
checkpoint drill SIGKILLs one rank at a checkpoint boundary: its peer must
exit non-zero within 60 s, and ``--auto-resume`` in 2 and in 4 ranks must
write the uninterrupted bytes. Tolerance zero. c10d's own stderr noise is
not compared.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gol_tpu.io import text_grid

REPO = Path(__file__).resolve().parent.parent
LIMIT = 40
GRIDS = ("random", "still", "lone")
# (variant, mesh, ranks, shard slots per rank, extra flags): the I/O
# variants on two ranks of two slots each, where local and remote
# neighbours mix (each rank launch costs seconds of CPU). The still and
# lone grids end the run at generations 2 and 1, through each variant's
# own write: the lead's gather (mpi) or the voted in-place windows.
CASES = {
    "tpu 2x2": ("tpu", "2x2", 4, 1, []),
    "mpi 2x2": ("mpi", "2x2", 2, 2, []),
    "async 2x2": ("async", "2x2", 2, 2, []),
    "collective 2x2": ("collective", "2x2", 2, 2, []),
    "packed-io 4x1": ("tpu", "4x1", 4, 1, ["--packed-io"]),
    "pallas 4x1": ("tpu", "4x1", 4, 1, ["--kernel", "pallas"]),
}
RUNS = [(case, grid) for case in CASES for grid in GRIDS]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_grids(work: Path) -> None:
    still = np.zeros((64, 64), np.uint8)
    still[10:12, 20:22] = 1  # a block: similar at once (Generations 2)
    lone = np.zeros((64, 64), np.uint8)
    lone[40, 7] = 1  # dies at once (Generations 1)
    for name, grid in (("random", text_grid.generate(64, 64, seed=3)),
                       ("still", still), ("lone", lone)):
        text_grid.write_grid(str(work / f"{name}.txt"), grid)


def _rank_env(rank: int, ranks: int, port: int, slots: int, extra=None) -> dict:
    env = {**os.environ, "GOL_TORCH_DEVICE": "cpu", "GOL_MULTIHOST": "1",
           "RANK": str(rank), "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(rank),
           "LOCAL_WORLD_SIZE": str(ranks), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "GOL_TORCH_MESH_DEVICES": str(slots),
           # One thread per rank: the ranks share the CPU with each other.
           "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    env.pop("GOL_FAULTS", None)
    return {**env, **(extra or {})}


def _ranks(argv, ranks: int, slots: int, cwd: Path, per_rank=None,
           timeout: float = 180) -> list:
    """``python -m gol_tpu_torch argv`` in ``ranks`` processes: per rank
    ``(rc, stdout, stderr, seconds to exit)``. Every rank is killed in the
    end, so none outlives the test blocked in a collective."""
    port = _free_port()
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-m", "gol_tpu_torch", *argv],
                              cwd=cwd, env=_rank_env(r, ranks, port, slots,
                                                     (per_rank or {}).get(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(ranks)]
    out = []
    try:
        pending = dict(enumerate(procs))
        results = {}
        while pending:
            for r, p in list(pending.items()):
                if p.poll() is not None:
                    o, e = p.communicate()
                    results[r] = (p.returncode, o, e, time.monotonic() - t0)
                    del pending[r]
            if time.monotonic() - t0 > timeout:
                break
            time.sleep(0.02)
        out = [results.get(r, (None, "", "", None)) for r in range(ranks)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _mask(text: str) -> str:
    return re.sub(r"\d+\.\d+ msecs", "X msecs", text)


def _single(argv, slots: int) -> tuple[str, int]:
    """The single-process port, in this process, on the same mesh."""
    from gol_tpu_torch import cli

    old = {k: os.environ.get(k) for k in ("GOL_TORCH_DEVICE", "GOL_TORCH_MESH_DEVICES")}
    os.environ.update(GOL_TORCH_DEVICE="cpu", GOL_TORCH_MESH_DEVICES=str(slots))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return buf.getvalue(), rc


def _argv(case: str, grid: str, work: Path, output: str) -> list:
    variant, mesh, _, _, flags = CASES[case]
    return ["64", "64", str(work / f"{grid}.txt"), "--variant", variant,
            "--mesh", mesh, *flags, "--gen-limit", str(LIMIT), "--output", output]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's ranks, three runs at a time, and the single-process
    port's run of each."""
    work = tmp_path_factory.mktemp("cli")
    _write_grids(work)

    def one(key):
        case, grid = key
        _, _, ranks, slots, _ = CASES[case]
        out = work / f"{case.replace(' ', '_')}_{grid}"
        out.mkdir()
        return key, _ranks(_argv(case, grid, work, str(out / "multi.out")),
                           ranks, slots, out)

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        multi = dict(pool.map(one, RUNS))
    single = {}
    for case, grid in RUNS:
        out = work / f"{case.replace(' ', '_')}_{grid}"
        single[(case, grid)] = _single(_argv(case, grid, work, str(out / "single.out")),
                                       4)
    return work, multi, single


@pytest.mark.parametrize("case,grid", RUNS, ids=[f"{c} {g}" for c, g in RUNS])
def test_ranks_print_and_write_the_single_process_run(runs, case, grid):
    work, multi, single = runs
    text, rc = single[(case, grid)]
    assert rc == 0
    expect_gens = {"still": 2, "lone": 1}.get(grid)
    if expect_gens is not None:
        assert f"Generations:\t{expect_gens}\n" in text
    for rank, (prc, stdout, stderr, _) in enumerate(multi[(case, grid)]):
        assert prc == 0, f"rank {rank}: {stderr[-3000:]}"
        assert _mask(stdout) == _mask(text), f"rank {rank}"
    out = work / f"{case.replace(' ', '_')}_{grid}"
    assert (out / "multi.out").read_bytes() == (out / "single.out").read_bytes()


def test_bootstrap_line_names_the_backend(runs):
    _, multi, _ = runs
    for rank, (_, _, stderr, _) in enumerate(multi[("tpu 2x2", "random")]):
        assert (f"gol_tpu_torch: bootstrap: rank {rank} of 4 on cpu over gloo"
                in stderr)


@pytest.mark.parametrize("argv", [
    ["64", "64", "{input}", "--variant", "game"],
    ["64", "64", "{input}", "--variant", "tpu", "--host"],
    ["generate", "16", "16", "--seed", "1", "-o", "{out}"],
], ids=["game", "tpu --host", "generate"])
def test_serial_lanes_form_no_cluster(tmp_path, monkeypatch, argv):
    """With GOL_MULTIHOST=1 but no launcher variables, a serial variant,
    --host and a subcommand run alone: none calls the bootstrap."""
    from gol_tpu_torch import cli
    from gol_tpu_torch.parallel import bootstrap

    text_grid.write_grid(str(tmp_path / "in.txt"), text_grid.generate(64, 64, seed=3))
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GOL_MULTIHOST", "1")
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    args = [a.format(input=tmp_path / "in.txt", out=tmp_path / "g.txt") for a in argv]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args) == 0
    assert bootstrap.world() is None


def test_distributed_variant_needs_the_launcher_variables(tmp_path, monkeypatch,
                                                          capsys):
    from gol_tpu_torch import cli

    text_grid.write_grid(str(tmp_path / "in.txt"), text_grid.generate(64, 64, seed=3))
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GOL_MULTIHOST", "1")
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["64", "64", str(tmp_path / "in.txt"), "--variant", "tpu"]) == 1
    assert "gol: GOL_MULTIHOST=1 needs $RANK" in capsys.readouterr().err


# --- the checkpoint drill ---------------------------------------------------


def _ckpt_argv(work: Path, mesh: str, ckdir: str, output: str, *extra) -> list:
    return ["64", "64", str(work / "random.txt"), "--variant", "tpu", "--mesh", mesh,
            "--gen-limit", str(LIMIT), "--checkpoint-every", "10",
            "--checkpoint-dir", ckdir, "--output", output, *extra]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """Two ranks on 2x1, rank 1 SIGKILLed at the generation-20 boundary;
    then --auto-resume from copies of what it left, in 2 ranks (2x1) and
    in 4 ranks (2x2) at once; and the uninterrupted single-process run."""
    work = tmp_path_factory.mktemp("drill")
    _write_grids(work)
    killed = _ranks(_ckpt_argv(work, "2x1", "ck", "killed.out"), 2, 1, work,
                    per_rank={1: {"GOL_FAULTS": "kill_at_gen=20,kill_mode=sigkill"}})
    shutil.copytree(work / "ck", work / "ck4")
    after_kill = sorted(os.listdir(work / "ck"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(_ranks, _ckpt_argv(work, "2x1", "ck", "r2.out",
                                             "--auto-resume"), 2, 1, work)
        four = pool.submit(_ranks, _ckpt_argv(work, "2x2", "ck4", "r4.out",
                                              "--auto-resume"), 4, 1, work)
        resumed = {2: two.result(), 4: four.result()}
    text, rc = _single(_ckpt_argv(work, "2x1", str(work / "cks"),
                                  str(work / "single.out")), 2)
    assert rc == 0
    return work, killed, after_kill, resumed, text


def test_drill_lost_rank_ends_its_peer(drill):
    _, killed, after_kill, _, _ = drill
    (rc0, _, err0, t0), (rc1, _, _, t1) = killed
    assert rc1 == -9  # the SIGKILL the fault plan sent
    assert rc0 not in (0, None), "the peer of a killed rank must exit non-zero"
    assert t0 - t1 < 60, f"peer exited {t0 - t1:.1f} s after the kill"
    # The generation-20 boundary never committed; generation 10's did.
    assert "ckpt-00000010.manifest.json" in after_kill
    assert "ckpt-00000020.manifest.json" not in after_kill


@pytest.mark.parametrize("ranks", [2, 4])
def test_drill_resume_restores_the_uninterrupted_run(drill, ranks):
    work, _, _, resumed, text = drill
    for rank, (rc, stdout, stderr, _) in enumerate(resumed[ranks]):
        assert rc == 0, f"rank {rank}: {stderr[-3000:]}"
        assert "auto-resume: restored checkpoint at generation 10" in stderr
        assert _mask(stdout) == _mask(text)
    assert (work / f"r{ranks}.out").read_bytes() == (work / "single.out").read_bytes()


@pytest.mark.parametrize("ranks,mesh", [(2, (2, 1)), (4, (2, 2))])
def test_drill_manifests_cover_every_shard(drill, ranks, mesh):
    """The lead's manifest carries every rank's CRC blocks, and the
    fingerprint is the single-process run's."""
    work, _, _, _, _ = drill
    ckdir = work / ("ck" if ranks == 2 else "ck4")
    manifest = json.loads((ckdir / "ckpt-00000030.manifest.json").read_text())
    single = json.loads((work / "cks" / "ckpt-00000030.manifest.json").read_text())
    h, w = 64 // mesh[0], 64 // mesh[1]
    assert sorted(manifest["checksums"]) == sorted(
        f"{r * h}:{(r + 1) * h},{c * w}:{(c + 1) * w}"
        for r in range(mesh[0]) for c in range(mesh[1]))
    assert manifest["run_fingerprint"] == single["run_fingerprint"]
    assert manifest["payload"] == single["payload"]
    assert (ckdir / manifest["payload"]).read_bytes() == \
        (work / "cks" / single["payload"]).read_bytes()
