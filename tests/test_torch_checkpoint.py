"""The port's checkpoint lane (on the CPU) against the JAX package's.

Each case of ``tests/test_crash_recovery.py`` runs through both CLIs on the
same argv: ``gol_tpu.cli.main`` and ``gol_tpu_torch.cli.main``, each with
its own output file and checkpoint directory. They must agree on the exit
code, the printed lines (milliseconds masked), the ``gol:`` error line, the
output bytes, and the checkpoint directory: the same file names, the same
payload bytes, and manifests equal but for ``created_unix``. Kills use
``kill_mode=exception``: each package raises its own ``InjectedCrash``.

The JAX package writes its packed checkpoints as zarr when tensorstore is
installed; the port has no zarr store and writes the packed text codec, as
the JAX package does without tensorstore, so these tests take tensorstore
away from the JAX package (``HAVE_TENSORSTORE = False``). Then directories
written by either package resume in the other, and the run fingerprint is
the JAX package's under any mesh.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from gol_tpu import cli as jax_cli
from gol_tpu.io import packed_io as jax_packed_io
from gol_tpu.io import ts_store
from gol_tpu.resilience import faults as jax_faults
from gol_tpu.resilience import checkpoint as jax_checkpoint
from gol_tpu_torch import cli
from gol_tpu_torch.io import packed_io, text_grid
from gol_tpu_torch.parallel.mesh import make_mesh, split
from gol_tpu_torch.pipeline.snapshot import HostSnapshot, SnapshotBuffers
from gol_tpu_torch.resilience import checkpoint, faults

_MS = re.compile(r"\d+\.\d+ msecs")
GEN_LIMIT = 12
EVERY = 3
BOUNDARIES = (3, 6, 9)
PACKAGES = {"jax": (jax_cli.main, jax_faults.InjectedCrash),
            "port": (cli.main, faults.InjectedCrash)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")
    monkeypatch.delenv("GOL_FAULTS", raising=False)
    monkeypatch.setattr(ts_store, "HAVE_TENSORSTORE", False)
    jax_faults.clear()
    faults.clear()
    yield
    jax_faults.clear()
    faults.clear()


@pytest.fixture
def grid16(tmp_path):
    p = tmp_path / "in.txt"
    text_grid.write_grid(str(p), text_grid.generate(16, 16, seed=77))
    return str(p)


def _ck_args(infile, *extra, size=16, limit=GEN_LIMIT, every=EVERY):
    return [str(size), str(size), infile, "--variant", "game",
            "--gen-limit", str(limit), "--checkpoint-every", str(every), *extra]


def _run(capsys, main, args):
    """``(rc, stdout with ms masked, stderr)``; an InjectedCrash propagates."""
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, _MS.sub("X msecs", out), err


def _gol_lines(err: str, tmp_path) -> list[str]:
    return [line.replace(str(tmp_path), "<tmp>")
            for line in err.splitlines() if line.startswith("gol:")]


def _directory(path) -> dict:
    """name -> payload bytes, or the manifest without ``created_unix``."""
    if not os.path.isdir(path):
        return {}
    out = {}
    for name in sorted(os.listdir(path)):
        data = open(os.path.join(path, name), "rb").read()
        if name.endswith(".manifest.json"):
            manifest = json.loads(data)
            manifest.pop("created_unix")
            out[name] = manifest
        else:
            out[name] = data
    return out


class Pair:
    """One scenario on both packages: per package its own output file and
    checkpoint directory under ``tmp_path``."""

    def __init__(self, tmp_path, capsys):
        self.tmp_path, self.capsys = tmp_path, capsys

    def paths(self, tag):
        return self.tmp_path / f"{tag}.ck", self.tmp_path / f"{tag}.out"

    def run(self, args, crash=False):
        """Run ``args`` + each package's --checkpoint-dir/--output; compare
        the two runs and return the port's ``(rc, stdout, stderr)``."""
        results = {}
        for tag, (main, crash_type) in PACKAGES.items():
            ckdir, out = self.paths(tag)
            argv = [*args, "--checkpoint-dir", str(ckdir), "--output", str(out)]
            if crash:
                with pytest.raises(crash_type):
                    main(argv)
                self.capsys.readouterr()
                results[tag] = (None, "", "")
            else:
                results[tag] = _run(self.capsys, main, argv)
        (jrc, jout, jerr), (prc, pout, perr) = results["jax"], results["port"]
        assert (prc, pout) == (jrc, jout)
        assert _gol_lines(perr, self.tmp_path) == [
            line.replace("jax.", "port.") for line in _gol_lines(jerr, self.tmp_path)]
        assert ("restored checkpoint" in perr) == ("restored checkpoint" in jerr)
        (jck, jout_path), (pck, pout_path) = self.paths("jax"), self.paths("port")
        assert _directory(pck) == _directory(jck)
        assert pout_path.exists() == jout_path.exists()
        if pout_path.exists():
            assert pout_path.read_bytes() == jout_path.read_bytes()
        return results["port"]

    def output(self) -> bytes:
        return self.paths("port")[1].read_bytes()


def _reference(capsys, infile, tmp_path, *extra, size=16, limit=GEN_LIMIT):
    """The uninterrupted, checkpoint-free run of the port: bytes, lines."""
    out = tmp_path / f"ref{limit}.out"
    rc, text, _ = _run(capsys, cli.main, [str(size), str(size), infile,
                                          "--variant", "game", "--gen-limit",
                                          str(limit), *extra, "--output", str(out)])
    assert rc == 0
    return out.read_bytes(), text


def _manifests(ckdir) -> list[str]:
    return sorted(n for n in os.listdir(ckdir) if n.endswith(".manifest.json"))


def _assert_prior_state_readable(ckdir):
    """Every committed manifest points at an existing payload."""
    for name in _manifests(ckdir) if os.path.isdir(ckdir) else []:
        with open(os.path.join(ckdir, name)) as f:
            assert os.path.exists(os.path.join(ckdir, json.load(f)["payload"]))


@pytest.mark.parametrize("kill_at", BOUNDARIES)
def test_kill_at_every_boundary_then_auto_resume(tmp_path, grid16, capsys, kill_at):
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    pair.run(_ck_args(grid16, "--fault-plan", f"kill_at_gen={kill_at}"), crash=True)
    ckdir = pair.paths("port")[0]
    _assert_prior_state_readable(ckdir)
    if kill_at > EVERY:
        assert _manifests(ckdir)[-1] == f"ckpt-{kill_at - EVERY:08d}.manifest.json"
    assert not pair.paths("port")[1].exists()
    rc, text, _ = pair.run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and pair.output() == ref and text == ref_text


def test_env_var_fault_plan_crosses_into_run(tmp_path, grid16, capsys, monkeypatch):
    ref, _ = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    monkeypatch.setenv("GOL_FAULTS", "kill_at_gen=6")
    pair.run(_ck_args(grid16), crash=True)
    monkeypatch.delenv("GOL_FAULTS")
    rc, _, _ = pair.run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and pair.output() == ref


def test_midwrite_failure_keeps_prior_and_resumes(tmp_path, grid16, capsys):
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    rc, _, err = pair.run(_ck_args(grid16, "--fault-plan", "payload_write_fail=2"))
    assert rc == 1 and "injected" in err
    names = os.listdir(pair.paths("port")[0])
    assert "ckpt-00000003.manifest.json" in names
    assert "ckpt-00000006.manifest.json" not in names
    rc, text, _ = pair.run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and pair.output() == ref and text == ref_text


def test_auto_resume_with_empty_dir_runs_from_scratch(tmp_path, grid16, capsys):
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    rc, text, _ = Pair(tmp_path, capsys).run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and text == ref_text


@pytest.mark.parametrize("writer", [[], ["--sync-checkpoints"]], ids=["async", "sync"])
def test_checkpointed_run_is_bit_exact_without_crashes(tmp_path, grid16, capsys,
                                                       writer):
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    rc, text, _ = pair.run(_ck_args(grid16, *writer))
    assert rc == 0 and pair.output() == ref and text == ref_text
    assert _manifests(pair.paths("port")[0]) == [
        "ckpt-00000006.manifest.json", "ckpt-00000009.manifest.json"]


def test_async_and_sync_writers_write_the_same_directory(tmp_path, grid16, capsys):
    for ck, writer in (("a", []), ("s", ["--sync-checkpoints"])):
        out, ckdir = tmp_path / f"{ck}.out", tmp_path / ck
        rc, _, _ = _run(capsys, cli.main, _ck_args(
            grid16, *writer, "--checkpoint-keep", "5", "--checkpoint-dir",
            str(ckdir), "--output", str(out)))
        assert rc == 0
    assert _directory(tmp_path / "a") == _directory(tmp_path / "s")
    assert len(_manifests(tmp_path / "a")) == 3


def test_auto_resume_respects_reduced_gen_limit(tmp_path, grid16, capsys):
    pair = Pair(tmp_path, capsys)
    rc, _, _ = pair.run(_ck_args(grid16))  # checkpoints 6 and 9 kept
    assert rc == 0
    for limit, expect_resume in ((8, True), (5, False)):
        ref, ref_text = _reference(capsys, grid16, tmp_path, limit=limit)
        rc, text, err = pair.run(_ck_args(grid16, "--auto-resume", limit=limit))
        assert rc == 0 and pair.output() == ref and text == ref_text
        assert ("restored checkpoint" in err) == expect_resume


def test_stale_dir_from_different_input_never_restored(tmp_path, grid16, capsys):
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    a_in = tmp_path / "a.txt"
    text_grid.write_grid(str(a_in), text_grid.generate(16, 16, seed=99))
    pair = Pair(tmp_path, capsys)
    rc, _, _ = pair.run(_ck_args(str(a_in)))
    assert rc == 0
    rc, text, err = pair.run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and "restored checkpoint" not in err
    assert pair.output() == ref and text == ref_text


def _sim16(tmp_path) -> str:
    infile = tmp_path / "sim.txt"
    text_grid.write_grid(str(infile), text_grid.generate(16, 16, seed=26,
                                                         density=0.25))
    return str(infile)


@pytest.mark.parametrize("fault", ["kill_at_gen=20", "kill_during_ckpt_write=3"])
def test_similarity_exit_resumes_to_same_generation(tmp_path, capsys, fault):
    """Crash and resume across the similarity exit at generation 23, killed
    at a boundary or during the async writer's third payload write."""
    infile = _sim16(tmp_path)
    ref, ref_text = _reference(capsys, infile, tmp_path, limit=40)
    assert "Generations:\t23" in ref_text
    pair = Pair(tmp_path, capsys)
    pair.run(_ck_args(infile, "--fault-plan", fault, limit=40, every=5), crash=True)
    names = os.listdir(pair.paths("port")[0])
    if fault.startswith("kill_during"):
        assert "ckpt-00000010.manifest.json" in names
        assert "ckpt-00000015.manifest.json" not in names
    rc, text, _ = pair.run(_ck_args(infile, "--auto-resume", limit=40, every=5))
    assert rc == 0 and pair.output() == ref and text == ref_text


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_packed_io_lane_kill_and_resume(tmp_path, capsys, mesh):
    infile = tmp_path / "in.txt"
    text_grid.write_grid(str(infile), text_grid.generate(64, 64, seed=21,
                                                         density=0.35))
    base = ["64", "64", str(infile), "--variant", "tpu", "--mesh", mesh,
            "--packed-io", "--gen-limit", str(GEN_LIMIT),
            "--checkpoint-every", str(EVERY)]
    ref, ref_text = _reference(capsys, str(infile), tmp_path, "--variant", "tpu",
                               "--mesh", mesh, "--packed-io", size=64)
    pair = Pair(tmp_path, capsys)
    pair.run([*base, "--fault-plan", "kill_at_gen=6"], crash=True)
    _assert_prior_state_readable(pair.paths("port")[0])
    manifest = json.loads(open(pair.paths("port")[0] /
                               "ckpt-00000003.manifest.json").read())
    assert manifest["payload_format"] == "packed-text"
    assert manifest["state_shape"] == [64, 2]
    rc, text, _ = pair.run([*base, "--auto-resume"])
    assert rc == 0 and pair.output() == ref


@pytest.mark.parametrize("writer", [[], ["--sync-checkpoints"]], ids=["async", "sync"])
def test_kill_during_write_then_auto_resume(tmp_path, grid16, capsys, writer):
    """A crash with payload write 2 (generation 6's) in flight: on the
    async lane the deferred wait at boundary 6 has committed generation 3;
    the torn payload never becomes a checkpoint, on either lane."""
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    pair.run(_ck_args(grid16, *writer, "--fault-plan", "kill_during_ckpt_write=2"),
             crash=True)
    ckdir = pair.paths("port")[0]
    _assert_prior_state_readable(ckdir)
    assert _manifests(ckdir) == ["ckpt-00000003.manifest.json"]
    assert not pair.paths("port")[1].exists()
    rc, text, _ = pair.run(_ck_args(grid16, "--auto-resume"))
    assert rc == 0 and pair.output() == ref and text == ref_text


@pytest.mark.parametrize("fault", ["ts_spec", "flaky_payload_write"])
def test_transient_faults_heal_without_aborting(tmp_path, capsys, monkeypatch, fault):
    """Transient IO failures are retried under the unified policy: the run
    completes with the identical output and checkpoints. ``ts_spec`` is the
    JAX package's spec (its TensorStore probes have no call site on the
    packed text codec either package writes here); ``flaky_payload_write``
    makes each package's first packed payload write raise a transient
    error."""
    infile = tmp_path / "in.txt"
    text_grid.write_grid(str(infile), text_grid.generate(64, 64, seed=21,
                                                         density=0.35))
    base = ["64", "64", str(infile), "--variant", "tpu", "--mesh", "4x1",
            "--packed-io", "--gen-limit", str(GEN_LIMIT),
            "--checkpoint-every", str(EVERY)]
    ref, _ = _reference(capsys, str(infile), tmp_path, "--variant", "tpu",
                        "--mesh", "4x1", "--packed-io", size=64)
    if fault == "ts_spec":
        base += ["--fault-plan", "ts_write_fail=2,ts_write_error=transient,"
                 "ts_open_transient=1"]
    else:
        for module, errors in ((jax_packed_io, jax_faults), (packed_io, faults)):
            real, calls = module.write_packed, []

            def flaky(*a, real=real, calls=calls, errors=errors, **kw):
                calls.append(1)
                if len(calls) == 1:
                    raise errors.TransientInjectedError("packed payload write")
                return real(*a, **kw)

            monkeypatch.setattr(module, "write_packed", flaky)
    pair = Pair(tmp_path, capsys)
    rc, _, _ = pair.run(base)
    assert rc == 0 and pair.output() == ref


@pytest.mark.parametrize("codec", ["text-grid", "packed-text"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_directories_resume_across_packages(tmp_path, capsys, codec, writer, reader):
    """A directory one package's killed run left behind resumes in the
    other, to the uninterrupted run's bytes and lines."""
    infile = tmp_path / "in.txt"
    text_grid.write_grid(str(infile), text_grid.generate(64, 64, seed=21,
                                                         density=0.35))
    lane = ["--variant", "tpu", "--mesh", "2x2"] + (
        ["--packed-io"] if codec == "packed-text" else [])
    ref, ref_text = _reference(capsys, str(infile), tmp_path, *lane, size=64)
    ckdir, out = tmp_path / "ck", tmp_path / "out.out"
    args = ["64", "64", str(infile), *lane, "--gen-limit", str(GEN_LIMIT),
            "--checkpoint-every", str(EVERY), "--checkpoint-dir", str(ckdir),
            "--output", str(out)]
    main, crash = PACKAGES[writer]
    with pytest.raises(crash):
        main([*args, "--fault-plan", "kill_at_gen=9"])
    assert _manifests(ckdir)[-1] == "ckpt-00000006.manifest.json"
    assert json.loads((ckdir / "ckpt-00000006.manifest.json").read_text())[
        "payload_format"] == codec
    rc, text, err = _run(capsys, PACKAGES[reader][0], [*args, "--auto-resume"])
    assert rc == 0 and "restored checkpoint at generation 6" in err
    assert out.read_bytes() == ref and text == ref_text


def test_checkpoint_on_one_mesh_resumes_on_another(tmp_path, capsys):
    """Written on --mesh 4x1, resumed on --mesh 2x2: the CRC blocks are
    re-sliced from the state, so any decomposition verifies."""
    infile = tmp_path / "in.txt"
    text_grid.write_grid(str(infile), text_grid.generate(64, 64, seed=5))
    ref, ref_text = _reference(capsys, str(infile), tmp_path, "--variant", "tpu",
                               "--mesh", "2x2", size=64)
    ckdir, out = tmp_path / "ck", tmp_path / "out.out"
    base = ["64", "64", str(infile), "--variant", "tpu", "--gen-limit",
            str(GEN_LIMIT), "--checkpoint-every", str(EVERY), "--checkpoint-dir",
            str(ckdir), "--output", str(out)]
    with pytest.raises(faults.InjectedCrash):
        cli.main([*base, "--mesh", "4x1", "--fault-plan", "kill_at_gen=9"])
    manifest = json.loads((ckdir / "ckpt-00000006.manifest.json").read_text())
    assert sorted(manifest["checksums"]) == [
        "0:16,0:64", "16:32,0:64", "32:48,0:64", "48:64,0:64"]
    rc, text, err = _run(capsys, cli.main, [*base, "--mesh", "2x2", "--auto-resume"])
    assert rc == 0 and "restored checkpoint at generation 6" in err
    assert out.read_bytes() == ref and text == ref_text


@pytest.mark.parametrize("mesh", [(1, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("packed", [False, True], ids=["cells", "words"])
def test_run_fingerprint_and_checksums_equal_jax(mesh, packed):
    """The fingerprint and the geometry-keyed CRC blocks of the same state
    on the same mesh equal the JAX package's (its state sharded over the
    suite's virtual CPU devices), and the fingerprint is the same under
    every mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from gol_tpu.parallel import mesh as jax_mesh

    grid = text_grid.generate(64, 64, seed=3)
    host = np.packbits(grid, axis=1, bitorder="little").view(np.uint32) \
        if packed else grid
    tensor = torch.from_numpy(host.view(np.int32).copy() if packed else host.copy())
    if mesh == (1, 1):
        state, jax_state = tensor, jax.numpy.asarray(host)
    else:
        state = split(tensor, make_mesh(*mesh))
        jm = jax_mesh.make_mesh(*mesh)
        jax_state = jax.device_put(host, NamedSharding(
            jm, PartitionSpec(*jm.axis_names)))
    got = checkpoint.run_fingerprint(state, tag="c", mesh_shape=mesh)
    assert got == jax_checkpoint.run_fingerprint(jax_state, tag="c")
    assert got == checkpoint.run_fingerprint(tensor, tag="c")
    assert checkpoint._shard_checksums(state, mesh) == \
        jax_checkpoint._shard_checksums(jax_state)


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_host_snapshot_copies_every_shard(mesh):
    grid = torch.from_numpy(text_grid.generate(32, 32, seed=4))
    state = grid if mesh is None else split(grid, make_mesh(*mesh))
    buffers = SnapshotBuffers()
    snap = HostSnapshot(state, buffers)
    shards = state if mesh else [state]
    got = snap.state if mesh else [snap.state]
    assert len(got) == len(shards)
    for g, s in zip(got, shards):
        assert torch.equal(g, s) and g.data_ptr() != s.data_ptr()
    again = HostSnapshot(state, buffers)  # the same buffers, reused
    assert [t.data_ptr() for t in (again.state if mesh else [again.state])] == \
        [t.data_ptr() for t in got]


def test_zarr_words_checkpoints_are_refused(tmp_path, grid16, capsys):
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    (ckdir / "ckpt-00000003.manifest.json").write_text(
        json.dumps({"format_version": 1, "payload_format": "zarr-words"}))
    rc, _, err = _run(capsys, cli.main, _ck_args(
        grid16, "--auto-resume", "--checkpoint-dir", str(ckdir),
        "--output", str(tmp_path / "o.out")))
    assert rc == 1 and "zarr-words" in err and "gol:" in err


@pytest.mark.parametrize("args,needle", [
    (["--checkpoint-dir", "{tmp}/ck"], "--checkpoint-every"),
    (["--checkpoint-every", "0"], "positive"),
    (["--checkpoint-every", "3", "--checkpoint-keep", "0"], "--checkpoint-keep"),
    (["--checkpoint-every", "3", "--snapshot-every", "3"], "snapshot"),
    (["--auto-resume", "--resume-gen", "5"], "--resume-gen"),
    (["--host", "--checkpoint-every", "3"], "--host"),
    (["--fault-plan", "ts_write_fial=1"], "unknown fault plan key"),
    (["--fault-plan", "kill_mode=gently"], "kill_mode"),
], ids=["dir_without_mode", "nonpositive", "keep0", "snapshot", "resume_gen",
        "host", "bad_key", "bad_mode"])
def test_flag_validation_matches_jax(tmp_path, grid16, capsys, args, needle):
    argv = ["16", "16", grid16, *[a.replace("{tmp}", str(tmp_path)) for a in args]]
    results = [_run(capsys, main, argv) for main, _ in PACKAGES.values()]
    (jrc, jout, jerr), (prc, pout, perr) = results
    assert prc == jrc == 1 and pout == jout
    assert _gol_lines(perr, tmp_path) == _gol_lines(jerr, tmp_path)
    assert needle in perr


@pytest.mark.parametrize("free,saved", [(10, False), (1 << 40, True)],
                         ids=["pressure", "room"])
def test_disk_reserve_sheds_checkpoints_under_pressure(tmp_path, grid16, capsys,
                                                       free, saved):
    """--disk-reserve: with the free bytes the fault plan pins below the
    watchdog's checkpoint tier, every save sheds and the run still
    completes; with room, the saves land."""
    ref, ref_text = _reference(capsys, grid16, tmp_path)
    pair = Pair(tmp_path, capsys)
    rc, text, _ = pair.run(_ck_args(grid16, "--disk-reserve", str(1 << 20),
                                    "--fault-plan", f"disk_free_bytes={free}"))
    assert rc == 0 and pair.output() == ref and text == ref_text
    assert bool(_manifests(pair.paths("port")[0])) == saved


@pytest.mark.parametrize("writer,want", [
    ([], {"pipeline.stage", "pipeline.write", "pipeline.drain"}),
    (["--sync-checkpoints"], {"checkpoint.save"}),
], ids=["async", "sync"])
def test_traced_kill_dumps_the_flight_record(tmp_path, grid16, capsys, writer,
                                             want):
    # The spans and the recorder hook of the checkpoint lane, turned on as
    # the JAX package's --profile / flight recorder would turn them on.
    from gol_tpu_torch.obs import recorder, trace

    trace.clear()
    trace.enable()
    recorder.install(str(tmp_path / "flight"))
    try:
        with pytest.raises(faults.InjectedCrash):
            cli.main(_ck_args(grid16, *writer, "--fault-plan", "kill_at_gen=6",
                              "--checkpoint-dir", str(tmp_path / "ck"),
                              "--output", str(tmp_path / "out.txt")))
    finally:
        recorder.uninstall()
        trace.disable()
        trace.clear()
    capsys.readouterr()
    (dump,) = os.listdir(tmp_path / "flight")
    records = recorder.read_dump(str(tmp_path / "flight" / dump))
    assert records[0]["reason"].startswith("fault-injection: kill at")
    assert want <= {r["name"] for r in records if r["record"] == "span"}
    states = [r["name"] for r in records if r["record"] == "state"]
    assert states == ([] if writer else ["checkpoint_writer"])
    registry = next(r for r in records if r["record"] == "registry")
    assert "checkpoint_saves_total" in json.dumps(registry)
