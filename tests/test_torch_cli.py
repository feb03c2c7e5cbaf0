"""The port's CLI (gol_tpu_torch.cli, on the CPU) against the JAX package's
(gol_tpu.cli): output file bytes, exit codes and printed lines, with the
millisecond values masked.

Under this suite's 8 virtual CPU devices the JAX CLI runs the distributed
variants over a device mesh unless it is given ``--mesh 1x1``, the
single-device form the port runs. The first test keeps the mesh for the
``tpu`` variant (its grids are square and divide over the mesh; the bytes
must match all the same); the others pass ``--mesh 1x1`` to JAX for every
distributed variant (``_jax_args``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from gol_tpu import cli as jax_cli
from gol_tpu_torch import cli, oracle
from gol_tpu_torch.config import GameConfig
from gol_tpu_torch.io import text_grid
from gol_tpu_torch.variants import VARIANTS

_MS = re.compile(r"\d+\.\d+ msecs")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _write(tmp_path, name, grid):
    path = tmp_path / name
    text_grid.write_grid(str(path), grid)
    return str(path)


def _jax_args(args):
    """JAX's CLI in the port's single-device form: a 1x1 mesh for the
    distributed variants."""
    variant = args[args.index("--variant") + 1] if "--variant" in args else "tpu"
    return [*args, "--mesh", "1x1"] if VARIANTS[variant].distributed else list(args)


def _both(capsys, args, tmp_path=None, single_device=False):
    """Run both CLIs: ``[(rc, stdout masked, output bytes)]`` for JAX, port.
    ``single_device`` runs JAX's distributed variants on a 1x1 mesh."""
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        extra = []
        if tmp_path is not None:
            extra = ["--output", str(tmp_path / f"{tag}.out")]
        run_args = _jax_args(args) if single_device and tag == "jax" else args
        rc = main([*run_args, *extra])
        out = _MS.sub("X msecs", capsys.readouterr().out)
        data = None
        if tmp_path is not None and (tmp_path / f"{tag}.out").exists():
            data = (tmp_path / f"{tag}.out").read_bytes()
        results.append((rc, out, data))
    return results


@pytest.mark.parametrize("variant", ["game", "cuda", "tpu"])
def test_random_grid_matches_jax(variant, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=5))
    jax_res, port_res = _both(capsys, ["64", "64", path, "--variant", variant],
                              tmp_path)
    assert port_res == jax_res
    assert port_res[0] == 0 and port_res[2]
    lines = port_res[1].splitlines()
    assert any(line.startswith("Generations:\t") for line in lines)
    assert ("Reading file:\tX msecs" in lines) == (variant == "tpu")


@pytest.mark.parametrize("variant", ["game", "cuda"])
@pytest.mark.parametrize("flow", ["block", "lone", "dead"])
def test_verify_flows_match_jax(flow, variant, capsys, tmp_path):
    g = np.zeros((48, 48), np.uint8)
    if flow == "block":
        g[3:5, 3:5] = 1
    elif flow == "lone":
        g[10, 40] = 1
    path = _write(tmp_path, "in.txt", g)
    jax_res, port_res = _both(capsys, ["48", "48", path, "--variant", variant],
                              tmp_path)
    assert port_res == jax_res


@pytest.mark.parametrize(
    "flags",
    [["--gen-limit", "37"], ["--gens", "37", "--kernel", "lax"],
     ["--no-check-similarity", "--gen-limit", "50"],
     ["--similarity-frequency", "1", "--warmup"]],
    ids=["limit37", "gens_lax", "no_similarity", "freq1_warmup"],
)
def test_flags_match_jax(flags, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 32, seed=9))
    jax_res, port_res = _both(
        capsys, ["64", "32", path, "--variant", "game", *flags], tmp_path)
    assert port_res == jax_res


def test_default_output_file_name(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, "in.txt", text_grid.generate(32, 32, seed=2))
    outputs = []
    for main in (jax_cli.main, cli.main):
        assert main(["32", "32", path, "--variant", "cuda"]) == 0
        outputs.append((tmp_path / "cuda_output.out").read_bytes())
        (tmp_path / "cuda_output.out").unlink()
    assert outputs[0] == outputs[1]
    capsys.readouterr()


def test_no_input_prints_finished(capsys):
    for args in ([], ["16", "16"], ["16", "16", "--variant", "cuda"]):
        jax_res, port_res = _both(capsys, args)
        assert port_res == jax_res == (0, "Finished\n", None)


def test_atoi_defaults_to_30x30(capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(30, 30, seed=1))
    jax_res, port_res = _both(
        capsys, ["abc", "-4", path, "--variant", "game", "--gen-limit", "20"],
        tmp_path)
    assert port_res == jax_res
    assert "Generations:\t" in port_res[1]


def test_errors_keep_the_gol_contract(capsys, tmp_path):
    # A missing input file: exit 1 with a `gol:` line on both.
    missing = str(tmp_path / "missing.txt")
    for main in (jax_cli.main, cli.main):
        assert main(["32", "32", missing, "--variant", "game"]) == 1
        assert capsys.readouterr().err.startswith("gol: ")
    # Packed I/O refuses a width that does not pack.
    path48 = _write(tmp_path, "in48.txt", text_grid.generate(48, 48, seed=1))
    assert cli.main(["48", "48", path48, "--packed-io"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("gol: ") and "divisible by 32" in err
    # The packed kernel refuses a width that does not pack.
    assert cli.main(["48", "48", path48, "--kernel", "packed"]) == 1
    assert "does not support" in capsys.readouterr().err
    # A grid above the dense ceiling is refused before anything allocates.
    assert cli.main(["65536", "16385", path48]) == 1
    assert "cell ceiling" in capsys.readouterr().err


def test_cuda_request_without_a_card_exits_1(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cuda")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    path = _write(tmp_path, "in.txt", text_grid.generate(32, 32, seed=1))
    assert cli.main(["32", "32", path, "--variant", "game"]) == 1
    assert "no CUDA card" in capsys.readouterr().err


def test_generate_matches_jax(capsys, tmp_path):
    outs = []
    for main in (jax_cli.main, cli.main):
        assert main(["generate", "40", "6", "--seed", "3"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    files = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / f"{tag}.txt"
        assert main(["generate", "40", "6", "--seed", "3", "-o", str(out)]) == 0
        files.append(out.read_bytes())
    assert files[0] == files[1] == outs[0].encode()


# ---------------------------------------------------------------------------
# The single-device lanes: every variant, --kernel pallas, --packed-io,
# --host, --snapshot-every, --resume-gen.


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_variant_matches_jax(variant, capsys, tmp_path):
    # 48 x 30 on a 48 x 48 file: mpi/collective/async/openmp force the
    # height to the width and read the whole file; game and cuda read 30
    # rows. tpu keeps rectangles, and its read takes only an exact file.
    path = _write(tmp_path, "in.txt", text_grid.generate(48, 48, seed=8))
    height = "48" if variant == "tpu" else "30"
    jax_res, port_res = _both(capsys, ["48", height, path, "--variant", variant],
                              tmp_path, single_device=True)
    assert port_res == jax_res
    assert port_res[0] == 0 and port_res[2]
    lines = port_res[1].splitlines()
    assert ("Reading file:\tX msecs" in lines) == VARIANTS[variant].io_timings
    assert (lines[-1] == "Finished") == VARIANTS[variant].final_finished


def _shifted_newline_file(tmp_path, n):
    """A file of exactly n x (n+1) bytes whose first row is one cell short
    and whose second row is one cell long."""
    data = bytearray(text_grid.encode(text_grid.generate(n, n, seed=12)))
    del data[n - 1]
    data.insert(2 * (n + 1) - 1, ord("1"))
    path = tmp_path / "shifted.txt"
    path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("variant", ["tpu", "collective", "async", "openmp"])
def test_sharded_variants_read_the_file_by_position(variant, capsys, tmp_path):
    # A 48^2 file run as 30 30: the sharded read refuses its size, as JAX's
    # does, where a serial scan would take its first 900 cells.
    path48 = _write(tmp_path, "in48.txt", text_grid.generate(48, 48, seed=1))
    errs = []
    for main, args in ((jax_cli.main, ["--mesh", "1x1"]), (cli.main, [])):
        assert main(["30", "30", path48, "--variant", variant, *args]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "size 2352 != 930 for a 30x30 text grid (sharded I/O requires" in errs[1]
    # A right-sized file with a misplaced newline reads by position.
    path = _shifted_newline_file(tmp_path, 32)
    jax_res, port_res = _both(capsys, ["32", "32", path, "--variant", variant,
                                       "--gen-limit", "5"], tmp_path,
                              single_device=True)
    assert port_res == jax_res and port_res[0] == 0
    serial = _both(capsys, ["32", "32", path, "--variant", "game",
                            "--gen-limit", "5"], tmp_path)[1]
    assert serial[2] != port_res[2]


def test_default_variant_refuses_a_wrong_size_file(capsys, tmp_path, monkeypatch):
    # The port's default variant is tpu, whose read is the sharded one.
    monkeypatch.chdir(tmp_path)
    path48 = _write(tmp_path, "in48.txt", text_grid.generate(48, 48, seed=1))
    assert cli.main(["30", "30", path48]) == 1
    err = capsys.readouterr().err
    assert err == (f"gol: {path48}: size 2352 != 930 for a 30x30 text grid "
                   "(sharded I/O requires the exact height x (width+1) layout)\n")
    assert not (tmp_path / "tpu_output.out").exists()


@pytest.mark.parametrize("variant", ["game", "cuda"])
@pytest.mark.parametrize("flow", ["random", "block", "lone", "dead"])
def test_kernel_pallas_matches_jax(flow, variant, capsys, tmp_path):
    # Shapes JAX's Pallas kernel takes: height % 8 == 0, width % 128 == 0.
    g = text_grid.generate(128, 16, seed=6) if flow == "random" else \
        np.zeros((16, 128), np.uint8)
    if flow == "block":
        g[3:5, 60:62] = 1
    elif flow == "lone":
        g[10, 100] = 1
    path = _write(tmp_path, "in.txt", g)
    jax_res, port_res = _both(
        capsys, ["128", "16", path, "--variant", variant, "--kernel", "pallas",
                 "--gen-limit", "200"], tmp_path)
    assert port_res == jax_res and port_res[0] == 0


@pytest.mark.parametrize("variant", ["game", "cuda"])
def test_kernel_pallas_runs_shapes_jax_refuses(variant, capsys, tmp_path):
    # JAX's Pallas gate refuses 48^2; the port's kernel takes it, and its
    # output equals JAX's --kernel lax run.
    path = _write(tmp_path, "in.txt", text_grid.generate(48, 48, seed=3))
    assert jax_cli.main(["48", "48", path, "--variant", variant,
                         "--kernel", "pallas"]) == 1
    capsys.readouterr()
    jax_res, _ = _both(capsys, ["48", "48", path, "--variant", variant,
                                "--kernel", "lax"], tmp_path)
    _, port_res = _both(capsys, ["48", "48", path, "--variant", variant,
                                 "--kernel", "pallas"], tmp_path)
    assert port_res == jax_res and port_res[0] == 0


@pytest.mark.parametrize("variant", ["game", "cuda", "tpu", "async"])
def test_packed_io_matches_jax(variant, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=4))
    for extra in ([], ["--gen-limit", "37", "--warmup"]):
        jax_res, port_res = _both(
            capsys, ["64", "64", path, "--variant", variant, "--packed-io", *extra],
            tmp_path, single_device=True)
        assert port_res == jax_res and port_res[0] == 0
    assert not list(tmp_path.glob("*.inprogress"))


@pytest.mark.parametrize("variant", ["game", "cuda", "collective", "openmp"])
def test_host_matches_jax(variant, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(48, 48, seed=5))
    jax_res, port_res = _both(
        capsys, ["48", "48", path, "--variant", variant, "--host"], tmp_path)
    assert port_res == jax_res and port_res[0] == 0


@pytest.mark.parametrize(
    "variant,flags",
    [("game", ["--kernel", "pallas"]), ("cuda", []), ("tpu", ["--kernel", "lax"]),
     ("collective", ["--packed-io"]), ("cuda", ["--packed-io"])],
    ids=["game_pallas", "cuda_auto", "tpu_lax", "collective_packed_io",
         "cuda_packed_io"],
)
def test_snapshots_match_jax(variant, flags, capsys, tmp_path):
    # 128 wide: JAX's Pallas kernel takes only widths that divide by 128.
    path = _write(tmp_path, "in.txt", text_grid.generate(128, 128, seed=10))
    results, snaps = [], []
    for tag, main, extra in (("jax", jax_cli.main, _jax_args(["--variant", variant])[2:]),
                             ("port", cli.main, [])):
        snapdir = tmp_path / f"snaps_{tag}"
        rc = main(["128", "128", path, "--variant", variant, *flags, *extra,
                   "--gen-limit", "40", "--snapshot-every", "16",
                   "--snapshot-dir", str(snapdir),
                   "--output", str(tmp_path / f"{tag}.out")])
        results.append((rc, _MS.sub("X msecs", capsys.readouterr().out),
                        (tmp_path / f"{tag}.out").read_bytes()))
        snaps.append({p.name: p.read_bytes() for p in sorted(snapdir.iterdir())})
    assert results[1] == results[0] and results[1][0] == 0
    assert snaps[1] == snaps[0]
    assert sorted(snaps[1]) == ["gen_000016.out", "gen_000032.out", "gen_000040.out"]


@pytest.mark.parametrize("flags", [[], ["--kernel", "pallas"], ["--packed-io"]],
                         ids=["auto", "pallas", "packed_io"])
def test_resume_gen_matches_jax_and_the_whole_run(flags, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(128, 32, seed=19))
    snap = tmp_path / "snaps" / "gen_000013.out"
    base = ["128", "32", "--variant", "game", "--gen-limit", "60", *flags]
    assert cli.main([*base[:2], path, *base[2:], "--snapshot-every", "13",
                     "--snapshot-dir", str(tmp_path / "snaps"),
                     "--output", str(tmp_path / "whole.out")]) == 0
    capsys.readouterr()
    jax_res, port_res = _both(
        capsys, [*base[:2], str(snap), *base[2:], "--resume-gen", "13"], tmp_path)
    assert port_res == jax_res and port_res[0] == 0
    assert port_res[2] == (tmp_path / "whole.out").read_bytes()


@pytest.mark.parametrize(
    "flags",
    [["--resume-gen", "-1"], ["--gen-limit", "10", "--resume-gen", "25"],
     ["--host", "--resume-gen", "3"], ["--host", "--kernel", "packed"],
     ["--host", "--packed-io"], ["--packed-io", "--kernel", "lax"],
     ["--packed-io", "--kernel", "pallas"], ["--snapshot-format", "zarr"],
     ["--packed-io", "--variant", "game", "WIDTH48"],
     ["--kernel", "packed", "SQUARE40"],
     ["--kernel", "packed", "--variant", "cuda", "SQUARE40"]],
    ids=["resume_negative", "resume_above_limit", "host_resume", "host_kernel",
         "host_packed_io", "packed_io_lax", "packed_io_pallas",
         "zarr_without_packed_io", "packed_io_width", "packed_shape",
         "packed_shape_cuda"],
)
def test_refusals_match_jax(flags, capsys, tmp_path):
    width = "48" if "WIDTH48" in flags else "40" if "SQUARE40" in flags else "64"
    height = "40" if "SQUARE40" in flags else "64"
    flags = [f for f in flags if f not in ("WIDTH48", "SQUARE40")]
    path = _write(tmp_path, "in.txt",
                  text_grid.generate(int(width), int(height), seed=2))
    errs = []
    for main in (jax_cli.main, cli.main):
        assert main([width, height, path, "--variant", "game", *flags]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[1].startswith("gol: ")


@pytest.mark.parametrize(
    "args",
    [["40000", "40000", "MISSING", "--variant", "game"],
     ["65536", "65536", "MISSING", "--variant", "tpu", "--mesh", "1x1"]],
    ids=["game", "tpu_1x1"],
)
def test_dense_ceiling_refusal_matches_jax(args, capsys, tmp_path):
    # Above the dense ceiling both CLIs refuse before reading the file (it
    # need not exist), with the same line naming the sparse lane.
    args = [str(tmp_path / "missing.txt") if a == "MISSING" else a for a in args]
    results = []
    for main in (jax_cli.main, cli.main):
        rc = main(args)
        results.append((rc, *capsys.readouterr()))
    assert results[0] == results[1]
    rc, out, err = results[1]
    assert rc == 1 and out == ""
    assert err.startswith("gol: ") and "use the sparse lane" in err


def _subcommands(parser) -> set:
    return set(next(a for a in parser._actions if a.dest == "command").choices)


def test_jax_subcommands_not_ported_are_named():
    # Every subcommand of the JAX CLI is the port's, and the port has no
    # subcommand JAX lacks: none is left to refuse.
    jax_names = _subcommands(jax_cli.build_parser())
    port_names = _subcommands(cli.build_parser())
    assert port_names == set(cli.SUBCOMMANDS) == jax_names


def test_show_without_sizes_matches_jax(capsys, tmp_path):
    # `show FILE` (no W H) exits 2 with show's usage under both CLIs.
    path = _write(tmp_path, "in.txt", text_grid.generate(8, 8, seed=1))
    results = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["show", path])
        results.append((exc.value.code, *capsys.readouterr()))
    assert results[1] == results[0]
    assert results[1][0] == 2 and results[1][2].startswith("usage: gol show ")


@pytest.mark.parametrize(
    "args",
    [["8", "8", "IN"], ["8", "8", "IN", "--animate", "5", "--fps", "0"],
     ["12", "6", "IN", "--animate", "40", "--fps", "0"],
     ["0", "x", "IN30"], ["8", "8", "MISSING"]],
    ids=["show", "animate", "animate_to_empty", "atoi_defaults", "missing_file"],
)
def test_show_matches_jax(args, capsys, tmp_path):
    """`show` renders the same VT100 stream, and fails alike on a missing
    file; the 12x6 grid is a pair of cells that dies in one generation, which
    stops the animation early."""
    grids = {"IN": text_grid.generate(8, 8, seed=4),
             "IN30": text_grid.generate(30, 30, seed=6)}
    if args[0] == "12":
        grids["IN"] = np.zeros((6, 12), np.uint8)
        grids["IN"][2, 3:5] = 1
    paths = {k: _write(tmp_path, f"{k}.txt", g) for k, g in grids.items()}
    paths["MISSING"] = str(tmp_path / "missing.txt")
    args = ["show", *(paths.get(a, a) for a in args)]
    results = []
    for main in (jax_cli.main, cli.main):
        results.append((main(args), *capsys.readouterr()))
    assert results[1] == results[0]
    rc, out, err = results[1]
    if args[-1] == paths["MISSING"]:
        assert rc == 1 and out == "" and err.startswith("gol: ")
    else:
        assert rc == 0 and err == "" and out.count("\033[H") >= 1


def test_unknown_kernel_matches_jax(capsys, tmp_path):
    """An unknown --kernel exits 1 with JAX's message. The lists differ by
    JAX's two Pallas debugging routes, which the port does not have."""
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=2))
    errs = []
    for main in (jax_cli.main, cli.main):
        assert main(["64", "64", path, "--variant", "game", "--kernel", "bogus"]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == ("gol: unknown kernel 'bogus'; available: ['lax', 'packed', "
                       "'packed-interp', 'packed-jnp', 'pallas']\n")
    assert errs[1] == errs[0].replace("'packed-interp', 'packed-jnp', ", "")


@pytest.mark.parametrize("kernel", ["packed-interp", "packed-jnp"])
def test_jax_debug_kernels_are_unknown_to_the_port(kernel, capsys, tmp_path):
    # A known difference: JAX runs its Pallas debugging routes, the port
    # refuses them as unknown kernels.
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=2))
    args = ["64", "64", path, "--variant", "game", "--kernel", kernel,
            "--gen-limit", "8", "--output", str(tmp_path / "jax.out")]
    assert jax_cli.main(args) == 0
    capsys.readouterr()
    assert cli.main(args) == 1
    assert capsys.readouterr().err == (
        f"gol: unknown kernel {kernel!r}; available: ['lax', 'packed', 'pallas']\n")


def test_zarr_is_refused(capsys, tmp_path):
    # The port has no TensorStore: zarr snapshots and inputs exit 1.
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=2))
    zarr_dir = tmp_path / "gen_000010.zarr"
    zarr_dir.mkdir()
    for args in ([path, "--packed-io", "--snapshot-format", "zarr",
                  "--snapshot-every", "5"],
                 [str(zarr_dir), "--packed-io", "--resume-gen", "10"],
                 [str(zarr_dir)]):
        assert cli.main(["64", "64", *args]) == 1
        err = capsys.readouterr().err
        assert err.startswith("gol: ") and ("zarr" in err or "TensorStore" in err)


# ---------------------------------------------------------------------------
# The mesh lanes: --mesh RxC over GOL_TORCH_MESH_DEVICES=8 CPU shards, with
# the same --mesh passed to the JAX CLI (8 virtual CPU devices).


@pytest.fixture
def eight_shards(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_MESH_DEVICES", "8")


@pytest.mark.parametrize("mesh", ["2x2", "4x1", None], ids=["2x2", "4x1", "default"])
@pytest.mark.parametrize("variant", ["mpi", "collective", "async", "openmp", "tpu"])
def test_mesh_variants_match_jax(variant, mesh, eight_shards, capsys, tmp_path):
    # JAX's Pallas kernel takes no shard narrower than 128 cells, so the
    # port's --kernel pallas (K6) is held against JAX's --kernel lax.
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=14))
    base = ["64", "64", path, "--variant", variant,
            *(["--mesh", mesh] if mesh else [])]
    jax_res, port_res = _both(capsys, [*base, "--gen-limit", "300"], tmp_path)
    assert port_res == jax_res and port_res[0] == 0
    jax_res, _ = _both(capsys, [*base, "--kernel", "lax", "--gen-limit", "40"], tmp_path)
    _, port_res = _both(capsys, [*base, "--kernel", "pallas", "--gen-limit", "40"],
                        tmp_path)
    assert port_res == jax_res and port_res[0] == 0


@pytest.mark.parametrize("variant", ["tpu", "collective"])
def test_mesh_lax_and_rectangles_match_jax(variant, eight_shards, capsys, tmp_path):
    # tpu keeps rectangles: 32 rows over 2x4 shards of 16x16 (lax) and 4x1
    # shards of 8x64 (auto: the 8-generation pass with 8-row shards).
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 32 if variant == "tpu" else 64,
                                                         seed=15))
    height = "32" if variant == "tpu" else "64"
    for flags in (["--mesh", "2x4", "--kernel", "lax"], ["--mesh", "4x1"],
                  ["--mesh", "2x4", "--gen-limit", "21", "--no-check-similarity"]):
        jax_res, port_res = _both(
            capsys, ["64", height, path, "--variant", variant, *flags], tmp_path)
        assert port_res == jax_res and port_res[0] == 0


@pytest.mark.parametrize(
    "args",
    [["16", "16", "IN16", "--variant", "tpu", "--mesh", "3x1"],
     ["64", "64", "IN64", "--variant", "game", "--mesh", "2x2"],
     ["64", "64", "IN64", "--variant", "tpu", "--mesh", "2by2"],
     ["64", "64", "IN64", "--variant", "collective", "--mesh", "3x3"],
     ["64", "64", "IN64", "--variant", "tpu", "--mesh", "0x2"],
     ["64", "64", "IN64", "--variant", "mpi", "--host", "--mesh", "2x2"],
     ["96", "96", "IN96", "--variant", "tpu", "--mesh", "2x2", "--packed-io"],
     ["40", "40", "IN40", "--variant", "tpu", "--mesh", "2x2", "--kernel", "packed"]],
    ids=["does_not_divide", "single_device_variant", "malformed", "too_many",
         "zero_axis", "host", "packed_io_width", "packed_shard_shape"],
)
def test_mesh_refusals_match_jax(args, eight_shards, capsys, tmp_path):
    paths = {"IN16": _write(tmp_path, "in16.txt", text_grid.generate(16, 16, seed=1)),
             "IN40": _write(tmp_path, "in40.txt", text_grid.generate(40, 40, seed=1)),
             "IN64": _write(tmp_path, "in64.txt", text_grid.generate(64, 64, seed=1)),
             "IN96": _write(tmp_path, "in96.txt", text_grid.generate(96, 96, seed=1))}
    args = [paths.get(a, a) for a in args]
    errs = []
    for main in (jax_cli.main, cli.main):
        assert main(args) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[1].startswith("gol: ")


def test_huge_byte_lane_warning_matches_jax(eight_shards, capsys, tmp_path):
    """65536^2 over two shards is 2 GB of bytes per shard: both CLIs warn and
    name --packed-io before the read, then fail on the missing file."""
    missing = str(tmp_path / "missing.txt")
    results = []
    for main in (jax_cli.main, cli.main):
        rc = main(["65536", "65536", missing, "--variant", "tpu", "--mesh", "2x1"])
        results.append((rc, *capsys.readouterr()))
    assert results[1] == results[0]
    rc, out, err = results[1]
    assert rc == 1 and out == ""
    assert err.splitlines()[0] == (
        "warning: 65536x65536 as bytes is 2.0 GB per buffer per device; if this "
        "runs out of device memory, use --packed-io (bit-packed state, 32x smaller)")
    assert err.splitlines()[1].startswith("gol: ")


@pytest.mark.parametrize(
    "flags",
    [["--packed-io"], ["--snapshot-every", "10"], ["--resume-gen", "5"]],
    ids=["packed_io", "snapshot_every", "resume_gen"],
)
def test_lanes_not_ported_to_a_mesh_exit_1(flags, eight_shards, capsys, tmp_path,
                                            monkeypatch):
    """These three lanes exited 1 on a mesh until the segment and
    packed-state runners took one. Now each runs there as in the JAX CLI:
    output file, snapshot files and printed lines identical, alone and with
    ``--packed-io``."""
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=3))
    combos = [flags] if flags == ["--packed-io"] else [flags, [*flags, "--packed-io"]]
    for mesh in (["--mesh", "2x2"], []):  # the default mesh is 8x1 here
        for combo in combos:
            results, snaps = [], []
            for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
                snapdir = tmp_path / f"snaps_{tag}_{len(mesh)}_{len(combo)}"
                rc = main(["64", "64", path, "--variant", "tpu", *mesh, *combo,
                           "--gen-limit", "40", "--snapshot-dir", str(snapdir),
                           "--output", str(tmp_path / f"{tag}.out")])
                results.append((rc, _MS.sub("X msecs", capsys.readouterr().out),
                                (tmp_path / f"{tag}.out").read_bytes()))
                snaps.append({p.name: p.read_bytes() for p in snapdir.glob("*")})
            assert results[1] == results[0] and results[1][0] == 0, (mesh, combo)
            assert snaps[1] == snaps[0], (mesh, combo)
            if "--snapshot-every" in combo:
                assert sorted(snaps[1]) == [f"gen_{g:06d}.out" for g in (10, 20, 30, 40)]
    assert not list(tmp_path.glob("*.inprogress"))


# ---------------------------------------------------------------------------
# `batch` and `compact`, against the JAX CLI.

_RATE = re.compile(r"\d+\.\d+ boards/sec")


def _masked_stderr(err: str) -> str:
    return _MS.sub("X msecs", _RATE.sub("X boards/sec", err))


def _batch_inputs(tmp_path, width, height, seeds):
    """Input files of ``width`` x ``height``: a board that dies, one that
    stands still and random ones."""
    paths = []
    dies = np.zeros((height, width), np.uint8)
    dies[height // 2, width // 2] = 1
    still = np.zeros((height, width), np.uint8)
    still[1:3, 1:3] = 1
    for i, g in enumerate([dies, still] + [text_grid.generate(width, height, seed=s)
                                           for s in seeds]):
        paths.append(_write(tmp_path, f"in{i}.txt", g))
    return paths


def _run_both(capsys, args, outputs):
    """Each CLI on ``args``: ``(rc, stdout, masked stderr, {output: bytes})``,
    the outputs read and removed after each run, so both write the same
    names."""
    results = []
    for main in (jax_cli.main, cli.main):
        rc = main(args)
        out, err = capsys.readouterr()
        data = {}
        for path in outputs():
            data[path.name] = path.read_bytes()
            path.unlink()
        results.append((rc, out, _masked_stderr(err), data))
    return results


@pytest.mark.parametrize("case", [
    ("packed", 32, 32, []), ("masked", 30, 30, []), ("tall", 20, 33, []),
    ("cuda", 32, 32, ["--variant", "cuda"]), ("limit", 64, 32, ["--gen-limit", "7"]),
    ("max_batch_2", 32, 32, ["--max-batch", "2"]),
    ("max_batch_1_cuda", 30, 30, ["--max-batch", "1", "--variant", "cuda"]),
], ids=lambda c: c[0])
def test_batch_matches_jax(case, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, width, height, flags = case
    paths = _batch_inputs(tmp_path, width, height, (1, 2, 3))
    outdir = tmp_path / "out"
    results = _run_both(capsys, ["batch", str(width), str(height), *paths,
                                 "--output-dir", str(outdir), "--gen-limit", "40",
                                 *flags],
                        lambda: sorted(outdir.glob("*.out")))
    assert results[1] == results[0]
    rc, out, err, data = results[1]
    assert rc == 0 and len(data) == 5 and len(out.splitlines()) == 5
    assert err.startswith("Batch:\t5 boards, 1 bucket(s), ")
    assert err.endswith("X boards/sec, X msecs\n")


def test_batch_writes_next_to_its_inputs_by_default(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = _batch_inputs(tmp_path, 32, 32, (4,))
    results = _run_both(capsys, ["batch", "32", "32", *paths, "--gen-limit", "20"],
                        lambda: sorted(tmp_path.glob("*.txt.out")))
    assert results[1] == results[0]
    assert sorted(results[1][3]) == [f"in{i}.txt.out" for i in range(3)]


@pytest.mark.parametrize("flags", [["--max-batch", "0"], ["--max-batch", "65"],
                                   ["--variant", "nope"]],
                         ids=["max_batch_0", "max_batch_65", "variant"])
def test_batch_refusals_match_jax(flags, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paths = _batch_inputs(tmp_path, 32, 32, ())
    results = []
    for main in (jax_cli.main, cli.main):
        try:
            rc = main(["batch", "32", "32", *paths, *flags])
        except SystemExit as e:  # argparse's refusal
            rc = e.code
        out, err = capsys.readouterr()
        results.append((rc, out, err))
    assert results[1] == results[0]
    assert results[1][0] != 0
    assert not list(tmp_path.glob("*.out"))


def test_batch_missing_file_matches_jax(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = _run_both(capsys, ["batch", "32", "32", "missing.txt"], lambda: [])
    assert results[1] == results[0]
    assert results[1][0] == 1 and results[1][2].startswith("gol: ")


def _journal_dir(path, seed):
    """A segmented journal written by the JAX package: submits, results,
    a failure and a cancel, sealed into several segments."""
    from gol_tpu.serve import jobs as jax_jobs

    j = jax_jobs.JobJournal(str(path), segment_bytes=300)
    for i in range(5):
        job = jax_jobs.Job(id=f"{seed}-{i}", width=8, height=6,
                           board=text_grid.generate(8, 6, seed=seed + i))
        j.record_submit(job)
        if i < 3:
            job.result = jax_jobs.JobResult(grid=job.board, generations=i,
                                            exit_reason="gen_limit")
            j.record_done(job)
    j.close()


@pytest.mark.parametrize("layout", ["journal", "fleet", "fleet_retain", "empty"])
def test_compact_matches_jax(layout, capsys, tmp_path, monkeypatch):
    """``compact`` on a journal directory and on a fleet-shaped one (one
    journal per worker partition): the same lines and the same files."""
    import shutil

    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    if layout == "journal":
        _journal_dir(src, 0)
    elif layout.startswith("fleet"):
        for k, name in enumerate(("w0", "w1")):
            _journal_dir(src / name, 10 * k)
        (src / "manifest.json").write_text("{}")
    else:
        src.mkdir()
    flags = ["--retain", "1"] if layout == "fleet_retain" else []
    results = []
    for main in (jax_cli.main, cli.main):
        shutil.copytree(src, tmp_path / "work")
        rc = main(["compact", "work", *flags])
        out, err = capsys.readouterr()
        files = {str(p.relative_to(tmp_path / "work")): p.read_bytes()
                 for p in sorted((tmp_path / "work").rglob("*")) if p.is_file()
                 and p.name != "compaction.lock"}
        results.append((rc, out, err, files))
        shutil.rmtree(tmp_path / "work")
    assert results[1] == results[0]
    rc, out, err, _ = results[1]
    if layout == "empty":
        assert rc == 1 and err == "gol: no journal state under work\n"
    else:
        assert rc == 0 and "compacted" in out


# ---------------------------------------------------------------------------
# `serve`, `submit` and `gc`, against the JAX CLI.


def _parser_of(module, name):
    sub = next(a for a in module.build_parser()._actions if a.dest == "command")
    return sub.choices[name]


def _options(parser) -> list:
    """Each argument's strings, dest, default, choices, nargs, const and
    type: everything but the help text."""
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default),
         repr(sorted(a.choices)) if a.choices else None, repr(a.nargs),
         repr(a.const), getattr(a.type, "__name__", None))
        for a in parser._actions)


@pytest.mark.parametrize("name", ["serve", "submit", "gc", "tune", "top",
                                  "fleet-trace", "fleet", "router"])
def test_server_lane_parsers_match_jax(name):
    """The same option strings and defaults as JAX's parsers; the options
    whose lanes are not ported are there too, and refused when used."""
    assert _options(_parser_of(cli, name)) == _options(_parser_of(jax_cli, name))


def _serve_rc(main, args, capsys):
    try:
        rc = main(["serve", "--port", "0", "--sample-interval", "0", *args])
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("flags, refusal", [
    (["--cache-payload", "ts", "--result-cache"], "'ts' cache payload"),
], ids=["ts"])
def test_serve_refusals_exit_1_naming_the_roadmap(flags, refusal, capsys,
                                                  tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, out, err = _serve_rc(cli.main, flags, capsys)
    assert (rc, out) == (1, "")
    assert err.startswith("gol: ") and refusal in err and err.count("\n") == 1
    assert "ROADMAP.md" in err or "not ported" in err
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("flags", [
    ["--resident-ring", "8", "--pipeline-depth", "16"],
    ["--resident-ring", "2", "--pipeline-depth", "2", "--journal-dir", "j"],
    ["--warm-plans"],
], ids=["ring_8", "ring_2", "warm_plans"])
def test_serve_lanes_run(flags, capsys, tmp_path, monkeypatch):
    """The lanes the port once refused run: the server boots with them (its
    ``serve_forever`` stands in for traffic: one job through the scheduler,
    then a drained shutdown) and exits 0."""
    from gol_tpu_torch.serve.jobs import new_job
    from gol_tpu_torch.serve.server import GolServer
    from gol_tpu_torch.tune import select

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GOL_PLAN_CACHE", str(tmp_path / "plans.json"))
    select.reset()
    seen = {}

    def serve_forever(self):
        self.start()
        board = text_grid.generate(32, 32, seed=3)
        job = self.scheduler.submit(new_job(32, 32, board, gen_limit=20))
        assert self.scheduler.drain(timeout=60)
        seen["ring"] = self.scheduler.resident_ring
        seen["result"] = job.result
        self.shutdown(drain=True)

    monkeypatch.setattr(GolServer, "serve_forever", serve_forever)
    rc, out, err = _serve_rc(cli.main, flags, capsys)
    select.reset()
    assert rc == 0 and out.startswith("serving on http://127.0.0.1:")
    ring = int(flags[1]) if flags[0] == "--resident-ring" else 0
    assert seen["ring"] == ring
    solo = oracle.run(text_grid.generate(32, 32, seed=3), GameConfig(gen_limit=20))
    assert np.array_equal(seen["result"].grid, solo.grid)
    assert seen["result"].generations == solo.generations
    if flags == ["--warm-plans"]:
        assert err.startswith("no tuned serve shapes to warm")


@pytest.mark.parametrize("flags", [
    ["--flush-age", "-1"], ["--slo-latency-p99", "0"], ["--cache-entries", "0"],
    ["--cache-disk-bytes", "0"], ["--journal-segment-bytes", "-1"],
    ["--journal-retain", "0"], ["--disk-reserve", "-1"], ["--disk-reserve", "5"],
    ["--metrics-history"], ["--metrics-history", "H", "--sample-interval", "0"],
    ["--history-bytes", "100"], ["--retry-budget", "-1"],
    ["--resident-ring", "1"], ["--resident-ring", "-1"], ["--resident-ring", "2"],
    ["--max-batch", "65"], ["--pipeline-depth", "2", "--max-inflight", "2"],
    ["--cache-payload", "zarr"],
], ids=lambda f: "_".join(f).strip("-").replace("--", ""))
def test_serve_flag_refusals_match_jax(flags, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = [_serve_rc(main, flags, capsys) for main in (jax_cli.main, cli.main)]
    assert results[1] == results[0]
    assert results[1][0] != 0


def test_serve_without_a_card_exits_1_before_serving(capsys, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GOL_TORCH_DEVICE")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc, out, err = _serve_rc(cli.main, ["--journal-dir", "j"], capsys)
    assert (rc, out) == (1, "")
    assert err.startswith("gol: ") and "no CUDA card" in err


def _running_servers(tmp_path, tag=""):
    from gol_tpu.serve.server import GolServer as JaxServer
    from gol_tpu_torch.serve.server import GolServer

    servers = {}
    for name, cls in (("jax", JaxServer), ("port", GolServer)):
        servers[name] = cls(port=0, journal_dir=str(tmp_path / f"j_{tag}{name}"),
                            flush_age=0.01, sample_interval=0, result_cache=True)
        servers[name].start()
    return servers


_NOTE = re.compile(r"\tqueue \d+\.\d+ ms\ttotal \d+\.\d+ ms")
_ID = re.compile(r"\b[0-9a-f]{32}\b")


def _submit_lines(text: str) -> list:
    """The printed lines with ids and timings masked, sorted: a result line
    prints when a poll finds its job done, in an order the timing sets."""
    return sorted(_ID.sub("ID", _NOTE.sub("\tqueue X ms\ttotal X ms", text))
                  .splitlines())


@pytest.mark.parametrize("flags", [[], ["--wire", "packed"], ["--variant", "cuda"],
                                   ["--no-wait"], ["--no-cache", "--gen-limit", "9"]],
                         ids=["text", "packed", "cuda", "no_wait", "no_cache"])
def test_submit_crosses_the_packages(flags, capsys, tmp_path, monkeypatch):
    """JAX's submit against the port's server and the port's submit against
    JAX's server, beside each package against its own: the same printed
    lines (ids and timings masked) and byte-identical outputs. Each pair
    submits the inputs twice, so the second answers from the cache."""
    monkeypatch.chdir(tmp_path)
    paths = _batch_inputs(tmp_path, 30, 30, (5,)) + [
        _write(tmp_path, "wide.txt", text_grid.generate(32, 32, seed=6))]
    results = {}
    for client, main in (("jax", jax_cli.main), ("port", cli.main)):
        servers = _running_servers(tmp_path, client)
        capsys.readouterr()  # the servers' boot lines
        try:
            for target, srv in servers.items():
                outdir = tmp_path / f"out_{client}_{target}"
                runs = []
                for _ in range(2):
                    rc = main(["submit", "30", "30", *paths, "--server", srv.url,
                               "--poll-interval", "0.02", "--gen-limit", "40",
                               "--output-dir", str(outdir), *flags])
                    out, err = capsys.readouterr()
                    runs.append((rc, _submit_lines(out.replace(str(outdir), "OUT")),
                                 err))
                files = {p.name: p.read_bytes() for p in sorted(outdir.glob("*"))}
                results[(client, target)] = (runs, files)
        finally:
            for srv in servers.values():
                srv.shutdown()
    want = results[("jax", "jax")]
    for key, got in results.items():
        assert got == want, key
    runs, files = want
    assert runs[0][0] == 0 and runs[0][2] == ""
    if "--no-wait" in flags:
        assert files == {}
    else:
        assert len(files) == len(paths)
        assert (any("cached:" in line for line in runs[1][1])
                == ("--no-cache" not in flags))


def test_submit_against_a_draining_server_matches_jax(capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(8, 8, seed=2))
    servers = _running_servers(tmp_path)
    results = []
    try:
        for srv in servers.values():
            srv.drain()
        capsys.readouterr()  # the servers' boot lines
        for main in (jax_cli.main, cli.main):
            for srv in servers.values():
                rc = main(["submit", "8", "8", path, "--server", srv.url])
                out, err = capsys.readouterr()
                results.append((rc, out, err.replace(srv.url, "URL")))
    finally:
        for srv in servers.values():
            srv.shutdown()
    assert all(r == results[0] for r in results)
    assert results[0][0] == 1 and "HTTP 429: server is draining" in results[0][2]


def test_serve_submit_and_sigterm_as_processes(tmp_path):
    """``python -m gol_tpu_torch serve`` on the CPU: it prints its URL,
    answers ``submit``, drains on SIGTERM and exits 0; a restart replays
    nothing and still serves the result."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "GOL_TORCH_DEVICE": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [repo] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else []))}
    path = _write(tmp_path, "in.txt", text_grid.generate(30, 30, seed=3))
    journal = str(tmp_path / "journal")
    serve = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", "serve", "--port", "0",
         "--journal-dir", journal, "--result-cache", "--flush-age", "0.01"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
        cwd=tmp_path)
    try:
        line = serve.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:")
        url = line.split()[2]
        sub = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "submit", "30", "30", path,
             "--server", url, "--gen-limit", "25", "--poll-interval", "0.02"],
            capture_output=True, text=True, env=env, timeout=120)
        assert sub.returncode == 0, sub.stderr
        assert "Generations:\t25\tgen_limit\t-> " in sub.stdout
        serve.send_signal(signal.SIGTERM)
        assert serve.wait(timeout=60) == 0
    finally:
        if serve.poll() is None:
            serve.kill()
        serve.stdout.close()
    want = text_grid.read_grid(path, 30, 30)
    from gol_tpu_torch import oracle
    from gol_tpu_torch.config import GameConfig

    got = text_grid.read_grid(path + ".out", 30, 30)
    np.testing.assert_array_equal(got, oracle.run(want, GameConfig(gen_limit=25)).grid)
    assert os.listdir(os.path.join(journal, "cache"))


# ---------------------------------------------------------------------------
# The pattern lane: --pattern, --universe, --place, --engine, --tile, --gens,
# --macro-cas, and --engine sparse|macro over a dense input file


PATTERNS = Path(__file__).resolve().parent.parent / "patterns"


def _both_io(capsys, args, tmp_path, name="out.rle"):
    """Both CLIs: ``[(rc, stdout masked, stderr, output bytes)]`` for JAX,
    port, each writing ``--output`` into its own directory. The port's log
    lines name its own logger (``gol_tpu_torch: ...``)."""
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / tag / name
        out.parent.mkdir(exist_ok=True)
        rc = main([*args, "--output", str(out)])
        stdout, stderr = capsys.readouterr()
        stderr = stderr.replace("gol_tpu_torch: ", "gol_tpu: ")
        results.append((rc, _MS.sub("X msecs", stdout), stderr,
                        out.read_bytes() if out.exists() else None))
    return results


@pytest.fixture
def pinned_plans(tmp_path, monkeypatch):
    """A private, empty plan cache: both packages' --engine auto read the
    bundled crossover (2^25 cells) and the built-in macro threshold."""
    from gol_tpu.tune import select as jax_select
    from gol_tpu_torch.tune import select

    monkeypatch.setenv("GOL_PLAN_CACHE", str(tmp_path / "plans.json"))
    select.reset()
    jax_select.reset()
    yield
    select.reset()
    jax_select.reset()


@pytest.mark.parametrize("variant", ["game", "cuda", "tpu"])
@pytest.mark.parametrize("engine", ["auto", "dense", "sparse", "macro"])
@pytest.mark.parametrize("case", [
    ("glider", "64x64", "10,10", "8", "50"),
    ("gosper_gun", "128x96", "40,30", "8", "120"),
    ("diehard", "128x128", "50,60", "16", "140"),
    ("block", None, "0,0", "4", "9"),
], ids=lambda c: c[0])
def test_pattern_lane_matches_jax(case, engine, variant, pinned_plans, capsys,
                                  tmp_path):
    name, universe, place, tile, gens = case
    if name == "block":  # the RLE's own extents are the universe
        pattern = tmp_path / "block.rle"
        pattern.write_text("x = 16, y = 16\n6$6b2o$6b2o!")
    else:
        pattern = PATTERNS / f"{name}.rle"
    args = ["--pattern", str(pattern), "--place", place, "--tile", tile,
            "--gens", gens, "--variant", variant, "--engine", engine]
    if universe:
        args += ["--universe", universe]
    jax_res, port_res = _both_io(capsys, args, tmp_path)
    assert port_res == jax_res
    assert port_res[0] == 0 and port_res[3]


@pytest.mark.parametrize("engine", ["auto", "sparse", "macro"])
def test_pattern_lane_default_output_and_large_universe(engine, pinned_plans,
                                                        capsys, tmp_path,
                                                        monkeypatch):
    """Above the bundled crossover auto takes the sparse lane (8192^2 >=
    2^25); the default output is sparse_output.rle, never a dense grid."""
    monkeypatch.chdir(tmp_path)
    outputs = []
    for main in (jax_cli.main, cli.main):
        rc = main(["--pattern", str(PATTERNS / "glider.rle"), "--universe",
                   "8192x8192", "--place", "4000,4000", "--gens", "30",
                   "--engine", engine, "--variant", "game"])
        out, err = capsys.readouterr()
        outputs.append((rc, _MS.sub("X msecs", out), err,
                        (tmp_path / "sparse_output.rle").read_bytes()))
        (tmp_path / "sparse_output.rle").unlink()
        assert not (tmp_path / "game_output.out").exists()
    assert outputs[0] == outputs[1] and outputs[1][0] == 0


@pytest.mark.parametrize("gens,engine", [(300, "auto"), (300, "macro"),
                                         (40, "auto")])
def test_auto_follows_measured_thresholds_as_jax(gens, engine, pinned_plans,
                                                 capsys, tmp_path):
    """Under measured thresholds in the plan cache (each package's own
    entry: 2^16 cells, 64 generations) auto takes the sparse lane at 1024^2
    and upgrades a deep run kept off the torus seam to the macro lane; both
    lanes write the same bytes either way."""
    from gol_tpu.tune import plans as jax_plans
    from gol_tpu.tune import select as jax_select
    from gol_tpu_torch.tune import plans, select

    for store, sel in ((plans.PlanStore(), select),
                       (jax_plans.PlanStore(), jax_select)):
        store.put(sel.sparse_fingerprint(), {"auto_area": 1 << 16})
        store.put(sel.macro_fingerprint(), {"auto_gens": 64})
    args = ["--pattern", str(PATTERNS / "glider.rle"), "--universe",
            "1024x1024", "--place", "512,512", "--gens", str(gens),
            "--tile", "8", "--engine", engine, "--variant", "game"]
    jax_res, port_res = _both_io(capsys, args, tmp_path)
    assert port_res == jax_res and port_res[0] == 0
    assert port_res[3].startswith(f"#C generations {gens} exit gen_limit\n".encode())


@pytest.mark.parametrize("engine", ["sparse", "macro"])
@pytest.mark.parametrize("variant", ["game", "cuda"])
@pytest.mark.parametrize("flow", ["random", "block", "lone", "dead"])
def test_engine_over_an_input_file_matches_jax(flow, variant, engine, capsys,
                                               tmp_path):
    if flow == "random":
        g = text_grid.generate(64, 64, seed=13)
    else:
        g = np.zeros((64, 64), np.uint8)
        if flow == "block":
            g[30:32, 30:32] = 1
        elif flow == "lone":
            g[20, 40] = 1
    path = _write(tmp_path, "in.txt", g)
    args = ["64", "64", path, "--variant", variant, "--engine", engine,
            "--tile", "16", "--gen-limit", "40"]
    if engine == "macro" and flow == "random":
        # A soup touches the universe edge: the plane refusal, as in JAX.
        args[-1] = "3"
    jax_res, port_res = _both_io(capsys, args, tmp_path)
    assert port_res == jax_res


def test_macro_cas_directory_moves_between_the_packages(capsys, tmp_path):
    """--macro-cas written by one CLI, read by the other: the same bytes,
    and the warm run finds every advance in the directory."""
    cas = tmp_path / "cas"
    args = ["--pattern", str(PATTERNS / "gosper_gun.rle"), "--universe",
            "512x512", "--place", "200,200", "--tile", "8", "--gens", "300",
            "--engine", "macro", "--macro-cas", str(cas), "--variant", "game"]
    jax_res, port_res = _both_io(capsys, args, tmp_path)
    assert port_res == jax_res and port_res[0] == 0
    entries = sorted(p.name for p in cas.rglob("*") if p.is_file())
    assert entries
    # Fresh directories: each package cold, then the other warm from it.
    for first, second in ((jax_cli.main, cli.main), (cli.main, jax_cli.main)):
        d = tmp_path / f"cas_{first.__module__}"
        outs = []
        for main in (first, second):
            out = tmp_path / "o.rle"
            assert main([*args[:-4], "--macro-cas", str(d), "--variant", "game",
                         "--output", str(out)]) == 0
            outs.append(out.read_bytes())
        capsys.readouterr()
        assert outs[0] == outs[1] == port_res[3]


@pytest.mark.parametrize("flags", [
    ["--engine", "sparse", "--macro-cas", "CAS"],
    ["--engine", "dense", "--macro-cas", "CAS"],
    ["--engine", "shard"],
    ["--shard-across", "http://127.0.0.1:1"],
    ["--engine", "shard", "--shard-across", "http://127.0.0.1:1", "NOPATTERN"],
    ["--gens", "-1"],
    ["--universe", "64"],
    ["--universe", "64x64", "--place", "3"],
    ["--universe", "64x64", "--place", "62,0"],
    ["--universe", "64x64", "--place", "62,0", "--engine", "dense"],
    ["--universe", "60x64", "--engine", "sparse", "--tile", "8"],
    ["--universe", "64x64", "--engine", "macro", "--tile", "7"],
    ["--universe", "64x64", "--engine", "sparse", "--tile", "2"],
    ["--universe", "64x64", "--engine", "sparse", "--kernel", "lax"],
    ["--universe", "64x64", "--engine", "macro", "--kernel", "pallas"],
    ["--universe", "65536x65536", "--engine", "dense"],
    ["--universe", "64x64", "--mesh", "1x1"],
    ["--universe", "64x64", "--packed-io"],
    ["--universe", "64x64", "--host"],
    ["--universe", "64x64", "--snapshot-every", "10"],
    ["--universe", "64x64", "--resume-gen", "5"],
    ["--universe", "64x64", "--checkpoint-every", "10"],
    ["--universe", "32x32", "--place", "1,1", "--tile", "4", "--engine",
     "macro", "--gens", "200"],
    ["INPUT"],
], ids=["cas_sparse", "cas_dense", "shard_no_router", "router_no_shard",
        "shard_no_pattern", "gens_negative", "universe_form", "place_form",
        "place_outside", "place_outside_dense", "universe_tile", "macro_odd_tile",
        "tile_small", "sparse_kernel", "macro_kernel", "dense_ceiling", "mesh",
        "packed_io", "host", "snapshots", "resume", "checkpoints", "plane",
        "input_and_pattern"])
def test_pattern_lane_refusals_match_jax(flags, capsys, tmp_path):
    path = _write(tmp_path, "in.txt", text_grid.generate(64, 64, seed=3))
    args = ["--pattern", str(PATTERNS / "glider.rle")]
    if "NOPATTERN" in flags:
        args = ["64", "64", path]
    elif "INPUT" in flags:
        args = ["64", "64", path, *args]
    flags = [str(tmp_path / "cas") if f == "CAS" else f for f in flags
             if f not in ("NOPATTERN", "INPUT")]
    results = []
    for main in (jax_cli.main, cli.main):
        rc = main([*args, *flags, "--output", str(tmp_path / "o.rle")])
        out, err = capsys.readouterr()
        results.append((rc, _MS.sub("X msecs", out), err))
    assert results[1] == results[0]
    assert results[1][0] == 1 and results[1][2].startswith("gol: ")
    assert not (tmp_path / "o.rle").exists()


def test_run_parser_matches_jax():
    """The run parser's options, defaults and choices are JAX's, the
    pattern lane's included."""
    assert _options(_parser_of(cli, "run")) == _options(_parser_of(jax_cli, "run"))


# ---------------------------------------------------------------------------
# fleet, router, submit --shard-across and run --engine shard


def _cli_rc(main, args, capsys, fleet_dir=None):
    """(rc, stdout, stderr) of one CLI call, the logger prefix, the fleet
    directory and pids normalized."""
    try:
        rc = main(args)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    err = err.replace("gol_tpu_torch: ", "gol_tpu: ")
    if fleet_dir is not None:
        err = err.replace(str(fleet_dir), "FLEET")
    return rc, out, re.sub(r"pid \d+", "pid N", err)


FLEET_REFUSALS = {
    "workers_negative": ["--workers", "-1"],
    "flush_age": ["--flush-age", "-1"],
    "health_interval": ["--health-interval", "0"],
    "history_without_sampler": ["--metrics-history", "--sample-interval", "0"],
    "history_bytes": ["--history-bytes", "100"],
    "cores_negative": ["--cores-per-worker", "-1"],
    "cores_beyond_host": ["--cores-per-worker", "100000"],
    "breaker_cooldown": ["--breaker-cooldown", "-1"],
    "routers": ["--routers", "0"],
    "retry_budget": ["--retry-budget", "-1"],
    "cache_disk_bytes": ["--cache-disk-bytes", "0"],
    "segment_bytes": ["--journal-segment-bytes", "-1"],
    "journal_retain": ["--journal-retain", "0"],
    "disk_reserve": ["--disk-reserve", "-1"],
    "chaos_unknown": ["--chaos", "bogus=1"],
    "chaos_probability": ["--chaos", "reset=2"],
    "bounds_without_autoscale": ["--min-workers", "2"],
    "autoscale_floor": ["--autoscale", "--min-workers", "0"],
    "autoscale_order": ["--autoscale", "--min-workers", "3", "--max-workers", "2"],
    "no_workers": ["--workers", "0"],
    "workers_text": ["--workers", "x"],
}


@pytest.mark.parametrize("flags", list(FLEET_REFUSALS.values()),
                         ids=list(FLEET_REFUSALS))
def test_fleet_refusals_match_jax(flags, capsys, tmp_path, monkeypatch):
    """Refused before any worker spawns, in both packages: the same exit
    code, stdout and stderr."""
    monkeypatch.chdir(tmp_path)
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        fleet_dir = tmp_path / f"fleet_{tag}"
        results.append(_cli_rc(main, ["fleet", "--port", "0", "--fleet-dir",
                                      str(fleet_dir), *flags], capsys, fleet_dir))
    assert results[1] == results[0]
    assert results[1][0] != 0
    assert not any((tmp_path / f"fleet_{t}" / "w0").exists() for t in ("jax", "port"))


@pytest.mark.parametrize("flags", [
    ["--fleet-dir", "F", "--router-id", "bad id"],
    ["--fleet-dir", "F", "--router-id", "r1"],
    ["--router-id", "r1"],
    ["--fleet-dir", "F"],
], ids=["bad_id", "no_manifest", "no_fleet_dir", "no_router_id"])
def test_router_refusals_match_jax(flags, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = [_cli_rc(main, ["router", *flags], capsys)
               for main in (jax_cli.main, cli.main)]
    assert results[1] == results[0]
    assert results[1][0] != 0


@pytest.fixture
def port_fleet(tmp_path):
    """Two port workers attached by URL behind a port router, in process."""
    from gol_tpu_torch.fleet.router import RouterServer
    from gol_tpu_torch.fleet.workers import Fleet
    from gol_tpu_torch.serve.server import GolServer

    servers = [GolServer(port=0, journal_dir=str(tmp_path / f"w{i}"),
                         flush_age=0.01, sample_interval=0) for i in range(2)]
    fleet = Fleet(str(tmp_path / "fleet"))
    for i, srv in enumerate(servers):
        srv.start()
        fleet.attach(srv.url, f"w{i}")
    router = RouterServer(fleet, port=0)
    router.start()
    yield router.url
    router.shutdown(cascade=False)
    for srv in servers:
        srv.shutdown()


@pytest.mark.parametrize("variant", ["game", "cuda"])
def test_run_engine_shard_prints_the_sparse_lines(variant, port_fleet, capsys,
                                                  tmp_path):
    """``run --engine shard --shard-across URL`` of either package against
    the port's router prints the lines ``run --engine sparse`` prints and
    writes the same RLE bytes."""
    args = ["--pattern", str(PATTERNS / "gosper_gun.rle"), "--universe",
            "512x512", "--place", "230,230", "--gens", "30", "--variant",
            variant]
    results = []
    for tag, main, extra in (
            ("sparse", cli.main, ["--engine", "sparse"]),
            ("shard", cli.main, ["--engine", "shard", "--shard-across", port_fleet]),
            ("jax_shard", jax_cli.main,
             ["--engine", "shard", "--shard-across", port_fleet])):
        out = tmp_path / f"{tag}.rle"
        rc = main([*args, *extra, "--output", str(out)])
        stdout, stderr = capsys.readouterr()
        results.append((rc, _MS.sub("X msecs", stdout), out.read_bytes()))
    assert results[0][0] == 0 and "Generations:\t30" in results[0][1]
    assert results[1] == results[0] == results[2]


def test_submit_shard_across_matches_jax(port_fleet, capsys, tmp_path,
                                         monkeypatch):
    """``submit --shard-across`` against the port's router: both packages'
    clients fan the boards over the fleet's two workers (one stderr line
    says so) and print the same result lines and bytes."""
    monkeypatch.chdir(tmp_path)
    paths = _batch_inputs(tmp_path, 30, 30, (5, 6))
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        outdir = tmp_path / f"out_{tag}"
        rc = main(["submit", "30", "30", *paths, "--server", port_fleet,
                   "--shard-across", "--poll-interval", "0.02", "--gen-limit",
                   "40", "--output-dir", str(outdir)])
        out, err = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(outdir.glob("*"))}
        results.append((rc, _submit_lines(out.replace(str(outdir), "OUT")),
                        err, files))
    assert results[1] == results[0]
    rc, _, err, files = results[1]
    assert rc == 0 and len(files) == len(paths)
    assert err == ("gol submit: fleet membership now 2 worker(s)\n"
                   f"gol submit: sharding {len(paths)} board(s) across 2 fleet "
                   "worker(s)\n")
