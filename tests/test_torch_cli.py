"""The port's CLI (gol_tpu_torch.cli, on the CPU) against the JAX package's
(gol_tpu.cli): output file bytes, exit codes and printed lines, with the
millisecond values masked.

Under this suite's 8 virtual CPU devices the JAX ``tpu`` variant runs over
a device mesh while the port runs it on one device, so its grids are square
and divide over the mesh; the bytes must match all the same.
"""

import re

import numpy as np
import pytest

from gol_tpu import cli as jax_cli
from gol_tpu_torch import cli
from gol_tpu_torch.io import text_grid

_MS = re.compile(r"\d+\.\d+ msecs")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("GOL_TORCH_DEVICE", "cpu")


def _write(tmp_path, name, grid):
    path = tmp_path / name
    text_grid.write_grid(str(path), grid)
    return str(path)


def _both(capsys, args, tmp_path=None):
    """Run both CLIs: ``[(rc, stdout masked, output bytes)]`` for JAX, port."""
    results = []
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        extra = []
        if tmp_path is not None:
            extra = ["--output", str(tmp_path / f"{tag}.out")]
        rc = main([*args, *extra])
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
    # Variants that need the mesh are not ported yet.
    path = _write(tmp_path, "in.txt", text_grid.generate(32, 32, seed=1))
    assert cli.main(["32", "32", path, "--variant", "mpi"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("gol: ") and "not ported yet" in err
    # The packed kernel refuses a width that does not pack.
    path48 = _write(tmp_path, "in48.txt", text_grid.generate(48, 48, seed=1))
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
