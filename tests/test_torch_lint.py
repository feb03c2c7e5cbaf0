"""The PyTorch port stands alone: no module of gol_tpu_torch/, and not
chip_smoke.py, imports ``jax`` or the JAX package ``gol_tpu`` (whose name
is a prefix of the port's own)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
# The package's sources; its git-ignored build directory holds no source.
PORT_FILES = sorted(
    p for p in (REPO / "gol_tpu_torch").rglob("*.py") if "_build" not in p.parts
) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gol_tpu")


def _forbidden(module: str | None) -> bool:
    top = (module or "").split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, node.args[0].value


def test_scanner_tells_the_packages_apart():
    assert _forbidden("gol_tpu") and _forbidden("gol_tpu.ops.packed_math")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("gol_tpu_torch") and not _forbidden("gol_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like") and not _forbidden(None)


def test_port_files_exist():
    assert (REPO / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_gol_tpu_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_mesh_modules_are_scanned():
    scanned = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for name in ("mesh", "halo", "collectives"):
        assert f"gol_tpu_torch/parallel/{name}.py" in scanned
