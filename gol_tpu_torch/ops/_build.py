"""Build and load the port's native code: CUDA kernels and the host codec.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, which the kernel modules bind with ``ctypes`` — seconds
to build, where a source that includes PyTorch's headers takes minutes.
The host text codec (``native/codec.c``) compiles the same way with ``cc``.
Libraries land in ``gol_tpu_torch/_build/`` named by a hash of the source
and the flags, so an edited source rebuilds at its first use and an
unchanged one never does. ``nvcc -Xptxas -v`` reports each kernel's
registers, shared memory and spills; the report is kept beside the library
(``build_log``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CC_FLAGS = ("-O3", "-shared", "-fPIC")


def _nvcc() -> str:
    # CUDA_HOME is torch's own search ($CUDA_HOME, then nvcc on PATH, then
    # the toolkit's default install prefix).
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(nvcc):
            return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from gol_tpu_torch/csrc at first use"
    )


def _cc() -> str:
    cc = shutil.which("cc")
    if cc:
        return cc
    raise RuntimeError(
        "cc not found; the port's text codec is built from "
        "gol_tpu_torch/native/codec.c at first use"
    )


def _library(source: Path, flags: tuple[str, ...]) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update("\0".join(flags).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def _compile(source: Path, flags: tuple[str, ...], compiler) -> Path:
    """Compile ``source`` unless its current build exists; raise with the
    compiler's output if the compile fails."""
    lib = _library(source, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) building "
            f"{source.name}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source and flags."""
    return _library(CSRC / f"{name}.cu", NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless its current build exists."""
    return build_source(CSRC / f"{name}.cu")


def build_source(source: Path) -> Path:
    """Compile any CUDA source with the package's nvcc flags into
    ``_build/`` unless its current build exists (``tools/band_sweep.py``
    builds rewritten copies of a kernel source)."""
    return _compile(source, NVCC_FLAGS, _nvcc)


def build_log(name: str) -> str:
    """nvcc's report (``-Xptxas -v``) from the build of the current source."""
    return source_log(CSRC / f"{name}.cu")


def source_log(source: Path) -> str:
    """nvcc's report from the build of ``source`` as it is now."""
    log = _library(source, NVCC_FLAGS).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built CUDA library, loaded once per process."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def load_c(source: Path) -> ctypes.CDLL:
    """A host C source built with ``cc`` and loaded once per process."""
    return ctypes.CDLL(str(_compile(source, CC_FLAGS, _cc)))
