"""Build and load the port's native code: CUDA kernels and the host codec.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, which the kernel modules bind with ``ctypes`` — seconds
to build, where a source that includes PyTorch's headers takes minutes.
The host text codec (``native/codec.c``) compiles the same way with ``cc``.
Libraries land in ``BUILD_DIR`` (``gol_tpu_torch/_build/``, or the
directory ``--compile-cache DIR`` names: ``enable_compile_cache``) named by
a hash of the source and the flags, so an edited source rebuilds at its
first use and an unchanged one never does. A library is loaded once per
process and build directory. ``nvcc -Xptxas -v`` reports each kernel's
registers, shared memory and spills; the report is kept beside the library
(``build_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
# Serialises the first build and load of a library across threads (the
# server's worker pools launch from several), so two first calls never
# both compile.
_LOAD_LOCK = threading.Lock()
_LOADED: dict = {}


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


def enable_compile_cache(cache_dir: str | None) -> None:
    """Make ``cache_dir`` the build directory of this process: the kernels
    and the codec build there unless their current build exists, so a
    second run with the same directory builds nothing. A missing directory
    is created. No-op when ``cache_dir`` is falsy, so the CLI passes its
    ``--compile-cache`` flag through unconditionally."""
    global BUILD_DIR
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    BUILD_DIR = Path(cache_dir).resolve()


def _compile(source: Path, flags: tuple[str, ...], compiler) -> Path:
    """Compile ``source`` unless its current build exists; raise with the
    compiler's output if the compile fails."""
    lib = _library(source, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    # pid and thread id: unique to one thread of one process, so processes
    # sharing a --compile-cache directory never write one staging file.
    tmp = lib.with_name(
        f".{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
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


def load(name: str, bind=None) -> ctypes.CDLL:
    """The built CUDA library of ``csrc/<name>.cu``, loaded once per process
    and build directory; ``bind(lib)`` declares its C entries at the load.
    The kernel wrappers call it at every launch, so a hit is one lookup."""
    return _load(BUILD_DIR, name, bind)


def load_c(source: Path, bind=None) -> ctypes.CDLL:
    """A host C source built with ``cc``, loaded as ``load`` loads."""
    return _load(BUILD_DIR, source, bind)


def _load(build_dir: Path, what, bind) -> ctypes.CDLL:
    """A hit is one cache lookup; a miss takes ``_LOAD_LOCK``, so a second
    thread asking for the same library waits and gets the same ``CDLL``."""
    key = (build_dir, what, bind)
    lib = _LOADED.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(key)
            if lib is None:
                lib = _LOADED[key] = _loaded(build_dir, what, bind)
    return lib


def _loaded(build_dir: Path, what, bind) -> ctypes.CDLL:
    """``what`` is a CUDA source's name or a C source's path. ``build_dir``
    (``BUILD_DIR`` at the call) keys the cache: a library built into
    another directory is another library, loaded on its own."""
    if isinstance(what, str):
        lib = build(what)
    else:
        lib = _compile(what, CC_FLAGS, _cc)
    lib = ctypes.CDLL(str(lib))
    return bind(lib) if bind is not None else lib
