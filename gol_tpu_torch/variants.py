"""The six reference programs as policy bundles over the one engine.

The reference is six standalone mains differing only in I/O strategy, loop
accounting, and which lines they print (SURVEY.md §2 C1-C6). Here each is a
``Variant`` record; the engine and kernels are shared. Output filenames match
the reference byte-for-byte so existing comparison scripts keep working.

A copy of ``gol_tpu/variants.py``. ``distributed`` means the variant runs
over a mesh of shards (``parallel/mesh.py``; ``--mesh``, or the default
mesh over ``platform_env.mesh_devices()``, which is one shard where there is
one device), read and written through the variant's own I/O strategy
(``io/sharded.py``), with the variant's printed lines and file name.
"""

from __future__ import annotations

import dataclasses

from gol_tpu_torch.config import Convention


@dataclasses.dataclass(frozen=True)
class Variant:
    """Per-program behavior switches (citations per field below)."""

    name: str
    output_file: str  # src/game.c:27 etc.
    convention: str = Convention.C
    io: str = "serial"  # serial | gathered | sharded | sharded_async
    distributed: bool = False  # runs over a device mesh
    force_square: bool = False  # `height = width`, src/game_mpi.c:504
    serial_header: bool = False  # the extra "Finished.\n\n", src/game.c:201
    io_timings: bool = False  # "Reading file"/"Writing file" lines
    final_finished: bool = True  # game_openmp.c:501 comments its one out


VARIANTS = {
    # C1 — serial ground truth (src/game.c). Single device, rectangles allowed.
    "game": Variant(
        name="game",
        output_file="game_output.out",
        serial_header=True,
    ),
    # C2 — master-scatter I/O (src/game_mpi.c): one host reads/writes, blocks
    # are scattered/gathered. The degenerate debug-mode I/O.
    "mpi": Variant(
        name="mpi",
        output_file="mpi_output.out",
        io="gathered",
        distributed=True,
        force_square=True,
        io_timings=True,
    ),
    # C3 — collective MPI-IO (src/game_mpi_collective.c): every shard reads
    # and writes its own file window.
    "collective": Variant(
        name="collective",
        output_file="collective_output.out",
        io="sharded",
        distributed=True,
        force_square=True,
        io_timings=True,
    ),
    # C4 — async MPI-IO (src/game_mpi_async.c): byte-identical to C3 except
    # iread/iwrite and the filename; here the per-shard windows genuinely
    # overlap via a thread pool (the reference waits immediately).
    "async": Variant(
        name="async",
        output_file="async_output.out",
        io="sharded_async",
        distributed=True,
        force_square=True,
        io_timings=True,
    ),
    # C5 — hybrid MPI+OpenMP (src/game_openmp.c): intra-rank threading is
    # inherent on TPU (the VPU vectorizes the whole shard), so this is C3
    # with the reference's quirks: openmp_output.out and no final "Finished"
    # (game_openmp.c:501 is commented out).
    "openmp": Variant(
        name="openmp",
        output_file="openmp_output.out",
        io="sharded",
        distributed=True,
        force_square=True,
        io_timings=True,
        final_finished=False,
    ),
    # C6 — CUDA single-accelerator (src/game_cuda.cu): single chip, numeric
    # cells, divergent loop accounting, no I/O timing lines.
    "cuda": Variant(
        name="cuda",
        output_file="cuda_output.out",
        convention=Convention.CUDA,
    ),
    # The TPU-native flagship: no legacy quirks — sharded I/O over the full
    # mesh, rectangles allowed, C accounting. Not in the reference; this is
    # what new users should run.
    "tpu": Variant(
        name="tpu",
        output_file="tpu_output.out",
        io="sharded",
        distributed=True,
        io_timings=True,
    ),
}


def get_variant(name: str) -> Variant:
    try:
        return VARIANTS[name]
    except KeyError:
        raise ValueError(
            f"unknown variant {name!r}; available: {', '.join(sorted(VARIANTS))}"
        ) from None
