"""CLI entry point of the PyTorch port — ``python -m gol_tpu_torch <width>
<height> <input_file>``, the reference's ``./a.out`` contract on CUDA cards.

The port of ``gol_tpu/cli.py``'s ``run``:

- ``width = atoi(argv[1])``, ``height = atoi(argv[2])`` — C atoi semantics,
  non-numeric parses to 0; distributed variants force ``height = width``
  (src/game_mpi.c:504); non-positive dimensions default to 30x30;
- with no input file the simulation is skipped and only ``Finished`` prints
  (src/game.c:238-241);
- ``--variant`` picks the reference program reproduced (output filename,
  printed lines, loop accounting, file I/O strategy); the distributed ones
  (``mpi``, ``collective``, ``async``, ``openmp``, ``tpu``) run over a mesh
  of shards: ``--mesh RxC``, or by default the row-heaviest factorization
  of ``platform_env.mesh_devices()`` that divides the grid (one shard, the
  single-device form, where that is one device). ``GOL_TORCH_MESH_DEVICES``
  sets how many shards the devices hold;
- lanes: the device run (``--kernel``), ``--packed-io`` (word state straight
  from and to the file), ``--host`` (the numpy oracle), ``--snapshot-every``
  and ``--resume-gen`` (segmented runs), and the crash-safe checkpoint lane
  (``--checkpoint-every``, ``--auto-resume``, the async writer,
  ``GOL_FAULTS`` / ``--fault-plan``); all but ``--host`` run on a mesh too;
- the pattern lane: ``--pattern FILE [--place X,Y] [--universe WxH]``
  places an RLE pattern into an otherwise-empty universe, and ``--engine``
  picks the engine (``dense``, ``sparse`` — the tiled O(live-area) engine
  of ``sparse/`` — ``macro`` — the hash-consed macrocell engine of
  ``macro/`` — or ``auto``: sparse above the tuned area threshold,
  upgraded to macro above the generation threshold); ``--engine
  sparse|macro`` also runs over a dense input file. Their tile steps run
  on T1 (``ops/stencil_tile``), and both write ``sparse_output.rle``;
- timings print as ``<Phase>:\\t<ms> msecs``. Execution time excludes set-up
  — the kernels' build and load, and the optional ``--warmup`` run happen
  before the timer starts — and ends in a device sync;
- observability: ``--trace DIR`` (the JAX CLI's spans, ``cli.read_phase``,
  ``engine.compile``, ``cli.execution``, ``cli.write_phase``,
  ``engine.segment`` and the checkpoint lane's, exported as Chrome trace
  JSON, with the flight recorder armed), ``--profile DIR`` (a guarded
  ``torch.profiler`` capture of the timed region) and ``--compile-cache
  DIR`` (the build directory of the kernels and the codec).

It runs on the card; ``GOL_TORCH_DEVICE=cpu`` runs it on the CPU through the
kernels' plain torch versions. Errors print as ``gol: <error>`` with exit
code 1.

Subcommands: ``generate <width> <height>`` emits a random grid
(generate.sh); ``show`` renders a grid with the reference's VT100 codes;
``trace-report``, ``history-report`` and ``slo-report`` render the obs
artifacts; ``batch W H FILES...`` runs many boards through the padding-
bucket batcher in one process (``serve/batcher.py``, the batched kernels
B1 and B2); ``compact DIR`` folds a job journal's sealed segments into its
snapshot (``serve/compaction.py``); ``serve`` runs the HTTP service over
the journaled scheduler and the result cache (``serve/server.py``, on B1
and B2; ``--resident-ring R`` its resident ring lanes, ``--warm-plans``
the tuned bucket runners built at boot); ``fleet`` runs a router over N
``serve`` worker processes (``fleet/``, ``chaos/``) and ``router`` one
more router replica over a running fleet; ``submit W H FILES...`` is the
HTTP client of a server or a fleet (of either package; ``--shard-across``
fans boards over a fleet's workers), and ``gc DIR`` garbage-collects a
result-cache CAS; ``run --pattern F --engine shard --shard-across URL``
runs one universe across a fleet's workers (``shard/``, T1 on each
worker); ``tune`` measures and caches engine and serve plans (``tune/``);
``top`` and ``fleet-trace`` read a live server (``obs/top``,
``obs/fleettrace``). ``serve --cache-payload ts`` exits 1 with a ``gol:``
line (the port has no zarr store); ``tune --sparse-crossover`` measures
and caches the dense/sparse crossover of ``--engine auto``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from gol_tpu_torch import engine, oracle
from gol_tpu_torch.config import DEFAULT_HEIGHT, DEFAULT_WIDTH, GameConfig
from gol_tpu_torch.io import packed_io, sharded, text_grid
from gol_tpu_torch.obs import profiler
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.profiler import fence
from gol_tpu_torch.ops import _build
from gol_tpu_torch.parallel.mesh import make_mesh, topology_for, validate_grid
from gol_tpu_torch.platform_env import (NoDeviceError, configure_cli_logging,
                                        resolve_device)
from gol_tpu_torch.resilience import faults
from gol_tpu_torch.sparse.board import DEFAULT_TILE, SparseBoard, dense_cells_guard
from gol_tpu_torch.variants import VARIANTS, Variant, get_variant

# `serve`'s exit report of its kernel launches (see _write_exit_stats).
EXIT_STATS_ENV = "GOL_TORCH_EXIT_STATS"


def atoi(s: str | None) -> int:
    """C atoi: optional sign + leading digits, anything else is 0."""
    if not s:
        return 0
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def _warn_if_huge_byte_lane(width: int, height: int, mesh=None) -> None:
    """Steer 2GB+-per-shard byte-lane runs toward --packed-io.

    The byte lane carries two uint8 buffers through the loop, and at 2GB+
    of cells per shard the card's out-of-memory error names no remedy. The
    packed lane is 32x smaller: say so up front, but only where --packed-io
    would accept the shape (width divisible by 32 x mesh columns). The text
    and conditions are the JAX CLI's, a shard standing for its device."""
    shards = cols = 1
    if mesh is not None:
        shards = len(mesh.devices)
        cols = mesh.shape[1]
    per_shard = width * height // shards
    if per_shard >= (2 << 30) and width % (32 * cols) == 0:
        print(
            f"warning: {width}x{height} as bytes is "
            f"{per_shard / (1 << 30):.1f} GB per buffer per device; "
            "if this runs out of device memory, use --packed-io "
            "(bit-packed state, 32x smaller)",
            file=sys.stderr,
        )


def _parse_mesh_arg(spec: str | None, distributed: bool,
                    width: int | None = None, height: int | None = None):
    if not distributed:
        if spec:
            raise ValueError(
                "--mesh only applies to distributed variants "
                "(mpi/collective/async/openmp/tpu); this variant is single-device"
            )
        return None
    if spec:
        m = re.fullmatch(r"(\d+)x(\d+)", spec)
        if not m:
            raise ValueError(f"--mesh must look like RxC, got {spec!r}")
        return make_mesh(int(m.group(1)), int(m.group(2)))
    # Default factorization over mesh_devices(): row-heaviest that divides
    # the grid.
    return make_mesh(width=width, height=height)


def _read_phase(variant: Variant, path: str, width: int, height: int, device,
                mesh=None):
    if variant.io == "serial":
        return engine.put_grid(text_grid.read_grid(path, width, height), device, mesh)
    if variant.io == "gathered":
        return sharded.read_gathered(path, width, height, device, mesh)
    return sharded.read_sharded(
        path, width, height, device, parallel=(variant.io == "sharded_async"),
        mesh=mesh,
    )


def _write_phase(variant: Variant, path: str, grid, mesh=None) -> None:
    if variant.io == "serial":
        text_grid.write_grid(path, grid.cpu().numpy())
    elif variant.io == "gathered":
        sharded.write_gathered(path, grid, mesh)
    else:
        sharded.write_sharded(path, grid, parallel=(variant.io == "sharded_async"),
                              mesh=mesh)


def _checkpointing(args) -> bool:
    # `is not None`, not truthiness: --checkpoint-every 0 must reach the
    # validator and be rejected loudly, not silently disable the lane.
    return (
        args.checkpoint_every is not None
        or args.auto_resume
        or args.checkpoint_dir is not None
    )


def _validate_checkpoint_args(args) -> None:
    """Normalize and cross-check the crash-safety flags before any lane runs
    (so a contradictory combination never half-starts a checkpoint dir)."""
    if not _checkpointing(args):
        return
    if args.checkpoint_dir is None:
        args.checkpoint_dir = "./checkpoints"
    if args.checkpoint_every is None and not args.auto_resume:
        raise ValueError(
            "--checkpoint-dir needs --checkpoint-every N (write checkpoints) "
            "and/or --auto-resume (restart from the newest one)"
        )
    if args.checkpoint_every is not None and args.checkpoint_every <= 0:
        raise ValueError(
            f"--checkpoint-every must be positive, got {args.checkpoint_every}"
        )
    if args.checkpoint_keep < 1:
        raise ValueError(
            f"--checkpoint-keep must be >= 1, got {args.checkpoint_keep}"
        )
    if args.snapshot_every:
        raise ValueError(
            "checkpointing does not compose with --snapshot-every: a "
            "checkpoint IS a resumable snapshot plus a crash-consistent "
            "manifest — use one or the other"
        )
    if args.auto_resume and args.resume_gen:
        raise ValueError(
            "--auto-resume discovers the resume generation from the "
            "checkpoint manifests; --resume-gen contradicts it"
        )
    if args.host:
        raise ValueError(
            "checkpointing rides the segmented device loop; --host has none"
        )


def _run(args) -> int:
    if args.gens is not None:
        # --gens is the deep-time spelling of --gen-limit (the macro lane's
        # natural vocabulary); one value drives every lane either way.
        if args.gens < 0:
            raise ValueError(f"--gens must be >= 0, got {args.gens}")
        args.gen_limit = args.gens
    if args.macro_cas and args.engine not in ("macro", "auto"):
        # A silently-ignored persistence flag would misreport what ran.
        raise ValueError(
            "--macro-cas applies to the macro engine lane; add "
            "--engine macro (or auto)"
        )
    if args.engine == "shard" and not args.shard_across:
        raise ValueError(
            "--engine shard needs --shard-across ROUTER_URL (the job "
            "runs across a fleet, not in this process)"
        )
    if args.shard_across and args.engine != "shard":
        raise ValueError("--shard-across applies to --engine shard")
    if args.engine == "shard" and args.pattern is None:
        raise ValueError(
            "--engine shard takes the --pattern lane (the universe "
            "travels as RLE; dense input files do not)"
        )
    _build.enable_compile_cache(args.compile_cache)

    if args.fault_plan:
        faults.install(faults.FaultPlan.parse(args.fault_plan))
    else:
        # from_env() is None when GOL_FAULTS is unset, so a plan armed by a
        # previous in-process run is cleared: each run gets exactly the
        # faults it asked for.
        faults.install(faults.FaultPlan.from_env())
    variant = get_variant(args.variant)
    width, height = atoi(args.width), atoi(args.height)
    if variant.force_square:
        height = width  # src/game_mpi.c:504
    if width <= 0:
        width = DEFAULT_WIDTH
    if height <= 0:
        height = DEFAULT_HEIGHT

    if args.pattern is not None:
        # The geometry-first lane: the board is a pattern placed into a
        # declared universe — construction never materializes the canvas,
        # so the engine choice (sparse above the area threshold) happens
        # BEFORE any allocation the choice is supposed to avoid.
        return _run_pattern(args, variant)

    if args.input_file is None:
        # Simulation skipped entirely (src/game.c:238-241).
        if variant.final_finished:
            print("Finished")
        return 0

    config = GameConfig(
        gen_limit=args.gen_limit,
        check_similarity=not args.no_check_similarity,
        similarity_frequency=args.similarity_frequency,
        convention=variant.convention,
    )
    output_path = args.output or f"./{variant.output_file}"

    _validate_checkpoint_args(args)
    if args.resume_gen < 0:
        raise ValueError(f"--resume-gen must be >= 0, got {args.resume_gen}")
    if args.resume_gen > config.gen_limit:
        # A typo'd resume count would otherwise produce a no-op run with a
        # plausible-looking report above the limit.
        raise ValueError(
            f"--resume-gen {args.resume_gen} exceeds --gen-limit "
            f"{config.gen_limit}; nothing to resume"
        )
    # TensorStore snapshots are refused before every lane: the port has no
    # zarr store.
    if args.snapshot_format == "zarr":
        if not args.packed_io:
            raise ValueError(
                "--snapshot-format zarr stores the bitpacked word state and "
                "needs the packed lane; add --packed-io"
            )
        raise ValueError(
            "--snapshot-format zarr needs tensorstore, which the PyTorch "
            "port does not use; use --snapshot-format text"
        )
    if args.input_file.endswith(".zarr"):
        raise ValueError(
            "a .zarr input (TensorStore snapshot) is not readable by the "
            "PyTorch port; resume from a gen_NNNNNN.out snapshot instead"
        )

    if args.engine == "sparse":
        # Sparse engine over a dense input FILE (the A/B lane): reading the
        # file materializes the grid, so this only serves sizes the dense
        # guard admits — giant universes come in as --pattern instead.
        _validate_sparse_flags(args)
        return _run_sparse_file(args, variant, config, width, height)

    if args.engine == "macro":
        # Same A/B lane, macrocell engine: holds the tree against the
        # dense/sparse answers from the CLI.
        _validate_macro_flags(args)
        return _run_macro_file(args, variant, config, width, height)

    if args.host:
        # lax is what the host oracle effectively is, so it stays accepted;
        # forcing an accelerator kernel alongside --host is a contradiction.
        if args.mesh or args.kernel not in ("auto", "lax") or args.packed_io:
            raise ValueError(
                "--mesh/--kernel/--packed-io do not apply with --host "
                "(oracle runs on the host CPU)"
            )
        if args.resume_gen:
            raise ValueError("--resume-gen is not supported with --host "
                             "(the oracle has no segmented loop)")
        return _run_host(args, variant, config, width, height, output_path)

    mesh = _parse_mesh_arg(args.mesh, variant.distributed, width, height)
    if mesh is not None and not topology_for(mesh).distributed:
        mesh = None  # a 1x1 mesh is the single-device engine
    validate_grid(height, width, topology_for(mesh))
    devices = list(mesh.devices) if mesh is not None else [resolve_device()]

    if args.packed_io:
        if args.kernel not in ("auto", "packed"):
            raise ValueError(
                f"--packed-io always runs the packed kernel; --kernel "
                f"{args.kernel!r} contradicts it"
            )
        # Packed state is 32x smaller than bytes, so this lane branches off
        # before the dense ceiling.
        return _run_packed_io(args, variant, config, width, height,
                              output_path, devices, mesh)

    if mesh is None:
        # Mesh reads materialize per shard, as in the JAX CLI.
        dense_cells_guard(height, width)
    _warn_if_huge_byte_lane(width, height, mesh)
    device = devices[0]
    t0 = time.perf_counter()
    with obs_trace.span("cli.read_phase", file=args.input_file):
        device_grid = _read_phase(variant, args.input_file, width, height,
                                  device, mesh)
    read_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")

    if _checkpointing(args):
        run_fn = _prepare_checkpointed(args, variant, config, device_grid,
                                       height, width, device, mesh, packed=False)
    elif args.snapshot_every:
        run_fn = _prepare_segmented(args, variant, config, device_grid, height,
                                    width, device, mesh)
    elif args.resume_gen:
        run_fn = _prepare_resumed(args, config, device_grid, height, width,
                                  device, mesh, packed=False)
    else:
        runner = engine.make_runner((height, width), config, args.kernel, device,
                                    mesh=mesh)
        if args.warmup:
            fence(runner(device_grid))

        def run_fn():
            return runner(device_grid)

    final, generations, exec_ms = _execute(args, run_fn, device)
    return _report_and_write(
        variant, generations, exec_ms,
        lambda: _write_phase(variant, output_path, final, mesh),
    )


def _execute(args, run_fn, device):
    """The timed region, ``(final, generations, exec_ms)``: ``run_fn`` and
    the fence on its result, under ``--profile``'s capture and the
    ``cli.execution`` span."""
    with profiler.capture(args.profile, device):
        with obs_trace.span("cli.execution"):
            t0 = time.perf_counter()
            final, generations = run_fn()
            fence(final)
            exec_ms = (time.perf_counter() - t0) * 1000
    return final, generations, exec_ms


def _report_and_write(variant: Variant, generations, exec_ms, write_fn) -> int:
    """The reference's printed-output contract (src/game.c:201-206,
    src/game_mpi_collective.c:367-450)."""
    if variant.serial_header:
        print("Finished.\n")
    print(f"Generations:\t{generations}")
    print(f"Execution time:\t{exec_ms:.2f} msecs")
    t0 = time.perf_counter()
    with obs_trace.span("cli.write_phase"):
        write_fn()
    write_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Writing file:\t{write_ms:.2f} msecs")
    if variant.final_finished:
        print("Finished")
    return 0


def _run_packed_io(args, variant, config, width, height, output_path, devices,
                   mesh) -> int:
    """The all-packed lane: file -> word state -> file, no uint8 grid ever;
    over a mesh, every shard from and to its own window of the file.

    The read and write go through the native codec (native/codec.c); the
    printed lines keep the reference contract."""
    device = devices[0]
    t0 = time.perf_counter()
    with obs_trace.span("cli.read_phase", file=args.input_file):
        words = packed_io.read_packed(args.input_file, width, height, device, mesh)
    read_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")

    if _checkpointing(args):
        run_fn = _prepare_checkpointed(args, variant, config, words, height,
                                       width, device, mesh, packed=True)
    elif args.snapshot_every:
        run_fn = _prepare_packed_segmented(args, config, words, height, width,
                                           device, mesh)
    elif args.resume_gen:
        run_fn = _prepare_resumed(args, config, words, height, width, device,
                                  mesh, packed=True)
    else:
        runner = engine.make_packed_runner((height, width), config, device,
                                           mesh=mesh)
        if args.warmup:
            fence(runner(words))

        def run_fn():
            return runner(words)

    final, generations, exec_ms = _execute(args, run_fn, device)
    return _report_and_write(
        variant, generations, exec_ms,
        lambda: packed_io.write_packed(output_path, final, width, mesh),
    )


def _snapshot_loop(args, config, runner, state0, write_snapshot):
    """Shared snapshotting loop over a segment runner, built (and its
    kernels loaded) before the timer: every segment's state is written as
    ``gen_NNNNNN.out``, a valid input file (the reference's only resume
    path, output-is-input, src/game.c:25-40 vs :154-165 — here it exists
    mid-run). Execution time covers the segmented loop including the
    snapshot writes."""
    outdir = args.snapshot_dir or "./snapshots"
    os.makedirs(outdir, exist_ok=True)

    def run_fn():
        final, generations = state0, 0
        for generations, final, _stopped in engine._iter_segments(
                runner, state0, config, args.snapshot_every, args.resume_gen):
            write_snapshot(os.path.join(outdir, f"gen_{generations:06d}.out"),
                           final)
        return final, generations

    return run_fn


def _prepare_segmented(args, variant, config, device_grid, height, width,
                       device, mesh):
    runner = engine.make_segment_runner((height, width), config, args.kernel,
                                        device, mesh=mesh)
    return _snapshot_loop(
        args, config, runner, device_grid,
        lambda path, state: _write_phase(variant, path, state, mesh))


def _prepare_packed_segmented(args, config, words, height, width, device, mesh):
    """Snapshotting loop over word state: every snapshot is written through
    the packed codec, itself a valid input file for any lane."""
    runner = engine.make_packed_segment_runner((height, width), config, device,
                                               mesh=mesh)
    return _snapshot_loop(
        args, config, runner, words,
        lambda path, state: packed_io.write_packed(path, state, width, mesh))


def _prepare_resumed(args, config, state, height, width, device, mesh, *,
                     packed):
    """Continue a run from a snapshot without writing further snapshots.

    The input file is the state after ``--resume-gen`` generations of a run
    that had not early-exited; the similarity phase is realigned from that
    count alone (``engine.resume_scalars``), so exits and the reported total
    match the uninterrupted run."""
    if packed:
        runner = engine.make_packed_segment_runner((height, width), config,
                                                   device, mesh=mesh)
    else:
        runner = engine.make_segment_runner((height, width), config,
                                            args.kernel, device, mesh=mesh)
    gen0, counter0 = engine.resume_scalars(config, args.resume_gen)
    report = engine._REPORT[config.convention]

    def run_fn():
        final, gen, _counter, _stopped = runner(state, gen0, counter0,
                                                config.gen_limit)
        return final, report(gen)

    return run_fn


def _checkpoint_codec(args, variant, width, height, device, mesh):
    """Payload encoding of the checkpoint lane: the packed lane stores the
    bitpacked words through the packed text codec (what the JAX package
    writes without tensorstore: the port has no zarr store), the byte lane a
    text grid through the variant's own I/O. Both are topology-independent,
    so checkpoints restore across mesh changes and across the two
    packages."""
    from gol_tpu_torch.resilience.checkpoint import PayloadCodec

    if args.packed_io:
        return PayloadCodec(
            format="packed-text",
            suffix=".out",
            write=lambda path, state: packed_io.write_packed(path, state, width, mesh),
            read=lambda path: packed_io.read_packed(path, width, height, device, mesh),
        )
    return PayloadCodec(
        format="text-grid",
        suffix=".out",
        write=lambda path, state: _write_phase(variant, path, state, mesh),
        read=lambda path: _read_phase(variant, path, width, height, device, mesh),
    )


def _refuse_zarr_checkpoints(directory: str) -> None:
    """A directory holding the JAX package's ``zarr-words`` checkpoints
    (TensorStore payloads) is refused: the port cannot read them, and
    resuming past them, or pruning them, would misreport what ran."""
    if not os.path.isdir(directory):
        return
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".manifest.json"):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                fmt = json.load(f).get("payload_format")
        except (OSError, ValueError):
            continue  # an unreadable manifest is restore()'s to skip
        if fmt == "zarr-words":
            raise ValueError(
                f"{os.path.join(directory, name)}: a zarr-words checkpoint "
                "(TensorStore payload) is not readable by the PyTorch port; "
                "resume it with python -m gol_tpu, or use another "
                "--checkpoint-dir"
            )


def _prepare_checkpointed(args, variant, config, state, height, width, device,
                          mesh, *, packed):
    """The crash-safe lane: --checkpoint-every writes an atomic checkpoint
    (fresh payload + manifest committed last; resilience/checkpoint.py) at
    every segment boundary, and --auto-resume restarts from the newest valid
    manifest, with no --resume-gen arithmetic. Resumed runs are bit-exact
    with uninterrupted ones: the segment loop carries the exact resume
    scalars (``engine.resume_scalars``), so the output file and the
    reported Generations are byte-identical either way.

    Everything before ``run_fn`` is set-up outside the timer: the
    fingerprint of the initial state, the restore, the runner's build (the
    kernels' build and load) and one zero-step call of it, the port's
    counterpart of the JAX lane's zero-step compile call."""
    from gol_tpu_torch.resilience.checkpoint import CheckpointManager, run_fingerprint

    _refuse_zarr_checkpoints(args.checkpoint_dir)
    mesh_shape = mesh.shape if mesh is not None else (1, 1)
    guard = None
    if args.disk_reserve:
        # The shed-checkpoints tier of the disk-pressure watchdog, ticked at
        # every save boundary.
        from gol_tpu_torch.resilience.diskguard import DiskGuard

        guard = DiskGuard(args.checkpoint_dir, admission_bytes=args.disk_reserve)
    mgr = CheckpointManager(
        args.checkpoint_dir,
        height=height,
        width=width,
        codec=_checkpoint_codec(args, variant, width, height, device, mesh),
        keep=args.checkpoint_keep,
        guard=guard,
        # Fingerprinted on the initial state (before any restore): a reused
        # checkpoint dir holding another input's checkpoints must never hand
        # that run's state to this one.
        run_fingerprint=run_fingerprint(state, tag=config.convention,
                                        mesh_shape=mesh_shape),
        mesh_shape=mesh_shape,
    )
    completed = args.resume_gen
    if args.auto_resume:
        # Checkpoints past --gen-limit are skipped, mirroring the
        # --resume-gen validator.
        restored = mgr.restore(max_generation=config.gen_limit)
        if restored is not None:
            state, info = restored
            completed = info.generation

    if packed:
        runner = engine.make_packed_segment_runner((height, width), config,
                                                   device, mesh=mesh)
    else:
        runner = engine.make_segment_runner((height, width), config,
                                            args.kernel, device, mesh=mesh)
    gen0, counter0 = engine.resume_scalars(config, completed)
    fence(runner(state, gen0, counter0, 0))  # zero-step call: first launches warm
    segment = args.checkpoint_every or max(1, config.gen_limit)

    # The async writer (default): a boundary costs the card only the
    # device->host snapshot; payload write and fsync run on a background
    # thread while the next segment computes, and the manifest commits at
    # the next boundary after draining that write (pipeline/writer.py).
    # --sync-checkpoints keeps the fully synchronous path; both give
    # identical outputs and checkpoint payloads.
    use_async = bool(args.checkpoint_every) and not args.sync_checkpoints

    def run_fn():
        writer = None
        if use_async:
            from gol_tpu_torch.pipeline.writer import AsyncCheckpointWriter

            writer = AsyncCheckpointWriter(mgr)
        try:
            final, generations = state, completed
            for generations, final, stopped in engine._iter_segments(
                    runner, state, config, segment, completed):
                if args.checkpoint_every and not stopped:
                    # An early-exited state is the final output, not mid-run
                    # state: a checkpoint of it would replay as mid-run on
                    # resume and change the reported count.
                    _, counter = engine.resume_scalars(config, generations)
                    if writer is not None:
                        writer.save(final, generations, counter)
                    else:
                        mgr.save(final, generations, counter)
            if writer is not None:
                # The final boundary's deferred wait: commit the last
                # pending checkpoint before the run reports success.
                writer.drain()
            return final, generations
        finally:
            if writer is not None:
                writer.close()  # join on exit, also on the error path

    return run_fn


def _validate_lane_flags(args, lane: str) -> None:
    """Flags the pattern/sparse lanes cannot honor: both are single-device
    and snapshot-free, and a silently-ignored flag would misreport what
    ran. ``--kernel`` is deliberately NOT here — the dense pattern branch
    honors it; only the sparse engine rejects it (below)."""
    for flag, name in (
        (args.mesh, "--mesh"),
        (args.packed_io, "--packed-io"),
        (args.host, "--host"),
        (args.snapshot_every, "--snapshot-every"),
        (args.resume_gen, "--resume-gen"),
    ):
        if flag:
            raise ValueError(f"{name} does not apply to {lane}")
    if _checkpointing(args):
        raise ValueError(
            f"checkpointing is not supported on {lane}; the serve path "
            "replays sparse jobs from their journaled spec"
        )


def _validate_sparse_flags(args) -> None:
    _validate_lane_flags(args, "the sparse engine lane")
    if args.kernel != "auto":
        raise ValueError(
            "--kernel does not apply to the sparse engine lane (the tile "
            "step is its own kernel family)"
        )


def _validate_macro_flags(args) -> None:
    _validate_lane_flags(args, "the macro engine lane")
    if args.kernel != "auto":
        raise ValueError(
            "--kernel does not apply to the macro engine lane (leaf steps "
            "ride the sparse tile kernel family)"
        )


def _parse_universe(spec: str) -> tuple[int, int]:
    m = re.fullmatch(r"(\d+)x(\d+)", spec)
    if not m:
        raise ValueError(f"--universe must look like WxH, got {spec!r}")
    return int(m.group(1)), int(m.group(2))  # (width, height)


def _parse_place(spec: str) -> tuple[int, int]:
    m = re.fullmatch(r"(-?\d+),(-?\d+)", spec)
    if not m:
        raise ValueError(f"--place must look like X,Y, got {spec!r}")
    return int(m.group(1)), int(m.group(2))  # (x=column, y=row)


def _run_sparse(variant, config, board, read_ms, output_path) -> int:
    """Drive a sparse simulation and write the result as RLE (a giant
    universe's dense text grid must never be written), keeping the
    reference's printed contract."""
    from gol_tpu_torch.sparse import TileMemo, simulate_sparse

    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")
    t0 = time.perf_counter()
    result = simulate_sparse(board, config, TileMemo())
    exec_ms = (time.perf_counter() - t0) * 1000
    comments = (
        f"generations {result.generations} exit {result.exit_reason}",
    )
    return _report_and_write(
        variant,
        result.generations,
        exec_ms,
        lambda: _write_text(output_path, result.board.to_rle(comments)),
    )


def _run_macro(args, variant, config, board, read_ms, output_path) -> int:
    """Drive a macrocell simulation (``macro/``) and write the result as
    RLE — same output contract as the sparse lane, because the result is
    byte-identical by construction; only the generation count scales
    differently (O(log gens) guarded jumps)."""
    from gol_tpu_torch.macro import MacroMemo, NodeStore, simulate_macro

    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")
    memo = MacroMemo(NodeStore(board.tile), cas_dir=args.macro_cas)
    t0 = time.perf_counter()
    result = simulate_macro(board, config, memo)
    exec_ms = (time.perf_counter() - t0) * 1000
    comments = (
        f"generations {result.generations} exit {result.exit_reason}",
    )
    return _report_and_write(
        variant,
        result.generations,
        exec_ms,
        lambda: _write_text(output_path, result.board.to_rle(comments)),
    )


def _run_shard(args, variant, config, pattern, x, y, height, width, tile,
               read_ms) -> int:
    """``--engine shard``: submit the pattern as ONE sharded job to a
    fleet router (``shard/``) and poll it home. The printed contract
    and the written RLE are byte-identical to the sparse lane's — the
    sharded engine's core promise — only the execution spans N workers."""
    from gol_tpu_torch.fleet import client as fleet_client
    from gol_tpu_torch.io import rle as rle_codec
    from gol_tpu_torch.sparse.board import SparseBoard

    router = args.shard_across.rstrip("/")
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")
    body = {
        "shard": True,
        "rle": rle_codec.encode(pattern),
        "x": x, "y": y, "width": width, "height": height, "tile": tile,
        "convention": config.convention,
        "gen_limit": config.gen_limit,
        "check_similarity": config.check_similarity,
        "similarity_frequency": config.similarity_frequency,
    }
    t0 = time.perf_counter()
    status, payload = fleet_client.http_json(
        "POST", f"{router}/jobs", body, timeout=120)
    if status != 202:
        raise ValueError(
            f"shard submit rejected: HTTP {status} {payload}"
        )
    job_id = payload["id"]
    while True:
        status, job = fleet_client.http_json(
            "GET", f"{router}/jobs/{job_id}", timeout=30)
        if status != 200:
            raise ValueError(
                f"shard job poll failed: HTTP {status} {job}"
            )
        if job.get("state") in ("done", "failed"):
            break
        time.sleep(0.1)
    if job["state"] == "failed":
        raise ValueError(
            f"shard job failed: {job.get('error', 'unknown error')}"
        )
    status, result = fleet_client.http_json(
        "GET", f"{router}/result/{job_id}", timeout=300)
    if status != 200:
        raise ValueError(f"shard result fetch failed: HTTP {status}")
    exec_ms = (time.perf_counter() - t0) * 1000
    generations = int(result["generations"])
    comments = (
        f"generations {generations} exit {result['exit_reason']}",
    )
    # Round-trip through SparseBoard: validates the merged document and
    # re-emits it through the same encoder as the sparse lane, so the
    # written file is byte-identical to a single-worker run's.
    board = SparseBoard.from_rle(result["rle"], height=height,
                                 width=width, tile=tile)
    output_path = args.output or "./sparse_output.rle"
    return _report_and_write(
        variant,
        generations,
        exec_ms,
        lambda: _write_text(output_path, board.to_rle(comments)),
    )




def _write_text(path: str, text: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def _run_pattern(args, variant) -> int:
    """``--pattern FILE [--place X,Y] [--universe WxH]``: the RLE input
    lane. Board construction is geometry-first — only the tiles the
    pattern touches are allocated — so the engine choice (``--engine``,
    default auto: sparse above the area threshold) happens before any
    canvas could exist."""
    from gol_tpu_torch.io import rle as rle_codec

    if args.input_file is not None:
        raise ValueError("--pattern replaces the input file argument")
    _validate_lane_flags(args, "the --pattern lane")
    config = GameConfig(
        gen_limit=args.gen_limit,
        check_similarity=not args.no_check_similarity,
        similarity_frequency=args.similarity_frequency,
        convention=variant.convention,
    )
    t0 = time.perf_counter()
    with open(args.pattern, "r", encoding="utf-8") as f:
        pattern = rle_codec.parse(f.read())
    read_ms = (time.perf_counter() - t0) * 1000
    ph, pw = pattern.shape
    if args.universe:
        width, height = _parse_universe(args.universe)
    else:
        width, height = pw, ph
    x, y = _parse_place(args.place)
    tile = args.tile or DEFAULT_TILE
    engine_pick = args.engine
    if engine_pick == "auto":
        from gol_tpu_torch.sparse.engine import auto_engine

        engine_pick = auto_engine(height, width, tile)
        if engine_pick == "sparse":
            # A sparse-routed auto run upgrades to the macrocell lane when
            # the generation count clears the crossover AND the placement
            # provably keeps the whole run off the torus seam (auto must
            # never pick an engine that can raise mid-run). Byte-identical
            # either way — this only changes how fast the answer arrives.
            from gol_tpu_torch.macro import auto_macro

            if auto_macro(height, width, tile, config.gen_limit,
                          (y, x, y + ph - 1, x + pw - 1)):
                engine_pick = "macro"
    if engine_pick == "shard":
        if args.kernel != "auto":
            raise ValueError(
                "--kernel does not apply to the shard engine (the "
                "workers' tile step is its own kernel family)"
            )
        return _run_shard(args, variant, config, pattern, x, y,
                          height, width, tile, read_ms)
    if engine_pick in ("sparse", "macro"):
        if args.kernel != "auto":
            raise ValueError(
                "--kernel does not apply to the sparse engine (the tile "
                "step is its own kernel family); add --engine dense to "
                "force the dense lane"
            )
        board = SparseBoard.from_pattern(pattern, x, y, height, width, tile)
        output_path = args.output or "./sparse_output.rle"
        if engine_pick == "macro":
            return _run_macro(args, variant, config, board, read_ms,
                              output_path)
        return _run_sparse(variant, config, board, read_ms, output_path)
    # Dense engine on a pattern input: materialize (guarded), place, run
    # the classic device lane.
    dense_cells_guard(height, width, what="universe")
    if x < 0 or y < 0 or y + ph > height or x + pw > width:
        raise ValueError(
            f"pattern {ph}x{pw} at ({x},{y}) does not fit the "
            f"{height}x{width} universe"
        )
    grid = np.zeros((height, width), np.uint8)
    grid[y:y + ph, x:x + pw] = pattern
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")
    device = resolve_device()
    device_grid = torch.from_numpy(grid).to(device)
    runner = engine.make_runner((height, width), config, args.kernel, device)
    t0 = time.perf_counter()
    final, generations = runner(device_grid)
    fence(final)
    exec_ms = (time.perf_counter() - t0) * 1000
    output_path = args.output or f"./{variant.output_file}"
    return _report_and_write(
        variant,
        int(generations),
        exec_ms,
        lambda: text_grid.write_grid(output_path, final.cpu().numpy()),
    )


def _run_sparse_file(args, variant, config, width, height) -> int:
    """``--engine sparse`` over a dense input file (the A/B lane: the same
    file the dense engine reads, simulated tile-wise — holding the sparse
    lane against the dense one from the CLI)."""
    dense_cells_guard(height, width, what="input file")
    t0 = time.perf_counter()
    grid = text_grid.read_grid(args.input_file, width, height)
    read_ms = (time.perf_counter() - t0) * 1000
    board = SparseBoard.from_dense(grid, args.tile or DEFAULT_TILE)
    output_path = args.output or "./sparse_output.rle"
    return _run_sparse(variant, config, board, read_ms, output_path)


def _run_macro_file(args, variant, config, width, height) -> int:
    """``--engine macro`` over a dense input file: the same A/B lane as
    ``_run_sparse_file``, driven through the macrocell tree."""
    dense_cells_guard(height, width, what="input file")
    t0 = time.perf_counter()
    grid = text_grid.read_grid(args.input_file, width, height)
    read_ms = (time.perf_counter() - t0) * 1000
    board = SparseBoard.from_dense(grid, args.tile or DEFAULT_TILE)
    output_path = args.output or "./sparse_output.rle"
    return _run_macro(args, variant, config, board, read_ms, output_path)


def _run_host(args, variant, config, width, height, output_path) -> int:
    """--host: the NumPy oracle path, no device involved.

    Prints exactly the lines the variant would print on the device —
    including the Reading/Writing lines of io_timings variants
    (src/game_mpi_collective.c:200-203,447-450) — so host and device output
    are line-for-line comparable."""
    dense_cells_guard(height, width)
    t0 = time.perf_counter()
    grid = text_grid.read_grid(args.input_file, width, height)
    read_ms = (time.perf_counter() - t0) * 1000
    if variant.io_timings:
        print(f"Reading file:\t{read_ms:.2f} msecs")
    t0 = time.perf_counter()
    result = oracle.run(grid, config)
    exec_ms = (time.perf_counter() - t0) * 1000
    return _report_and_write(
        variant, result.generations, exec_ms,
        lambda: text_grid.write_grid(output_path, result.grid),
    )


def _show(args) -> int:
    """Render a grid file with the reference's VT100 codes (src/game.c:42-58);
    --animate evolves it live on the host oracle."""
    from gol_tpu_torch import render

    width, height = atoi(args.width), atoi(args.height)
    if width <= 0:
        width = DEFAULT_WIDTH
    if height <= 0:
        height = DEFAULT_HEIGHT
    grid = text_grid.read_grid(args.input_file, width, height)
    if args.animate:
        render.animate(grid, args.animate, fps=args.fps)
    else:
        render.show(grid)
    return 0


def _arm_observability(trace_dir: str | None):
    """``--trace DIR``: enable span tracing and the flight recorder.

    Returns an export thunk ``main`` calls when the lane ends (clean, error
    return or crash unwind): the Chrome trace JSON lands in DIR. A crash
    also gets the flight recorder's JSONL dump in DIR, written at the
    injection or excepthook moment; ``gol trace-report`` renders both."""
    if not trace_dir:
        return lambda: None
    from gol_tpu_torch.obs import recorder

    os.makedirs(trace_dir, exist_ok=True)
    obs_trace.enable()
    recorder.install(trace_dir)

    def export():
        path = os.path.join(trace_dir, f"trace-{os.getpid()}.json")
        obs_trace.export_chrome(path)
        print(f"trace -> {path}", file=sys.stderr)
        return path

    return export


def _fetch_json(url: str, timeout: float = 5.0) -> dict:
    """GET ``url`` -> its JSON object, or {} on any connection or HTTP
    trouble, as the JAX CLI's: a 200 whose body is not JSON reads as
    ``{"error": <its first 200 bytes>}``."""
    import http.client
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": "application/json"},
                                 method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except (urllib.error.URLError, http.client.HTTPException, OSError,
            ValueError):
        return {}
    try:
        payload = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        payload = {"error": raw[:200].decode("utf-8", "replace")}
    return payload if status == 200 and isinstance(payload, dict) else {}


def _slo_report(args) -> int:
    """``gol slo-report``: summarize SLO state from a live server's ``/slo``
    or from a flight-recorder dump (the ``slo`` state record a crash leaves
    behind)."""
    from gol_tpu_torch.obs import recorder, slo as obs_slo

    target = args.target
    if target.startswith(("http://", "https://")):
        status = _fetch_json(f"{target.rstrip('/')}/slo", timeout=10)
        if not status:
            raise ValueError(f"no SLO status from {target} (is the server "
                             "up, and does it have /slo?)")
        sys.stdout.write(obs_slo.render_status(status))
        return 0
    state = None
    for rec in recorder.read_dump(target):
        if rec.get("record") == "state" and rec.get("name") == obs_slo.STATE_PROVIDER:
            state = {k: v for k, v in rec.items()
                     if k not in ("record", "name")}
    if state is None:
        raise ValueError(
            f"{target} holds no SLO state record (was the dumping process "
            "a server? pre-SLO dumps have none)"
        )
    sys.stdout.write(obs_slo.render_status(state))
    return 0


def _trace_report(args) -> int:
    """``gol trace-report``: render the summary of a Chrome trace JSON
    (a ``--trace DIR`` export) or a flight-recorder JSONL dump."""
    from gol_tpu_torch.obs import report

    sys.stdout.write(report.render(args.trace_file))
    return 0


def _history_report(args) -> int:
    """``gol history-report``: render a metrics-history ring as
    rate/value/percentile timelines (obs/history.py)."""
    from gol_tpu_torch.obs import history

    if not os.path.isdir(args.history_dir):
        raise ValueError(f"{args.history_dir} is not a directory (pass the "
                         "ring a --metrics-history run wrote)")
    sys.stdout.write(history.render_report(args.history_dir))
    return 0


def _generate(args) -> int:
    if args.output:
        text_grid.generate_to_file(
            args.output, args.width, args.height, density=args.density, seed=args.seed
        )
    else:
        grid = text_grid.generate(
            args.width, args.height, density=args.density, seed=args.seed
        )
        sys.stdout.write(text_grid.encode(grid).decode("ascii"))
    return 0


def _batch(args) -> int:
    """``batch``: the offline batched lane — N input files, one process.

    Jobs are bucketed as the JAX package's server would
    (``serve/batcher.py``), each bucket runs as few batches as the
    batch-size ladder allows, and per-board results are bit-identical to
    solo ``run``s."""
    from gol_tpu_torch.serve import batcher
    from gol_tpu_torch.serve.jobs import new_job

    variant = get_variant(args.variant)
    width, height = atoi(args.width), atoi(args.height)
    if width <= 0:
        width = DEFAULT_WIDTH
    if height <= 0:
        height = DEFAULT_HEIGHT
    if not 1 <= args.max_batch <= batcher.MAX_BATCH:
        raise ValueError(
            f"--max-batch must be in [1, {batcher.MAX_BATCH}], "
            f"got {args.max_batch}"
        )
    outdir = args.output_dir
    if outdir:
        os.makedirs(outdir, exist_ok=True)

    jobs = []
    for path in args.input_files:
        grid = text_grid.read_grid(path, width, height)
        job = new_job(
            width, height, grid,
            convention=variant.convention,
            gen_limit=args.gen_limit,
        )
        jobs.append((path, job))

    buckets: dict = {}
    for path, job in jobs:
        buckets.setdefault(batcher.bucket_for(job), []).append((path, job))

    t0 = time.perf_counter()
    batches = 0
    occupancy = []
    outputs = []
    for key, members in buckets.items():
        for i in range(0, len(members), args.max_batch):
            chunk = members[i : i + args.max_batch]
            results = batcher.run_batch(key, [job for _, job in chunk])
            batches += 1
            occupancy.append(len(chunk) / batcher.pad_batch(len(chunk)))
            for (path, _job), result in zip(chunk, results):
                out_path = (
                    os.path.join(outdir, os.path.basename(path) + ".out")
                    if outdir
                    else path + ".out"
                )
                text_grid.write_grid(out_path, result.grid)
                outputs.append(
                    (path, result.generations, result.exit_reason, out_path)
                )
    exec_s = time.perf_counter() - t0
    for path, gens, reason, out_path in outputs:
        print(f"{path}\tGenerations:\t{gens}\t{reason}\t-> {out_path}")
    mean_occ = sum(occupancy) / len(occupancy) if occupancy else 0.0
    print(
        f"Batch:\t{len(jobs)} boards, {len(buckets)} bucket(s), "
        f"{batches} dispatch(es), occupancy {mean_occ:.2f}, "
        f"{len(jobs) / max(exec_s, 1e-9):.1f} boards/sec, "
        f"{exec_s * 1000:.2f} msecs",
        file=sys.stderr,
    )
    return 0


def _journal_partitions(directory: str) -> list[str]:
    """Journal directories under ``directory``: itself when it IS one, else
    every immediate subdirectory holding journal state — the fleet-dir
    shape, where each worker partition compacts independently."""
    from gol_tpu_torch.serve import compaction

    def is_partition(d):
        return (
            os.path.exists(os.path.join(d, compaction.ACTIVE_FILENAME))
            or os.path.exists(compaction.snapshot_path(d))
            or bool(compaction.sealed_segments(d))
        )

    if is_partition(directory):
        return [directory]
    try:
        subdirs = sorted(
            os.path.join(directory, name) for name in os.listdir(directory)
        )
    except OSError as err:
        raise ValueError(f"cannot read {directory}: {err}") from None
    return [d for d in subdirs if os.path.isdir(d) and is_partition(d)]


def _compact_cmd(args) -> int:
    """``compact``: offline journal compaction — fold sealed segments into
    the CRC-stamped snapshot and retire them. Accepts a journal directory
    OR a fleet directory, whose partitions compact independently."""
    from gol_tpu_torch.serve import compaction

    partitions = _journal_partitions(args.dir)
    if not partitions:
        raise ValueError(f"no journal state under {args.dir}")
    for directory in partitions:
        report = compaction.compact(directory, retain_results=args.retain)
        print(
            f"{directory}: "
            + (f"compacted {report.segments_retired} segment(s) -> "
               f"snapshot ({report.records_kept} records"
               + (f", {report.terminal_dropped} old result(s) dropped"
                  if report.terminal_dropped else "")
               + f"), {report.bytes_before} -> {report.bytes_after} bytes"
               if report.compacted else
               f"nothing to compact ({report.bytes_after} bytes"
               + (f"; swept {report.segments_retired} stale segment(s)"
                  if report.segments_retired else "") + ")")
        )
    return 0


def _serve(args) -> int:
    """``serve``: the batched multi-tenant simulation service.

    Boots the HTTP API (``serve/server.py``) over the journaled scheduler
    on the card (``GOL_TORCH_DEVICE=cpu``: the CPU). The device is resolved
    and the batched kernels (B1, B2) are built and loaded before ``serving
    on <url>`` prints, so a machine without a card exits 1 with a ``gol:``
    line instead of accepting jobs it cannot run. SIGTERM/SIGINT drain
    gracefully: admission stops, queued buckets flush, in-flight batches
    finish, then the process exits — no accepted job is lost (the journal
    replays any that were cut off).

    ``--compile-cache DIR`` is the build directory of the kernels;
    ``--resident-ring R`` mounts the resident ring lanes
    (``serve/resident.py``); ``--warm-plans`` builds and runs once the
    bucket runners of every shape ``tune`` recorded, before ``serving on``
    prints. Refused with a ``gol:`` line, as not ported: ``--cache-payload
    ts``."""
    import signal

    from gol_tpu_torch.cache.store import TS_REFUSAL
    from gol_tpu_torch.ops import stencil_batch

    if args.cache_payload == "ts":
        raise ValueError(TS_REFUSAL)
    _build.enable_compile_cache(args.compile_cache)

    # The subprocess fault harness (GOL_FAULTS crosses the exec boundary,
    # flags don't). Unset, this clears any plan a previous in-process run
    # armed — same contract as `run`.
    faults.install(faults.FaultPlan.from_env())

    from gol_tpu_torch.serve.server import GolServer

    if args.flush_age < 0:
        raise ValueError(f"--flush-age must be >= 0, got {args.flush_age}")
    if args.warm_plans:
        _warm_plans()
    if args.slo_latency_p99 <= 0:
        raise ValueError(
            f"--slo-latency-p99 must be > 0, got {args.slo_latency_p99}"
        )
    if args.cache_entries < 1:
        raise ValueError(
            f"--cache-entries must be >= 1, got {args.cache_entries}"
        )
    if args.cache_disk_bytes is not None and args.cache_disk_bytes < 1:
        raise ValueError(
            f"--cache-disk-bytes must be >= 1, got {args.cache_disk_bytes}"
        )
    if args.journal_segment_bytes is not None \
            and args.journal_segment_bytes < 0:
        raise ValueError(
            f"--journal-segment-bytes must be >= 0, got "
            f"{args.journal_segment_bytes}"
        )
    if args.journal_retain is not None and args.journal_retain < 1:
        raise ValueError(
            f"--journal-retain must be >= 1, got {args.journal_retain}"
        )
    if args.disk_reserve < 0:
        raise ValueError(
            f"--disk-reserve must be >= 0, got {args.disk_reserve}"
        )
    if args.disk_reserve and not args.journal_dir:
        raise ValueError(
            "--disk-reserve watches the journal partition; pass "
            "--journal-dir (a journal-less server has no durable state "
            "to protect)"
        )
    # --result-cache with a journal but no explicit --cache-dir puts the
    # CAS tier beside the journal: restarts keep their durable tier with
    # zero extra flags. No journal and no --cache-dir = memory-only.
    cache_dir = args.cache_dir
    if args.result_cache and cache_dir is None and args.journal_dir:
        cache_dir = os.path.join(args.journal_dir, "cache")
    # --metrics-history with no DIR rides the journal partition; bare
    # --metrics-history without a journal needs an explicit DIR.
    history_dir = args.metrics_history
    if history_dir == "auto":
        if not args.journal_dir:
            raise ValueError(
                "--metrics-history needs a DIR (or --journal-dir, whose "
                "partition hosts the default <journal-dir>/history)"
            )
        history_dir = os.path.join(args.journal_dir, "history")
    if history_dir and args.sample_interval <= 0:
        # The history ring is fed by the sampler thread; with the sampler
        # disabled the ring would mount and then silently stay empty.
        raise ValueError(
            "--metrics-history is fed by the background sampler; "
            f"--sample-interval must be > 0 (got {args.sample_interval})"
        )
    if args.history_bytes is not None and args.history_bytes < 4096:
        raise ValueError(
            f"--history-bytes must be >= 4096, got {args.history_bytes}"
        )
    if args.retry_budget < 0:
        raise ValueError(
            f"--retry-budget must be >= 0, got {args.retry_budget}"
        )
    scheduler_kwargs = {}
    if args.retry_budget:
        # The dispatch-retry token bucket: N tokens of capacity, refilled
        # over a minute. 0 (default) = unlimited.
        from gol_tpu_torch.resilience.retry import RetryBudget

        scheduler_kwargs["retry_budget"] = RetryBudget(
            capacity=args.retry_budget,
            refill_per_s=args.retry_budget / 60.0,
        )
    if resolve_device().type == "cuda":
        stencil_batch.load_kernels()
    server = GolServer(
        host=args.host,
        port=args.port,
        journal_dir=args.journal_dir,
        max_queue_depth=args.max_queue_depth,
        max_batch=args.max_batch,
        flush_age=args.flush_age,
        max_inflight=args.max_inflight,
        pipeline_depth=args.pipeline_depth,
        resident_ring=args.resident_ring,
        slo_shed=args.slo_shed,
        slo_latency_target=args.slo_latency_p99,
        sample_interval=args.sample_interval,
        result_cache=args.result_cache,
        cache_dir=cache_dir,
        cache_entries=args.cache_entries,
        cache_payload=args.cache_payload,
        cache_disk_bytes=args.cache_disk_bytes,
        journal_segment_bytes=args.journal_segment_bytes,
        journal_retain=args.journal_retain,
        disk_reserve=args.disk_reserve,
        history_dir=history_dir,
        history_bytes=args.history_bytes,
        **scheduler_kwargs,
    )
    stop = {"signaled": False}

    def _on_signal(signum, frame):
        # Second signal: exit hard (the journal still replays on restart).
        if stop["signaled"]:
            raise SystemExit(1)
        stop["signaled"] = True
        import threading

        threading.Thread(
            target=lambda: (server.shutdown(drain=True)), daemon=True
        ).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"serving on {server.url}", flush=True)
    if server.replayed:
        print(f"replayed {server.replayed} unfinished job(s) from the journal",
              flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    # A second signal raises SystemExit(1) in the main thread (the hard-exit
    # path): it propagates, so supervisors see a non-zero status.
    stats_dir = os.environ.get(EXIT_STATS_ENV)
    if stats_dir:
        _write_exit_stats(stats_dir)
    return 0


def _write_exit_stats(directory: str) -> None:
    """``$GOL_TORCH_EXIT_STATS``: a drained ``serve`` leaves
    ``DIR/serve-<pid>.json`` — its kernel wrappers' launch counts and the
    card's peak allocated bytes (null on the CPU). How a smoke run reads
    the worker processes a fleet spawned, whose counters it cannot see."""
    from gol_tpu_torch.ops import (stencil_batch, stencil_packed,
                                   stencil_pallas, stencil_tile)

    device = resolve_device()
    doc = {
        "pid": os.getpid(),
        "launches": {**stencil_packed.LAUNCHES, **stencil_pallas.LAUNCHES,
                     **stencil_batch.LAUNCHES, **stencil_tile.LAUNCHES},
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"serve-{os.getpid()}.json"), "w",
              encoding="utf-8") as f:
        json.dump(doc, f)


def _fleet(args) -> int:
    """``gol fleet``: the sharded serving fleet — router + N workers.

    Spawns ``--workers`` local ``gol serve`` subprocesses (each on its own
    journal partition under ``--fleet-dir``) and/or attaches externally
    managed workers by ``--attach URL`` (the multi-host lane: boot workers
    wherever ``parallel/bootstrap.py`` put the devices, hand the router
    their URLs), then serves the single-server HTTP job API unchanged
    behind bucket-consistent routing (``fleet/``).

    Restart story: started on a ``--fleet-dir`` holding a manifest, the
    router reattaches workers that are still alive and respawns dead local
    partitions, whose journals replay to exactly-once — killing the router
    loses nothing. SIGTERM/SIGINT cascade a fleet-wide graceful drain:
    admission stops at the router, every worker drains, local workers get
    SIGTERM, then the router exits."""
    import signal
    import subprocess

    from gol_tpu_torch.fleet.router import RouterServer
    from gol_tpu_torch.fleet.workers import (
        WORKER_MODULE, Fleet, core_slice_prefix,
    )

    if args.workers < 0:
        raise ValueError(f"--workers must be >= 0, got {args.workers}")
    if args.flush_age < 0:
        raise ValueError(f"--flush-age must be >= 0, got {args.flush_age}")
    if args.health_interval <= 0:
        raise ValueError(
            f"--health-interval must be > 0, got {args.health_interval}"
        )
    # The worker-side --metrics-history/--history-bytes rules, enforced
    # BEFORE any worker spawns: forwarding a value every worker will
    # reject at its own argv parse would boot-crash the whole fleet and
    # surface as a raw _await_ready RuntimeError instead of the CLI's
    # `gol: <error>` contract.
    if args.metrics_history and args.sample_interval <= 0:
        raise ValueError(
            "--metrics-history is fed by each worker's background "
            f"sampler; --sample-interval must be > 0 "
            f"(got {args.sample_interval})"
        )
    if args.history_bytes is not None and args.history_bytes < 4096:
        raise ValueError(
            f"--history-bytes must be >= 4096, got {args.history_bytes}"
        )
    if args.cores_per_worker < 0:
        raise ValueError(
            f"--cores-per-worker must be >= 0, got {args.cores_per_worker}"
        )
    if args.cores_per_worker > (os.cpu_count() or args.cores_per_worker):
        # Validated BEFORE any worker spawns (the history-flags contract):
        # taskset fails outright on a range naming CPUs the host lacks,
        # and every worker would boot-crash with a raw log tail instead
        # of a `gol:` error.
        raise ValueError(
            f"--cores-per-worker {args.cores_per_worker} exceeds the "
            f"host's {os.cpu_count()} cores"
        )
    if args.breaker_cooldown < 0:
        raise ValueError(
            f"--breaker-cooldown must be >= 0, got {args.breaker_cooldown}"
        )
    if args.routers < 1:
        raise ValueError(f"--routers must be >= 1, got {args.routers}")
    if args.retry_budget < 0:
        # Validated BEFORE any worker spawns (the history-flags contract):
        # forwarded verbatim, a negative budget boot-crashes every worker
        # long after launch instead of erroring here.
        raise ValueError(
            f"--retry-budget must be >= 0, got {args.retry_budget}"
        )
    # Storage-lifecycle flags: same validated-before-spawn contract.
    if args.cache_disk_bytes is not None and args.cache_disk_bytes < 1:
        raise ValueError(
            f"--cache-disk-bytes must be >= 1, got {args.cache_disk_bytes}"
        )
    if args.journal_segment_bytes is not None \
            and args.journal_segment_bytes < 0:
        raise ValueError(
            f"--journal-segment-bytes must be >= 0, got "
            f"{args.journal_segment_bytes}"
        )
    if args.journal_retain is not None and args.journal_retain < 1:
        raise ValueError(
            f"--journal-retain must be >= 1, got {args.journal_retain}"
        )
    if args.disk_reserve < 0:
        raise ValueError(
            f"--disk-reserve must be >= 0, got {args.disk_reserve}"
        )
    if args.chaos:
        # Parsed up front so a typo'd plan is a `gol: <error>` before any
        # worker spawns — and so the boot banner can echo the armed plan.
        from gol_tpu_torch.chaos import ChaosPlan

        ChaosPlan.parse(args.chaos)
    # Autoscaler bounds resolve against --workers; AutoscaleConfig's own
    # validation (min >= 1, max >= min, threshold ordering) runs HERE,
    # before any worker spawns — same contract as the history flags.
    autoscale_cfg = None
    if args.autoscale:
        from gol_tpu_torch.fleet.autoscale import AutoscaleConfig

        min_workers = (args.min_workers if args.min_workers is not None
                       else max(1, args.workers))
        max_workers = (args.max_workers if args.max_workers is not None
                       else max(4, args.workers))
        autoscale_cfg = AutoscaleConfig(
            min_workers=min_workers,
            max_workers=max_workers,
            up_saturation=args.scale_up_saturation,
            up_sustain=args.scale_up_sustain,
            down_occupancy=args.scale_down_occupancy,
            down_sustain=args.scale_down_sustain,
            cooldown_s=args.scale_cooldown,
        )
    elif args.min_workers is not None or args.max_workers is not None:
        raise ValueError("--min-workers/--max-workers need --autoscale")
    # Worker flags forwarded verbatim to every spawned `gol serve` —
    # including --warm-plans, so a tuned fleet pre-compiles each worker's
    # bucket programs (and the plan cache is shared via GOL_PLAN_CACHE /
    # the default cache path, exactly as for a single server).
    serve_args = [
        "--max-queue-depth", str(args.max_queue_depth),
        "--max-batch", str(args.max_batch),
        "--flush-age", str(args.flush_age),
        "--pipeline-depth", str(args.pipeline_depth),
        "--slo-latency-p99", str(args.slo_latency_p99),
        "--sample-interval", str(args.sample_interval),
    ]
    if args.retry_budget:
        serve_args += ["--retry-budget", str(args.retry_budget)]
    if args.resident_ring:
        serve_args += ["--resident-ring", str(args.resident_ring)]
    if args.warm_plans:
        serve_args += ["--warm-plans"]
    if args.compile_cache:
        serve_args += ["--compile-cache", args.compile_cache]
    if args.slo_shed:
        serve_args += ["--slo-shed"]
    if args.result_cache:
        # Each worker's CAS tier lands on its own journal partition
        # (--result-cache + --journal-dir defaults --cache-dir to
        # <partition>/cache): with --cache-route, a fingerprint's HRW owner
        # IS the worker whose partition holds its cache shard.
        serve_args += ["--result-cache"]
    if args.trace:
        # Every worker arms its own tracer on the SHARED directory
        # (exports/flight dumps are pid-qualified, so processes never
        # collide); the router's own arming rides main()'s --trace hook.
        serve_args += ["--trace", args.trace]
    if args.metrics_history:
        # Bare --metrics-history on a worker resolves to its journal
        # partition (<partition>/history) — per-process rings, exactly
        # like the journal and the CAS tier.
        serve_args += ["--metrics-history"]
        if args.history_bytes is not None:
            serve_args += ["--history-bytes", str(args.history_bytes)]
    # Storage-lifecycle flags, forwarded verbatim: every partition rotates,
    # compacts, budgets its CAS, and watches its own free bytes
    # INDEPENDENTLY — one full-disk partition 507s alone while the rest of
    # the fleet serves.
    if args.cache_disk_bytes is not None:
        serve_args += ["--cache-disk-bytes", str(args.cache_disk_bytes)]
    if args.journal_segment_bytes is not None:
        serve_args += ["--journal-segment-bytes",
                       str(args.journal_segment_bytes)]
    if args.journal_retain is not None:
        serve_args += ["--journal-retain", str(args.journal_retain)]
    if args.disk_reserve:
        serve_args += ["--disk-reserve", str(args.disk_reserve)]

    # --cores-per-worker: pin worker k to its own equal `taskset` slice
    # (the fixed per-worker budget of a one-worker-per-device deployment,
    # on a shared host) and weight it for --affinity placement. Autoscaled
    # spawns ride the same hook, so new workers land on distinct slices.
    spawn_prefix = None
    spawn_weight = None
    if args.cores_per_worker:
        spawn_prefix = core_slice_prefix(args.cores_per_worker)
        spawn_weight = float(args.cores_per_worker)

    from gol_tpu_torch.fleet import replicate

    fleet = Fleet(args.fleet_dir, serve_args=serve_args,
                  spawn_prefix=spawn_prefix, spawn_weight=spawn_weight)
    recovered = fleet.load()
    if recovered:
        print(f"reattached {recovered} worker partition(s) from "
              f"{fleet.manifest_path}", flush=True)
    # This invocation's flags become the manifest's `config` block — the
    # single source of truth a `gol router` replica boots from (set AFTER
    # load(), so the operator's current flags supersede a stale block).
    fleet.manifest_config = {
        "serve_args": serve_args,
        "health_interval": args.health_interval,
        "big_edge": args.big_edge,
        "cache_route": bool(args.cache_route),
        "affinity": bool(args.affinity),
        "breakers": not args.no_breakers,
        "breaker_cooldown": args.breaker_cooldown,
        "breaker_slow": args.breaker_slow,
        "max_queue_depth": args.max_queue_depth,
        "cores_per_worker": args.cores_per_worker,
        "autoscale": (dataclasses.asdict(autoscale_cfg)
                      if autoscale_cfg is not None else None),
    }
    # Arm the leader lease BEFORE spawning: normally this primary wins
    # immediately, but if a surviving replica of a previous incarnation
    # still holds the lock, the restarted primary joins as a follower for
    # the single-writer ticks (it still performs this boot's operator-
    # initiated spawns — the flock serializes the manifest writes).
    fleet.enable_leader_election(label="r0")
    for url in args.attach or []:
        fleet.attach(url)
    fleet.spawn_fleet(args.workers, big_lane=args.big_lane)
    if not fleet.workers():
        raise ValueError(
            "fleet has no workers: pass --workers N and/or --attach URL"
        )
    fleet.write_manifest()  # persist the config block even when nothing spawned
    fleet.start_health(args.health_interval)
    # The chaos-hardened data path: breakers default ON for the
    # CLI fleet (the library RouterServer default stays off/byte-identical
    # for embedders and old tests); --chaos mounts the fault-injecting
    # proxy pool on the router->worker data path. Breaker transitions land
    # in a durable ring beside the autoscaler's decisions.
    chaos_pool = None
    if args.chaos:
        from gol_tpu_torch.chaos import ChaosPlan, ProxyPool

        chaos_pool = ProxyPool(ChaosPlan.parse(args.chaos))
        # Respawns move workers to fresh ports; every health tick drops
        # the proxies (listener socket + accept thread each) still
        # fronting the dead ones.
        fleet.add_tick_hook(
            lambda: chaos_pool.prune(w.url for w in fleet.workers())
        )
        print(f"chaos: fault injection ARMED on the router->worker data "
              f"path ({args.chaos})", flush=True)
    breaker_kwargs = {}
    if not args.no_breakers:
        from gol_tpu_torch.fleet.breaker import BreakerConfig
        from gol_tpu_torch.obs.history import HistoryWriter as _BreakerRing

        breaker_kwargs = {
            "breakers": True,
            "breaker_config": BreakerConfig(
                cooldown_s=args.breaker_cooldown,
                slow_s=args.breaker_slow if args.breaker_slow > 0 else None,
            ),
            # Per-ROUTER ring: each replica is the single writer
            # of its own `<fleet-dir>/routers/<id>/breaker-history`, and
            # warm-start merges across all of them.
            "breaker_history": _BreakerRing(
                os.path.join(replicate.state_dir(args.fleet_dir, "r0"),
                             replicate.BREAKER_RING),
                source="breaker",
            ),
        }
    router = RouterServer(fleet, host=args.host, port=args.port,
                          big_edge=args.big_edge,
                          cache_route=args.cache_route,
                          affinity_route=args.affinity,
                          chaos=chaos_pool,
                          router_id="r0",
                          state_dir=replicate.state_dir(args.fleet_dir, "r0"),
                          **breaker_kwargs)
    if not args.no_breakers:
        # Same cadence as the chaos-proxy prune: a retired worker's
        # breaker (and its state gauge) leaves with its membership row.
        fleet.add_tick_hook(router.prune_breakers)
    if autoscale_cfg is not None:
        from gol_tpu_torch.fleet.autoscale import Autoscaler
        from gol_tpu_torch.obs.history import HistoryWriter

        # Every decision lands in a durable history ring beside the router's
        # — `gol history-report` and the bench suite replay why the fleet
        # grew. The tick rides the health loop: one cadence, and the /slo
        # payloads the loop fetched this tick ARE the burn signal.
        autoscaler = Autoscaler(
            fleet, router, autoscale_cfg,
            queue_capacity=args.max_queue_depth,
            history=HistoryWriter(
                os.path.join(args.fleet_dir, "autoscaler-history"),
                source="autoscaler",
            ),
        )
        router.autoscaler = autoscaler
        fleet.add_tick_hook(autoscaler.tick)
        print(f"autoscaler: {autoscale_cfg.min_workers}"
              f"..{autoscale_cfg.max_workers} workers "
              f"(up at {autoscale_cfg.up_saturation:.2f} saturation or "
              f"SLO-critical burn, down below "
              f"{autoscale_cfg.down_occupancy:.2f} occupancy, "
              f"{autoscale_cfg.cooldown_s:.0f}s cooldown)", flush=True)
    if args.metrics_history:
        # The router's durable record is the fleet-MERGED snapshot, floored
        # by MonotonicCounters — the series an incident review replays stay
        # monotonic through every worker respawn in the window.
        router.start_history(
            os.path.join(args.fleet_dir, "router-history"),
            interval=args.sample_interval,  # validated > 0 above
            total_bytes=args.history_bytes,
        )
    # --routers N: N-1 extra `gol router` replica subprocesses over the
    # same --fleet-dir. Replicas are the horizontal CONTROL plane: each
    # serves the full job API from the shared manifest, contests the
    # leader lease, and inherits the durable floors/breaker state — so no
    # single router process is a SPOF. They are deliberately NOT
    # supervised (no respawn-the-router loop: the operator's init system
    # owns router lifetimes; the fleet only guarantees any survivor can
    # carry the whole control plane).
    replicas: list = []
    for k in range(1, args.routers):
        rid = f"r{k}"
        rdir = replicate.state_dir(args.fleet_dir, rid)
        os.makedirs(rdir, exist_ok=True)
        log_path = os.path.join(rdir, "log")
        log_f = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE, "router",
                 "--fleet-dir", args.fleet_dir,
                 "--router-id", rid, "--port", "0"],
                stdout=log_f, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONUNBUFFERED": "1"},
            )
        finally:
            log_f.close()
        replicas.append(proc)
        print(f"router replica {rid} pid={proc.pid} (log: {log_path})",
              flush=True)

    stop = {"signaled": False}

    def _on_signal(signum, frame):
        # Second signal: exit hard (workers' journals replay on restart).
        if stop["signaled"]:
            raise SystemExit(1)
        stop["signaled"] = True
        import threading

        def _cascade():
            # Replicas go FIRST: they hold no worker processes, and
            # stopping them before the workers drain means no replica
            # wins the lease mid-cascade and starts "supervising" the
            # teardown it cannot see.
            for proc in replicas:
                if proc.poll() is None:
                    proc.terminate()
            router.shutdown(cascade=True)
            for proc in replicas:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()

        threading.Thread(target=_cascade, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    roster = ", ".join(f"{w.id}={w.url}" for w in fleet.workers())
    print(f"fleet router on {router.url} "
          f"({len(fleet.workers())} workers: {roster})", flush=True)
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _router(args) -> int:
    """``gol router``: one attachable router replica over a running fleet.

    Boots from the shared manifest alone (`--fleet-dir` is the only
    coordination channel): adopts the membership and the `config` block
    the primary recorded, inherits the durable counter floors and breaker
    evidence under ``<fleet-dir>/routers/``, and contests the leader
    lease. While following it routes, forwards, and serves lookups like
    any replica (active-active data plane); if the leader dies, the
    kernel drops the flock and the next health tick here picks up the
    single-writer ticks (respawn supervision, scale decisions).

    SIGTERM/SIGINT stop THIS replica only (``cascade=False``): workers
    belong to the fleet, not to any one router."""
    import signal

    from gol_tpu_torch.fleet import replicate
    from gol_tpu_torch.fleet.router import RouterServer
    from gol_tpu_torch.fleet.workers import Fleet, core_slice_prefix

    if not re.match(r"^[A-Za-z0-9][A-Za-z0-9._-]*$", args.router_id):
        raise ValueError(
            f"--router-id must be alphanumeric/._- (got {args.router_id!r})"
        )
    manifest = os.path.join(args.fleet_dir, "manifest.json")
    if not os.path.exists(manifest):
        raise ValueError(
            f"no fleet manifest at {manifest}: start "
            f"`gol fleet --fleet-dir {args.fleet_dir}` first"
        )
    fleet = Fleet(args.fleet_dir, replica=True)
    recovered = fleet.load()
    cfg = fleet.manifest_config or {}
    # A replica spawns nothing at boot, but a replica-turned-leader
    # respawns dead partitions and scales — with the primary's recorded
    # spawn recipe, not a divergent one.
    fleet.serve_args = list(cfg.get("serve_args") or [])
    cores = int(cfg.get("cores_per_worker") or 0)
    if cores:
        fleet._spawn_prefix = core_slice_prefix(cores)
        fleet._spawn_weight = float(cores)
    leading = fleet.enable_leader_election(label=args.router_id)
    breaker_kwargs = {}
    if cfg.get("breakers", True):
        from gol_tpu_torch.fleet.breaker import BreakerConfig
        from gol_tpu_torch.obs.history import HistoryWriter as _BreakerRing

        cooldown = float(cfg.get("breaker_cooldown", 5.0))
        slow = float(cfg.get("breaker_slow", 1.0))
        breaker_kwargs = {
            "breakers": True,
            "breaker_config": BreakerConfig(
                cooldown_s=cooldown, slow_s=slow if slow > 0 else None,
            ),
            "breaker_history": _BreakerRing(
                os.path.join(
                    replicate.state_dir(args.fleet_dir, args.router_id),
                    replicate.BREAKER_RING),
                source="breaker",
            ),
        }
    router = RouterServer(
        fleet, host=args.host, port=args.port,
        big_edge=int(cfg.get("big_edge", 1024)),
        cache_route=bool(cfg.get("cache_route")),
        affinity_route=bool(cfg.get("affinity")),
        router_id=args.router_id,
        state_dir=replicate.state_dir(args.fleet_dir, args.router_id),
        **breaker_kwargs)
    if breaker_kwargs:
        fleet.add_tick_hook(router.prune_breakers)
    if isinstance(cfg.get("autoscale"), dict):
        # Armed but leader-gated: the tick no-ops until THIS replica holds
        # the lease, then scale decisions continue where the dead leader's
        # stopped. Its decision ring lives in this replica's own state dir
        # (single writer per directory), not the primary's legacy path.
        from gol_tpu_torch.fleet.autoscale import AutoscaleConfig, Autoscaler
        from gol_tpu_torch.obs.history import HistoryWriter

        try:
            autoscale_cfg = AutoscaleConfig(**cfg["autoscale"])
        except (TypeError, ValueError) as err:
            raise ValueError(
                f"manifest autoscale config is invalid: {err}") from err
        autoscaler = Autoscaler(
            fleet, router, autoscale_cfg,
            queue_capacity=int(cfg.get("max_queue_depth", 1024)),
            history=HistoryWriter(
                os.path.join(
                    replicate.state_dir(args.fleet_dir, args.router_id),
                    "autoscaler-history"),
                source="autoscaler",
            ),
        )
        router.autoscaler = autoscaler
        fleet.add_tick_hook(autoscaler.tick)
    fleet.start_health(float(cfg.get("health_interval", 1.0)))
    stop = {"signaled": False}

    def _on_signal(signum, frame):
        if stop["signaled"]:
            raise SystemExit(1)
        stop["signaled"] = True
        import threading

        threading.Thread(
            target=lambda: router.shutdown(cascade=False), daemon=True
        ).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"fleet router on {router.url} "
          f"(replica {args.router_id} over {args.fleet_dir}, "
          f"{recovered} partition(s) adopted, "
          f"{'leading' if leading else 'following'})", flush=True)
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _warm_plans() -> None:
    """Build the bucket runners of every tuner-recorded serve shape (plus
    the tuned quantum/ladder geometry, consulted by ``bucket_for``) and run
    each once on inert operands, which on the card builds and loads the
    kernels. EVERY ladder rung is warmed, not just the full batch: real
    flushes dispatch at whatever rung the flushed count rounds to. Warm
    failures are loud but non-fatal: a server that builds on first
    dispatch still serves."""
    import numpy as np

    from gol_tpu_torch.serve import batcher
    from gol_tpu_torch.serve.jobs import new_job
    from gol_tpu_torch.tune import select

    entries = select.warm_entries()
    if not entries:
        print("no tuned serve shapes to warm (run `gol tune --serve-board` "
              "first)", file=sys.stderr)
        return
    rungs = batcher._plan().batch_ladder
    for entry in entries:
        t0 = time.perf_counter()
        # Warm entries are cache-file content: a stale or hand-edited one
        # (bad convention, non-numeric extent) degrades loudly to building
        # on first dispatch, never aborts server boot.
        try:
            height, width = int(entry["height"]), int(entry["width"])
            convention = str(entry.get("convention", "c"))
            board = np.zeros((height, width), dtype=np.uint8)
            key = batcher.bucket_for(
                new_job(width, height, board, convention=convention)
            )
            for rung in rungs:
                batcher.warm(key, batch=rung)
        except Exception as err:  # noqa: BLE001 - warmup must not kill boot
            print(f"warm entry {entry} failed ({type(err).__name__}: {err})",
                  file=sys.stderr)
            continue
        print(f"warmed bucket {key.label()} ({len(rungs)} batch rungs) in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)


def _tune(args) -> int:
    """``tune``: the offline measured search.

    Searches the declarative space (``tune/space.py``) for each requested
    shape x convention, byte-gating every candidate against the default
    engine (oracle-checked where affordable), and commits the winners to
    the persistent plan cache — after which ``run`` and ``serve`` on the
    same machine pick them up. A human-readable report goes to --report
    (or stderr). ``--compile-cache DIR`` is the kernels' build directory;
    ``--sparse-crossover`` measures the dense/sparse crossover of
    ``--engine auto`` and caches it."""
    _build.enable_compile_cache(args.compile_cache)

    from gol_tpu_torch.tune import measure, plans, select

    shapes = []
    for spec in args.shape or ["256x256"]:
        m = re.fullmatch(r"(\d+)x(\d+)", spec)
        if not m:
            raise ValueError(f"--shape must look like HxW, got {spec!r}")
        shapes.append((int(m.group(1)), int(m.group(2))))
    conventions = (
        ["c", "cuda"] if args.convention == "both" else [args.convention]
    )
    mesh = _parse_mesh_arg(args.mesh, bool(args.mesh))
    store = plans.PlanStore(args.plan_cache)
    results = []
    families = [False]
    if args.packed:
        # The packed-state lane (--packed-io runs) consults its own
        # family's fingerprints — tune it explicitly or it stays on the
        # built-in ladder.
        bad = [f"{h}x{w}" for h, w in shapes if w % 32 != 0]
        if bad:
            raise ValueError(
                f"--packed needs widths divisible by 32 (the packed word), "
                f"got {bad}"
            )
        families.append(True)
    for height, width in shapes:
        for convention in conventions:
            for packed_state in families:
                config = GameConfig(gen_limit=args.gen_limit,
                                    convention=convention)
                family = "packed" if packed_state else "byte"
                print(f"tune engine: {height}x{width}/{convention}/{family} "
                      f"(gen_limit={args.gen_limit}, iters={args.iters})",
                      file=sys.stderr)
                result = measure.run_engine_search(
                    height, width, config, mesh, packed_state=packed_state,
                    iters=args.iters, quick=args.quick,
                )
                results.append(result)
                store.put(
                    select.engine_fingerprint((height, width), config, mesh,
                                              packed_state=packed_state),
                    result.winner.to_dict(),
                    measured=result.to_dict() if args.provenance else {
                        "tuned_vs_default": round(result.speedup, 4),
                        "default": result.default_label,
                    },
                )
                print(f"  winner {result.winner.label()} at "
                      f"{result.speedup:.3f}x the default ladder",
                      file=sys.stderr)

    if args.serve_board:
        m = re.fullmatch(r"(\d+)x(\d+)", args.serve_board)
        if not m:
            raise ValueError(
                f"--serve-board must look like HxW, got {args.serve_board!r}"
            )
        height, width = int(m.group(1)), int(m.group(2))
        if mesh is not None and topology_for(mesh).distributed:
            raise ValueError("--serve-board tunes the single-device serving "
                             "lane; drop --mesh")
        print(f"tune serve: {height}x{width} boards", file=sys.stderr)
        result = measure.run_serve_search(
            height, width, conventions[0],
            gen_limit=min(args.gen_limit, 8), iters=args.iters,
        )
        results.append(result)
        plan_dict = result.winner.to_dict()
        plan_dict["warm"] = [
            {"height": height, "width": width, "convention": convention}
            for convention in conventions
        ]
        if result.marginal:
            # The winner's marginal kernel rate rides with the plan: the
            # serving dispatch-gap monitor reads it back as its roofline
            # (select.marginal_rates).
            plan_dict["marginal"] = result.marginal
        store.put(
            select.serve_fingerprint(), plan_dict,
            measured={"tuned_vs_default": round(result.speedup, 4)},
        )
        print(f"  winner {result.winner.label()} at "
              f"{result.speedup:.3f}x the default geometry", file=sys.stderr)

    if args.sparse_crossover:
        # The `--engine auto` dense/sparse threshold, measured on THIS
        # host instead of hard-coded: fit dense cost (linear in area)
        # against the sparse engine's flat cost and persist the solved
        # crossover (tune.select.sparse_auto_area consults it).
        print("tune sparse-crossover: dense-vs-sparse per-generation cost",
              file=sys.stderr)
        crossover = measure.run_sparse_crossover_search(
            iters=args.iters, quick=args.quick,
        )
        store.put(
            select.sparse_fingerprint(),
            {"auto_area": crossover.auto_area},
            measured=crossover.to_dict(),
        )
        print(f"  dense overtakes sparse at ~{crossover.auto_area} cells "
              f"(~{int(crossover.auto_area ** 0.5)}^2); persisted as the "
              "--engine auto threshold", file=sys.stderr)

    report = measure.render_report(results)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(report)
        print(f"report -> {args.report}", file=sys.stderr)
    else:
        print(report, file=sys.stderr)
    print(f"plans -> {store.path}", file=sys.stderr)
    # A same-process serve (tests, tune-then-serve scripts) must see the
    # fresh plans: drop the consult caches.
    select.reset()
    from gol_tpu_torch.serve import batcher

    batcher._reset_plan()
    return 0


def _top(args) -> int:
    """``top``: live terminal dashboard over /metrics + /slo.

    Polls the two JSON endpoints every --interval seconds and redraws one
    ANSI frame in place (``obs/top.py`` renders; this loop only owns HTTP
    and the terminal). --iterations N exits after N frames (0 = run until
    interrupted) — the scriptable/test lane."""
    from gol_tpu_torch.obs import top as obs_top

    ring = _ServerRing(getattr(args, "servers", None) or args.server)
    if args.interval <= 0:
        raise ValueError(f"--interval must be > 0, got {args.interval}")
    ansi = sys.stdout.isatty() and not args.no_ansi
    frames = 0
    try:
        while True:
            # --servers: probe the ring preferred-first; the dashboard
            # follows whichever replica answers (the title names it). One
            # base — the plain --server invocation — is pinned.
            metrics, answered = {}, None
            for cand in ring.rotation():
                metrics = _fetch_json(f"{cand}/metrics?format=json")
                if metrics:
                    answered = cand
                    ring.prefer(cand)
                    break
            base = answered or ring.current
            slo = _fetch_json(f"{base}/slo")
            title = f"gol top — {base}"
            if len(ring.bases) > 1:
                title += (f" [answered by {base}]" if answered
                          else f" [all {len(ring.bases)} routers "
                               "unreachable]")
            frame = obs_top.render_frame(
                metrics, slo or None, ansi=ansi,
                title=title,
            )
            if ansi:
                sys.stdout.write(obs_top.CLEAR)
            sys.stdout.write(frame)
            sys.stdout.flush()
            frames += 1
            if args.iterations and frames >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _fleet_trace(args) -> int:
    """``fleet-trace``: one stitched Perfetto timeline for the fleet.

    Collects ``GET /debug/trace`` from the server and every worker its
    ``GET /fleet`` lists (a single ``serve`` — no /fleet — is traced
    alone), normalizes each process's monotonic clock against its wall
    anchor, and writes ONE Chrome trace JSON: a pid lane per process,
    cross-process flow arrows per job. Unreachable workers are skipped
    with a note."""
    import urllib.error

    from gol_tpu_torch.obs import fleettrace

    ring = _ServerRing(getattr(args, "servers", None) or args.server)
    doc = None
    last_err = None
    for cand in ring.rotation():
        # --servers: the stitched export reads idempotent debug
        # endpoints, so trying the next replica router is always safe.
        try:
            doc = fleettrace.export(cand, args.output)
            if len(ring.bases) > 1:
                print(f"fleet-trace: exported via router {cand}",
                      file=sys.stderr)
            break
        except (urllib.error.URLError, ConnectionError, OSError) as err:
            last_err = err
            if len(ring.bases) > 1:
                print(f"fleet-trace: router {cand} unreachable "
                      f"({type(err).__name__}); trying the next replica",
                      file=sys.stderr)
    if doc is None:
        raise ValueError(
            f"no router in {', '.join(ring.bases)} answered: {last_err}")
    other = doc.get("otherData", {})
    processes = other.get("processes", {})
    events = doc.get("traceEvents", [])
    flows = sum(1 for e in events if e.get("ph") in ("s", "t", "f"))
    spans = sum(1 for e in events if e.get("ph") == "X")
    print(f"fleet-trace -> {args.output}: {len(processes)} process(es) "
          f"[{', '.join(sorted(processes))}], {spans} span(s), "
          f"{flows} flow point(s)", file=sys.stderr)
    for entry in other.get("skipped", []):
        print(f"  skipped {entry.get('name')}: {entry.get('reason')}",
              file=sys.stderr)
    if not processes:
        print("fleet-trace: no process had tracing enabled — start the "
              "fleet with --trace DIR", file=sys.stderr)
        return 1
    return 0


def _gc_cmd(args) -> int:
    """``gc``: CAS garbage collection — sweep orphans and evict
    least-recently-used entries to a byte budget. DRY-RUN by default
    (prints what would happen); --apply deletes. Eviction is always safe:
    the CAS is a cache, the journal stays the source of truth."""
    from gol_tpu_torch.cache import gc as cas_gc

    if not os.path.isdir(args.dir):
        raise ValueError(f"no such cache directory: {args.dir}")
    if args.budget is not None and args.budget < 0:
        raise ValueError(f"--budget must be >= 0, got {args.budget}")
    report = cas_gc.collect(args.dir, args.budget, apply=args.apply)
    verb = "removed" if args.apply else "would remove"
    print(f"{args.dir}: {report.entries} entr(ies), "
          f"{report.bytes_total} bytes"
          + (f" (budget {report.budget})" if report.budget is not None
             else ""))
    print(f"  {verb} {len(report.orphans)} orphan(s) "
          f"({report.orphan_bytes} bytes)")
    for path in report.orphans:
        print(f"    {path}")
    verb = "evicted" if args.apply else "would evict"
    print(f"  {verb} {len(report.evicted)} entr(ies) "
          f"({report.evicted_bytes} bytes, LRU first)")
    for fp in report.evicted:
        print(f"    {fp}")
    print(f"  after: {report.bytes_after} bytes"
          + ("" if args.apply else " (dry run; pass --apply to delete)"))
    return 0


def _http_json(method: str, url: str, body: dict | None = None, timeout=30,
               raw: bytes | None = None, content_type: str | None = None,
               headers: dict | None = None):
    """The ONE stdlib JSON client (``fleet/client.py``): HTTP errors come
    back as (status, payload), connection trouble raises for the callers'
    retry/timeout logic. ``raw``/``content_type`` send a pre-encoded
    body (the packed wire submit); ``headers`` adds request headers (the
    submit deadline stamp, obs/propagate.py)."""
    from gol_tpu_torch.fleet import client as fleet_client

    return fleet_client.http_json(method, url, body, timeout=timeout,
                                  raw=raw, content_type=content_type,
                                  headers=headers)


def _http_exchange(method: str, url: str, timeout=30, accept=None):
    """Byte-level GET for the packed result fetch: (status, content type,
    body bytes) — the caller parses by the RESPONSE type, so an old
    server answering JSON degrades transparently."""
    from gol_tpu_torch.fleet import client as fleet_client

    headers = {"Accept": accept} if accept else None
    return fleet_client.http_exchange(method, url, timeout=timeout,
                                      headers=headers)


class _WireDowngrade(Exception):
    """A packed submit answered 400/415: resend as text (retryable)."""


class _WireCRCResend(Exception):
    """A packed submit answered a CRC-mismatch 400: the frame was
    corrupted in transit, not rejected — resend PACKED (bounded)."""


def _connection_trouble(err: BaseException) -> bool:
    """Connection-level trouble worth an in-call retry: refused, reset,
    timed out, torn HTTP — anything the transport raised. HTTP statuses
    never reach here (they return as values), so semantics stay with the
    call sites."""
    import urllib.error

    return isinstance(err, (urllib.error.URLError, ConnectionError, OSError))


def _submit_retry():
    """The ONE retry stance for ``gol submit`` — a jittered exponential
    policy over a shared token-bucket budget, replacing the three ad-hoc
    loops that had grown here (the status poll, the result collect, and
    the packed->text wire downgrade). The shared budget bounds the
    client's total retry amplification: against a browned-out fleet the
    bucket drains and every site degrades to one attempt per sweep,
    surfacing the original errors instead of piling on. The per-target
    no-contact cutoff in ``_collect_results`` is UNCHANGED — the policy
    retries inside a sweep; the cutoff still decides when a target is
    dead."""
    from gol_tpu_torch.resilience.retry import RetryBudget, RetryPolicy

    policy = RetryPolicy(attempts=3, base_delay=0.1, multiplier=2.0,
                         max_delay=1.0, jitter=0.25)
    budget = RetryBudget(capacity=16.0, refill_per_s=1.0)
    return policy, budget


class _ServerRing:
    """The ``--servers A,B,C`` failover ring: every base is a router
    REPLICA over one fleet (shared manifest — any replica can place,
    forward, or look up any job), so idempotent GETs rotate freely on
    connection trouble, while the job-creating POST rotates ONLY on
    delivery-impossible failures (refused/DNS/unreachable: no byte
    reached any queue). An ambiguous failure — reset or timeout AFTER
    the bytes went out — never rotates: the first router may have
    accepted and journaled the job, and a blind resubmit to a sibling
    double-runs the board under two ids (the ambiguous-504 contract,
    now applied across replicas). A plain ``--server`` invocation gets a
    one-element ring, so every single-server path is pinned unchanged."""

    def __init__(self, spec):
        if isinstance(spec, str):
            bases = [s.strip().rstrip("/") for s in spec.split(",")]
        else:
            bases = [s.rstrip("/") for s in spec]
        self.bases = [b for b in bases if b]
        if not self.bases:
            raise ValueError("--servers needs at least one URL")
        self._i = 0  # the preferred base: last one that answered

    @property
    def current(self) -> str:
        return self.bases[self._i]

    def prefer(self, base: str) -> None:
        if base in self.bases:
            self._i = self.bases.index(base)

    def rotation(self) -> list:
        """Every base, preferred first — the probe order for idempotent
        reads."""
        return self.bases[self._i:] + self.bases[:self._i]

    def others(self, base: str) -> list:
        """Failover candidates for a dead ``base``, in ring order after
        it (empty for a one-element ring)."""
        if len(self.bases) < 2:
            return []
        try:
            i = self.bases.index(base)
        except ValueError:
            return list(self.bases)
        return self.bases[i + 1:] + self.bases[:i]


def _submit(args) -> int:
    """``submit``: client for a running server (of either package).

    Submits each input file as one job, then (by default) polls until every
    job is terminal and writes each result next to its input
    (``<input>.out`` or into --output-dir), printing the per-board
    ``Generations:`` accounting the solo CLI prints. A pure HTTP client: it
    needs no device."""
    variant = get_variant(args.variant)
    width, height = atoi(args.width), atoi(args.height)
    if width <= 0:
        width = DEFAULT_WIDTH
    if height <= 0:
        height = DEFAULT_HEIGHT
    ring = _ServerRing(getattr(args, "servers", None) or args.server)
    base = ring.current
    # --shard-across: against a fleet router, fan the multi-board submit
    # round-robin over the fleet's workers directly (GET /fleet lists
    # them); against a single `gol serve` — no /fleet endpoint — the flag
    # is a no-op and every job goes to --server as always. Membership is
    # re-fetched on an interval (and on a 429) rather than snapshotted
    # once: against an autoscaled fleet, workers appear mid-submission —
    # exactly because of the load this loop is applying — and a one-shot
    # snapshot would never send them a job.
    targets = _ShardTargets(
        base, args.shard_across,
        refresh_s=getattr(args, "shard_refresh", 5.0),
        fetch=_fetch_json,
    )
    targets.refresh(force=True)
    if args.shard_across and len(targets.targets) > 1:
        print(f"gol submit: sharding {len(args.input_files)} board(s) "
              f"across {len(targets.targets)} fleet worker(s)",
              file=sys.stderr)
    # --wire packed: boards travel as binary wire frames (io/wire.py, ~8x
    # fewer bytes). Degradation is PER TARGET: a server that answers 415
    # (or 400 — an old server's JSON parser rejecting the frame) gets ONE
    # logged resend as text and every later submit to it goes text too —
    # bounded per target by construction, so it bypasses the retry budget
    # (format negotiation is free; brownout amplification is what the
    # budget caps).
    wire_default = getattr(args, "wire", "text")
    wire_mode = {}  # per target; new targets default to the flag's mode
    from gol_tpu_torch.obs import propagate as obs_propagate

    policy, budget = _submit_retry()
    ids = {}  # job id -> (input path, server base the job lives on)
    for path in args.input_files:
        target = targets.next()
        wire_mode.setdefault(target, wire_default)
        grid = text_grid.read_grid(path, width, height)
        meta = {
            "convention": variant.convention,
            "gen_limit": args.gen_limit,
            "priority": args.priority,
        }
        if args.deadline is not None:
            meta["deadline_s"] = args.deadline
        if args.no_cache:
            # Per-job result-cache opt-out (Job.no_cache); servers without
            # a cache ignore the field after type validation.
            meta["no_cache"] = True
        job_t0 = time.perf_counter()

        def deadline_headers():
            # --timeout: stamp the REMAINING X-Gol-Deadline budget at send
            # time — a resend after backoff carries less than the first
            # attempt did, exactly like a router hop. Old servers ignore
            # the header; no --timeout sends no header (pinned).
            if args.timeout is None:
                return None
            remaining = args.timeout - (time.perf_counter() - job_t0)
            return {obs_propagate.DEADLINE_HEADER:
                    obs_propagate.encode_deadline(remaining)}

        crc_resends = {"n": 0}  # per board: transit-corrupted frames

        def post_once(target):
            if wire_mode[target] == "packed":
                from gol_tpu_torch.io import wire

                status, payload = _http_json(
                    "POST", f"{target}/jobs",
                    raw=wire.encode_frame(meta, grid=grid),
                    content_type=wire.CONTENT_TYPE,
                    headers=deadline_headers(),
                )
                if status not in (400, 415):
                    return status, payload
                if status == 400 and wire.is_crc_error(payload):
                    # The server's CRC gate caught a frame corrupted in
                    # transit (a 400 created no job: resending is
                    # unconditionally safe) — that is the wire format
                    # WORKING, not the server rejecting it. Downgrading
                    # here would swap detected corruption for the text
                    # lane's undetectable kind, on exactly the link that
                    # corrupts. Resend packed, twice at most; a hop
                    # corrupting every frame surfaces the 400 loudly.
                    if crc_resends["n"] < 2:
                        crc_resends["n"] += 1
                        print(
                            f"gol submit: {target} reports a frame CRC "
                            "mismatch (corrupted in transit); resending "
                            f"packed ({crc_resends['n']}/2)",
                            file=sys.stderr,
                        )
                        raise _WireCRCResend(status)
                    return status, payload
                print(
                    f"gol submit: {target} does not accept the packed "
                    f"wire format (HTTP {status}); retrying as text",
                    file=sys.stderr,
                )
                wire_mode[target] = "text"
                raise _WireDowngrade(status)
            body = {"width": width, "height": height,
                    "cells": text_grid.encode(grid).decode("ascii"),
                    **meta}
            return _http_json("POST", f"{target}/jobs", body,
                              headers=deadline_headers())

        def submit_to(target):
            # The job-creating POST is NOT idempotent: only failures that
            # guarantee nothing reached the server (refused, DNS,
            # unreachable — the router's spill-safety classification) are
            # auto-retried. Anything ambiguous — a reset or timeout after
            # the bytes went out — surfaces instead of re-POSTing, because
            # the server may have accepted and journaled the job and a
            # blind resend would run the board twice under two ids.
            from gol_tpu_torch.resilience.retry import delivery_impossible

            while True:
                try:
                    return policy.call(
                        lambda: post_once(target),
                        retryable=delivery_impossible,
                        budget=budget,
                    )
                except _WireDowngrade:
                    # Format negotiation, not a transient: post_once
                    # already flipped this target to text, so the resend
                    # is deterministic and happens AT MOST ONCE per
                    # target — it spends no retry-budget tokens (a fleet
                    # of old servers must not eat the brownout budget,
                    # and an empty bucket must not strand the downgrade).
                    continue
                except _WireCRCResend:
                    # A transit-corrupted frame, bounded at 2 per board
                    # inside post_once; same budget exemption (nothing
                    # reached the queue — a 400 created no job).
                    continue

        def submit_failover(target):
            # --servers: a dead ROUTER rotates the POST to the next
            # replica — but only on delivery-impossible failures, where
            # no byte reached any queue (see _ServerRing). The rotation
            # applies to ring bases only: a --shard-across WORKER target
            # failing surfaces as before (the job's placement is the
            # router's business, not a reason to re-pick routers).
            from gol_tpu_torch.resilience.retry import delivery_impossible

            tried = {target}
            while True:
                try:
                    return target, submit_to(target)
                except OSError as err:
                    if target not in ring.bases \
                            or not delivery_impossible(err):
                        raise
                    nxt = next((b for b in ring.others(target)
                                if b not in tried), None)
                    if nxt is None:
                        raise
                    print(f"gol submit: router {target} unreachable "
                          f"({type(err).__name__}); failing over to {nxt}",
                          file=sys.stderr)
                    tried.add(nxt)
                    wire_mode.setdefault(nxt, wire_default)
                    target = nxt
                    ring.prefer(nxt)

        try:
            target, (status, payload) = submit_failover(target)
            if status == 429:
                # A shed burst: the membership that 429'd may already be
                # stale — an autoscaled fleet is likely scaling up RIGHT
                # NOW because of this very load. Re-fetch and retry ONCE
                # against the next (possibly brand-new) target before
                # giving up.
                targets.on_429()
                retry = targets.next()
                wire_mode.setdefault(retry, wire_default)
                print(f"gol submit: {target} shed the job (HTTP 429); "
                      f"refreshed membership, retrying on {retry}",
                      file=sys.stderr)
                target = retry
                target, (status, payload) = submit_failover(target)
        except OSError as err:
            # Exchange trouble the policy refused to retry: either
            # no-contact retries ran out, or — the case that matters —
            # the failure was ambiguous and a resend could double-run
            # the board. Name which, so the operator knows whether a
            # resubmit is safe.
            from gol_tpu_torch.resilience.retry import delivery_impossible

            fate = ("never delivered — safe to resubmit"
                    if delivery_impossible(err)
                    else "outcome unknown — the job may have been "
                         "accepted there; audit before resubmitting")
            print(f"gol submit: {path}: {target} exchange failed "
                  f"({type(err).__name__}: {err}); {fate}",
                  file=sys.stderr)
            return 1
        if status != 202:
            # A router's ambiguous 504 names the worker whose outcome is
            # unknown (and its breaker state): surface both, so the
            # operator knows WHICH partition to audit before resubmitting.
            note = ""
            if isinstance(payload, dict) and payload.get("worker"):
                breaker = payload.get("breaker")
                note = (f" [outcome unknown at worker {payload['worker']}"
                        + (f", breaker {breaker}" if breaker else "") + "]")
            detail = (payload.get("error", payload)
                      if isinstance(payload, dict) else payload)
            print(f"gol submit: {path}: HTTP {status}: {detail}{note}",
                  file=sys.stderr)
            return 1
        if not isinstance(payload, dict) or "id" not in payload:
            # A 202 whose ack BODY was corrupted in transit (bit-flipped
            # hop garbling the JSON): the job WAS accepted — the status
            # line survived — but there is no id to poll, and a resend
            # would run the board twice. Same loud-abandon contract as
            # the ambiguous 504.
            print(
                f"gol submit: {path}: {target} accepted the job but the "
                "ack body arrived corrupted; cannot track it — audit the "
                "server's journal before resubmitting",
                file=sys.stderr,
            )
            return 1
        ids[payload["id"]] = (path, target)
        print(f"{path}\t{payload['id']}")
    if not args.wait:
        return 0

    outdir = args.output_dir
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    return _collect_results(dict(ids), args, outdir,
                            retry=(policy, budget), ring=ring)


class _ShardTargets:
    """The --shard-across target set, kept fresh through the submission.

    ``gol submit`` used to snapshot GET /fleet once at startup, so a long
    submission never saw workers an autoscaler added mid-run — the fleet
    would scale up under the load and the client would keep hammering the
    original N workers. This object re-fetches membership every
    ``refresh_s`` seconds of submission (and immediately on a 429 burst,
    via ``on_429``) and rotates round-robin over the CURRENT healthy
    non-big workers. Disabled (``--shard-across`` absent) or against a
    single ``gol serve`` (no /fleet endpoint, fetch returns {}), the
    target list stays ``[base]`` — the pinned no-op behavior.

    Clock: ``time.perf_counter`` (interval arithmetic only)."""

    def __init__(self, base: str, enabled: bool, refresh_s: float = 5.0,
                 fetch=None, clock=time.perf_counter):
        self.base = base
        self.enabled = enabled
        self.refresh_s = refresh_s
        self._fetch = fetch if fetch is not None else _fetch_json
        self._clock = clock
        self.targets = [base]
        self._i = 0
        self._fetched_at: float | None = None

    def refresh(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = self._clock()
        if (not force and self._fetched_at is not None
                and now - self._fetched_at < self.refresh_s):
            return
        self._fetched_at = now
        membership = self._fetch(f"{self.base}/fleet")
        urls = [
            str(w["url"]).rstrip("/")
            for w in (membership.get("workers") or [])
            if w.get("url") and w.get("healthy", True) and not w.get("big")
            and not w.get("retiring")
        ]
        if not urls:
            return  # single server / unreachable: keep what we have
        if urls != self.targets:
            print(f"gol submit: fleet membership now {len(urls)} "
                  f"worker(s)", file=sys.stderr)
        self.targets = urls

    def next(self) -> str:
        """The next round-robin target, after an interval-gated refresh."""
        self.refresh()
        target = self.targets[self._i % len(self.targets)]
        self._i += 1
        return target

    def on_429(self) -> None:
        """A shed answer: whatever membership produced it is suspect —
        re-fetch NOW regardless of the interval."""
        self.refresh(force=True)


def _collect_results(pending: dict, args, outdir, retry=None,
                     ring=None) -> int:
    """Poll every submitted job to a terminal state and write its result.

    ``pending`` maps job id -> (input path, server base URL) — with
    ``--servers`` the bases differ per job, so contact tracking is PER
    TARGET: one dead server abandons only ITS jobs after
    ``--server-timeout`` of no contact; jobs on healthy targets keep
    completing. Connection errors and 5xx answers are both
    transient-with-timeout — the server-restart/worker-respawn windows
    the journal-replay story is built for.

    ``retry`` is the submit loop's shared (RetryPolicy, RetryBudget) pair
    (``_submit_retry``): transient connection trouble retries INSIDE a
    sweep under the budget before it counts against the per-target
    no-contact cutoff — whose semantics are deliberately unchanged."""
    import time as _time
    import urllib.error

    policy, budget = retry if retry is not None else _submit_retry()
    rc = 0
    now = time.perf_counter()
    last_contact = {base: now for _, base in pending.values()}
    bad_body: dict = {}  # job_id -> sweeps whose 200 body was unusable
    while pending:
        _time.sleep(args.poll_interval)
        stale_this_sweep = set()  # targets already found down this sweep
        for job_id in list(pending):
            entry = pending.get(job_id)
            if entry is None:
                continue  # removed mid-sweep by target_down on its base
            path, job_base = entry
            if job_base in stale_this_sweep:
                continue

            def target_down(detail):
                stale_this_sweep.add(job_base)
                if (time.perf_counter() - last_contact[job_base]
                        <= args.server_timeout):
                    return False  # transient so far; retry next sweep
                victims = [j for j, (_, b) in pending.items()
                           if b == job_base]
                print(
                    f"gol submit: no contact with {job_base} for "
                    f"{args.server_timeout:.0f}s ({detail}); giving up on "
                    f"{len(victims)} job(s) there",
                    file=sys.stderr,
                )
                for j in victims:
                    del pending[j]
                return True

            def bad_body_strike(detail):
                """Bounded tolerance for answers whose BODY is unusable —
                a bit-flipped hop garbling status JSON, a result grid, or
                a packed frame's CRC. Transit corruption heals on the next
                sweep's refetch; a hop corrupting EVERY exchange must not
                poll forever (the answers keep coming, so the no-contact
                cutoff above never fires for this job). True once the
                3-strike bound is hit: the job is abandoned loudly."""
                bad_body[job_id] = bad_body.get(job_id, 0) + 1
                if bad_body[job_id] < 3:
                    return False
                print(
                    f"gol submit: {path}: unusable response body across "
                    f"{bad_body[job_id]} sweeps ({detail}); giving up on "
                    f"job {job_id}", file=sys.stderr,
                )
                pending.pop(job_id, None)
                return True

            try:
                status, payload = policy.call(
                    lambda: _http_json("GET", f"{job_base}/jobs/{job_id}"),
                    retryable=_connection_trouble, budget=budget,
                )
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # --servers: a status GET is idempotent, and any replica
                # router can look up any job — re-home this job to the
                # next ring base that is not itself past the no-contact
                # cutoff. Only ring bases re-home; with every router
                # dead, each base ages past the cutoff and
                # the per-target give-up below fires exactly as before.
                moved = None
                if ring is not None and job_base in ring.bases:
                    now2 = time.perf_counter()
                    for cand in ring.others(job_base):
                        last_contact.setdefault(cand, now2)
                        if now2 - last_contact[cand] <= args.server_timeout:
                            moved = cand
                            break
                if moved is not None:
                    print(f"gol submit: router {job_base} unreachable "
                          f"({type(e).__name__}); polling job {job_id} "
                          f"via {moved}", file=sys.stderr)
                    pending[job_id] = (path, moved)
                    continue
                if target_down(e):
                    rc = 1
                continue
            if status >= 500:
                # A fleet router whose worker is mid-respawn answers 503
                # while the partition replays; same treatment as a
                # connection error. (Contact is only refreshed by real
                # answers, so a permanently-5xxing target times out.)
                if target_down(f"HTTP {status}"):
                    rc = 1
                continue
            last_contact[job_base] = time.perf_counter()
            if status != 200:
                print(f"gol submit: lost job {job_id}: HTTP {status}",
                      file=sys.stderr)
                del pending[job_id]
                rc = 1
                continue
            state = (payload.get("state")
                     if isinstance(payload, dict) else None)
            if state is None:
                # Parsed, but not as a job answer (a flip that left valid
                # JSON): same bounded-refetch treatment as a parse error.
                if bad_body_strike("no job state in the answer"):
                    rc = 1
                continue
            if state in ("queued", "scheduled", "running"):
                # A usable answer clears the strikes: the bound is on
                # CONSECUTIVE corrupt sweeps, not lifetime total — a long
                # job under intermittent, self-healing transit flips must
                # never strike out. (A done job's result-fetch strikes
                # stay consecutive by construction: any good fetch
                # completes the job.)
                bad_body.pop(job_id, None)
                continue
            del pending[job_id]
            if state != "done":
                print(f"gol submit: {path}: job {state}: "
                      f"{payload.get('error', '')}", file=sys.stderr)
                rc = 1
                continue
            try:
                # Body corruption (ValueError: a packed frame's CRC gate
                # — WireError subclasses it — or garbled JSON/grid text)
                # is retryable HERE and nowhere else: the result on the
                # worker is intact, so a refetch is the fix (the gate
                # turning a flipped bit into a retry instead of a wrong
                # board).
                status, result, grid = policy.call(
                    lambda: _fetch_result(
                        job_base, job_id, getattr(args, "wire", "text")
                    ),
                    retryable=lambda e: (_connection_trouble(e)
                                         or isinstance(e, ValueError)),
                    budget=budget,
                )
            except (urllib.error.URLError, ConnectionError, OSError,
                    ValueError, KeyError) as e:
                if isinstance(e, (ValueError, KeyError)):
                    if bad_body_strike(repr(e)):
                        rc = 1
                        continue
                pending[job_id] = (path, job_base)  # refetch next sweep
                continue
            if status >= 500:
                pending[job_id] = (path, job_base)  # refetch next sweep
                continue
            if status != 200:
                print(f"gol submit: {path}: result fetch HTTP {status}",
                      file=sys.stderr)
                rc = 1
                continue
            if (not isinstance(result, dict) or "generations" not in result
                    or "exit_reason" not in result):
                # Valid JSON and a decodable grid, but a flip ate a meta
                # key: don't trust the body enough to write it out — the
                # same bounded refetch as any other unusable answer
                # (previously an uncaught KeyError at the print below
                # abandoned every pending job).
                if bad_body_strike("result meta incomplete"):
                    rc = 1
                    continue
                pending[job_id] = (path, job_base)
                continue
            out_path = (
                os.path.join(outdir, os.path.basename(path) + ".out")
                if outdir
                else path + ".out"
            )
            text_grid.write_grid(out_path, grid)
            # The cache marker: present only when the server answered from
            # its result cache (or coalesced the run) — old servers' result
            # payloads lack the key and the line degrades to nothing,
            # exactly like the timeline columns after it.
            cached = result.get("cached")
            marker = f"\tcached:{cached}" if cached else ""
            print(f"{path}\tGenerations:\t{result['generations']}\t"
                  f"{result['exit_reason']}\t-> {out_path}{marker}"
                  f"{_submit_latency_note(job_base, job_id)}")
    return rc


def _fetch_result(base: str, job_id: str, wire_pref: str):
    """GET /result/<id> -> (status, result meta dict, grid or None).

    With ``wire_pref == "packed"`` the fetch sends ``Accept:
    application/x-gol-packed`` and parses by the RESPONSE content type —
    a new server answers a binary frame (~8x fewer bytes on the wire), an
    old server ignores the header and answers JSON, byte-identical
    either way (the decoded grid is the same board; test-pinned)."""
    if wire_pref == "packed":
        from gol_tpu_torch.io import wire

        status, ctype, body = _http_exchange(
            "GET", f"{base}/result/{job_id}", accept=wire.CONTENT_TYPE
        )
        if status == 200 and wire.is_packed(ctype):
            frame = wire.decode_frame(body)
            return status, dict(frame.meta), frame.grid()
        try:
            result = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            result = {"error": body[:200].decode("utf-8", "replace")}
    else:
        status, result = _http_json("GET", f"{base}/result/{job_id}")
    grid = None
    if status == 200:
        grid = text_grid.decode(
            result["grid"].encode("ascii"), result["width"], result["height"]
        )
    return status, result, grid


def _submit_latency_note(base: str, job_id: str) -> str:
    """Where the client's time went, from the job's timeline (the server's
    per-job milestone decomposition) — appended to the per-board result
    line so the answer arrives without anyone curling a debug endpoint.
    Empty when the server predates timelines or the fetch fails: the
    result line must never fail because the ops surface did."""
    import urllib.error

    try:
        status, tl = _http_json("GET", f"{base}/jobs/{job_id}/timeline",
                                timeout=5)
    except (urllib.error.URLError, ConnectionError, OSError):
        return ""
    if status != 200 or tl.get("total_seconds") is None:
        return ""
    queue_ms = (tl.get("segments") or {}).get("queue_wait", 0.0) * 1e3
    return (f"\tqueue {queue_ms:.1f} ms"
            f"\ttotal {tl['total_seconds'] * 1e3:.1f} ms")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gol",
        description="Game of Life on CUDA cards (PyTorch port of gol_tpu)",
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="run a simulation (also the default command)")
    run.add_argument("width", nargs="?", default=None)
    run.add_argument("height", nargs="?", default=None)
    run.add_argument("input_file", nargs="?", default=None)
    run.add_argument(
        "--variant", default="tpu", choices=sorted(VARIANTS),
        help="which reference program to reproduce (default: tpu; the "
        "distributed variants run over a mesh)",
    )
    run.add_argument(
        "--mesh", default=None,
        help="mesh RxC of shards for a distributed variant (default: the "
        "row-heaviest factorization of the mesh devices that divides the "
        "grid; GOL_TORCH_MESH_DEVICES=N lays N shards over the cards)",
    )
    run.add_argument(
        "--kernel", default="auto",
        help="stencil kernel: packed (32 cells per word, CUDA kernels), "
        "pallas (byte cells, one CUDA kernel per generation), lax (byte "
        "cells, plain torch), or auto (packed where the width divides by "
        "32, else lax)",
    )
    run.add_argument("--gen-limit", type=int, default=GameConfig().gen_limit)
    run.add_argument(
        "--gens", type=int, default=None, metavar="N",
        help="alias for --gen-limit (the deep-time spelling: the macro "
        "engine reaches e.g. --gens 1000000000 in O(log N) jumps)",
    )
    run.add_argument(
        "--similarity-frequency", type=int, default=GameConfig().similarity_frequency
    )
    run.add_argument(
        "--pattern", default=None, metavar="FILE",
        help="run an RLE pattern file (Gosper gun, r-pentomino, ...) placed "
        "into an otherwise-empty --universe instead of reading a dense "
        "input file — the giant-universe input path: the byte canvas is "
        "never materialized on the sparse lane",
    )
    run.add_argument(
        "--place", default="0,0", metavar="X,Y",
        help="top-left cell of the --pattern placement (column X, row Y; "
        "default 0,0)",
    )
    run.add_argument(
        "--universe", default=None, metavar="WxH",
        help="universe extents for --pattern (e.g. 65536x65536); defaults "
        "to the pattern's own RLE extents",
    )
    run.add_argument(
        "--engine", default="auto", choices=("auto", "dense", "sparse",
                                             "macro", "shard"),
        help="engine family: dense (the classic O(area) lanes), sparse "
        "(tiled O(live-area) — sparse/, tile steps on T1), macro "
        "(hash-consed macrocell, O(log gens) deep time — macro/), shard "
        "(one giant universe spanning a fleet's workers with per-super-step "
        "halo exchange — shard/; needs --shard-across), or auto (sparse "
        "above the area threshold when the extents tile evenly, upgraded "
        "to macro above the generation threshold when the placement keeps "
        "the run off the torus seam)",
    )
    run.add_argument(
        "--shard-across", default=None, metavar="URL",
        help="fleet router URL for --engine shard: the universe is "
        "partitioned across the router's workers by rendezvous hashing "
        "over tile coordinates and run as coordinated super-steps; the "
        "result is byte-identical to the sparse engine's",
    )
    run.add_argument(
        "--tile", type=int, default=0, metavar="N",
        help="sparse/macro engine tile edge (default 256); universe "
        "extents must be multiples of it (and it must be even for macro "
        "— the macrocell leaf splits in half)",
    )
    run.add_argument(
        "--macro-cas", default=None, metavar="DIR",
        help="mount a disk CAS tier under the macro engine's advance memo "
        "(cache/): memoized superstep results persist across runs and "
        "restarts (a directory either package wrote), and `gc` budgets "
        "the directory",
    )
    run.add_argument("--no-check-similarity", action="store_true")
    run.add_argument("--output", default=None, help="override the output file path")
    run.add_argument("--host", action="store_true", help="run the NumPy oracle on CPU")
    run.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR/trace.json "
        "(start/stop guarded: a run with nothing to capture proceeds "
        "unprofiled, a crashed run never leaves a torn trace directory)",
    )
    run.add_argument(
        "--trace", default=None, metavar="DIR",
        help="span tracing + flight recorder (gol_tpu_torch/obs): phase/engine "
        "spans export to DIR as Chrome trace JSON when the run ends; a "
        "crash additionally dumps the last spans as flight-*.jsonl at the "
        "moment of death; SIGUSR1 dumps live. Summarize either file with "
        "`gol trace-report`",
    )
    run.add_argument(
        "--snapshot-every", type=int, default=None, metavar="N",
        help="write a resumable grid snapshot every N generations "
        "(exec time then includes snapshot writes)",
    )
    run.add_argument(
        "--snapshot-dir", default=None, help="snapshot directory (default ./snapshots)"
    )
    run.add_argument(
        "--snapshot-format", choices=("text", "zarr"), default="text",
        help="snapshot encoding: 'text' writes gen_NNNNNN.out files (valid "
        "input files); 'zarr' is refused (the port has no TensorStore)",
    )
    run.add_argument(
        "--resume-gen", type=int, default=0, metavar="N",
        help="treat the input file as the state after N generations (a "
        "gen_NNNNNN.out snapshot of a run that had not early-exited) and "
        "continue to --gen-limit with the similarity phase realigned",
    )
    run.add_argument(
        "--warmup", action="store_true",
        help="run once, untimed, before the measured run",
    )
    run.add_argument(
        "--packed-io", action="store_true",
        help="read and write the file straight to and from bitpacked device "
        "state through the native codec (width must divide by 32)",
    )
    run.add_argument(
        "--checkpoint-every",
        type=int,
        default=None,
        metavar="N",
        help="write a crash-consistent checkpoint (fresh payload + atomically "
        "committed manifest) every N generations; a crash at any point "
        "leaves the newest prior checkpoint readable",
    )
    run.add_argument(
        "--checkpoint-dir",
        default=None,
        metavar="D",
        help="checkpoint directory (default ./checkpoints)",
    )
    run.add_argument(
        "--checkpoint-keep",
        type=int,
        default=2,
        metavar="K",
        help="retain the K newest checkpoints (default 2; >= 1)",
    )
    run.add_argument(
        "--auto-resume",
        action="store_true",
        help="restart from the newest valid checkpoint manifest in "
        "--checkpoint-dir — no --resume-gen arithmetic; resumed runs are "
        "bit-exact with uninterrupted ones",
    )
    run.add_argument(
        "--disk-reserve",
        type=int,
        default=0,
        metavar="N",
        help="disk-pressure watchdog on the checkpoint directory "
        "(resilience/diskguard.py): below 2N free bytes checkpoint saves "
        "shed loudly (the run continues; auto-resume falls back to the "
        "previous committed checkpoint) and recover automatically. "
        "0 (default) disables the guard",
    )
    run.add_argument(
        "--sync-checkpoints",
        action="store_true",
        help="write checkpoints synchronously (device idle during payload "
        "write + fsync). Default is the async writer (gol_tpu_torch/pipeline): "
        "a boundary costs only a device->host snapshot, the payload writes on "
        "a background thread under the next segment's compute, and the "
        "manifest commits at the next boundary — bit-identical outputs and "
        "payloads either way; this flag is the A/B lever",
    )
    run.add_argument(
        "--fault-plan",
        default=None,
        metavar="SPEC",
        help="fault injection for the crash-recovery harness, k=v comma "
        "list (see gol_tpu_torch/resilience/faults.py; also honored from the "
        "GOL_FAULTS env var). Testing only.",
    )
    run.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="build the CUDA kernels and the codec into DIR and reuse them "
        "from there: re-running with the same DIR skips the builds",
    )
    run.set_defaults(func=_run)

    shw = sub.add_parser("show", help="render a grid in the terminal (VT100, src/game.c:42-58)")
    shw.add_argument("width")
    shw.add_argument("height")
    shw.add_argument("input_file")
    shw.add_argument("--animate", type=int, default=0, metavar="N", help="evolve N generations live")
    shw.add_argument("--fps", type=float, default=10.0)
    shw.set_defaults(func=_show)

    gen = sub.add_parser("generate", help="emit a random grid (replaces generate.sh)")
    gen.add_argument("width", type=int)
    gen.add_argument("height", type=int)
    gen.add_argument("-o", "--output", default=None)
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("--density", type=float, default=0.5)
    gen.set_defaults(func=_generate)

    hrp = sub.add_parser(
        "history-report",
        help="render a durable metrics-history ring (--metrics-history) as "
        "rate/value/percentile timelines with respawn boundaries marked",
    )
    hrp.add_argument("history_dir", help="a history directory "
                     "(e.g. <journal>/history or <fleet>/router-history)")
    hrp.set_defaults(func=_history_report)

    rpt = sub.add_parser(
        "trace-report",
        help="summarize a trace file (Chrome trace JSON from --trace, or a "
        "flight-recorder JSONL dump): per-phase p50/p95, span tree, gap "
        "analysis",
    )
    rpt.add_argument("trace_file", help="trace-*.json or flight-*.jsonl")
    rpt.set_defaults(func=_trace_report)

    slr = sub.add_parser(
        "slo-report",
        help="summarize SLO state from a running server's /slo endpoint or "
        "from a flight-recorder dump's slo state record",
    )
    slr.add_argument(
        "target",
        help="server URL (http://...) or a flight-*.jsonl dump path",
    )
    slr.set_defaults(func=_slo_report)

    cpt = sub.add_parser(
        "compact",
        help="offline journal compaction: fold sealed segments into the "
        "CRC-stamped snapshot and retire them (a journal dir, or a fleet "
        "dir whose partitions compact independently)",
    )
    cpt.add_argument("dir", help="journal directory or fleet directory")
    cpt.add_argument(
        "--retain", type=int, default=None, metavar="N",
        help="keep only the newest N terminal records in the snapshot "
        "(the result-retention window; default: all)",
    )
    cpt.set_defaults(func=_compact_cmd)

    bat = sub.add_parser(
        "batch",
        help="offline batched lane: run N input files through the padding-"
        "bucket batcher in one process",
    )
    bat.add_argument("width")
    bat.add_argument("height")
    bat.add_argument("input_files", nargs="+")
    bat.add_argument(
        "--variant", default="tpu", choices=sorted(VARIANTS),
        help="reference program whose loop accounting the jobs use",
    )
    bat.add_argument("--gen-limit", type=int, default=GameConfig().gen_limit)
    bat.add_argument("--max-batch", type=int, default=64)
    bat.add_argument("--output-dir", default=None,
                     help="write results here (default: next to each input)")
    bat.set_defaults(func=_batch)

    srv = sub.add_parser(
        "serve",
        help="run the batched multi-tenant simulation service (HTTP JSON API)",
    )
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000,
                     help="listen port (0 = pick a free one; printed on boot)")
    srv.add_argument(
        "--journal-dir", default=None, metavar="D",
        help="crash-safe job journal directory; a restarted server replays "
        "unfinished jobs from it and keeps serving finished results "
        "(default: no journal — jobs do not survive restarts)",
    )
    srv.add_argument("--max-queue-depth", type=int, default=1024,
                     help="admission cap: past this, POST /jobs returns 429")
    srv.add_argument("--max-batch", type=int, default=64,
                     help="boards per dispatched batch (<= 64)")
    srv.add_argument(
        "--flush-age", type=float, default=0.05, metavar="S",
        help="dispatch a partial bucket once its oldest job has waited S "
        "seconds (the latency/occupancy trade)",
    )
    srv.add_argument("--max-inflight", type=int, default=1,
                     help="concurrently running batches (worker threads)")
    srv.add_argument(
        "--pipeline-depth", type=int, default=1,
        help="pipelined dispatch window: at N >= 2 the single synchronous "
        "worker becomes a dispatcher/completer pair with N batches in "
        "flight — the device computes batch k while the host stages k+1 "
        "and journals k-1 (try 2). Default 1 keeps the classic worker; "
        "exactly-once journal semantics, admission, drain, and retry are "
        "identical at every depth",
    )
    srv.add_argument(
        "--resident-ring", type=int, default=0, metavar="R",
        help="device-resident mega-batch lanes: each padding bucket gets a "
        "ring of R slots bound to ONE compiled drain program — the "
        "dispatcher refills slots (async device_put) while a drain "
        "computes, up to R batches dispatch as one program with every "
        "slot's output aliased over its input, and the per-batch Python "
        "dispatch tax disappears from the hot path. Needs "
        "--pipeline-depth >= 2 (>= 2R keeps the device stream fed); "
        "0 (default) keeps the per-batch lanes. Results are byte-identical "
        "either way",
    )
    srv.add_argument(
        "--result-cache", action="store_true",
        help="serve repeat boards from the content-addressed result cache "
        "(gol_tpu_torch/cache): identical submissions complete at admission in "
        "O(1), identical in-flight submissions run the engine once. Hits "
        "are journaled as normal DONE records (exactly-once unchanged); "
        "per-job no_cache opts out. With --journal-dir the on-disk CAS "
        "tier defaults to <journal-dir>/cache",
    )
    srv.add_argument(
        "--cache-dir", default=None, metavar="DIR",
        help="on-disk CAS tier for the result cache (implies "
        "--result-cache): content-addressed CRC-gated entries that "
        "survive restarts; corrupt entries evict loudly and re-run",
    )
    srv.add_argument(
        "--cache-entries", type=int, default=1024, metavar="N",
        help="in-process result-cache LRU bound (default 1024 entries)",
    )
    srv.add_argument(
        "--cache-payload", choices=("packed", "text", "ts"), default="packed",
        help="CAS payload encoding: 'packed' (default — the binary wire "
        "frame, io/wire.py, ~8x smaller than text at any width; packed "
        "hits serve without a decode/re-encode round trip) or 'text' "
        "(self-contained meta JSON); 'ts' (TensorStore zarr) is not "
        "ported and is refused",
    )
    srv.add_argument(
        "--cache-disk-bytes", type=int, default=None, metavar="N",
        help="byte budget for the on-disk CAS tier: past it the cache "
        "garbage-collects itself, least-recently-used entries first "
        "(gol_tpu_torch/cache/gc.py — eviction is always safe, the journal "
        "stays the source of truth). Default: unbounded; `gol gc` runs "
        "the same pass offline",
    )
    srv.add_argument(
        "--journal-segment-bytes", type=int, default=None, metavar="N",
        help="rotate the job journal into sealed segments past N bytes "
        "(default 8 MiB); sealed segments compact into a CRC-stamped "
        "snapshot on idle sampler ticks, bounding the durable footprint "
        "(gol_tpu_torch/serve/compaction.py; `gol compact` runs it offline). "
        "0 disables rotation (the unbounded single-file journal)",
    )
    srv.add_argument(
        "--journal-retain", type=int, default=None, metavar="N",
        help="result-retention window: compaction keeps only the newest N "
        "terminal records in the snapshot — results older than the window "
        "answer 404 after a restart. Default: retain every result "
        "(replayed state identical to the unbounded log)",
    )
    srv.add_argument(
        "--disk-reserve", type=int, default=0, metavar="N",
        help="disk-pressure watchdog (resilience/diskguard.py): when free "
        "bytes on the journal partition fall below 4N the CAS stops "
        "taking writes, below 2N checkpoints shed, below N POST /jobs "
        "answers 507 (naming the partition and free bytes) while "
        "in-flight jobs still complete and journal; recovery is "
        "automatic with 25%% hysteresis. 0 (default) disables the guard",
    )
    srv.add_argument(
        "--warm-plans", action="store_true",
        help="pre-compile the bucket programs of every serve shape recorded "
        "by `gol tune` before accepting traffic",
    )
    srv.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="build the kernels in DIR (and load them from it): restarted "
        "servers skip the nvcc build",
    )
    srv.add_argument(
        "--trace", default=None, metavar="DIR",
        help="span tracing + flight recorder: per-batch spans (one per "
        "dispatched bucket batch) export to DIR as Chrome trace JSON on "
        "shutdown; GET /debug/trace snapshots them live; crashes dump "
        "flight-*.jsonl; SIGUSR1 dumps without stopping the server",
    )
    srv.add_argument(
        "--slo-shed", action="store_true",
        help="shed load when an SLO burn is critical: POST /jobs answers "
        "429 + Retry-After until the burn clears. Default is observe-only "
        "(burns log and export at GET /slo; admission is untouched)",
    )
    srv.add_argument(
        "--slo-latency-p99", type=float, default=60.0, metavar="S",
        help="the per-priority-class p99 end-to-end latency objective in "
        "seconds (default 60); error-rate (1%%) and queue-saturation (80%%) "
        "objectives are built in — see gol_tpu_torch/obs/slo.py",
    )
    srv.add_argument(
        "--sample-interval", type=float, default=1.0, metavar="S",
        help="seconds between SLO/dispatch-gap sampler ticks (the "
        "gol-serve-sampler thread); <= 0 disables the background sampler "
        "(GET /slo then evaluates on demand)",
    )
    srv.add_argument(
        "--metrics-history", nargs="?", const="auto", default=None,
        metavar="DIR",
        help="durable metrics history (gol_tpu_torch/obs/history.py): every "
        "sampler tick appends the serving metrics snapshot to a "
        "size-capped append-only JSONL ring in DIR, surviving restarts "
        "(render with `gol history-report DIR`). With no DIR the ring lands at "
        "<journal-dir>/history. Default: off (no per-tick cost)",
    )
    srv.add_argument(
        "--history-bytes", type=int, default=None, metavar="N",
        help="metrics-history ring cap in bytes (default 16 MiB); oldest "
        "segments compact away past it",
    )
    srv.add_argument(
        "--retry-budget", type=float, default=0.0, metavar="N",
        help="token-bucket budget on batch dispatch RETRIES (N tokens, "
        "refilled over a minute): under a brownout the scheduler degrades "
        "to first-attempt-only dispatch — surfacing the original error — "
        "instead of amplifying the overload with retry traffic. 0 "
        "(default) = unlimited, the pre-budget behavior",
    )
    srv.set_defaults(func=_serve)

    flt = sub.add_parser(
        "fleet",
        help="run the sharded serving fleet: a router front-end over N "
        "`gol serve` workers (same HTTP job API, bucket-consistent "
        "routing, partitioned journals, health-aware placement, "
        "fleet-wide drain)",
    )
    flt.add_argument("--host", default="127.0.0.1")
    flt.add_argument("--port", type=int, default=8000,
                     help="router listen port (0 = pick a free one)")
    flt.add_argument(
        "--workers", type=int, default=2, metavar="N",
        help="local worker subprocesses to run (default 2; partitions "
        "recovered from an existing --fleet-dir manifest count toward N)",
    )
    flt.add_argument(
        "--attach", action="append", default=[], metavar="URL",
        help="adopt an externally managed `gol serve` by URL (repeatable; "
        "the multi-host lane — boot workers where parallel/bootstrap.py "
        "put the devices, hand the router their URLs). Attached workers "
        "are health-checked and routed around, never respawned",
    )
    flt.add_argument(
        "--fleet-dir", default="./fleet", metavar="D",
        help="fleet state directory: the membership manifest plus one "
        "journal partition per local worker (default ./fleet). Restarting "
        "on the same directory reattaches live workers and respawns dead "
        "partitions, whose journals replay to exactly-once",
    )
    flt.add_argument(
        "--big-lane", action="store_true",
        help="spawn one dedicated worker for oversized boards (padded "
        "edge > --big-edge): giant compiles and batches never block the "
        "bucket workers",
    )
    flt.add_argument(
        "--big-edge", type=int, default=1024, metavar="N",
        help="padded board edge above which jobs route to the big-lane "
        "worker when one exists (default 1024)",
    )
    flt.add_argument(
        "--health-interval", type=float, default=1.0, metavar="S",
        help="seconds between worker health/burn probes (default 1)",
    )
    # Worker passthrough flags (forwarded to every spawned `gol serve`).
    flt.add_argument("--max-queue-depth", type=int, default=1024)
    flt.add_argument("--max-batch", type=int, default=64)
    flt.add_argument("--flush-age", type=float, default=0.05, metavar="S")
    flt.add_argument("--pipeline-depth", type=int, default=1)
    flt.add_argument("--resident-ring", type=int, default=0, metavar="R")
    flt.add_argument(
        "--warm-plans", action="store_true",
        help="each worker pre-compiles its tuner-recorded bucket programs "
        "at boot (per-worker plan warm-up from the shared plan cache)",
    )
    flt.add_argument("--compile-cache", default=None, metavar="DIR")
    flt.add_argument(
        "--result-cache", action="store_true",
        help="each worker mounts the tiered result cache (LRU + a CAS tier "
        "on its own journal partition) — repeat boards complete at "
        "admission; see `gol serve --result-cache`",
    )
    flt.add_argument(
        "--cache-route", action="store_true",
        help="route submissions by result FINGERPRINT instead of padding "
        "bucket (the fleet cache tier): every repeat of a board lands on "
        "the one worker whose cache holds its answer, and hot patterns "
        "spread across workers by fingerprint. Trade: a bucket's programs "
        "may compile on several workers (one-time, bought back by every "
        "repeat). Pair with --result-cache",
    )
    flt.add_argument(
        "--cache-disk-bytes", type=int, default=None, metavar="N",
        help="forwarded to every worker: per-partition CAS byte budget "
        "with LRU garbage collection (see `gol serve --cache-disk-bytes`)",
    )
    flt.add_argument(
        "--journal-segment-bytes", type=int, default=None, metavar="N",
        help="forwarded to every worker: journal segment rotation "
        "threshold (see `gol serve --journal-segment-bytes`)",
    )
    flt.add_argument(
        "--journal-retain", type=int, default=None, metavar="N",
        help="forwarded to every worker: result-retention window at "
        "compaction (see `gol serve --journal-retain`)",
    )
    flt.add_argument(
        "--disk-reserve", type=int, default=0, metavar="N",
        help="forwarded to every worker: per-partition disk-pressure "
        "watchdog — a full-disk partition sheds CAS writes, then "
        "checkpoints, then 507s new admission, alone, while the rest of "
        "the fleet serves (see `gol serve --disk-reserve`)",
    )
    flt.add_argument("--slo-shed", action="store_true")
    flt.add_argument("--slo-latency-p99", type=float, default=60.0,
                     metavar="S")
    flt.add_argument("--sample-interval", type=float, default=1.0,
                     metavar="S")
    flt.add_argument(
        "--trace", default=None, metavar="DIR",
        help="fleet-wide span tracing: arms the router AND every spawned "
        "worker (one pid-qualified export per process in DIR), and stamps "
        "X-Gol-Trace onto forwarded submits so worker spans join the "
        "router's trace. Stitch every live process's ring into ONE "
        "Perfetto timeline with `gol fleet-trace`",
    )
    flt.add_argument(
        "--metrics-history", action="store_true",
        help="durable metrics history for the whole fleet: every worker "
        "appends its snapshot ring beside its journal partition "
        "(<partition>/history) and the router appends the fleet-MERGED, "
        "respawn-floored view to <fleet-dir>/router-history — the "
        "cumulative series stay monotonic through worker respawns. "
        "Render with `gol history-report <dir>`",
    )
    flt.add_argument("--history-bytes", type=int, default=None, metavar="N",
                     help="per-process history ring cap in bytes "
                     "(default 16 MiB)")
    # The elastic fleet (fleet/autoscale.py + affinity.py).
    flt.add_argument(
        "--autoscale", action="store_true",
        help="close the loop: spawn workers when SLO burn rates or queue "
        "saturation climb (up to --max-workers), drain+retire the "
        "emptiest when occupancy stays below the floor (down to "
        "--min-workers). Every decision is journaled to "
        "<fleet-dir>/autoscaler-history and visible in `gol top`",
    )
    flt.add_argument(
        "--min-workers", type=int, default=None, metavar="N",
        help="autoscaler floor (default: the --workers count)",
    )
    flt.add_argument(
        "--max-workers", type=int, default=None, metavar="N",
        help="autoscaler ceiling (default: max(4, --workers))",
    )
    flt.add_argument(
        "--scale-up-saturation", type=float, default=0.8, metavar="F",
        help="scale up when merged queue depth exceeds this fraction of "
        "the fleet-wide admission cap, sustained --scale-up-sustain ticks "
        "(default 0.8); SLO-critical burn on every window also triggers",
    )
    flt.add_argument(
        "--scale-down-occupancy", type=float, default=0.05, metavar="F",
        help="retire a worker when queued+inflight stays below this "
        "fraction of the cap for --scale-down-sustain ticks (default "
        "0.05; the wide gap to --scale-up-saturation is the hysteresis "
        "dead band)",
    )
    flt.add_argument("--scale-up-sustain", type=int, default=2, metavar="T",
                     help="consecutive health ticks the up condition must "
                     "hold (default 2)")
    flt.add_argument("--scale-down-sustain", type=int, default=10,
                     metavar="T",
                     help="consecutive health ticks the down condition "
                     "must hold (default 10)")
    flt.add_argument(
        "--scale-cooldown", type=float, default=30.0, metavar="S",
        help="seconds after any scale event before the next decision can "
        "fire (default 30; flap protection on top of the sustain windows)",
    )
    flt.add_argument(
        "--cores-per-worker", type=int, default=0, metavar="N",
        help="pin worker k to its own N-core `taskset` slice (local "
        "spawns only; autoscaled workers land on distinct slices) and "
        "weight it N for --affinity placement. 0 = no pinning (default)",
    )
    flt.add_argument(
        "--affinity", action="store_true",
        help="affinity-aware placement: rank workers by weighted HRW over "
        "per-worker capacity weights (--cores-per-worker pins, or each "
        "worker's tuned marginal rate advertised on /healthz) instead of "
        "hash rank alone. Off (the default) — and on with no weights "
        "configured — is byte-identical to plain HRW placement",
    )
    # The chaos-hardened data path (chaos/ + fleet/breaker.py).
    flt.add_argument(
        "--no-breakers", action="store_true",
        help="disable the per-worker circuit breakers (on by default: "
        "consecutive failures or a degraded fraction of recent calls "
        "rank a worker LAST — never removed, so HRW bucket affinity "
        "survives recovery — until a half-open probe succeeds)",
    )
    flt.add_argument(
        "--breaker-cooldown", type=float, default=5.0, metavar="S",
        help="seconds an OPEN breaker holds before its single half-open "
        "probe (default 5)",
    )
    flt.add_argument(
        "--breaker-slow", type=float, default=1.0, metavar="S",
        help="forward latency above S seconds counts as degraded toward "
        "the breaker's windowed trip (default 1.0; <= 0 disables the "
        "latency signal)",
    )
    flt.add_argument(
        "--retry-budget", type=float, default=0.0, metavar="N",
        help="forwarded to every worker: token-bucket budget on batch "
        "dispatch retries (see `gol serve --retry-budget`)",
    )
    flt.add_argument(
        "--chaos", default=None, metavar="PLAN",
        help="mount a seeded fault-injecting proxy (chaos/) on the "
        "router->worker data path: PLAN is a k=v list, e.g. "
        "'seed=7,reset=0.05,latency=0.2,latency_ms=50,bitflip=0.05' "
        "(classes: refuse, reset, truncate, slowloris, bitflip, latency). "
        "Health probes stay direct — chaos exercises the data plane's "
        "defenses, not the supervisor. NEVER set this in production",
    )
    flt.add_argument(
        "--routers", type=int, default=1, metavar="N",
        help="total router replicas over this fleet (default 1). N-1 "
        "extra `gol router` subprocesses boot from the shared manifest, "
        "serve the full job API active-active, and contest the leader "
        "lease for the single-writer ticks — kill any one (the leader "
        "included) and the survivors carry the control plane",
    )
    flt.set_defaults(func=_fleet)

    rtr = sub.add_parser(
        "router",
        help="one attachable router replica over a running fleet: boots "
        "from the shared manifest (membership + config), inherits the "
        "durable floors/breaker state, contests the leader lease. "
        "SIGTERM stops this replica only — never the workers",
    )
    rtr.add_argument("--fleet-dir", required=True, metavar="DIR",
                     help="the running fleet's --fleet-dir (the manifest "
                     "is the only coordination channel)")
    rtr.add_argument("--router-id", required=True, metavar="ID",
                     help="this replica's identity (its durable state "
                     "lives under <fleet-dir>/routers/<ID>/)")
    rtr.add_argument("--host", default="127.0.0.1")
    rtr.add_argument("--port", type=int, default=0,
                     help="0 = any free port (default; the URL is "
                     "advertised in <fleet-dir>/routers/<ID>/advert.json)")
    rtr.set_defaults(func=_router)

    gcp = sub.add_parser(
        "gc",
        help="CAS garbage collection: sweep orphans + evict LRU entries "
        "to a byte budget (dry-run by default; --apply deletes)",
    )
    gcp.add_argument("dir", help="cache (CAS) directory")
    gcp.add_argument(
        "--budget", type=int, default=None, metavar="BYTES",
        help="target byte budget (default: sweep garbage only)",
    )
    gcp.add_argument("--apply", action="store_true",
                     help="actually delete (default is a dry-run report)")
    gcp.set_defaults(func=_gc_cmd)

    sbm = sub.add_parser(
        "submit", help="submit jobs to a running gol serve and fetch results"
    )
    sbm.add_argument("width")
    sbm.add_argument("height")
    sbm.add_argument("input_files", nargs="+")
    sbm.add_argument("--server", default="http://127.0.0.1:8000")
    sbm.add_argument(
        "--servers", default=None, metavar="A,B,C",
        help="comma-separated router REPLICA URLs over one fleet "
        "(overrides --server): job-creating POSTs fail over ONLY on "
        "delivery-impossible errors (refused/DNS/unreachable — nothing "
        "reached any queue); ambiguous failures surface for audit, never "
        "blind-resubmit. Status/result GETs rotate freely",
    )
    sbm.add_argument(
        "--variant", default="tpu", choices=sorted(VARIANTS),
        help="reference program whose loop accounting the jobs use",
    )
    sbm.add_argument("--gen-limit", type=int, default=GameConfig().gen_limit)
    sbm.add_argument("--priority", type=int, default=0)
    sbm.add_argument("--deadline", type=float, default=None, metavar="S",
                     help="dispatch-ordering deadline, seconds from acceptance")
    sbm.add_argument(
        "--timeout", type=float, default=None, metavar="S",
        help="end-to-end latency BUDGET per job, propagated as the "
        "X-Gol-Deadline header and decremented per hop: the router stops "
        "forwarding, the worker refuses admission, and the scheduler "
        "skips dispatch once the budget is spent — each answering 504 "
        "(with the job's timeline attached at the dispatch gate) instead "
        "of burning capacity on an answer nobody is waiting for. Old "
        "servers ignore the header (behavior unchanged). Unlike "
        "--deadline, which only ORDERS dispatch, --timeout abandons work",
    )
    sbm.add_argument("--no-wait", dest="wait", action="store_false",
                     help="submit and print job ids without polling")
    sbm.add_argument(
        "--no-cache", action="store_true",
        help="opt these submissions out of the server's result cache "
        "(always a fresh engine run); result lines from cache-served "
        "repeats carry a 'cached:<tier>' marker otherwise",
    )
    sbm.add_argument(
        "--wire", choices=("text", "packed"), default="text",
        help="wire format for boards (io/wire.py): 'packed' submits binary "
        "frames (~8x fewer bytes than text) and fetches results with "
        "Accept: application/x-gol-packed. Degrades gracefully against "
        "old servers: a 415/400 submit answer retries as text (once, "
        "logged, per target), and JSON result answers parse as always",
    )
    sbm.add_argument("--poll-interval", type=float, default=0.2)
    sbm.add_argument(
        "--server-timeout", type=float, default=60.0, metavar="S",
        help="give up after S seconds without server contact while polling "
        "(transient connection errors — e.g. a server restart mid-replay — "
        "are retried until then)",
    )
    sbm.add_argument("--output-dir", default=None,
                     help="write results here (default: next to each input)")
    sbm.add_argument(
        "--shard-across", action="store_true",
        help="against a fleet router (`gol fleet`), fan the boards "
        "round-robin over the fleet's workers directly (GET /fleet lists "
        "them) instead of routing every submit through the front-end; "
        "membership is re-fetched every --shard-refresh seconds (and on "
        "a 429) so autoscaled workers absorb the load mid-submission; "
        "a no-op against a single `gol serve`",
    )
    sbm.add_argument(
        "--shard-refresh", type=float, default=5.0, metavar="S",
        help="seconds between --shard-across membership re-fetches "
        "(default 5)",
    )
    sbm.set_defaults(func=_submit)

    tun = sub.add_parser(
        "tune",
        help="offline measured search: pick kernel/depth/block/bucket plans "
        "and persist them to the plan cache (gol_tpu_torch/tune/)",
    )
    tun.add_argument(
        "--shape", action="append", metavar="HxW",
        help="engine grid shape(s) to tune (repeatable; default 256x256)",
    )
    tun.add_argument(
        "--convention", choices=("c", "cuda", "both"), default="both",
        help="loop-accounting convention(s) to tune (default: both)",
    )
    tun.add_argument("--mesh", default=None,
                     help="tune the RxC-mesh context instead of single-device")
    tun.add_argument(
        "--gen-limit", type=int, default=64,
        help="generations per timed trial (default 64: long enough that the "
        "loop dominates dispatch, short enough to search exhaustively)",
    )
    tun.add_argument("--iters", type=int, default=5,
                     help="timed trials per candidate (trimmed median)")
    tun.add_argument(
        "--quick", action="store_true",
        help="prune the depth/block axes to their extremes (smoke/CI)",
    )
    tun.add_argument(
        "--packed", action="store_true",
        help="also tune the packed-state family (the --packed-io lane "
        "consults its own plans; widths must divide by 32)",
    )
    tun.add_argument(
        "--sparse-crossover", action="store_true",
        help="also measure the dense/sparse engine crossover on this host "
        "and persist it as the `--engine auto` area threshold (default: "
        "the bundled crossover, 2^25 cells)",
    )
    tun.add_argument(
        "--serve-board", default=None, metavar="HxW",
        help="also tune the serve batcher's bucket geometry on this request "
        "shape (recorded for `gol serve --warm-plans`)",
    )
    tun.add_argument(
        "--plan-cache", default=None, metavar="FILE",
        help="plan cache file (default: $GOL_PLAN_CACHE or "
        "~/.cache/gol_tpu_torch/plans.json)",
    )
    tun.add_argument("--report", default=None, metavar="FILE",
                     help="write the human-readable report here")
    tun.add_argument(
        "--provenance", action="store_true",
        help="store the full per-candidate measurement series in the plan "
        "cache, not just the winner",
    )
    tun.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="build the kernels in DIR (and load them from it) while "
        "searching",
    )
    tun.add_argument(
        "--trace", default=None, metavar="DIR",
        help="span tracing + flight recorder: per-trial events export to "
        "DIR as Chrome trace JSON when the search ends (SIGUSR1 dumps a "
        "long search's progress live)",
    )
    tun.set_defaults(func=_tune)

    ftr = sub.add_parser(
        "fleet-trace",
        help="stitch the live span rings of a whole fleet (router + every "
        "worker) into ONE clock-normalized Perfetto trace file with "
        "cross-process flow arrows per job",
    )
    ftr.add_argument("--server", default="http://127.0.0.1:8000",
                     help="the fleet router (or a single gol serve) URL")
    ftr.add_argument("--servers", default=None, metavar="A,B,C",
                     help="comma-separated router REPLICA URLs over one "
                     "fleet (overrides --server): the export tries each "
                     "in turn until one answers")
    ftr.add_argument("-o", "--output", default="fleet-trace.json",
                     help="stitched Chrome trace JSON path "
                     "(default fleet-trace.json)")
    ftr.set_defaults(func=_fleet_trace)

    topp = sub.add_parser(
        "top",
        help="live terminal dashboard over a running gol serve: queue "
        "depths, ring occupancy, latency percentiles, SLO burn rates, and "
        "the live dispatch-gap ratio",
    )
    topp.add_argument("--server", default="http://127.0.0.1:8000")
    topp.add_argument("--servers", default=None, metavar="A,B,C",
                      help="comma-separated router REPLICA URLs over one "
                      "fleet (overrides --server): each frame follows "
                      "whichever replica answers, and the title names it")
    topp.add_argument("--interval", type=float, default=2.0, metavar="S",
                      help="seconds between refreshes (default 2)")
    topp.add_argument(
        "--iterations", type=int, default=0, metavar="N",
        help="exit after N frames (default 0 = run until interrupted)",
    )
    topp.add_argument(
        "--no-ansi", action="store_true",
        help="plain frames, no screen clearing/colors (also automatic when "
        "stdout is not a terminal)",
    )
    topp.set_defaults(func=_top)
    return parser


SUBCOMMANDS = ("run", "generate", "show", "trace-report", "history-report",
               "slo-report", "compact", "batch", "serve", "fleet", "router",
               "submit", "gc", "tune", "fleet-trace", "top")


def main(argv: list[str] | None = None) -> int:
    configure_cli_logging()
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # Default command is `run`, preserving the bare `<w> <h> <file>` contract.
    if not argv or argv[0] not in (*SUBCOMMANDS, "-h", "--help"):
        argv = ["run", *argv]
    args = build_parser().parse_args(argv)
    # --trace DIR: span tracing and the flight recorder armed before the
    # lane starts, inside the try so that a bad path (a file, an unwritable
    # parent) gets the `gol: <error>` contract; the Chrome trace exports
    # when the lane ends, error returns and crash unwinds included.
    export_trace = lambda: None  # noqa: E731 - replaced once arming succeeds
    try:
        export_trace = _arm_observability(getattr(args, "trace", None))
        return args.func(args)
    except (ValueError, OSError, NoDeviceError) as e:
        print(f"gol: {e}", file=sys.stderr)
        return 1
    finally:
        try:
            export_trace()
        except OSError as e:
            # A failed export (directory deleted mid-run, disk full) must
            # not mask the lane's result.
            print(f"gol: trace export failed: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
