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
  ``GOL_FAULTS`` / ``--fault-plan``); all but ``--host`` run on a mesh too.
  Patterns and the sparse and macro engines are not ported;
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
artifacts. The JAX CLI's other subcommands (``NOT_PORTED``) exit 1 with a
``gol:`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

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
from gol_tpu_torch.variants import VARIANTS, Variant, get_variant

# Dense-materialization ceiling (cells): 2^30 cells is a 1 GB uint8 canvas
# on the host, and the engine carries the grid plus its packed buffers.
MAX_DENSE_CELLS = 1 << 30


def atoi(s: str | None) -> int:
    """C atoi: optional sign + leading digits, anything else is 0."""
    if not s:
        return 0
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def dense_cells_guard(height: int, width: int) -> None:
    """Raise the CLI-contract error for a dense grid that cannot fit, before
    anything allocates it. The message is the JAX CLI's word for word; the
    sparse lane it names runs under ``python -m gol_tpu`` (not ported)."""
    cells = height * width
    if cells > MAX_DENSE_CELLS:
        raise ValueError(
            f"a {height}x{width} board is {cells} cells "
            f"({cells / (1 << 30):.1f} GB as bytes), above the dense "
            f"engine's {MAX_DENSE_CELLS}-cell ceiling; use the sparse lane "
            "(--pattern FILE --universe WxH [--engine sparse]) so the "
            "canvas is never materialized"
        )


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
        if args.gens < 0:
            raise ValueError(f"--gens must be >= 0, got {args.gens}")
        args.gen_limit = args.gens
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
    run.add_argument("--gens", type=int, default=None, metavar="N",
                     help="alias for --gen-limit")
    run.add_argument(
        "--similarity-frequency", type=int, default=GameConfig().similarity_frequency
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
    return parser


# The JAX CLI's other subcommands. Until one is ported its name is refused,
# not read as a width by `run`.
NOT_PORTED = ("serve", "fleet", "router", "submit", "batch", "tune",
              "fleet-trace", "top", "compact", "gc")
SUBCOMMANDS = ("run", "generate", "show", "trace-report", "history-report",
               "slo-report")


def main(argv: list[str] | None = None) -> int:
    configure_cli_logging()
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"gol: subcommand {argv[0]!r} is not ported yet; run it with "
              "python -m gol_tpu", file=sys.stderr)
        return 1
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
