#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

The quickest proof that the port still starts on the GPU. It needs one card,
``nvcc``, ``cc`` and nothing of JAX, and generates every input from a seed.
Phases, each of which fails the run (non-zero exit, no result line) on any
error:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   native code built from the checkout — one compiler per source, all
   started together: ``csrc/stencil_packed.cu`` (K1-K3, K5, K7, K8, the
   ghost-plane form that replaces K9-K13, and K14, the flag-free pass of
   the roofline), ``csrc/stencil_pallas.cu`` (K4, K6),
   ``csrc/stencil_batch.cu`` (B1, B2: the batch lane's batched steps) and
   ``native/codec.c`` (the packed-I/O text codec) — with nvcc's
   ``-Xptxas -v`` report (registers, shared memory, spills).
2. Kernels against their plain torch versions on the card: K1 (fast-flag
   8-generation pass), K2 (exact-flag pass), K3 (one generation) and K14
   (the 8-generation pass without flags) at
   (height, nwords) (1,1) (7,1) (16,2) (17,5) (1000,7) (16384,512) and
   ``BAND_SHAPES`` (2,1) (33,4) (40,132) (K3's height 2 and its 16-byte
   form), and K4
   (one byte-cell generation) at (height, width) (1,1) (7,3) (16,128)
   (17,161) (1000,225) (16384,16384), on random cells, a domino that dies
   and an L-tromino that becomes still. The mesh-shard kernels K5 (one
   generation from ghost rows and carry words), K7/K8 (K1/K2 of a
   full-width shard from 8-row ghost blocks) at shard (height, nwords)
   (1,1) (8,1) (17,5) (1000,7) (4096,512) and ``BAND_SHAPES`` (K7/K8 from
   8 rows), and K6 (K4
   of a shard) at (1,1) (7,3) (17,161) (8192,8192), and the ghost-plane
   forms of the 8-generation pass (summary flags: replaces K9+K10; exact
   flags: replaces K11+K12 and K13; a shard of a mesh with columns, from
   8-row ghost blocks and the (h+16) ghost word columns) at (8,1) (17,1)
   (16,2) (17,5) (1000,7) (8192,256): on random cells with random ghosts
   (every bit random), and on the domino and the L-tromino with the ghosts
   a one-shard torus exchanges. Every 8-generation form (K1, K2, K14, K7,
   K8 and the ghost-plane forms) also runs at the shapes around
   ``bandt_kernel``'s tile (``tile_shapes``: one band around its least
   height and two ragged ones, and nwords 1, 2, 31, 37 and 61 against its
   30-word strips). Outputs and flags must be identical. Then B1 (one
   generation of B packed tori) at (boards, height, nwords) (3,32,1)
   (32x32 one-word boards) (2,1,1) (4,17,5) (64,256,8) and B2 (B uint8
   boards, each wrapping at its own extent) on a 32x32 canvas of extents
   30x30, 18x24, 10x13 and 1x1, on the exact-fit 33x20 byte mode and on
   64 250x250 boards in a 256x256 canvas, at a block's generation 0 and 2
   with per-board step counts 3/1/0 (a spent board copies through, a
   padding slot never runs): words or cells and per-board flags
   identical.
3. Small flows through ``python -m gol_tpu_torch`` on the card, against the
   port's numpy oracle, for both loop conventions: the verify skill's four
   flows at 48^2 and 64^2 (random for 1000 generations, 2x2 block, lone
   cell, all dead) with ``--kernel auto`` and ``--kernel pallas``; the 64^2
   flows with ``--packed-io``; the 48^2 flows with ``--host``; the random
   48^2 grid under each of ``mpi``/``collective``/``async``/``openmp``
   (default output name, printed lines, bytes); ``--snapshot-every 100``
   (every ``gen_NNNNNN.out`` equal to the oracle's state at that
   generation); and ``--resume-gen 300`` from a snapshot against the whole
   run. Then, with ``GOL_TORCH_MESH_DEVICES=4`` (four shards on the one
   card), the eight flows through ``cli.main`` under ``--variant tpu``,
   ``collective``, ``async``, ``openmp`` and ``mpi``, each with ``--mesh
   4x1`` and ``--mesh 2x2`` and ``--kernel auto``, ``pallas`` and ``lax``,
   with ``--mesh 1x4`` and ``--kernel auto``, and the 64^2 flows with
   ``--packed-io`` on 4x1 and 2x2 (bytes, generation counts and printed
   lines against the oracle). 64^2 under ``--mesh 2x2`` has one-word shards:
   there an L-tromino that becomes still and a lone cell that dies must
   launch both ghost-plane forms. ``--snapshot-every 100`` and
   ``--resume-gen 300`` run again under ``--variant tpu --mesh 2x2``, with
   and without ``--packed-io``.
3c. The checkpoint lane at 64^2 on the card, against the oracle: ``--variant
   game`` and ``cuda`` with ``--kernel auto``, ``--kernel pallas`` and
   ``--packed-io``, and ``--variant tpu --mesh 2x2``, each with the async
   writer and with ``--sync-checkpoints``: a run with ``--checkpoint-every
   100``, a run killed by ``GOL_FAULTS=kill_at_gen=300,kill_mode=sigkill``
   (a real SIGKILL, one subprocess per lane, all in parallel; its newest
   manifest must be generation 200's), then ``--auto-resume`` from it:
   outputs and Generations equal the oracle's.
4. The main path at full size, 16384^2 (268 MB of text, 32 MiB of packed
   words), through the CLI entry point: ``--variant game`` and ``cuda``,
   each on (a) a random grid for 1000 generations (K1 only), (b) the same
   for 1003 (a K3 tail), (c) an L-tromino that becomes still at generation
   1 (K2 replay) and (d) a three-cell diagonal that dies at generation 2 (K2
   replay, and under ``cuda`` the K3 empty-exit replay), (c) and (d) once in
   the middle and once across the torus corner. Three lanes run the six
   inputs: ``--kernel auto`` (K1-K3), ``--kernel pallas`` (K4) and
   ``--packed-io`` (K1-K3 with no encode/decode). One uncounted run (a) of
   each lane warms the process first. For each variant and lane the launch
   counters are set to 0 just before its six runs and read just after; each
   kernel of the lane must have launched. ``pallas`` and ``--packed-io``
   must give the same output bytes and generation counts as ``auto``; every
   run is repeated with ``--kernel lax`` (byte cells, plain torch) with the
   same check, and (c)/(d) must match the oracle on a 64^2 copy.
   The mesh path at the same size: ``--variant tpu`` (C convention) on the
   six inputs under ``--mesh 4x1`` (four 4096x16384 shards) and ``--mesh
   2x2`` (8192x8192), each with ``--kernel auto`` and ``--kernel pallas``,
   and ``--mesh 2x2 --packed-io``: every output's bytes and generation
   count must equal the single-device ``--kernel auto`` run's. Counters are
   zeroed per lane: ``4x1 auto`` must launch K7, K8 and K5, ``2x2 auto`` and
   ``2x2 packed_io`` both ghost-plane forms and K5 (the block tail), both
   ``pallas`` lanes K6, and no lane a single-device kernel. Engine-level
   runs of (d) under the CUDA convention on 4x1 and 2x2 must launch K5 for
   the empty-exit replay.
4c. The checkpoint lane at the same size: run (a) under ``--variant game
   --checkpoint-every 250`` with the async writer and with
   ``--sync-checkpoints`` (text-grid payloads of 268 MB), each equal to
   phase 4's run (a) byte for byte; then a run SIGKILLed at generation 500
   and its ``--auto-resume``, equal too. The Execution times print beside
   phase 4's, with the writer's stall counters.
4d. Observability on the card, through ``cli.main``: run (a) under
   ``--variant game --kernel auto`` with ``--trace T`` alone (its
   Execution time beside phase 4's), then with ``--trace T --profile P``:
   bytes equal to phase 4's run (a), Generations 1000, the ``trace ->
   T/trace-<pid>.json`` line on stderr, ``trace-report`` of that file
   naming ``cli.read_phase``, ``engine.compile``, ``cli.execution`` and
   ``cli.write_phase``, and ``P/trace.json`` holding exactly 125 CUDA
   kernel events named ``bandt_kernel`` (K1). The capture covers the
   ``cli.execution`` span and nothing else, so every event in it is in
   that window. The same ``--profile`` check on ``--packed-io`` (125 K1),
   ``--variant tpu --mesh 4x1`` (500 K7) and ``--mesh 2x2`` (500 K9+K10),
   each with its bytes equal to run (a)'s. Each profiled lane prints its
   device-busy share (the union of the CUDA kernel intervals over the
   profiled window) beside its Execution time, the kernel time over the
   lane's unprofiled Execution time of phase 4 or 4b (the capture costs
   host time), and the host ops that take most of the window. Then ``--packed-io --compile-cache D`` twice, each
   in a subprocess of its own with a fresh ``D``: the first builds
   ``stencil_packed-*.so`` and ``codec-*.so`` into ``D`` (its
   ``engine.compile`` and ``cli.read_phase`` spans hold the two builds),
   the second builds nothing (the same files, the same mtimes); both
   outputs equal run (a)'s.
4e. The batch lane (bench.py's serving load): 64 random 256^2 boards
   (bucket ``256x256/c/packed``, B1) and 64 random 250^2 boards
   (``256x256/c/masked``, B2) through ``serve/batcher.run_batch`` at
   gen_limit 4 and 1000 under both conventions, and JAX's mixed-fate trio
   at 32^2 (gen_limit 60), with the launch counters set to 0 just before
   and read just after: B1 and B2 must launch, no other kernel. Every
   board's grid and generations equal the port's solo ``engine.simulate``
   (``--kernel auto`` for the packed boards, ``pallas`` for the masked
   ones) and the trio's also the oracle and its exit reasons. Then
   ``python -m gol_tpu_torch batch 256 256 <64 files> --gen-limit 1000
   --output-dir D`` in a subprocess: every output file equal to the solo
   ``run``'s bytes (``--variant tpu --mesh 1x1``) and its Generations.
   Boards/sec at B = 1, 8 and 64 per bucket and limit (bench.py's batch
   suite: 64/B dispatches of B boards, best of 3), and each bucket's B = 64
   dispatch under ``torch.profiler`` (device-busy share).
5. Timing: each kernel over 100 warm launches captured in one CUDA graph
   and replayed (CUDA events around the replay), so that the card and not
   the host's launch rate sets ``ms``; beside it ``eager_ms`` (the same
   launches issued one by one, what a host loop pays), ``wrapper_ms`` (the
   host's time per wrapper call while capturing, when nothing runs) and the
   plain version's ``plain_ms`` (eager). K1-K4 at 16384^2, K5/K7/K8 at the
   4x1 shard (4096 x 512 words), K5 and the ghost-plane forms at the 2x2
   shard (8192 x 256 words) and K6 at the 4x1 and 2x2 shards. K5 runs over
   the ring of the mesh's four shards, each with its own input, output and
   ghosts, launched in turn as the mesh launches them: together they
   exceed the 50 MB L2, so no launch finds its input there from its own
   last launch; the others ping-pong one pair. Each line prints the
   working set beside the bound, so that an L2-resident reading shows.
   Each time stands beside its bound — the larger of the
   bytes it must move (its inputs, ghosts included, read once and its
   output written once) over 3.35 TB/s and its 32-bit integer logic ops
   over the card's rate for them: 64 results per clock per SM (CUDA C++
   Programming Guide, arithmetic instruction throughput, compute capability
   9.0: 32-bit bitwise AND/OR/XOR, shifts and adds) times the SM count
   times the maximum SM clock (nvidia-smi ``clocks.max.sm``). The packed
   kernels' logic ops per word and generation are the adder network's 12
   (2 funnel shifts and 10 3-input LOP3s, ``roofline.OPS_PER_WORD_GEN``);
   the time at 28 two-input ops stays beside it (``ops_ms_two_input``).
   No single PyTorch call computes a B3/S23 step, so ``library_ms`` is
   null. B1 and B2 at phase 4e's shapes (64 x 256 x 8 words; 64 250^2
   boards in a 256^2 canvas), one launch of a block's first generation;
   B1's ops at the network's 12 per word, B2's at ``OPS_PER_CELL``.
6. The flag-cost roofline, ``gol_tpu_torch.tools.roofline``, at 16384^2 and
   65536^2: K1, K2 and K14 by CUDA-graph replay and by ``torch.profiler``
   device time, with the counters zeroed before it (K14's launches in the
   kernels line are this path's), and the SM clock nvidia-smi reads right
   after its timings. At each size the tool holds each
   kernel's last timed output and flags against the plain version at
   tolerance 0 and raises on a difference. Its JSON prints on a line of
   its own.

The last lines are the kernel table as one JSON object, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gol_tpu_torch import cli, engine, native, oracle, platform_env
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.io import bitpack, text_grid
from gol_tpu_torch.obs import profiler
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.ops import _build, packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.ops import stencil_batch as sb
from gol_tpu_torch.ops import stencil_pallas as spl
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import make_mesh
from gol_tpu_torch.serve import batcher
from gol_tpu_torch.serve.jobs import new_job
from gol_tpu_torch.tools import roofline

REPO = Path(__file__).resolve().parent
SIZE = 16384
SEED = 20261016
# The card's memory rate and the packed kernels' logic ops per word and
# generation: one copy, the roofline tool's.
HBM_BYTES_PER_S = roofline.HBM_BYTES_PER_S
OPS_PER_WORD_GEN = roofline.OPS_PER_WORD_GEN
# K4, per 4-cell word per generation, from the inner loop of
# csrc/stencil_pallas.cu: the new row's triple sum 8 (two 3-op shifted
# words, two adds), the 3x3 sums 2, two byte compares 7 each, the rule 2,
# the flags 5.
OPS_PER_BYTE_WORD = 31
# (2, 1), (33, 4) and (40, 132): band_kernel's (K3, K5) height 2 and its
# 16-byte form (nwords % 4 == 0) in one lane, a full strip and one lane more.
BAND_SHAPES = [(2, 1), (33, 4), (40, 132)]
PACKED_SHAPES = [(1, 1), (7, 1), (16, 2), (17, 5), (1000, 7), (SIZE, SIZE // 32),
                 *BAND_SHAPES]
BYTE_SHAPES = [(1, 1), (7, 3), (16, 128), (17, 161), (1000, 225), (SIZE, SIZE)]
# Mesh shards: packed (height, nwords) up to the 4x1 shard of 16384^2, and
# byte (height, width) up to its 2x2 shard.
SHARD_SHAPES = [(1, 1), (8, 1), (17, 5), (1000, 7), (SIZE // 4, SIZE // 32),
                *BAND_SHAPES]
SHARD_BYTE_SHAPES = [(1, 1), (7, 3), (17, 161), (SIZE // 2, SIZE // 2)]
# Shards of a mesh with columns, up to the 2x2 shard of 16384^2.
PLANE_SHAPES = [(8, 1), (17, 1), (16, 2), (17, 5), (1000, 7), (SIZE // 2, SIZE // 64)]
# Phase 2 adds the shapes around bandt_kernel's strip (tile_shapes) to
# PACKED_SHAPES, SHARD_SHAPES and PLANE_SHAPES.
# Phase 5's shapes per kernel: the main path's shards.
SHARD_TIMING = {"dist_band": [(SIZE // 4, SIZE // 32), (SIZE // 2, SIZE // 64)],
                "bandtg_fast": [(SIZE // 2, SIZE // 64)],
                "bandtg": [(SIZE // 2, SIZE // 64)],
                "bandtrow_fast": [(SIZE // 4, SIZE // 32)],
                "bandtrow": [(SIZE // 4, SIZE // 32)],
                "dist_byte_band": [(SIZE // 4, SIZE), (SIZE // 2, SIZE // 2)]}
# Kernels timed over a ring of the mesh's shards: their shards together
# exceed the L2 cache, as on the mesh path, where one alone would stay in it.
RING_TIMED = ("dist_band",)
L2_BYTES = 50 << 20  # the H100's L2 cache
KERNELS = [
    {
        "key": "bandt_fast", "id": "K1", "gens": sp.TEMPORAL_GENS,
        "name": "K1 bandt_kernel<SUMMARY>: 8-generation pass, summary flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:584",
        "into": sp._step_t_fast_into, "nflags": sp.SUMMARY_FLAGS,
        "plain": lambda x: sp._bandt_plain(x, exact=False),
    },
    {
        "key": "bandt", "id": "K2", "gens": sp.TEMPORAL_GENS,
        "name": "K2 bandt_kernel<EXACT>: 8-generation pass, exact flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:437",
        "into": sp._step_t_into, "nflags": sp.EXACT_FLAGS,
        "plain": lambda x: sp._bandt_plain(x, exact=True),
    },
    {
        "key": "bandt_noflags", "id": "K14", "gens": sp.TEMPORAL_GENS,
        "name": "K14 bandt_kernel<NONE>: 8-generation pass, no flags "
                "(the flag-cost roofline's)",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "tools/roofline_r4.py:47",
        "into": lambda x, out, flags: sp._step_t_noflags_into(x, out),
        "nflags": 0,
        "plain": lambda x: (sp._bandt_noflags_plain(x),
                            torch.zeros(0, dtype=torch.int32, device=x.device)),
    },
    {
        "key": "band", "id": "K3", "gens": 1,
        "name": "K3 band_kernel: one generation, fused flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:164",
        "into": sp._step_into, "nflags": sp.STEP_FLAGS,
        "plain": sp._band_plain,
    },
    {
        "key": "byte_band", "id": "K4", "gens": 1,
        "name": "K4 byte_step_kernel: one byte-cell generation, fused flags",
        "source": "gol_tpu_torch/csrc/stencil_pallas.cu",
        "replaces": "gol_tpu/ops/stencil_pallas.py:85",
        "into": spl._step_into, "nflags": spl.STEP_FLAGS,
        "plain": spl._band_plain, "cells": True,
    },
    {
        "key": "dist_band", "id": "K5", "gens": 1, "ghosts": "rows",
        "name": "K5 dist_band_kernel: one shard generation from ghost rows "
                "and carry words, fused flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:1540",
        "into": sp._distributed_step_into, "nflags": sp.STEP_FLAGS,
        "plain": sp._dist_band_plain,
    },
    {
        "key": "dist_byte_band", "id": "K6", "gens": 1, "ghosts": "rows",
        "name": "K6 byte_step_kernel<ShardCells>: one byte-cell shard "
                "generation from ghost rows and columns, fused flags",
        "source": "gol_tpu_torch/csrc/stencil_pallas.cu",
        "replaces": "gol_tpu/ops/stencil_pallas.py:180",
        "into": spl._distributed_step_into, "nflags": spl.STEP_FLAGS,
        "plain": spl._dist_band_plain, "cells": True,
    },
    {
        "key": "bandtrow_fast", "id": "K7", "gens": sp.TEMPORAL_GENS,
        "ghosts": "deep",
        "name": "K7 bandt_kernel<SUMMARY, ghost rows>: 8-generation pass of "
                "a full-width shard, summary flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:592",
        "into": sp._step_trow_fast_into, "nflags": sp.SUMMARY_FLAGS,
        "plain": lambda x, gt, gb: sp._bandtrow_plain(x, gt, gb, exact=False),
    },
    {
        "key": "bandtrow", "id": "K8", "gens": sp.TEMPORAL_GENS,
        "ghosts": "deep",
        "name": "K8 bandt_kernel<EXACT, ghost rows>: 8-generation pass of a "
                "full-width shard, exact flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:675",
        "into": sp._step_trow_into, "nflags": sp.EXACT_FLAGS,
        "plain": lambda x, gt, gb: sp._bandtrow_plain(x, gt, gb, exact=True),
    },
    {
        "key": "bandtg_fast", "id": "K9+K10", "gens": sp.TEMPORAL_GENS,
        "ghosts": "plane",
        "name": "K9+K10 bandt_kernel<SUMMARY, ghost plane>: 8-generation pass "
                "of a shard of a mesh with columns, summary flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:1038 (K9), :1086 (K10)",
        "into": sp._step_tg_fast_into, "nflags": sp.SUMMARY_FLAGS,
        "plain": lambda x, *g: sp._bandtg_plain(x, *g, exact=False),
    },
    {
        "key": "bandtg", "id": "K11+K12+K13", "gens": sp.TEMPORAL_GENS,
        "ghosts": "plane",
        "name": "K11+K12+K13 bandt_kernel<EXACT, ghost plane>: 8-generation "
                "pass of a shard of a mesh with columns, exact flags",
        "source": "gol_tpu_torch/csrc/stencil_packed.cu",
        "replaces": "gol_tpu/ops/stencil_packed.py:955 (K11), :868 (K12), "
                    ":490 (K13)",
        "into": sp._step_tg_into, "nflags": sp.EXACT_FLAGS,
        "plain": lambda x, *g: sp._bandtg_plain(x, *g, exact=True),
    },
]
# The batch lane's kernels: port-only rows of the kernel table. The JAX
# package steps a batch with jnp under vmap, no Pallas kernel; the port's
# host loop needs each board's flags out of the step's own pass.
BATCH_KERNELS = [
    {
        "key": "batch_packed", "id": "B1",
        "name": "B1 batch_packed_kernel: one generation of B packed tori, "
                "per-board flags and step counts",
        "source": "gol_tpu_torch/csrc/stencil_batch.cu",
        "replaces": "none: jnp under vmap (gol_tpu/engine.py:1286-1290)",
    },
    {
        "key": "batch_masked", "id": "B2",
        "name": "B2 batch_masked_kernel: one generation of B uint8 boards, "
                "each wrapping at its own extent, per-board flags and step counts",
        "source": "gol_tpu_torch/csrc/stencil_batch.cu",
        "replaces": "none: jnp under vmap (gol_tpu/engine.py:1081-1105)",
        "cells": True,
    },
]
# Phase 2's batch shapes: (boards, height, nwords) for B1 — a 32x32
# one-word board, one-row boards, the serving bucket's 64 x 256^2 — and
# (canvas height, width, extents) for B2: mixed extents in one canvas, the
# exact-fit byte mode, the serving bucket's 64 x 250^2 in 256^2.
BATCH_PACKED_SHAPES = [(3, 32, 1), (2, 1, 1), (4, 17, 5), (64, 256, 8)]
BATCH_MASKED_SHAPES = [(32, 32, [(30, 30), (18, 24), (10, 13), (1, 1)]),
                       (33, 20, [(33, 20)] * 2), (256, 256, [(250, 250)] * 64)]
# Phase 4e: the serving load of bench.py (--suite batch / megabatch): 64
# boards in the exact-fit 256^2 bucket and 64 in the masked 250^2 bucket.
BATCH_BOARDS = 64
BATCH_SIDES = {"256x256/packed": 256, "250x250/masked": 250}
BATCH_LIMITS = (4, 1000)
BATCH_SIZES = (1, 8, 64)
# B2's operations per cell: the 3x3 sum in 4 three-input adds, 2 compares
# and a 3-input logic op for the rule, one for the differs flag and a
# select. Bytes bound it either way.
OPS_PER_CELL = 9
PACKED = [k for k in KERNELS if not k.get("cells") and not k.get("ghosts")]
BYTE = [k for k in KERNELS if k.get("cells") and not k.get("ghosts")]
SHARD = [k for k in KERNELS if k.get("ghosts") in ("rows", "deep")
         and not k.get("cells")]
PLANE = [k for k in KERNELS if k.get("ghosts") == "plane"]
SHARD_BYTE = [k for k in KERNELS if k.get("ghosts") and k.get("cells")]
# The main path's lanes: CLI flags and the kernels each must launch.
LANES = {
    "auto": (["--kernel", "auto"], ("bandt_fast", "bandt", "band")),
    "pallas": (["--kernel", "pallas"], ("byte_band",)),
    "packed_io": (["--packed-io"], ("bandt_fast", "bandt", "band")),
}
# The mesh path's lanes, all under --variant tpu.
MESH_LANES = {
    "4x1 auto": (["--mesh", "4x1", "--kernel", "auto"],
                 ("bandtrow_fast", "bandtrow", "dist_band")),
    "4x1 pallas": (["--mesh", "4x1", "--kernel", "pallas"], ("dist_byte_band",)),
    "2x2 auto": (["--mesh", "2x2", "--kernel", "auto"],
                 ("bandtg_fast", "bandtg", "dist_band")),
    "2x2 packed_io": (["--mesh", "2x2", "--packed-io"],
                      ("bandtg_fast", "bandtg", "dist_band")),
    "2x2 pallas": (["--mesh", "2x2", "--kernel", "pallas"], ("dist_byte_band",)),
}
MESH_DEVICES = "4"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _zero_counters() -> None:
    for counters in (sp.LAUNCHES, spl.LAUNCHES, sb.LAUNCHES):
        for k in counters:
            counters[k] = 0


def _counts() -> dict:
    return {**sp.LAUNCHES, **spl.LAUNCHES, **sb.LAUNCHES}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


# ---------------------------------------------------------------------------
# 1. Card and build


def card_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(_build.build, "stencil_packed"),
                  pool.submit(_build.build, "stencil_pallas"),
                  pool.submit(_build.build, "stencil_batch"),
                  pool.submit(native.load)]
        for b in builds:
            b.result()
    sp.load_kernels()
    spl.load_kernels()
    sb.load_kernels()
    print(f"built and loaded {_build.library_path('stencil_packed').name}, "
          f"{_build.library_path('stencil_pallas').name}, "
          f"{_build.library_path('stencil_batch').name} and the codec in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in ("stencil_packed", "stencil_pallas", "stencil_batch"):
        print(_build.build_log(name).rstrip())
    return smi


# ---------------------------------------------------------------------------
# 2. Kernels against their plain versions


def _pattern(height: int, width: int, cells) -> np.ndarray:
    g = np.zeros((height, width), np.uint8)
    for r, c in cells:
        g[r % height, c % width] = 1
    return g


def _cell_inputs(height: int, width: int, rng) -> dict:
    domino = _pattern(height, width, [(height // 2, width // 2),
                                      (height // 2, width // 2 + 1)])
    tromino = _pattern(height, width, [(-1, -1), (0, -1), (-1, 0)])
    return {
        "random": (rng.random((height, width), dtype=np.float32) < 0.5).astype(np.uint8),
        "dies": domino,
        "becomes_still": tromino,
    }


def _ghosts(k: dict, x: torch.Tensor, rng) -> list:
    """Random ghosts of the shapes a shard kernel takes, every bit random."""
    height, n = x.shape
    T = sp.TEMPORAL_GENS
    shapes = {"rows": [(1, n), (1, n), (height + 2,), (height + 2,)],
              "deep": [(T, n)] * 2,
              "plane": [(T, n)] * 2 + [(height + 2 * T,)] * 2}[k["ghosts"]]
    if k.get("cells"):
        return [torch.from_numpy(rng.integers(0, 2, s, dtype=np.uint8)).to(x.device)
                for s in shapes]
    return [pm.words_from_numpy(rng.integers(0, 2**32, s, dtype=np.uint64)
                                .astype(np.uint32), x.device) for s in shapes]


def _torus_ghosts(k: dict, x: torch.Tensor) -> list:
    """The ghosts a one-shard torus exchanges: the shard's own far edges."""
    if k["ghosts"] == "deep":
        return list(sp.exchange_packed_deep([x], (1, 1))[0])
    if k["ghosts"] == "plane":
        return list(sp.deep_ghost_operands([x], (1, 1))[0])
    if k.get("cells"):
        return list(halo.exchange_parts([x], (1, 1))[0])
    return list(sp.exchange_packed([x], (1, 1))[0])


def _compare(k: dict, x: torch.Tensor, stats: dict, where: str,
             ghosts=()) -> None:
    dev = x.device
    out = torch.empty_like(x)
    flags = torch.zeros(k["nflags"], dtype=torch.int32, device=dev)
    k["into"](x, *ghosts, out, flags)
    want, want_flags = k["plain"](x, *ghosts)
    torch.cuda.synchronize(dev)
    err = int((_u32(out) - _u32(want)).abs().max())
    if flags.numel():
        err = max(err, int((flags - want_flags).abs().max()))
    s = stats[k["key"]]
    s["max_abs_err"] = max(s["max_abs_err"], err)
    s["checks"] += 1
    if err:
        fail(f"{k['id']} differs from its plain version at {where}: "
             f"{flags.tolist()} vs {want_flags.tolist()}")


def tile_shapes() -> list:
    """(height, nwords) around bandt_kernel's tile, read from the built
    library: a strip of TW = 30 interior words per warp, split into bands
    of at least TH rows: heights TH - 1, TH and TH + 1 (one band) and 2 TH
    + 17 (two, ragged); nwords 1, 2, 31, 61 and TW + 7 (none a multiple
    of TW)."""
    th, tw, _ = sp.bandt_tile()
    return [(th - 1, 1), (th + 1, 2), (2 * th + 17, 31), (th, 61),
            (th + 1, tw + 7)]


def check_kernels(dev, stats: dict) -> None:
    rng = np.random.default_rng(SEED)
    for height, nwords in PACKED_SHAPES + tile_shapes():
        for name, cells in _cell_inputs(height, 32 * nwords, rng).items():
            x = pm.encode(torch.from_numpy(cells).to(dev))
            for k in PACKED:
                _compare(k, x, stats, f"({height}, {nwords}) on {name}")
        print(f"(height, nwords) ({height}, {nwords}): "
              f"{' '.join(k['id'] for k in PACKED)} == plain on random, dies, "
              "becomes_still (tolerance 0: words and flags identical)", flush=True)
    for height, width in BYTE_SHAPES:
        for name, cells in _cell_inputs(height, width, rng).items():
            x = torch.from_numpy(cells).to(dev)
            for k in BYTE:
                _compare(k, x, stats, f"({height}, {width}) on {name}")
        print(f"(height, width) ({height}, {width}): K4 == plain on random, "
              "dies, becomes_still (tolerance 0: cells and flags identical)",
              flush=True)
    for kernels, shapes, to_state in ((SHARD, SHARD_SHAPES + tile_shapes(), pm.encode),
                                      (SHARD_BYTE, SHARD_BYTE_SHAPES, lambda t: t),
                                      (PLANE, PLANE_SHAPES + tile_shapes(), pm.encode)):
        for height, n in shapes:
            width = n if kernels is SHARD_BYTE else 32 * n
            checked = [k for k in kernels if k["ghosts"] != "deep"
                       or height >= sp.TEMPORAL_GENS]
            for name, cells in _cell_inputs(height, width, rng).items():
                x = to_state(torch.from_numpy(cells).to(dev))
                for k in checked:
                    ghosts = (_ghosts(k, x, rng) if name == "random"
                              else _torus_ghosts(k, x))
                    _compare(k, x, stats, f"({height}, {n}) on {name}", ghosts)
            print(f"shard ({height}, {n}): "
                  f"{' '.join(k['id'] for k in checked)} == plain on random "
                  "(random ghosts), dies, becomes_still (torus ghosts) "
                  "(tolerance 0: state and flags identical)", flush=True)


def _batch_board(height, width, kind, rng) -> np.ndarray:
    if kind == "random":
        return (rng.random((height, width), dtype=np.float32) < 0.5).astype(np.uint8)
    if kind == "dies":
        return _pattern(height, width, [(height // 2, width // 2)])
    return _pattern(height, width, [(0, 0), (0, 1), (1, 0), (1, 1)])  # a block


def _batch_steps(batch: int, dev) -> torch.Tensor:
    """Step counts of a block: even boards 3, odd boards 1 (spent at gen 2,
    so copied through), the last 0 (a padding slot)."""
    steps = [3 if b % 2 == 0 else 1 for b in range(batch)]
    steps[-1] = 0
    return torch.tensor(steps, dtype=torch.int32, device=dev)


def _compare_batch(key: str, launch, plain, x, stats: dict, where: str) -> None:
    """One launch of B1/B2 against its plain version at generation 0 and 2
    of a block: state and per-board flags identical."""
    for gen in (0, 2):
        out = torch.empty_like(x)
        flags = torch.zeros((x.shape[0], sb.STEP_FLAGS), dtype=torch.int32,
                            device=x.device)
        launch(x, out, flags, gen)
        want, want_flags = plain(x, gen)
        torch.cuda.synchronize(x.device)
        err = max(int((_u32(out.to(torch.int32)) - _u32(want.to(torch.int32))).abs().max()),
                  int((flags - want_flags).abs().max()))
        stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
        stats[key]["checks"] += 1
        if err:
            fail(f"{key} differs from its plain version at {where}, gen {gen}")


def check_batch_kernels(dev, stats: dict) -> None:
    """B1 and B2 against their plain versions: boards of several fates in
    one stack, per-board step counts (spent boards copy through, a padding
    slot never runs), B2's mixed extents in one canvas and its byte mode."""
    rng = np.random.default_rng(SEED + 4)
    kinds = ("random", "dies", "still")
    for batch, height, nwords in BATCH_PACKED_SHAPES:
        boards = np.stack([_batch_board(height, 32 * nwords, kinds[b % 3], rng)
                           for b in range(batch)])
        x = pm.words_from_numpy(bitpack.pack_words(boards), dev)
        steps = _batch_steps(batch, dev)
        _compare_batch(
            "batch_packed",
            lambda a, out, flags, gen: sb.batch_packed_step_into(a, out, flags, steps, gen),
            lambda a, gen: sb._batch_packed_plain(a, steps, gen),
            x, stats, f"({batch}, {height}, {nwords})")
        print(f"B1 at (boards, height, nwords) ({batch}, {height}, {nwords}) "
              "== plain at gen 0 and 2 (random, dies, still; steps 3/1/0) "
              "(tolerance 0: words and flags identical)", flush=True)
    for height, width, extents in BATCH_MASKED_SHAPES:
        batch = len(extents)
        canvas = np.zeros((batch, height, width), np.uint8)
        for b, (h, w) in enumerate(extents):
            canvas[b, :h, :w] = _batch_board(h, w, kinds[b % 3], rng)
        x = torch.from_numpy(canvas).to(dev)
        hs = torch.tensor([h for h, _ in extents], dtype=torch.int32, device=dev)
        ws = torch.tensor([w for _, w in extents], dtype=torch.int32, device=dev)
        steps = _batch_steps(batch, dev)
        _compare_batch(
            "batch_masked",
            lambda a, out, flags, gen: sb.batch_masked_step_into(
                a, out, flags, steps, hs, ws, gen),
            lambda a, gen: sb._batch_masked_plain(a, steps, hs, ws, gen),
            x, stats, f"{height}x{width} canvas, extents {sorted(set(extents))}")
        print(f"B2 at a {batch} x {height}x{width} canvas, extents "
              f"{sorted(set(extents))} == plain at gen 0 and 2 (tolerance 0: "
              "cells and flags identical)", flush=True)


# ---------------------------------------------------------------------------
# 3. Small flows through `python -m gol_tpu_torch`

_MS = re.compile(r"\d+\.\d+ msecs")


def _flows() -> dict:
    rng = np.random.default_rng(SEED + 1)
    flows = {}
    for n in (48, 64):
        flows[f"random{n}"] = (rng.random((n, n)) < 0.5).astype(np.uint8)
        flows[f"block{n}"] = _pattern(n, n, [(3, 3), (3, 4), (4, 3), (4, 4)])
        flows[f"lone{n}"] = _pattern(n, n, [(10, n - 8)])
        flows[f"dead{n}"] = np.zeros((n, n), np.uint8)
    return flows


def _expect_oracle(grid, convention, out: Path, limit: int = 1000):
    want = oracle.run(grid, GameConfig(convention=convention, gen_limit=limit))

    def check(stdout: str) -> str:
        gens = int(re.search(r"Generations:\t(\d+)", stdout).group(1))
        if gens != want.generations or out.read_bytes() != text_grid.encode(want.grid):
            raise AssertionError(f"generations {gens} vs oracle "
                                 f"{want.generations}, or output bytes differ")
        return f"Generations {gens} == oracle, output bytes == oracle"

    return check


def _flow_jobs(work: Path) -> list:
    """(label, argv, cwd, check) per process; ``check(stdout)`` returns
    what it verified or raises AssertionError."""
    flows = _flows()
    jobs = []
    for name, grid in flows.items():
        n = grid.shape[0]
        inp = work / f"{name}.txt"
        text_grid.write_grid(str(inp), grid)
        lanes = [("auto", ["--kernel", "auto"]), ("pallas", ["--kernel", "pallas"])]
        if n == 64:
            lanes.append(("packed_io", ["--packed-io"]))
        else:
            lanes.append(("host", ["--host"]))
        for variant in ("game", "cuda"):
            convention = Convention.CUDA if variant == "cuda" else Convention.C
            for lane, flags in lanes:
                out = work / f"{name}.{variant}.{lane}.out"
                jobs.append((f"{name:8s} --variant {variant:4s} {lane:9s}",
                             [str(n), str(n), str(inp), "--variant", variant,
                              *flags, "--output", str(out)],
                             work, _expect_oracle(grid, convention, out)))
    random48 = flows["random48"]
    for variant in ("mpi", "collective", "async", "openmp"):
        cwd = work / variant
        cwd.mkdir()
        lines = ["Reading file:\tX msecs", "Generations:\t1000",
                 "Execution time:\tX msecs", "Writing file:\tX msecs"]
        if variant != "openmp":
            lines.append("Finished")
        check_bytes = _expect_oracle(random48, Convention.C,
                                     cwd / f"{variant}_output.out")

        def check(stdout, lines=lines, check_bytes=check_bytes):
            if _MS.sub("X msecs", stdout).splitlines() != lines:
                raise AssertionError(f"printed lines {stdout!r}, want {lines}")
            return f"{check_bytes(stdout)}, printed lines as expected"

        jobs.append((f"random48 --variant {variant}", ["48", "48",
                     str(work / "random48.txt"), "--variant", variant], cwd, check))
    return jobs


def _run_jobs(jobs: list, env: dict) -> None:
    def run(job):
        label, argv, cwd, check = job
        proc = subprocess.run([sys.executable, "-m", "gol_tpu_torch", *argv],
                              cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            return label, f"exited {proc.returncode}:\n{proc.stderr}", False
        try:
            return label, check(proc.stdout), True
        except (AssertionError, AttributeError) as e:
            return label, str(e), False

    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as pool:
        for label, msg, ok in pool.map(run, jobs):
            if not ok:
                fail(f"python -m gol_tpu_torch {label}: {msg}")
            print(f"{label}: {msg}", flush=True)


def _snapshot_and_resume(work: Path, env: dict, lane=("--variant", "game"),
                         resume_lane=("--kernel", "pallas")) -> None:
    """--snapshot-every 100 on random64 under ``lane``, then --resume-gen
    300 from its gen_000300.out under ``lane`` and ``resume_lane``, against
    the whole run."""
    grid = _flows()["random64"]
    inp, snaps = work / "random64.txt", work / ("snaps" + "".join(lane))
    whole = oracle.run(grid, GameConfig())
    run = lambda argv: subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *argv], cwd=work, env=env,
        capture_output=True, text=True, timeout=300)
    proc = run(["64", "64", str(inp), *lane, "--snapshot-every",
                "100", "--snapshot-dir", str(snaps), "--output",
                str(work / "snap_whole.out")])
    if proc.returncode != 0:
        fail(f"{' '.join(lane)} --snapshot-every 100 exited "
             f"{proc.returncode}:\n{proc.stderr}")
    names = sorted(p.name for p in snaps.iterdir())
    want_names = [f"gen_{g:06d}.out" for g in range(100, whole.generations + 1, 100)]
    if names != want_names:
        fail(f"--snapshot-every 100 wrote {names}, want {want_names}")
    for name in names:
        gens = int(name[4:10])
        state = oracle.run(grid, GameConfig(gen_limit=gens)).grid
        if (snaps / name).read_bytes() != text_grid.encode(state):
            fail(f"snapshot {name} differs from the oracle's generation {gens}")
    if (work / "snap_whole.out").read_bytes() != text_grid.encode(whole.grid):
        fail("--snapshot-every 100: final output differs from the oracle")
    print(f"{' '.join(lane)} --snapshot-every 100: {len(names)} snapshots "
          f"{names[0]}..{names[-1]}, each == the oracle's state at its "
          "generation", flush=True)
    proc = run(["64", "64", str(snaps / "gen_000300.out"), *lane,
                *resume_lane, "--resume-gen", "300", "--output",
                str(work / "resumed.out")])
    gens = re.search(r"Generations:\t(\d+)", proc.stdout)
    if (proc.returncode != 0 or not gens or int(gens.group(1)) != whole.generations
            or (work / "resumed.out").read_bytes() != text_grid.encode(whole.grid)):
        fail(f"--resume-gen 300 differs from the whole run:\n{proc.stdout}{proc.stderr}")
    print(f"{' '.join(lane + resume_lane)} --resume-gen 300 from "
          f"gen_000300.out: Generations {gens.group(1)}, bytes == the whole run",
          flush=True)


def _subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def small_flows(work: Path) -> None:
    env = _subprocess_env()
    _run_jobs(_flow_jobs(work), env)
    _snapshot_and_resume(work, env)


def _cli_capture(args: list[str]) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def mesh_flows(work: Path) -> dict:
    """The eight flows over four shards on the card, in this process: every
    distributed variant, --mesh 4x1 and 2x2 with --kernel auto, pallas and
    lax, --mesh 1x4 with auto, and the 64^2 flows with --packed-io on 4x1
    and 2x2. Then the one-word shards of 64^2 under --mesh 2x2, and
    snapshots and resume under --mesh 2x2 (subprocesses). Returns the
    launch counts of the one-word-shard runs."""
    out = work / "mesh.out"
    lanes = [(mesh, ["--kernel", kernel]) for mesh in ("4x1", "2x2")
             for kernel in ("auto", "pallas", "lax")] + [("1x4", ["--kernel", "auto"])]
    packed_lanes = [("4x1", ["--packed-io"]), ("2x2", ["--packed-io"])]
    for name, grid in _flows().items():
        n = grid.shape[0]
        want = oracle.run(grid, GameConfig())
        want_bytes = text_grid.encode(want.grid)
        for variant in ("tpu", "collective", "async", "openmp", "mpi"):
            lines = ["Reading file:\tX msecs", f"Generations:\t{want.generations}",
                     "Execution time:\tX msecs", "Writing file:\tX msecs"]
            if variant != "openmp":
                lines.append("Finished")
            runs = 0
            for mesh, flags in lanes + (packed_lanes if n == 64 else []):
                rc, text = _cli_capture([str(n), str(n), str(work / f"{name}.txt"),
                                         "--variant", variant, "--mesh", mesh,
                                         *flags, "--output", str(out)])
                label = f"{name} --variant {variant} --mesh {mesh} {' '.join(flags)}"
                if rc != 0:
                    fail(f"{label} exited {rc}")
                if _MS.sub("X msecs", text).splitlines() != lines:
                    fail(f"{label}: printed {text!r}, want {lines}")
                if out.read_bytes() != want_bytes:
                    fail(f"{label}: output bytes differ from the oracle")
                runs += 1
            print(f"{name:8s} --variant {variant:10s}: {runs} mesh runs (4x1, 2x2 x "
                  f"auto, pallas, lax; 1x4 auto"
                  f"{'; 4x1, 2x2 packed-io' if n == 64 else ''}): Generations "
                  f"{want.generations}, bytes and printed lines == oracle",
                  flush=True)

    # 64^2 under --mesh 2x2: 32x32 shards, one word wide. The pass summary of
    # a grid that becomes still or dies inside a pass must replay the exact
    # ghost-plane form there too.
    _zero_counters()
    for name, cells in (("tromino64", TROMINO), ("lone64", [(10, 56)])):
        grid = _pattern(64, 64, cells)
        text_grid.write_grid(str(work / f"{name}.txt"), grid)
        want = oracle.run(grid, GameConfig())
        gens, _, _ = _cli(["64", "64", str(work / f"{name}.txt"), "--variant", "tpu",
                           "--mesh", "2x2", "--output", str(out)])
        if gens != want.generations or out.read_bytes() != text_grid.encode(want.grid):
            fail(f"{name} --variant tpu --mesh 2x2: Generations {gens} or bytes "
                 f"differ from the oracle ({want.generations})")
    counts = _counts()
    print(f"one-word shards (64x64, --mesh 2x2, becomes still and dies): "
          f"Generations and bytes == oracle, launches {_nonzero(counts)}", flush=True)
    _check_launches(counts, ("bandtg_fast", "bandtg"),
                    "64x64 --mesh 2x2 (one-word shards)")

    env = _subprocess_env()
    for lane in (("--variant", "tpu", "--mesh", "2x2"),
                 ("--variant", "tpu", "--mesh", "2x2", "--packed-io")):
        _snapshot_and_resume(work, env, lane, resume_lane=())
    return counts


# ---------------------------------------------------------------------------
# 3c. The checkpoint lane at 64^2

_RESTORED = re.compile(r"restored checkpoint at generation (\d+)")
CKPT_LANES = [("game", ["--kernel", "auto"]), ("game", ["--kernel", "pallas"]),
              ("game", ["--packed-io"]), ("cuda", ["--kernel", "auto"]),
              ("cuda", ["--kernel", "pallas"]), ("cuda", ["--packed-io"]),
              ("tpu", ["--mesh", "2x2"])]
CKPT_EVERY, CKPT_KILL_AT = 100, 300


def _manifests(ckdir: Path) -> list[str]:
    return sorted(p.name for p in ckdir.glob("*.manifest.json"))


def checkpoint_flows(work: Path) -> None:
    """Phase 3c: every lane of CKPT_LANES with the async and the sync
    writer, against the oracle: a run checkpointed every CKPT_EVERY
    generations and, from a directory of its own, a run SIGKILLed at
    CKPT_KILL_AT and its --auto-resume. The kills are subprocesses, all in
    parallel (a real SIGKILL needs a process of its own); the other runs go
    through ``cli.main`` in this process."""
    grid = _flows()["random64"]
    inp, n = work / "random64.txt", grid.shape[0]
    every, kill_at = CKPT_EVERY, CKPT_KILL_AT
    chains = []
    for variant, flags in CKPT_LANES:
        convention = Convention.CUDA if variant == "cuda" else Convention.C
        want = oracle.run(grid, GameConfig(convention=convention))
        for writer in ([], ["--sync-checkpoints"]):
            tag = "_".join([variant, *flags, *writer]).replace("-", "")
            chains.append({
                "label": " ".join(["--variant", variant, *flags, *writer]),
                "argv": [str(n), str(n), str(inp), "--variant", variant, *flags,
                         *writer, "--checkpoint-every", str(every),
                         "--output", str(work / f"ck_{tag}.out")],
                "out": work / f"ck_{tag}.out", "ckdir": work / f"ck_{tag}",
                "want": want, "last": (want.generations - 1) // every * every,
            })

    def in_process(chain, ckdir, extra=()) -> str:
        """One checkpointed run in this process, against the oracle: its
        stderr (the restore notice)."""
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, text = _cli_capture([*chain["argv"], "--checkpoint-dir",
                                     str(ckdir), *extra])
        want = chain["want"]
        gens = re.search(r"Generations:\t(\d+)", text)
        if (rc != 0 or not gens or int(gens.group(1)) != want.generations
                or chain["out"].read_bytes() != text_grid.encode(want.grid)):
            fail(f"random64 {chain['label']} {' '.join(extra)}: rc {rc}, "
                 f"{text!r} {err.getvalue()[-2000:]}")
        chain["out"].unlink()
        return err.getvalue()

    for chain in chains:
        full = work / f"full_{chain['ckdir'].name}"
        in_process(chain, full)
        kept = _manifests(full)
        if kept != [f"ckpt-{g:08d}.manifest.json"
                    for g in (chain["last"] - every, chain["last"])]:
            fail(f"random64 {chain['label']}: --checkpoint-every {every} kept {kept}")

    def kill(chain):
        return subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", *chain["argv"],
             "--checkpoint-dir", str(chain["ckdir"])], cwd=work,
            env={**_subprocess_env(),
                 "GOL_FAULTS": f"kill_at_gen={kill_at},kill_mode=sigkill"},
            capture_output=True, text=True, timeout=300)

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(chains)) as pool:
        killed = list(pool.map(kill, chains))
    for chain, proc in zip(chains, killed):
        newest = _manifests(chain["ckdir"])
        if (proc.returncode != -signal.SIGKILL or chain["out"].exists()
                or newest[-1:] != [f"ckpt-{kill_at - every:08d}.manifest.json"]):
            fail(f"random64 {chain['label']}: the SIGKILL run exited "
                 f"{proc.returncode} with manifests {newest}: {proc.stderr[-2000:]}")
        restored = _RESTORED.search(in_process(chain, chain["ckdir"], ["--auto-resume"]))
        if not restored or int(restored.group(1)) != kill_at - every:
            fail(f"random64 {chain['label']}: --auto-resume did not restore "
                 f"generation {kill_at - every}")
        print(f"random64 {chain['label']}: checkpointed run (kept {chain['last'] - every} "
              f"and {chain['last']}), SIGKILL at {kill_at} (newest manifest "
              f"{newest[-1]}), --auto-resume from {restored.group(1)}: "
              f"Generations {chain['want'].generations}, bytes == oracle", flush=True)


# ---------------------------------------------------------------------------
# 4. The main path at 16384^2


def _cli(args: list[str]) -> tuple[int, float, str]:
    rc, text = _cli_capture(args)
    if rc != 0:
        fail(f"gol_tpu_torch {' '.join(args)} exited {rc}:\n{text}")
    gens = int(re.search(r"Generations:\t(\d+)", text).group(1))
    exec_ms = float(re.search(r"Execution time:\t([0-9.]+) msecs", text).group(1))
    return gens, exec_ms, text


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


# Small patterns as (row, col) offsets from an anchor: the grid's middle, or
# its (0, 0) corner, where negative offsets wrap across the torus seam.
TROMINO = [(-1, -1), (0, -1), (-1, 0)]
DIAGONAL = [(-1, -1), (0, 0), (1, 1)]


def _live_offsets(grid: np.ndarray, anchor) -> set:
    h, w = grid.shape
    return {(((r - anchor[0] + h // 2) % h) - h // 2,
             ((c - anchor[1] + w // 2) % w) - w // 2)
            for r, c in np.argwhere(grid)}


def main_path(work: Path, dev) -> dict:
    inputs = {"random": work / "random.txt"}
    t0 = time.perf_counter()
    text_grid.generate_to_file(str(inputs["random"]), SIZE, SIZE, seed=SEED)
    patterns = {}
    for pname, cells in (("tromino", TROMINO), ("diagonal", DIAGONAL)):
        for where, anchor in (("mid", (SIZE // 2, SIZE // 2)), ("corner", (0, 0))):
            key = f"{pname}_{where}"
            patterns[key] = (cells, anchor)
            inputs[key] = work / f"{key}.txt"
            text_grid.write_grid(str(inputs[key]), _pattern(
                SIZE, SIZE, [(anchor[0] + r, anchor[1] + c) for r, c in cells]))
    print(f"wrote {len(inputs)} {SIZE}x{SIZE} inputs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    runs = [("a", "random", 1000), ("b", "random", 1003)] + [
        (tag, key, 1000) for tag, key in
        (("c", "tromino_mid"), ("c", "tromino_corner"),
         ("d", "diagonal_mid"), ("d", "diagonal_corner"))]
    out = work / "out.txt"

    def run(variant, flags, key, limit):
        gens, ms, _ = _cli([str(SIZE), str(SIZE), str(inputs[key]),
                            "--variant", variant, *flags,
                            "--gen-limit", str(limit), "--output", str(out)])
        return gens, ms

    # Warm the process at full size (allocator, first launches) with one
    # uncounted run (a) per lane; each lane's run (a) is timed after it, as
    # the CLI's --warmup would time it.
    for lane, (flags, _) in LANES.items():
        gens, ms = run("game", flags, "random", 1000)
        print(f"warm-up (uncounted): game {lane} random limit 1000: "
              f"Generations {gens}, Execution {ms:.3f} ms", flush=True)
    results, run_a, by_path = {}, {}, {}
    for variant in ("game", "cuda"):
        for lane, (flags, needed) in LANES.items():
            _zero_counters()
            for tag, key, limit in runs:
                before = _counts()
                if tag == "a":
                    torch.cuda.reset_peak_memory_stats(dev)
                gens, ms = run(variant, flags, key, limit)
                launched = {k: n - before[k] for k, n in _counts().items()}
                if tag == "a":
                    run_a[f"{variant} {lane}"] = {
                        "generations": gens, "exec_ms": ms,
                        "cell_updates_per_s": SIZE * SIZE * gens / (ms / 1000),
                        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                        "launches": launched,
                    }
                got = (gens, _digest(out))
                if lane == "auto":
                    results[(variant, key, limit)] = got
                elif got != results[(variant, key, limit)]:
                    fail(f"({tag}) {variant} {key}: {lane} (Generations {gens}) "
                         f"differs from --kernel auto "
                         f"({results[(variant, key, limit)][0]})")
                print(f"({tag}) {variant:4s} {key:15s} limit {limit}: {lane:9s} "
                      f"Generations {gens}, Execution {ms:.3f} ms, launches "
                      f"{_nonzero(launched)}"
                      + ("" if lane == "auto" else ", bytes == auto"), flush=True)
                if lane == "auto" and key in patterns:
                    cells, anchor = patterns[key]
                    convention = Convention.CUDA if variant == "cuda" else Convention.C
                    small_anchor = (32, 32) if key.endswith("mid") else (0, 0)
                    small = _pattern(64, 64, [(small_anchor[0] + r, small_anchor[1] + c)
                                              for r, c in cells])
                    want = oracle.run(small, GameConfig(convention=convention,
                                                        gen_limit=limit))
                    got_grid = text_grid.read_grid(str(out), SIZE, SIZE)
                    if (gens != want.generations or _live_offsets(got_grid, anchor)
                            != _live_offsets(want.grid, small_anchor)):
                        fail(f"{variant} {key}: Generations {gens} / live cells "
                             f"differ from the oracle's 64x64 copy "
                             f"({want.generations})")
            by_path[f"{variant} {lane}"] = _counts()
            print(f"main path, --variant {variant} {lane} (its six runs): "
                  f"launches {_nonzero(by_path[f'{variant} {lane}'])}", flush=True)
            _check_launches(by_path[f"{variant} {lane}"], needed,
                            f"--variant {variant} {lane}")

    for variant in ("game", "cuda"):
        for tag, key, limit in runs:
            gens, ms = run(variant, ["--kernel", "lax"], key, limit)
            if (gens, _digest(out)) != results[(variant, key, limit)]:
                fail(f"({tag}) {variant} {key}: --kernel lax (Generations "
                     f"{gens}) differs from --kernel auto "
                     f"({results[(variant, key, limit)][0]})")
            print(f"({tag}) {variant:4s} {key:15s} limit {limit}: lax       "
                  f"Generations {gens}, Execution {ms:.3f} ms: bytes == auto",
                  flush=True)
    print("run (a) Execution time, ms: " + ", ".join(
        f"{path} {r['exec_ms']:.3f}" for path, r in run_a.items()), flush=True)
    return {"launches": by_path, "run_a": run_a, "inputs": inputs,
            "results": results, "patterns": patterns, "runs": runs}


def _check_launches(counts: dict, needed, where: str) -> None:
    for k in KERNELS:
        n = counts[k["key"]]
        if (k["key"] in needed) != (n > 0):
            fail(f"{k['id']} ({k['key']}) launched {n} times on the {where} path")


def mesh_path(work: Path, dev, path: dict) -> dict:
    """--variant tpu over four shards at 16384^2, against the single-device
    --kernel auto runs of main_path; then the CUDA convention's empty exit
    on a 4x1 and a 2x2 mesh through the engine."""
    inputs, results, runs = path["inputs"], path["results"], path["runs"]
    out = work / "out.txt"

    def run(flags, key, limit):
        gens, ms, _ = _cli([str(SIZE), str(SIZE), str(inputs[key]), "--variant",
                            "tpu", *flags, "--gen-limit", str(limit),
                            "--output", str(out)])
        return gens, ms

    for lane, (flags, _) in MESH_LANES.items():
        gens, ms = run(flags, "random", 1000)
        print(f"warm-up (uncounted): tpu {lane} random limit 1000: "
              f"Generations {gens}, Execution {ms:.3f} ms", flush=True)
    by_path, run_a = {}, {}
    for lane, (flags, needed) in MESH_LANES.items():
        _zero_counters()
        for tag, key, limit in runs:
            before = _counts()
            if tag == "a":
                torch.cuda.reset_peak_memory_stats(dev)
            gens, ms = run(flags, key, limit)
            launched = {k: n - before[k] for k, n in _counts().items()}
            if tag == "a":
                run_a[f"tpu {lane}"] = {
                    "generations": gens, "exec_ms": ms,
                    "cell_updates_per_s": SIZE * SIZE * gens / (ms / 1000),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                    "launches": launched,
                }
            if (gens, _digest(out)) != results[("game", key, limit)]:
                fail(f"({tag}) tpu {lane} {key}: Generations {gens} or bytes differ "
                     f"from single-device --kernel auto "
                     f"({results[('game', key, limit)][0]})")
            print(f"({tag}) tpu  {key:15s} limit {limit}: {lane:13s} Generations "
                  f"{gens}, Execution {ms:.3f} ms, launches {_nonzero(launched)}, "
                  "bytes == single-device auto", flush=True)
        by_path[f"tpu {lane}"] = _counts()
        print(f"mesh path, --variant tpu {lane} (its six runs): launches "
              f"{_nonzero(by_path[f'tpu {lane}'])}", flush=True)
        _check_launches(by_path[f"tpu {lane}"], needed, f"--variant tpu {lane}")

    # The CUDA convention's empty exit (d) replays K5 from the block's start
    # on every shard; only the engine reaches it on a mesh (the cuda variant
    # is single-device).
    config = GameConfig(convention=Convention.CUDA)
    for rows, cols in ((4, 1), (2, 2)):
        mesh, where = make_mesh(rows, cols), f"cuda {rows}x{cols} auto engine (d)"
        _zero_counters()
        for key in ("diagonal_mid", "diagonal_corner"):
            cells, anchor = path["patterns"][key]
            grid = _pattern(SIZE, SIZE, [(anchor[0] + r, anchor[1] + c)
                                         for r, c in cells])
            got = engine.simulate(grid, config, mesh=mesh)
            small_anchor = (32, 32) if key.endswith("mid") else (0, 0)
            want = oracle.run(_pattern(64, 64, [(small_anchor[0] + r, small_anchor[1] + c)
                                                for r, c in cells]), config)
            if (got.generations != results[("cuda", key, 1000)][0]
                    or got.generations != want.generations
                    or _live_offsets(got.grid, anchor)
                    != _live_offsets(want.grid, small_anchor)):
                fail(f"engine {where} {key}: Generations {got.generations} or live "
                     f"cells differ from the oracle's 64x64 copy "
                     f"({want.generations})")
            print(f"(d) engine, cuda convention, {rows}x{cols} auto {key}: "
                  f"Generations {got.generations}, live cells == the oracle's "
                  "64x64 copy", flush=True)
        by_path[where] = _counts()
        print(f"mesh path, engine {where}: launches {_nonzero(by_path[where])}",
              flush=True)
        if by_path[where]["dist_band"] == 0:
            fail(f"the empty-exit replay on the {rows}x{cols} mesh launched no K5")
    print("mesh run (a) Execution time, ms: " + ", ".join(
        f"{p} {r['exec_ms']:.3f}" for p, r in run_a.items()), flush=True)
    return {"launches": by_path, "run_a": run_a}


def checkpoint_path(work: Path, path: dict) -> dict:
    """Phase 4c: run (a) under --variant game --checkpoint-every 250, async
    and sync, then a SIGKILL at 500 and --auto-resume: every output equal
    to phase 4's run (a)."""
    inp, out = path["inputs"]["random"], work / "out.txt"
    want = path["results"][("game", "random", 1000)]
    base = [str(SIZE), str(SIZE), str(inp), "--variant", "game",
            "--gen-limit", "1000", "--checkpoint-every", "250", "--output", str(out)]
    runs, by_path = {}, {}
    reg = obs_registry.default()
    for name, extra in (("async", []), ("sync", ["--sync-checkpoints"])):
        ckdir = work / f"ck4c_{name}"
        before = {k: reg.counter(k) for k in (
            "checkpoint_saves_total", "pipeline_stalls_total",
            "checkpoint_write_hidden_seconds")}
        _zero_counters()
        gens, ms, _ = _cli([*base, *extra, "--checkpoint-dir", str(ckdir)])
        by_path[f"game auto checkpoint {name}"] = _counts()
        if by_path[f"game auto checkpoint {name}"]["bandt_fast"] == 0:
            fail(f"--checkpoint-every 250 ({name}) launched no K1")
        if (gens, _digest(out)) != want:
            fail(f"--checkpoint-every 250 ({name}): Generations {gens} or bytes "
                 f"differ from phase 4's run (a)")
        kept = _manifests(ckdir)
        if kept != ["ckpt-00000500.manifest.json", "ckpt-00000750.manifest.json"]:
            fail(f"--checkpoint-every 250 ({name}) kept {kept}")
        runs[name] = {"exec_ms": ms, **{k: reg.counter(k) - v
                                        for k, v in before.items()}}
        print(f"(a) game --checkpoint-every 250, {name} writer: Generations {gens}, "
              f"Execution {ms:.3f} ms, {runs[name]}, bytes == run (a)", flush=True)
        shutil.rmtree(ckdir)
    ckdir = work / "ck4c_kill"
    out.unlink()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *base, "--checkpoint-dir",
         str(ckdir)], cwd=work, capture_output=True, text=True, timeout=600,
        env={**_subprocess_env(), "GOL_FAULTS": "kill_at_gen=500,kill_mode=sigkill"})
    kept = _manifests(ckdir)
    if proc.returncode != -signal.SIGKILL or out.exists() or kept != [
            "ckpt-00000250.manifest.json"]:
        fail(f"the 16384^2 SIGKILL run exited {proc.returncode} with manifests "
             f"{kept}: {proc.stderr[-2000:]}")
    print(f"(a) game --checkpoint-every 250 SIGKILLed at 500 after "
          f"{time.perf_counter() - t0:.1f} s: manifests {kept}", flush=True)
    _zero_counters()
    gens, ms, _ = _cli([*base, "--checkpoint-dir", str(ckdir), "--auto-resume"])
    by_path["game auto checkpoint resumed"] = _counts()
    if (gens, _digest(out)) != want:
        fail(f"--auto-resume at {SIZE}^2: Generations {gens} or bytes differ from "
             "phase 4's run (a)")
    runs["resumed from 250"] = {"exec_ms": ms}
    print(f"(a) game --auto-resume from generation 250: Generations {gens}, "
          f"Execution {ms:.3f} ms, bytes == run (a)", flush=True)
    runs["phase 4 run (a)"] = {"exec_ms": path["run_a"]["game auto"]["exec_ms"]}
    print("checkpoint lane Execution time, ms: " + ", ".join(
        f"{k} {v['exec_ms']:.3f}" for k, v in runs.items()), flush=True)
    return {"launches": by_path, "runs": runs}


# ---------------------------------------------------------------------------
# 4d. Observability on the card

# The spans a run (a) adds under --trace, and the profiled lanes: CLI flags
# (beside --gen-limit 1000 on the random input) and the kernel events the
# capture must hold, as (a name's part, count).
TRACED_SPANS = ("cli.read_phase", "engine.compile", "cli.execution",
                "cli.write_phase")
PROFILED_LANES = {
    "game auto": (["--variant", "game", "--kernel", "auto"], ("bandt_kernel", 125)),
    "game packed_io": (["--variant", "game", "--packed-io"], ("bandt_kernel", 125)),
    "tpu 4x1 auto": (["--variant", "tpu", "--mesh", "4x1", "--kernel", "auto"],
                     ("bandt_kernel", 500)),
    "tpu 2x2 auto": (["--variant", "tpu", "--mesh", "2x2", "--kernel", "auto"],
                     ("bandt_kernel", 500)),
}


def _cli_io(args: list[str]) -> tuple[int, str, str]:
    """``cli.main`` in this process: ``(rc, stdout, stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, out.getvalue(), err.getvalue()


def _union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (end - start if end is not None else 0.0)


def profile_summary(trace_json: Path, needle: str) -> dict:
    """A ``--profile`` capture's CUDA kernels: the events whose name holds
    ``needle``, the profiled window (first to last event), the union of
    the kernel intervals over it, and the host ops that take the most of
    it (top-level CPU ops by summed duration)."""
    if not trace_json.exists():
        fail(f"--profile wrote no {trace_json}")
    events = [e for e in json.loads(trace_json.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e and e.get("cat") != "Trace"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail(f"{trace_json}: the capture recorded no CUDA kernel")
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    host = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            n, t = host.get(e["name"], (0, 0.0))
            host[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(host.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "events": sum(needle in e["name"] for e in kernels),
        "kernel_events": len(kernels),
        "window_ms": (hi - lo) / 1e3,
        "kernel_busy_ms": busy / 1e3,
        "device_busy_share": busy / (hi - lo),
        "host_ops_ms": {name: [n, round(t / 1e3, 3)] for name, (n, t) in top},
    }


def _compile_cache_run(args: list[str], trace_dir: Path) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", *args, "--trace", str(trace_dir)],
        capture_output=True, text=True, timeout=600, env=_subprocess_env())
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"--compile-cache run exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    spans = {}
    for e in json.loads(next(trace_dir.glob("trace-*.json")).read_text())["traceEvents"]:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"wall_s": wall_s, "engine.compile_ms": spans.get("engine.compile"),
            "cli.read_phase_ms": spans.get("cli.read_phase"),
            "generations": int(re.search(r"Generations:\t(\d+)", proc.stdout).group(1))}


def observability(work: Path, path: dict, mesh: dict) -> dict:
    """Phase 4d: --trace, --profile and --compile-cache at 16384^2. Each
    profiled lane's kernel time also stands over its unprofiled Execution
    time from phase 4 or 4b, since the capture itself costs host time."""
    from gol_tpu_torch.obs import recorder
    from gol_tpu_torch.obs import trace as obs_trace

    inp, out = path["inputs"]["random"], work / "out.txt"
    want = path["results"][("game", "random", 1000)]
    base = [str(SIZE), str(SIZE), str(inp), "--gen-limit", "1000", "--output", str(out)]
    tdir = work / "obs_trace"
    runs, by_path, lanes = {}, {}, {}

    def traced(flags):
        rc, stdout, stderr = _cli_io([*base, *flags])
        if rc != 0:
            fail(f"gol_tpu_torch {' '.join(flags)} exited {rc}:\n{stderr}")
        gens = int(re.search(r"Generations:\t(\d+)", stdout).group(1))
        exec_ms = float(re.search(r"Execution time:\t([0-9.]+) msecs", stdout).group(1))
        if (gens, _digest(out)) != want or gens != 1000:
            fail(f"{' '.join(flags)}: Generations {gens} or bytes differ from "
                 "phase 4's run (a)")
        return exec_ms, stderr

    game_auto = PROFILED_LANES["game auto"][0]
    runs["phase 4 run (a)"] = path["run_a"]["game auto"]["exec_ms"]
    runs["--trace"], _ = traced([*game_auto, "--trace", str(tdir)])
    shutil.rmtree(tdir)
    obs_trace.clear()
    for lane, (flags, (needle, count)) in PROFILED_LANES.items():
        pdir = work / f"obs_profile_{lane.replace(' ', '_')}"
        extra = ["--profile", str(pdir)]
        if lane == "game auto":
            extra += ["--trace", str(tdir)]
        _zero_counters()
        exec_ms, stderr = traced([*flags, *extra])
        by_path[f"{lane} --profile (4d)"] = _counts()
        if lane == "game auto":
            runs["--trace --profile"] = exec_ms
            exported = tdir / f"trace-{os.getpid()}.json"
            if f"trace -> {exported}" not in stderr.splitlines():
                fail(f"--trace: no 'trace -> {exported}' line on stderr:\n{stderr}")
            obs_trace.disable()
            obs_trace.clear()
            recorder.uninstall()
            rc, report, _ = _cli_io(["trace-report", str(exported)])
            missing = [n for n in TRACED_SPANS if n not in report]
            if rc != 0 or missing:
                fail(f"trace-report of {exported} exited {rc}, missing {missing}")
            print(f"(a) game auto --trace --profile: trace-report names "
                  f"{', '.join(TRACED_SPANS)}", flush=True)
        summary = profile_summary(pdir / "trace.json", needle)
        if summary["events"] != count:
            fail(f"{lane} --profile: {summary['events']} CUDA kernel events named "
                 f"{needle}, expected {count}")
        unprofiled = {**path["run_a"], **mesh["run_a"]}[lane]["exec_ms"]
        lanes[lane] = {"exec_ms": exec_ms, **summary,
                       "unprofiled_exec_ms": unprofiled,
                       "kernel_busy_over_unprofiled": summary["kernel_busy_ms"] / unprofiled,
                       "launches": _nonzero(by_path[f"{lane} --profile (4d)"])}
        print("observability: " + json.dumps({"lane": lane, **lanes[lane]}),
              flush=True)
        shutil.rmtree(pdir)
    print("run (a) game auto Execution time, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in runs.items()), flush=True)

    cache = work / "obs_compile_cache"
    cc_args = [*base[:3], "--variant", "game", "--packed-io", "--gen-limit", "1000",
               "--compile-cache", str(cache), "--output", str(out)]
    builds = []
    for i in range(2):
        out.unlink()
        run = _compile_cache_run(cc_args, work / f"obs_cc_trace{i}")
        files = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
        if (run["generations"], _digest(out)) != want:
            fail(f"--compile-cache run {i + 1}: Generations or bytes differ from "
                 "phase 4's run (a)")
        builds.append({**run, "files": sorted(files)})
        print(f"--compile-cache run {i + 1}: " + json.dumps(builds[-1]), flush=True)
        if i == 0:
            first = files
            for stem in ("stencil_packed", "codec"):
                if not any(n.startswith(f"{stem}-") and n.endswith(".so") for n in files):
                    fail(f"--compile-cache built no {stem}-*.so into {cache}: {files}")
        elif files != first:
            fail(f"the second --compile-cache run built again: {first} -> {files}")
    print("--compile-cache: the second run built nothing (same files, same mtimes)",
          flush=True)
    return {"launches": by_path, "lanes": lanes, "runs": runs, "compile_cache": builds}


# ---------------------------------------------------------------------------
# 4e. The batch lane


def _batch_jobs(boards, convention, limit) -> list:
    return [new_job(b.shape[1], b.shape[0], b, convention=convention,
                    gen_limit=limit) for b in boards]


def _solo_check(board, result, config, kernel, where: str) -> None:
    want = engine.simulate(board, config, kernel=kernel)
    if (not np.array_equal(result.grid, want.grid)
            or result.generations != want.generations):
        fail(f"{where}: a board's batch result (Generations "
             f"{result.generations}) differs from its solo run "
             f"({want.generations})")


def _boards_per_sec(key, boards, convention, limit, repeats: int = 3) -> dict:
    """bench.py's batch suite: the boards as 64/B ``run_batch`` dispatches
    of B boards, best of ``repeats``, after one warm dispatch per B."""
    jobs = _batch_jobs(boards, convention, limit)
    rates = {}
    for b in BATCH_SIZES:
        batcher.run_batch(key, jobs[:b])
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for i in range(0, len(jobs), b):
                batcher.run_batch(key, jobs[i:i + b])
            best = min(best, time.perf_counter() - t0)
        rates[b] = len(jobs) / best
    return rates


def batch_lane(work: Path, dev) -> dict:
    """Phase 4e: the batch lane on the serving load of bench.py. 64 random
    256^2 boards (bucket 256x256/c/packed, B1) and 64 random 250^2 boards
    (256x256/c/masked, B2) through ``batcher.run_batch`` at gen_limit 4 and
    1000 under both conventions, then JAX's mixed-fate trio at 32^2, with
    the launch counters zeroed just before and read just after. Every
    board's grid, generations and exit reason equal the port's solo
    ``engine.simulate`` (``auto`` for the packed bucket, ``pallas`` for the
    masked one); the trio's equal the oracle too. Then ``python -m
    gol_tpu_torch batch 256 256 <64 files> --gen-limit 1000``, every output
    equal to the solo ``run``'s bytes, and boards/sec at B = 1, 8, 64."""
    rng = np.random.default_rng(SEED + 5)
    loads = {name: [rng.integers(0, 2, (side, side), dtype=np.uint8)
                    for _ in range(BATCH_BOARDS)]
             for name, side in BATCH_SIDES.items()}
    dies = np.zeros((32, 32), np.uint8)
    dies[4, 4] = 1
    still = np.zeros((32, 32), np.uint8)
    still[3:5, 3:5] = 1
    trio = [(dies, "empty"), (still, "similar"),
            (text_grid.generate(32, 32, seed=7), "gen_limit")]
    runs, exec_ms = {}, {}
    _zero_counters()
    for convention in (Convention.C, Convention.CUDA):
        for limit in BATCH_LIMITS:
            for name, boards in loads.items():
                jobs = _batch_jobs(boards, convention, limit)
                key = batcher.bucket_for(jobs[0])
                pad = batcher.pad_dim(BATCH_SIDES[name])
                want_label = f"{pad}x{pad}/{convention}/{name.split('/')[1]}"
                if key.label() != want_label:
                    fail(f"{name} boards went to bucket {key.label()}, not {want_label}")
                t0 = time.perf_counter()
                runs[(convention, limit, name)] = batcher.run_batch(key, jobs)
                exec_ms[f"{name} {convention} limit {limit}"] = (
                    time.perf_counter() - t0) * 1e3
        jobs = _batch_jobs([b for b, _ in trio], convention, 60)
        runs[(convention, 60, "trio")] = batcher.run_batch(
            batcher.bucket_for(jobs[0]), jobs)
    counts = _counts()
    print(f"batch lane: launches {_nonzero(counts)}; one dispatch each, ms: "
          + json.dumps({k: round(v, 3) for k, v in exec_ms.items()}), flush=True)
    for k in KERNELS + BATCH_KERNELS:
        if (k["key"] in ("batch_packed", "batch_masked")) != (counts[k["key"]] > 0):
            fail(f"{k['id']} ({k['key']}) launched {counts[k['key']]} times on "
                 "the batch lane")

    t0 = time.perf_counter()
    for (convention, limit, name), results in runs.items():
        if name == "trio":
            boards, kernel = [b for b, _ in trio], "auto"
        else:
            boards, kernel = loads[name], "auto" if "packed" in name else "pallas"
        cfg = GameConfig(convention=convention, gen_limit=limit)
        reasons = {}
        for i, (board, result) in enumerate(zip(boards, results)):
            _solo_check(board, result, cfg, kernel,
                        f"{name} {convention} limit {limit} board {i}")
            if name == "trio":
                oracle_want = oracle.run(board, cfg)
                if (not np.array_equal(result.grid, oracle_want.grid)
                        or result.generations != oracle_want.generations
                        or result.exit_reason != trio[i][1]):
                    fail(f"trio {convention} board {i}: {result.generations} "
                         f"{result.exit_reason} differs from the oracle "
                         f"({oracle_want.generations}, {trio[i][1]})")
            reasons[result.exit_reason] = reasons.get(result.exit_reason, 0) + 1
        print(f"{name} {convention} limit {limit}: {len(results)} boards == "
              f"solo --kernel {kernel} (grid, Generations), exit reasons {reasons}"
              + (", == the oracle" if name == "trio" else ""), flush=True)
    print(f"solo checks in {time.perf_counter() - t0:.1f} s", flush=True)

    # The CLI entry point on the packed load, against solo `run`s.
    side = str(BATCH_SIDES["256x256/packed"])
    files = []
    for i, board in enumerate(loads["256x256/packed"]):
        files.append(work / f"board{i:02d}.txt")
        text_grid.write_grid(str(files[i]), board)
    outdir = work / "batch_out"
    proc = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "batch", side, side,
         *map(str, files), "--gen-limit", "1000", "--output-dir", str(outdir)],
        capture_output=True, text=True, timeout=600, env=_subprocess_env())
    if proc.returncode != 0:
        fail(f"python -m gol_tpu_torch batch exited {proc.returncode}:\n{proc.stderr}")
    lines = proc.stdout.splitlines()
    solo_out = work / "solo.out"
    for path, line in zip(files, lines):
        gens, _, _ = _cli([side, side, str(path), "--variant", "tpu", "--mesh",
                           "1x1", "--gen-limit", "1000", "--output", str(solo_out)])
        batch_out = outdir / (path.name + ".out")
        if (batch_out.read_bytes() != solo_out.read_bytes()
                or f"Generations:\t{gens}\t" not in line):
            fail(f"batch output {batch_out.name} ({line!r}) differs from the solo "
                 f"run (Generations {gens})")
    if len(lines) != len(files):
        fail(f"batch printed {len(lines)} lines for {len(files)} files")
    print(f"python -m gol_tpu_torch batch {side} {side} <{len(files)} files> --gen-limit "
          f"1000: every output == the solo run's bytes and Generations; "
          f"{proc.stderr.strip()}", flush=True)

    rates = {}
    for name, boards in loads.items():
        for limit in BATCH_LIMITS:
            key = batcher.bucket_for(_batch_jobs(boards[:1], Convention.C, limit)[0])
            r = _boards_per_sec(key, boards, Convention.C, limit)
            rates[f"{name} limit {limit}"] = r
            print(f"boards/sec {name} c limit {limit}: " + ", ".join(
                f"B={b} {v:.1f}" for b, v in r.items())
                + f" (B={BATCH_SIZES[-1]} / B=1 = "
                f"{r[BATCH_SIZES[-1]] / r[BATCH_SIZES[0]]:.2f})", flush=True)

    busy = {}
    for name, needle in (("256x256/packed", "batch_packed_kernel"),
                         ("250x250/masked", "batch_masked_kernel")):
        for limit in BATCH_LIMITS:
            jobs = _batch_jobs(loads[name], Convention.C, limit)
            key = batcher.bucket_for(jobs[0])
            batcher.run_batch(key, jobs)  # warm
            prof_dir = work / f"prof_{needle}_{limit}"
            with profiler.capture(str(prof_dir), dev):
                batcher.run_batch(key, jobs)
            summary = profile_summary(prof_dir / "trace.json", needle)
            busy[f"{name} limit {limit}"] = summary
            print(f"profile {name} c limit {limit}, B={BATCH_BOARDS}: {summary['events']} "
                  f"{needle} events, busy {summary['kernel_busy_ms']:.3f} ms of a "
                  f"{summary['window_ms']:.3f} ms window = "
                  f"{summary['device_busy_share']:.3f}; host ops "
                  f"{summary['host_ops_ms']}", flush=True)
    return {"launches": {"batch lane (4e)": counts}, "boards_per_sec": rates,
            "exec_ms": exec_ms, "busy": busy}


# ---------------------------------------------------------------------------
# 5. Timing at 16384^2


def _time(fn, srcs, dsts, rounds: int) -> float:
    """ms per call of ``fn(i, src, dst)``, issued one by one, over
    ``rounds`` rounds of a ring of shards (``profiler.run_ring``; one shard
    is a ping-pong)."""
    profiler.run_ring(fn, srcs, dsts, 6)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    profiler.run_ring(fn, srcs, dsts, rounds)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(srcs))


def logic_ops_per_s() -> float:
    """The card's peak rate of 32-bit integer logic results per second."""
    rate = roofline.logic_ops_per_s()
    print(f"32-bit logic rate: {roofline.INT32_LOGIC_PER_CLK_PER_SM}/clk/SM x "
          f"SMs x max SM clock = {rate} ops/s", flush=True)
    return rate


def _timed(k: dict, xs: list, ghosts: list, ops_per_s: float) -> dict:
    """``k``'s ms per launch (graph replay; eager beside it) and its plain
    version's over the shards ``xs`` (one for a single device) with their
    ghosts ``ghosts[i]``, launched in turn, beside the bound for one
    launch's work and the working set of the ring (every shard's input,
    output and ghosts)."""
    ys = [torch.empty_like(x) for x in xs]
    flags = torch.zeros(k["nflags"], dtype=torch.int32, device=xs[0].device)
    launch = lambda i, a, b: k["into"](a, *ghosts[i], b, flags)
    rounds = 100 // len(xs)
    eager_ms = _time(launch, xs, ys, rounds)
    ms, wrapper_ms = profiler.ring_graph_ms(launch, xs, ys, rounds)
    plain_ms = _time(lambda i, a, b: k["plain"](a, *ghosts[i]), xs, ys, rounds)
    x = xs[0]
    ghost_bytes = [sum(g.numel() * g.element_size() for g in gs) for gs in ghosts]
    nbytes = 2 * x.numel() * x.element_size() + ghost_bytes[0]
    working_set = sum(2 * t.numel() * t.element_size() for t in xs) + sum(ghost_bytes)
    if k.get("cells"):
        ops = k["gens"] * (x.numel() // 4) * OPS_PER_BYTE_WORD
    else:
        ops = k["gens"] * x.numel() * OPS_PER_WORD_GEN
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    two_input = {} if k.get("cells") else {"ops_ms_two_input": k["gens"] * x.numel()
                                           * roofline.TWO_INPUT_OPS_PER_WORD_GEN
                                           / ops_per_s * 1e3}
    resident = "fits in" if working_set <= L2_BYTES else "exceeds"
    print(f"{k['id']} at {tuple(x.shape)}: {ms:.6f} ms/launch in a CUDA graph "
          f"(eager {eager_ms:.6f} ms, wrapper {wrapper_ms:.6f} ms on the host, "
          f"plain {plain_ms:.6f} ms); bytes {nbytes} -> {bytes_ms:.6f} ms, logic ops "
          f"{ops} -> {ops_ms:.6f} ms; working set {working_set} bytes over "
          f"{len(xs)} shard(s), {resident} the {L2_BYTES}-byte L2", flush=True)
    return {
        "shape": list(x.shape), "ms": ms, "eager_ms": eager_ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
        "ops_ms": ops_ms, "logic_ops_per_s": ops_per_s, **two_input,
        "ring_shards": len(xs), "working_set_bytes": working_set,
    }


def timing(dev) -> dict:
    ops_per_s = logic_ops_per_s()
    rng = np.random.default_rng(SEED + 2)
    cells = (rng.random((SIZE, SIZE), dtype=np.float32) < 0.5).astype(np.uint8)
    x_cells = torch.from_numpy(cells).to(dev)
    x_words = pm.encode(x_cells)
    out = {}
    for k in KERNELS:
        if not k.get("ghosts"):
            out[k["key"]] = _timed(k, [x_cells if k.get("cells") else x_words],
                                   [[]], ops_per_s)
            continue
        # Shard kernels at the mesh path's shard shapes, the first heading
        # the kernel's entry; K5 over the ring of the mesh's four shards.
        shapes = []
        for height, n in SHARD_TIMING[k["key"]]:
            state = x_cells if k.get("cells") else x_words
            if k["key"] in RING_TIMED:
                rows, cols = SIZE // height, state.shape[1] // n
                xs = [state[r * height:(r + 1) * height, c * n:(c + 1) * n].contiguous()
                      for r in range(rows) for c in range(cols)]
            else:
                xs = [state[:height, :n].contiguous()]
            shapes.append(_timed(k, xs, [_ghosts(k, x, rng) for x in xs], ops_per_s))
        out[k["key"]] = {**shapes[0], "by_shape": shapes}
    out.update(_timed_batch(ops_per_s))
    return out


def _fresh_flags_ms(launch, x: torch.Tensor, rounds: int) -> float:
    """ms per launch of ``launch(src, dst, flags)`` over ``rounds``
    ping-pong launches in one CUDA graph, launch k ORing into its own
    zeroed flag row, as the engine's block does (``ring_graph_ms``'s
    launches share one flag row, set after the first)."""
    y = torch.empty_like(x)
    rows = torch.zeros((rounds, x.shape[0], sb.STEP_FLAGS), dtype=torch.int32,
                       device=x.device)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, b = x, y
        for k in range(rounds):
            launch(a, b, rows[k])
            a, b = b, a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # warm, then timed
        rows.zero_()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def _timed_batch(ops_per_s: float) -> dict:
    """B1 and B2 at phase 4e's shapes, one launch of a block's first
    generation (every board runs): 64 boards of 256 x 8 words, and 64
    boards of 250^2 in a 256^2 canvas. ``ms`` is graph replay with a fresh
    flag row per launch, as in the engine's block; ``ms_flags_set`` the
    replay of ``_timed``, whose launches find their flags set after the
    first. The bytes are the boards, the step counts and extents read once
    and the boards and flags written once."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 6)
    b = BATCH_BOARDS
    words = pm.words_from_numpy(rng.integers(0, 2**32, (b, 256, 8), dtype=np.uint64)
                                .astype(np.uint32), dev)
    canvas = np.zeros((b, 256, 256), np.uint8)
    canvas[:, :250, :250] = rng.integers(0, 2, (b, 250, 250), dtype=np.uint8)
    cells = torch.from_numpy(canvas).to(dev)
    steps = torch.ones(b, dtype=torch.int32, device=dev)
    ext = torch.full((b,), 250, dtype=torch.int32, device=dev)
    cases = {
        "batch_packed": (
            words, (steps,),
            lambda a, o, f: sb.batch_packed_step_into(a, o, f, steps, 0),
            lambda a: sb._batch_packed_plain(a, steps, 0),
            words.numel() * OPS_PER_WORD_GEN),
        "batch_masked": (
            cells, (steps, ext, ext),
            lambda a, o, f: sb.batch_masked_step_into(a, o, f, steps, ext, ext, 0),
            lambda a: sb._batch_masked_plain(a, steps, ext, ext, 0),
            cells.numel() * OPS_PER_CELL),
    }
    out = {}
    for key, (x, vectors, launch, plain, ops) in cases.items():
        y = torch.empty_like(x)
        flags = torch.zeros((b, sb.STEP_FLAGS), dtype=torch.int32, device=dev)
        ring = lambda i, a, o: launch(a, o, flags)
        eager_ms = _time(ring, [x], [y], 100)
        set_ms, wrapper_ms = profiler.ring_graph_ms(ring, [x], [y], 100)
        ms = _fresh_flags_ms(launch, x, 100)
        plain_ms = _time(lambda i, a, o: plain(a), [x], [y], 10)
        nbytes = (2 * x.numel() * x.element_size() + flags.numel() * 4
                  + sum(v.numel() * 4 for v in vectors))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        print(f"{key} at {tuple(x.shape)}: {ms:.6f} ms/launch in a CUDA graph, "
              f"fresh flags per launch ({set_ms:.6f} with its flags set; eager "
              f"{eager_ms:.6f} ms, wrapper {wrapper_ms:.6f} ms on the host, plain "
              f"{plain_ms:.6f} ms); bytes {nbytes} -> {bytes_ms:.6f} ms, logic ops "
              f"{ops} -> {ops_ms:.6f} ms; working set "
              f"{2 * x.numel() * x.element_size()} bytes, fits in the "
              f"{L2_BYTES}-byte L2", flush=True)
        out[key] = {
            "shape": list(x.shape), "ms": ms, "ms_flags_set": set_ms,
            "eager_ms": eager_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
            "ops_ms": ops_ms, "logic_ops_per_s": ops_per_s,
            "working_set_bytes": 2 * x.numel() * x.element_size(),
        }
    return out


def roofline_phase() -> tuple[dict, dict]:
    """Phase 6: the roofline tool at 16384^2 and 65536^2, with the counters
    zeroed before it. Returns its report and the launch counts."""
    _zero_counters()
    report = roofline.report(roofline.SIZES)
    counts = _counts()
    if counts["bandt_noflags"] == 0:
        fail("the roofline launched no K14")
    for size in report["sizes"]:
        for name, c in size["checks"].items():
            if c["words_differing"] or c["flags_differing"]:
                fail(f"roofline {name} at {size['size']}^2 disagrees with "
                     f"its plain version: {c}")
        print(f"{size['size']}^2: K1, K2, K14 outputs and flags identical "
              "to their plain versions (tolerance 0)", flush=True)
        k = size["kernels"]
        print(f"{size['size']}^2: " + ", ".join(
            f"{name} {k[name]['graph']['ms']:.6f} ms (profiler "
            f"{k[name]['profiler']['ms']:.6f})" for name in k)
            + f"; bound {size['bound_ms']:.6f} ms ({size['bound_by']}); flag "
            f"overhead {size['flag_overhead_fraction']}, against K1 "
            f"{size['flag_overhead_fraction_k1']}", flush=True)
    print(f"SM clock right after the roofline's timings: "
          f"{report['sm_clock_mhz_after_timing']} MHz", flush=True)
    return report, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this smoke test needs one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # The CLI runs below, in this process and in the subprocesses, pick
    # their device from the environment: make it the card.
    os.environ[platform_env.DEVICE_ENV] = "cuda"
    stats = {k["key"]: {"max_abs_err": 0, "checks": 0}
             for k in KERNELS + BATCH_KERNELS}
    _build.BUILD_DIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR))
    try:
        phase("1. card and build")
        smi = card_and_build()
        phase("2. kernels against their plain versions")
        check_kernels(dev, stats)
        check_batch_kernels(dev, stats)
        phase("3. small flows through python -m gol_tpu_torch")
        small_flows(work)
        # From here on a mesh may put four shards on the one card.
        os.environ[platform_env.MESH_DEVICES_ENV] = MESH_DEVICES
        phase("3b. small flows over a mesh of four shards")
        one_word = mesh_flows(work)
        phase("3c. the checkpoint lane at 64x64")
        checkpoint_flows(work)
        phase(f"4. main path at {SIZE}x{SIZE} through the CLI")
        path = main_path(work, dev)
        phase(f"4b. mesh path at {SIZE}x{SIZE} through the CLI")
        mesh = mesh_path(work, dev, path)
        phase(f"4c. the checkpoint lane at {SIZE}x{SIZE}")
        ckpt = checkpoint_path(work, path)
        phase(f"4d. observability on the card at {SIZE}x{SIZE}")
        obs = observability(work, path, mesh)
        phase("4e. the batch lane")
        batch = batch_lane(work, dev)
        phase("5. timing")
        times = timing(dev)
        phase("6. the flag-cost roofline")
        roof, roof_counts = roofline_phase()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print("main path run (a): " + json.dumps({**path["run_a"], **mesh["run_a"]}))
    print("checkpoint lane: " + json.dumps(ckpt["runs"]))
    print("observability: " + json.dumps({"runs": obs["runs"], "lanes": {
        lane: {k: v[k] for k in ("exec_ms", "window_ms", "kernel_busy_ms",
                                 "device_busy_share", "unprofiled_exec_ms",
                                 "kernel_busy_over_unprofiled")}
        for lane, v in obs["lanes"].items()}}))
    print(json.dumps({"roofline": roof}))
    print("batch lane: " + json.dumps({
        "exec_ms": batch["exec_ms"], "boards_per_sec": batch["boards_per_sec"],
        "busy": {k: {m: v[m] for m in ("events", "window_ms", "kernel_busy_ms",
                                       "device_busy_share")}
                 for k, v in batch["busy"].items()}}))
    launches = {**path["launches"], **mesh["launches"], **ckpt["launches"],
                **obs["launches"], **batch["launches"],
                "tpu 2x2 auto 64x64 (one-word shards)": one_word,
                "roofline": roof_counts}
    table = []
    for k in KERNELS + BATCH_KERNELS:
        key = k["key"]
        by_path = {p: n[key] for p, n in launches.items() if n[key]}
        table.append({
            "name": k["name"], "id": k["id"], "route": "cuda",
            "source": k["source"], "replaces": k["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": stats[key]["max_abs_err"],
            "checks": stats[key]["checks"], **times[key], "library_ms": None,
        })
    print(f"chip_smoke: every phase passed in {time.perf_counter() - _T0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
