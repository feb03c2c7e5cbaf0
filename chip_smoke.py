#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card
    python3 chip_smoke.py --io-compare OTHER_TREE,. [--size N] [--rounds R]

The quickest proof that the port still starts on the GPU. With
``--io-compare`` it only times the packed read and write of several trees
of the repository against each other (``io_compare``). It needs one card,
``nvcc``, ``cc`` and nothing of JAX, and generates every input from a seed.
Phases, each of which fails the run (non-zero exit, no result line) on any
error:

1. Card and build: the card's name and power limit (nvidia-smi), then the
   native code built from the checkout — one compiler per source, all
   started together: ``csrc/stencil_packed.cu`` (K1-K3, K5, K7, K8, the
   ghost-plane form that replaces K9-K13, and K14, the flag-free pass of
   the roofline), ``csrc/stencil_pallas.cu`` (K4, K6),
   ``csrc/stencil_batch.cu`` (B1, B2: the batch lane's batched steps),
   ``csrc/stencil_tile.cu`` (T1: the sparse and macro lanes' tile step),
   ``csrc/packed_codec.cu`` (E1, D1: the byte-state lanes' cell <-> word
   codec) and ``native/codec.c`` (the packed-I/O text codec) — with nvcc's
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
   identical. Then T1 (one generation of B halo-extended tiles) at (tiles,
   edge) (3,4) (5,9) (64,256) (64,512) on random, still and all-zero
   blocks, into compact interiors and into the interior of a padded stack
   (whose ring must be left as it was): interiors and per-tile flags
   identical. Then E1 (pack cells into words) and D1 (unpack) against
   ``packed_math.encode``/``decode`` on random bytes (not only 0/1) at
   (height, width) (1,32) (7,96) (17,160) (1000,224) (16384,16384), on
   the 4x1 and 2x2 shards of 16384^2 (4096x16384, 8192x8192) and on
   65536^2 (2^32 cells, past 32-bit indices): words and cells identical,
   and D1(E1(x)) == (x != 0).
3. Small flows through the CLI on the card, against the port's numpy
   oracle, for both loop conventions: the verify skill's four flows at
   48^2 and 64^2 (random for 1000 generations, 2x2 block, lone cell, all
   dead) with ``--kernel auto`` and ``--kernel pallas``; the 64^2 flows
   with ``--packed-io``; the 48^2 flows with ``--host``; the random 48^2
   grid under each of ``mpi``/``collective``/``async``/``openmp`` (default
   output name, printed lines, bytes) — through ``cli.main`` in five
   worker processes at once (one per convention and size, one for the
   four variants), as phase 3b runs its variants; then, each in a fresh
   ``python -m gol_tpu_torch`` process, random64 under ``--variant game``
   on each lane once more (all three at once), ``--snapshot-every 100``
   (every ``gen_NNNNNN.out`` equal to the oracle's state at that
   generation) and ``--resume-gen 300`` from a snapshot against the whole
   run. Then, with ``GOL_TORCH_MESH_DEVICES=4`` (four shards on the one
   card), the eight flows through ``cli.main`` under ``--variant tpu``,
   ``collective``, ``async``, ``openmp`` and ``mpi``, each with ``--mesh
   4x1`` and ``--mesh 2x2`` and ``--kernel auto``, ``pallas`` and ``lax``,
   with ``--mesh 1x4`` and ``--kernel auto``, and the 64^2 flows with
   ``--packed-io`` on 4x1 and 2x2 (bytes, generation counts and printed
   lines against the oracle), one worker process per variant, all five
   at once. 64^2 under ``--mesh 2x2`` has one-word shards:
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
   inputs: ``--kernel auto`` (E1, K1-K3, D1), ``--kernel pallas`` (K4) and
   ``--packed-io`` (K1-K3 with no encode/decode). One uncounted run (a) of
   each lane warms the process first. For each variant and lane the launch
   counters are set to 0 just before its six runs and read just after; each
   kernel of the lane must have launched, and no other: every ``auto`` run
   launches E1 and D1 once each, ``pallas``, ``--packed-io`` and ``lax``
   neither. ``pallas`` and ``--packed-io``
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
   ``pallas`` lanes K6, and no lane a single-device kernel; each ``auto``
   run launches E1 and D1 once per shard, the other lanes neither. The
   ``Reading file`` and ``Writing file`` lines of the ``--packed-io`` lanes
   print: ``--variant tpu --mesh 1x1 --packed-io`` (one device) on (a)
   and ``--mesh 2x2 --packed-io``. Engine-level
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
   kernel events named ``bandt_kernel`` (K1) and one each of
   ``pack_cells_kernel`` (E1) and ``unpack_words_kernel`` (D1). A lane
   whose capture holds fewer kernel events than its launch counters
   counted is captured once more, which must be exact; the lane's line
   keeps the first capture's counts and busy share. The capture
   covers the ``cli.execution`` span and the profiler's guard on either
   side (``obs/profiler.py``), in which no kernel runs; the profiled
   window is the capture's ``gol.profiled_run`` range. The same
   ``--profile`` check on
   ``--packed-io`` (125 K1, no E1 or D1), ``--variant tpu --mesh 4x1``
   (500 K7, 4 E1 and 4 D1) and ``--mesh 2x2`` (500 K9+K10, 4 E1 and 4
   D1), each with its bytes equal to run (a)'s. Each profiled lane prints its
   device-busy share (the union of the CUDA kernel intervals over the
   profiled window) beside its Execution time, the kernel time over the
   lane's unprofiled Execution time of phase 4 or 4b (the capture costs
   host time), the host ops that take most of the window, and how long
   after the profiler's start its first kernel ran. Then ``--packed-io
   --compile-cache D`` twice, each
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
4f. The server lane, on B1 and B2, with the launch counters set to 0 just
   before each in-process part and read just after: (i) bench.py's
   pipeline load (the 128 boards of 4e at gen_limit 1000, C convention,
   and the trio in both conventions) POSTed by eight client threads to a
   real ``serve/server.GolServer`` with a journal, half as JSON and half as
   packed wire frames, then ``POST /drain``, at ``--pipeline-depth`` 1 and
   2 and ``--max-inflight 2``, and at depth 1 without a journal (a
   diagnostic: no fsync per submit), each on a fresh server, best of two;
   every
   result, fetched as JSON and as a packed frame, equals the solo
   ``engine.simulate`` (grid, generations, exit reason) and the trio the
   oracle. Jobs/s, boards/s, the ``job_latency_seconds`` p50 and p99 of
   ``/metrics?format=json`` and the mean of each timeline segment
   (``GET /jobs/<id>/timeline``) per lane, and the device-busy share of a
   depth-2 window under ``torch.profiler``. (ii) bench.py's cache load:
   128 jobs over 16 unique 256^2 boards (Zipf counts) through the
   ``Scheduler`` cold, warm (a ``ResultCache`` filled by one run) and
   coalesced (an empty one); every result equals the engine's; jobs/s and
   warm over cold. (iii) tools/serve_smoke.py's restart drill against
   ``python -m gol_tpu_torch serve --journal-dir J --result-cache``: 50
   jobs across the 32^2 and 30^2 buckets, SIGKILL with the second half
   accepted, a restart that replays them, every accepted id with exactly
   one done record equal to the oracle; then ``python -m gol_tpu_torch
   submit`` of 8 files (``--wire packed``) writes outputs equal to solo
   ``run``s, and ``python -m gol_tpu_torch gc J/cache`` reads the CAS.
4g. The resident ring (``serve --resident-ring``), on B1 and B2: bench.py's
   megabatch load uncut (64 boards, 32 random 256^2 and 32 random 250^2,
   gen_limit 4, max_batch 8, ring 4) through the port's ``Scheduler`` with
   a journal, lanes pipeline depth 1, 2 and 4, the resident ring (ring 4 at
   depth 8) and the ring at batched temporal depth 4; each bucket's
   marginal rate (its batch runner at G and 3G generations, the rate from
   the difference) at depth 1 and 4. Every job must end DONE and equal a
   solo ``simulate_batch`` of its board. Printed, not checked: each lane's
   cell-updates/s and gap ratio (over the combined marginal rate), resident
   over depth 1 beside the JAX package's own 1.5x gate for this suite, the
   ring lanes' drains, mean slot occupancy (batches per drain over the
   ring) and ``dispatch_gap_seconds`` p50, the B1/B2 launches of each lane
   (counters zeroed just before its measured run), and the device-busy
   share of one resident run under ``torch.profiler``. Then the drill:
   ``python -m gol_tpu_torch serve --resident-ring 4 --pipeline-depth 8
   --journal-dir J --trace T``, 64 jobs of 256^2 at gen_limit 1000,
   SIGKILLed once the journal holds its first done record, restarted and
   replayed: every id done exactly once, equal to the oracle. Against the
   restarted server ``top --iterations 2 --no-ansi`` (the ring row present)
   and ``fleet-trace -o F`` (F holds the server's lane and
   ``serve.resident_loop`` spans).
4h. The tuner at full width: ``python -m gol_tpu_torch tune --shape
   16384x16384 --convention c --quick --gen-limit 64 --serve-board 256x256
   --plan-cache P --report R`` (through ``cli.main``; its engine search runs
   K1, K3 and K4 at 16384^2, counted), printing the winner, every trial's
   median and the winner's speedup; no candidate may be excluded. Then run
   (a) (``--variant game``) under ``GOL_PLAN_CACHE=P``: bytes and
   Generations equal to phase 4's run (a), its Execution time printed
   beside phase 4's; then ``serve --warm-plans`` under P starts (its warm
   lines on stderr) and answers one 256^2 job equal to its solo run.
   Before phase 1 ``GOL_PLAN_CACHE`` is set to a fresh file, so every
   other phase runs and times the built-in plan.
4i. The sparse and macro lanes, on T1, with the launch counters set to 0
   just before each part and read just after (T1 must launch in each): (i)
   bench.py's sparse suite uncut: five gliders, tile 256, universes 4096^2
   to 65536^2, 24 sparse generations (each equal to the same run on the
   CPU, T1's plain version), and the dense lane (``--kernel auto``) for 4
   generations up to 16384^2, equal to a 4-generation sparse run; ms per
   generation, tiles per generation and the dense/sparse ratio. (ii)
   bench.py's macro suite: the Gosper gun, tile 256; sparse at 8192^2 for
   3000 generations; macro to 3000 generations at 8192^2, RLE equal to the
   sparse run's; macro at 2^20 squared for 10^6 generations cold into a
   fresh ``--macro-cas`` directory, then warm from it: boards equal, no
   leaf step and no T1 launch on the warm side. (iii) ``run --pattern
   patterns/gosper_gun.rle --universe 65536x65536 --place 32768,32768``
   under ``--engine sparse``, ``macro`` and ``auto`` (through
   ``cli.main``): equal RLE bytes. (iv) One sparse job and one macro job of
   (iii) through a real ``GolServer``: each answered ``rle`` equals the
   CLI's. (v) ``tune --sparse-crossover --quick`` into the smoke's plan
   cache: a crossover inside the tuner's band persisted (and printed), or
   JAX's loud refusal when the dense probes show no slope (the card's
   quick probes sit at its per-run host floor) with nothing persisted.
   Beside them, the device-busy share of a
   sparse run (65536^2, 24 generations) and a macro run (the gun at
   8192^2 to 1000 generations) under ``torch.profiler``.
4j. The fleet, its router and chaos, and the sharded single-job lane, on
   B1, B2 and T1 in worker processes (``serve`` subprocesses sharing the
   one card, each reporting its launch counts and peak allocated bytes
   at its drained exit through ``GOL_TORCH_EXIT_STATS``; every count
   starts at 0 in a fresh process). Per N in 1, 2, 4, ``python -m gol_tpu_torch fleet --workers N
   --cores-per-worker W`` (taskset slices, W = (cores - 2) // 4 clamped to
   1..6, as bench.py) with ``--compile-cache`` the build of phase 1: (i)
   bench.py's fleet load uncut (16 equal-work 160^2 buckets x 8 jobs,
   gen_limit 6000; a warm round, then a timed one), every job DONE and
   equal to the port's numpy oracle; (iii) the shard suite's universe
   uncut through the router (16x16 gliders in 65536^2, tile 256, a warm
   job of 4 generations, then 48 timed, checkpoint every 16), its RLE
   sha1 equal at every N and to ``simulate_sparse`` (the ``--engine
   sparse`` engine; the universe's RLE is beyond the CLI's dense pattern
   parse), the makespan as bench.py reads it (the most CPU seconds any
   worker spent); and ``run --pattern gosper_gun.rle --universe
   65536x65536 --gens 100 --engine shard --shard-across URL``, whose
   printed lines and RLE bytes equal ``--engine sparse``'s. At N = 2 the
   router drill (tests/test_fleet.py's TestRouterRestart): 12 jobs,
   SIGKILL the ``fleet`` process, restart it on the same --fleet-dir,
   every job answered through the new router, equal to the oracle, one
   done record each across the partitions; at N = 4 one shard worker is
   SIGKILLed mid-job past the durable floor: recoveries >= 1, the same
   RLE. B1 and T1 must launch at every N, B2 at N = 2 (the drill's 30^2
   boards). (ii) The chaos suite's two lanes, one timed round each after
   the warm ones, over in-process routers and two ``serve`` workers each:
   baseline, defended (breakers and their ring, ``--retry-budget 50``,
   ``X-Gol-Deadline``), and the defended workers behind a router whose
   hop to one of them runs ``refuse=0.2,reset=0.1``; the degraded round's
   jobs equal the oracle. Last, one cold and one warm boot of ``serve``
   (an empty ``--compile-cache``, then the same directory). The oracle
   runs in a process pool beside the first fleet's boot and warm round,
   never beside a timed round. Printed, not checked: jobs/s per N and N4 over
   N1 (the JAX package gates 2.5x), the shard cell-updates/s and N4 over
   N1 (gates 2x), T1 launches and peak allocated device bytes per
   worker (a worker SIGKILLed in a drill reports nothing), the boot times,
   defended over baseline and degraded over defended (the JAX package
   gates 0.97 and 0.70), and 4j's own seconds.
4k. Multi-process runs at 16384^2 on the one card: the distributed
   variants as N ranks of ``python -m gol_tpu_torch``, launched as torchrun
   launches them (``GOL_MULTIHOST=1``, ``RANK``, ``WORLD_SIZE``,
   ``MASTER_ADDR``, ``MASTER_PORT``), over gloo (the bootstrap's choice
   when ranks share a card), each rank writing ``GOL_TORCH_EXIT_STATS``
   (its launches, Execution ms, backend, and the host time of its
   cross-process halo phases and votes). ``--variant tpu --mesh 4x1`` in 4
   ranks on (b) and (d) (K7, K5, K8 in every rank), ``--mesh 2x2`` in 4
   ranks on (b) and (c) (both ghost-plane forms and K5), ``--mesh 2x2`` in
   2 ranks of 2 shard slots each (local and remote neighbours mixed) and
   ``--variant mpi --mesh 2x1`` in 2 ranks (the gathered lane) on (a), and
   ``--mesh 4x1`` with ``--packed-io`` and with ``--kernel pallas`` (K6)
   in 4 ranks on (a): every output's bytes and every rank's Generations
   equal phase 4's single-device ``--kernel auto`` run. Then the
   checkpoint lane in 2 ranks (``--mesh 2x1 --checkpoint-every 250``, rank
   1 SIGKILLed at the generation-500 boundary by ``GOL_FAULTS``): its peer
   must exit non-zero within 60 s, and ``--auto-resume`` in 2 ranks must
   restore generation 250 and write run (a)'s bytes. Last, the NCCL probe:
   two ranks of NCCL on the one card, whose error is printed. Per lane each
   rank's Execution ms and cell-updates/s, backend, halo and vote host time
   per pass and launches print; the ranks time-slice the one card, so the
   numbers measure the multi-process host tier and its transport, not
   scale-out over cards.
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
   B1's ops at the network's 12 per word, B2's at ``OPS_PER_CELL``. T1 at
   64 tiles of 256^2 (compact output, the sparse lane's form) and 64 leaf
   windows of 512^2 (padded ping-pong, the macro lane's form), 100
   launches in one CUDA graph with a fresh flag row each; its ops at
   ``OPS_PER_CELL``. E1 and D1 at 16384^2 (random 0/1 cells), 100
   launches in one CUDA graph, each from the same input into the same
   output; the bound is bytes, 268,435,456 of cells and 33,554,432 of
   words, and no single PyTorch call packs bits, so ``library_ms`` is
   null.
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

import argparse
import concurrent.futures
import contextlib
import ctypes
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
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from gol_tpu_torch import cli, engine, native, oracle, platform_env
from gol_tpu_torch.cache import ResultCache
from gol_tpu_torch.config import Convention, GameConfig
from gol_tpu_torch.fleet import client as fleet_client
from gol_tpu_torch.io import bitpack, text_grid, wire
from gol_tpu_torch.io import rle as rle_codec
from gol_tpu_torch.macro import MacroMemo, NodeStore, simulate_macro
from gol_tpu_torch.obs import profiler
from gol_tpu_torch.obs import registry as obs_registry
from gol_tpu_torch.ops import _build, packed_math as pm
from gol_tpu_torch.ops import stencil_packed as sp
from gol_tpu_torch.ops import stencil_batch as sb
from gol_tpu_torch.ops import stencil_pallas as spl
from gol_tpu_torch.ops import stencil_tile as stl
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import make_mesh
from gol_tpu_torch.serve import batcher, compaction
from gol_tpu_torch.serve.jobs import JobJournal, new_job
from gol_tpu_torch.serve.metrics import Metrics
from gol_tpu_torch.serve.scheduler import Scheduler
from gol_tpu_torch.serve.server import GolServer
from gol_tpu_torch.sparse import SparseBoard, TileMemo, simulate_sparse
from gol_tpu_torch.tools import roofline
from gol_tpu_torch.tune import plans as tune_plans
from gol_tpu_torch.tune import select as tune_select
from gol_tpu_torch.tune.space import ServePlan

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
# The sparse and macro lanes' kernel: a port-only row of the kernel table.
# The JAX package steps the tiles with jnp under vmap, no Pallas kernel; the
# port's host loop needs each tile's flags out of the step's own pass.
TILE_KERNELS = [
    {
        "key": "tile_step", "id": "T1",
        "name": "T1 tile_step_kernel: one generation of B halo-extended uint8 "
                "tiles, per-tile alive and changed flags",
        "source": "gol_tpu_torch/csrc/stencil_tile.cu",
        "replaces": "none: jnp under vmap, stencil_lax.evolve_padded_batch "
                    "(gol_tpu/ops/stencil_lax.py:61) via make_tile_step_runner "
                    "(gol_tpu/engine.py:1834)",
    },
]
# The byte-state lanes' cell <-> word codec: port-only rows of the kernel
# table. The JAX package encodes and decodes with jnp inside its jitted
# runner, which XLA fuses into one pass each way.
CODEC_KERNELS = [
    {
        "key": "encode", "id": "E1",
        "name": "E1 pack_cells_kernel: uint8 cells -> int32 words, "
                "bit j of word w = (cell 32w + j != 0)",
        "source": "gol_tpu_torch/csrc/packed_codec.cu",
        "replaces": "none: jnp encode in the jitted runner, fused by XLA "
                    "(gol_tpu/ops/packed_math.py:145 via gol_tpu/engine.py:775-782)",
    },
    {
        "key": "decode", "id": "D1",
        "name": "D1 unpack_words_kernel: int32 words -> 0/1 uint8 cells",
        "source": "gol_tpu_torch/csrc/packed_codec.cu",
        "replaces": "none: jnp decode in the jitted runner, fused by XLA "
                    "(gol_tpu/ops/packed_math.py:153 via gol_tpu/engine.py:790-794)",
    },
]
# Phase 2's E1/D1 shapes, (height, width): one word, odd word counts, a
# tall narrow grid, the main path's grid and its 4x1 and 2x2 shards; then
# CODEC_BIG^2, 2^32 cells, past 32-bit indices.
CODEC_SHAPES = [(1, 32), (7, 96), (17, 160), (1000, 224), (SIZE, SIZE),
                (SIZE // 4, SIZE), (SIZE // 2, SIZE // 2)]
CODEC_BIG = 4 * SIZE
# Integer operations per word, from csrc/packed_codec.cu: E1 takes 7 per 4
# cells (and, add, or, and, shift, multiply, shift) and 14 to place and
# join the 8 nibbles; D1 4 per nibble (shift, and, multiply, and). Bytes
# bound both.
CODEC_OPS_PER_WORD = {"encode": 70, "decode": 32}
# Phase 2's T1 shapes, (tiles, edge): the least tiles, an odd edge, the
# sparse lane's top rung at the default tile, the macro lane's leaf windows.
TILE_CHECK_SHAPES = [(3, 4), (5, 9), (64, 256), (64, 512)]
# Phase 4i: bench.py's sparse suite (bench.py:2291-2416) and macro suite
# (bench.py:2418-2530), uncut.
SPARSE_TILE = 256
SPARSE_SIZES = (1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)
SPARSE_GENS, DENSE_GENS, DENSE_MAX = 24, 4, 1 << 14
MACRO_UNIVERSE, MACRO_GENS = 1 << 20, 1_000_000
GUN_UNIVERSE, GUN_GENS = 1 << 13, 3000
CLI_UNIVERSE = 1 << 16  # (iii) and (iv): the gun at its middle
# Phase 4j: bench.py's fleet suite (bench.py:1076-1296), uncut: 16
# equal-work 160^2 buckets (one similarity frequency each), 8 jobs a
# bucket, at N = 1, 2, 4 workers; its chaos suite (bench.py:2764-3054): 4
# buckets at 10000 generations, 2 workers; its shard suite
# (bench.py:2564-2762): 16x16 gliders in 65536^2, tile 256.
FLEET_FREQS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 17, 18, 21, 24, 27)
FLEET_SIDE, FLEET_PER_BUCKET, FLEET_LIMIT, FLEET_NS = 160, 8, 6000, (1, 2, 4)
FLEET_SERVE = ["--flush-age", "0.2", "--max-batch", "8", "--pipeline-depth",
               "2", "--max-queue-depth", "4096"]
CHAOS_FREQS, CHAOS_LIMIT = (2, 3, 5, 9), 10000
CHAOS_PLAN = "seed=777,refuse=0.2,reset=0.1"
SHARD_UNIVERSE, SHARD_GRID, SHARD_LIMIT, SHARD_CKPT = 1 << 16, 16, 48, 16
# The CLI's shard lane: the gun of (iii) in 4i, 100 generations.
SHARD_CLI = ["--pattern", str(REPO / "patterns" / "gosper_gun.rle"),
             "--universe", f"{CLI_UNIVERSE}x{CLI_UNIVERSE}", "--place",
             f"{CLI_UNIVERSE // 2},{CLI_UNIVERSE // 2}", "--gens", "100"]
_MSECS = re.compile(r"\d+\.\d+ msecs")
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
# Phase 4f: the server lane. The pipeline load (BATCH_BOARDS per bucket at
# SERVER_LIMIT) through a real server per lane; the cache load; the
# restart drill of tools/serve_smoke.py.
SERVER_LIMIT = 1000
SERVER_LANES = {"depth 1": {}, "depth 2": {"pipeline_depth": 2},
                "max-inflight 2": {"max_inflight": 2},
                # A diagnostic beside them: no journal, so no fsync per
                # submit and per batch.
                "depth 1, no journal": {"journal_dir": None}}
CACHE_JOBS, CACHE_UNIQUES = 128, 16
DRILL_JOBS, DRILL_LIMIT = 50, 400
# Phase 4g: bench.py's megabatch suite (bench.py:696-910), uncut.
RING_SIDES, RING_BOARDS, RING_LIMIT = (256, 250), 64, 4
RING_MAX_BATCH, RING, RING_T = 8, 4, 4
RING_LANES = {
    "depth1": {"depth": 1},
    "depth2": {"depth": 2},
    "depth4": {"depth": 4},
    "resident_depth8": {"depth": 2 * RING, "resident": RING},
    f"resident_depth8_T{RING_T}": {"depth": 2 * RING, "resident": RING,
                                   "temporal_depth": RING_T},
}
RING_REPEATS = 3
RING_DRILL_JOBS, RING_DRILL_LIMIT = 64, 1000
# Phase 4h: the tuner's full-width search.
TUNE_ARGS = ["--shape", f"{SIZE}x{SIZE}", "--convention", "c", "--quick",
             "--gen-limit", "64", "--serve-board", "256x256"]
PACKED = [k for k in KERNELS if not k.get("cells") and not k.get("ghosts")]
BYTE = [k for k in KERNELS if k.get("cells") and not k.get("ghosts")]
SHARD = [k for k in KERNELS if k.get("ghosts") in ("rows", "deep")
         and not k.get("cells")]
PLANE = [k for k in KERNELS if k.get("ghosts") == "plane"]
SHARD_BYTE = [k for k in KERNELS if k.get("ghosts") and k.get("cells")]
# The main path's lanes: CLI flags and the kernels each must launch.
LANES = {
    "auto": (["--kernel", "auto"], ("bandt_fast", "bandt", "band", "encode",
                                    "decode")),
    "pallas": (["--kernel", "pallas"], ("byte_band",)),
    "packed_io": (["--packed-io"], ("bandt_fast", "bandt", "band")),
}
# The mesh path's lanes, all under --variant tpu.
MESH_LANES = {
    "4x1 auto": (["--mesh", "4x1", "--kernel", "auto"],
                 ("bandtrow_fast", "bandtrow", "dist_band", "encode", "decode")),
    "4x1 pallas": (["--mesh", "4x1", "--kernel", "pallas"], ("dist_byte_band",)),
    "2x2 auto": (["--mesh", "2x2", "--kernel", "auto"],
                 ("bandtg_fast", "bandtg", "dist_band", "encode", "decode")),
    "2x2 packed_io": (["--mesh", "2x2", "--packed-io"],
                      ("bandtg_fast", "bandtg", "dist_band")),
    "2x2 pallas": (["--mesh", "2x2", "--kernel", "pallas"], ("dist_byte_band",)),
}
MESH_DEVICES = "4"
# The single-device --packed-io lane that prints its I/O lines (under
# --variant tpu; the serial variants print none).
IO_LANE = ["--mesh", "1x1", "--packed-io"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"\n== {title} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _zero_counters() -> None:
    for counters in (sp.LAUNCHES, spl.LAUNCHES, sb.LAUNCHES, stl.LAUNCHES):
        for k in counters:
            counters[k] = 0


def _counts() -> dict:
    return {**sp.LAUNCHES, **spl.LAUNCHES, **sb.LAUNCHES, **stl.LAUNCHES}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


# ---------------------------------------------------------------------------
# 1. Card and build


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_and_build() -> str:
    smi = _smi()
    print(smi)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(_build.build, "stencil_packed"),
                  pool.submit(_build.build, "stencil_pallas"),
                  pool.submit(_build.build, "stencil_batch"),
                  pool.submit(_build.build, "stencil_tile"),
                  pool.submit(_build.build, "packed_codec"),
                  pool.submit(native.load)]
        for b in builds:
            b.result()
    sp.load_kernels()
    spl.load_kernels()
    sb.load_kernels()
    stl.load_kernels()
    print(f"built and loaded {_build.library_path('stencil_packed').name}, "
          f"{_build.library_path('stencil_pallas').name}, "
          f"{_build.library_path('stencil_batch').name}, "
          f"{_build.library_path('stencil_tile').name}, "
          f"{_build.library_path('packed_codec').name} and the codec in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in ("stencil_packed", "stencil_pallas", "stencil_batch",
                 "stencil_tile", "packed_codec"):
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


def _tile_stack(batch: int, tile: int, kind: str, rng) -> np.ndarray:
    """(batch, tile + 2, tile + 2) blocks: random cells (ring included), a
    still block in every tile, or all zero (the ladder's padding rows)."""
    p = tile + 2
    blocks = np.zeros((batch, p, p), np.uint8)
    if kind == "random":
        blocks[:] = rng.random((batch, p, p), dtype=np.float32) < 0.5
    elif kind == "still":
        blocks[:, 2:4, 2:4] = 1
    return blocks


def check_tile_kernel(dev, stats: dict) -> None:
    """T1 against its plain version in both output forms: compact (B, t, t),
    and the interior of a padded stack whose ring must be left as it was."""
    rng = np.random.default_rng(SEED + 11)
    for batch, tile in TILE_CHECK_SHAPES:
        for kind in ("random", "still", "zero"):
            x = torch.from_numpy(_tile_stack(batch, tile, kind, rng)).to(dev)
            want, want_flags = stl._tile_step_plain(x)
            for form in ("compact", "padded"):
                out = (torch.full((batch, tile, tile), 7, dtype=torch.uint8, device=dev)
                       if form == "compact" else torch.full_like(x, 7))
                flags = torch.zeros((batch, stl.TILE_FLAGS), dtype=torch.int32,
                                    device=dev)
                stl.tile_step_into(x, out, flags)
                torch.cuda.synchronize(dev)
                got = out if form == "compact" else out[:, 1:-1, 1:-1]
                err = max(int((got.to(torch.int32) - want.to(torch.int32)).abs().max()),
                          int((flags - want_flags).abs().max()))
                if form == "padded":
                    ring = out.clone()
                    ring[:, 1:-1, 1:-1] = 7
                    err = max(err, int((ring != 7).sum()))
                stats["tile_step"]["max_abs_err"] = max(
                    stats["tile_step"]["max_abs_err"], err)
                stats["tile_step"]["checks"] += 1
                if err:
                    fail(f"T1 differs from its plain version at ({batch}, {tile}) "
                         f"on {kind} blocks, {form} output")
        print(f"T1 at (tiles, edge) ({batch}, {tile}) == plain on random, still "
              "and all-zero blocks, compact and padded output (tolerance 0: "
              "interiors, flags and the untouched ring)", flush=True)


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if torch.equal(got, want):
        return 0
    if got.dtype == torch.int32:
        got, want = _u32(got), _u32(want)
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_codec_kernels(dev, stats: dict) -> None:
    """E1 and D1 against ``packed_math.encode``/``decode`` at CODEC_SHAPES
    and CODEC_BIG^2, on random bytes of which about half are 0 (so words
    are not all ones), made on the card from a seed; then D1(E1(x)) must
    be x != 0."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for height, width in [*CODEC_SHAPES, (CODEC_BIG, CODEC_BIG)]:
        cells = torch.randint(0, 256, (height, width), dtype=torch.uint8,
                              device=dev, generator=gen)
        cells.mul_(torch.randint(0, 2, (height, width), dtype=torch.uint8,
                                 device=dev, generator=gen))
        words = sp.encode(cells)
        err = {"encode": _max_abs_err(words, pm.encode(cells))}
        back = sp.decode(words)
        err["decode"] = _max_abs_err(back, pm.decode(words))
        round_trip = torch.equal(back, cells.ne(0).to(torch.uint8))
        for key, e in err.items():
            stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], e)
            stats[key]["checks"] += 1
        if any(err.values()) or not round_trip:
            fail(f"E1/D1 at ({height}, {width}): max abs err {err}, D1(E1(x)) "
                 f"{'==' if round_trip else '!='} (x != 0)")
        print(f"E1, D1 at ({height}, {width}) [{height * width} cells]: equal to "
              "the plain versions (tolerance 0); D1(E1(x)) == (x != 0)", flush=True)
        del cells, words, back
    torch.cuda.empty_cache()


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
    def check(stdout: str) -> str:
        want = oracle.run(grid, GameConfig(convention=convention, gen_limit=limit))
        gens = int(re.search(r"Generations:\t(\d+)", stdout).group(1))
        if gens != want.generations or out.read_bytes() != text_grid.encode(want.grid):
            raise AssertionError(f"generations {gens} vs oracle "
                                 f"{want.generations}, or output bytes differ")
        return f"Generations {gens} == oracle, output bytes == oracle"

    return check


def _flow_jobs(work: Path, write: bool = False) -> list:
    """(group, label, argv, cwd, check) per run; ``check(stdout)`` returns
    what it verified or raises AssertionError. ``write`` writes the input
    files and the variants' directories."""
    flows = _flows()
    jobs = []
    for name, grid in flows.items():
        n = grid.shape[0]
        inp = work / f"{name}.txt"
        if write:
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
                jobs.append((f"{variant} {n}", f"{name:8s} --variant {variant:4s} {lane:9s}",
                             [str(n), str(n), str(inp), "--variant", variant,
                              *flags, "--output", str(out)],
                             work, _expect_oracle(grid, convention, out)))
    random48 = flows["random48"]
    for variant in ("mpi", "collective", "async", "openmp"):
        cwd = work / variant
        if write:
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

        jobs.append(("variants", f"random48 --variant {variant}", ["48", "48",
                     str(work / "random48.txt"), "--variant", variant], cwd, check))
    return jobs


def flow_group(group: str, work: str) -> list[str]:
    """The phase-3 runs of one group through ``cli.main`` in this process,
    each from its own directory. Returns a line per run; raises
    RuntimeError at the first that differs from the oracle."""
    report = []
    for g, label, argv, cwd, check in _flow_jobs(Path(work)):
        if g != group:
            continue
        os.chdir(cwd)
        rc, text = _cli_capture(argv)
        if rc != 0:
            raise RuntimeError(f"{label} exited {rc}")
        try:
            report.append(f"{label}: {check(text)}")
        except (AssertionError, AttributeError) as e:
            raise RuntimeError(f"{label}: {e}") from None
    return report


def _run_flow_groups(work: Path) -> None:
    import multiprocessing

    groups = list(dict.fromkeys(job[0] for job in _flow_jobs(work, write=True)))
    with concurrent.futures.ProcessPoolExecutor(
            len(groups), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {g: pool.submit(flow_group, g, str(work)) for g in groups}
        for group, future in futures.items():
            try:
                report = future.result()
            except RuntimeError as err:
                fail(f"phase 3 flows ({group}): {err}")
            for line in report:
                print(line, flush=True)


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


def _fresh_process_flows(work: Path) -> None:
    """random64 ``--variant game`` on each lane (auto, pallas,
    ``--packed-io``) once more, each in a fresh ``python -m gol_tpu_torch``
    process, all at once: a fault that shows only in a new process's first
    run shows here."""
    procs = []
    for group, label, argv, cwd, check in _flow_jobs(work):
        if group == "game 64" and label.startswith("random64"):
            procs.append((label, check, subprocess.Popen(
                [sys.executable, "-m", "gol_tpu_torch", *argv], cwd=cwd,
                env=_subprocess_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    for label, check, proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"python -m gol_tpu_torch {label} exited {proc.returncode}:\n{stderr}")
        try:
            print(f"{label} (python -m): {check(stdout)}", flush=True)
        except (AssertionError, AttributeError) as e:
            fail(f"python -m gol_tpu_torch {label}: {e}")


def small_flows(work: Path) -> None:
    _run_flow_groups(work)
    _fresh_process_flows(work)
    _snapshot_and_resume(work, _subprocess_env())


def _cli_capture(args: list[str]) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


MESH_FLOW_LANES = [(mesh, ["--kernel", kernel]) for mesh in ("4x1", "2x2")
                   for kernel in ("auto", "pallas", "lax")] + [("1x4", ["--kernel", "auto"])]
PACKED_FLOW_LANES = [("4x1", ["--packed-io"]), ("2x2", ["--packed-io"])]


def variant_mesh_flows(variant: str, work: str) -> list[str]:
    """One variant's mesh runs on the eight flows, in this process: --mesh
    4x1 and 2x2 with --kernel auto, pallas and lax, --mesh 1x4 with auto,
    and at 64^2 --packed-io on 4x1 and 2x2. Returns a line per flow;
    raises RuntimeError at the first run that differs from the oracle."""
    work = Path(work)
    out = work / f"mesh.{variant}.out"
    report = []
    for name, grid in _flows().items():
        n = grid.shape[0]
        want = oracle.run(grid, GameConfig())
        want_bytes = text_grid.encode(want.grid)
        lines = ["Reading file:\tX msecs", f"Generations:\t{want.generations}",
                 "Execution time:\tX msecs", "Writing file:\tX msecs"]
        if variant != "openmp":
            lines.append("Finished")
        runs = 0
        for mesh, flags in MESH_FLOW_LANES + (PACKED_FLOW_LANES if n == 64 else []):
            rc, text = _cli_capture([str(n), str(n), str(work / f"{name}.txt"),
                                     "--variant", variant, "--mesh", mesh,
                                     *flags, "--output", str(out)])
            label = f"{name} --variant {variant} --mesh {mesh} {' '.join(flags)}"
            if rc != 0:
                raise RuntimeError(f"{label} exited {rc}")
            if _MS.sub("X msecs", text).splitlines() != lines:
                raise RuntimeError(f"{label}: printed {text!r}, want {lines}")
            if out.read_bytes() != want_bytes:
                raise RuntimeError(f"{label}: output bytes differ from the oracle")
            runs += 1
        report.append(f"{name:8s} --variant {variant:10s}: {runs} mesh runs (4x1, 2x2 "
                      f"x auto, pallas, lax; 1x4 auto"
                      f"{'; 4x1, 2x2 packed-io' if n == 64 else ''}): Generations "
                      f"{want.generations}, bytes and printed lines == oracle")
    return report


def mesh_flows(work: Path) -> dict:
    """The eight flows over four shards on the card: every distributed
    variant through ``variant_mesh_flows``, one worker process each, the
    five at once (each drives the card from its own process, as phase 3's
    subprocesses do). Then, in this process, the one-word shards of 64^2
    under --mesh 2x2, and snapshots and resume under --mesh 2x2
    (subprocesses). Returns the launch counts of the one-word-shard
    runs."""
    import multiprocessing

    out = work / "mesh.out"
    variants = ("tpu", "collective", "async", "openmp", "mpi")
    with concurrent.futures.ProcessPoolExecutor(
            len(variants), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {v: pool.submit(variant_mesh_flows, v, str(work)) for v in variants}
        for variant, future in futures.items():
            try:
                report = future.result()
            except RuntimeError as err:
                fail(f"--variant {variant} over a mesh: {err}")
            for line in report:
                print(line, flush=True)

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
    _check_launches(counts, ("bandtg_fast", "bandtg", "encode", "decode"),
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
                _check_codec(launched, 1 if lane == "auto" else 0,
                             f"({tag}) {variant} {key} {lane}")
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
            before = _counts()
            gens, ms = run(variant, ["--kernel", "lax"], key, limit)
            _check_codec({k: n - before[k] for k, n in _counts().items()}, 0,
                         f"({tag}) {variant} {key} lax")
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


def _check_codec(launched: dict, per_run: int, where: str) -> None:
    """E1 and D1 launched ``per_run`` times each in one run (once per shard
    of a byte-state lane, never elsewhere)."""
    if launched["encode"] != per_run or launched["decode"] != per_run:
        fail(f"{where}: E1 launched {launched['encode']} and D1 "
             f"{launched['decode']} times, expected {per_run} each")


def _check_launches(counts: dict, needed, where: str) -> None:
    for k in KERNELS + CODEC_KERNELS:
        n = counts[k["key"]]
        if (k["key"] in needed) != (n > 0):
            fail(f"{k['id']} ({k['key']}) launched {n} times on the {where} path")


def mesh_path(work: Path, dev, path: dict) -> dict:
    """--variant tpu over four shards at 16384^2, against the single-device
    --kernel auto runs of main_path; then the CUDA convention's empty exit
    on a 4x1 and a 2x2 mesh through the engine."""
    inputs, results, runs = path["inputs"], path["results"], path["runs"]
    out = work / "out.txt"

    io_lines = {}

    def run(flags, key, limit):
        gens, ms, text = _cli([str(SIZE), str(SIZE), str(inputs[key]), "--variant",
                               "tpu", *flags, "--gen-limit", str(limit),
                               "--output", str(out)])
        if "--packed-io" in flags and key == "random" and limit == 1000:
            io_lines[" ".join(flags)] = _io_lines(text, ms)
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
            _check_codec(launched, 4 if lane.endswith("auto") else 0,
                         f"({tag}) tpu {key} {lane}")
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
        _check_codec(by_path[where], 8, f"engine {where}, its two runs")
    print("mesh run (a) Execution time, ms: " + ", ".join(
        f"{p} {r['exec_ms']:.3f}" for p, r in run_a.items()), flush=True)

    # The single-device --packed-io lane's I/O lines (tpu prints them; the
    # serial variants of phase 4 do not), in a process phase 4's
    # --packed-io lane warmed.
    _zero_counters()
    gens, _ = run(IO_LANE, "random", 1000)
    if (gens, _digest(out)) != results[("game", "random", 1000)]:
        fail("(a) tpu --mesh 1x1 --packed-io: Generations or bytes differ from "
             "single-device --kernel auto")
    _check_launches(_counts(), ("bandt_fast",), "--variant tpu --mesh 1x1 --packed-io")
    for flags, lines in io_lines.items():
        print(f"(a) packed I/O, tpu {flags}: " + json.dumps(lines), flush=True)
    return {"launches": by_path, "run_a": run_a, "io": io_lines}


def _io_lines(text: str, exec_ms: float) -> dict:
    """The Reading/Writing file lines of a run's printed output, in ms."""
    lines = {"exec_ms": exec_ms}
    for key, label in (("read_ms", "Reading file"), ("write_ms", "Writing file")):
        m = re.search(rf"{label}:\t([0-9.]+) msecs", text)
        if not m:
            fail(f"no '{label}' line in:\n{text}")
        lines[key] = float(m.group(1))
    return lines


# --io-compare: the packed I/O lanes of run (a), each tree's CLI in a
# process of its own that runs it 1 + IO_TIMED times (the first, which also
# creates the CUDA context and loads the kernels, uncounted).
IO_COMPARE_LANES = {"tpu 1x1 packed_io": IO_LANE,
                    "tpu 2x2 packed_io": ["--mesh", "2x2", "--packed-io"]}
IO_TIMED = 2
_REPEATED_MAIN = ("import sys\n"
                  "from gol_tpu_torch import cli\n"
                  "for _ in range(int(sys.argv[1])):\n"
                  "    assert cli.main(sys.argv[2:]) == 0\n")


def io_compare(trees: list[Path], size: int, rounds: int) -> dict:
    """``--io-compare``: the ``Reading file``/``Writing file`` lines of
    run (a) on IO_COMPARE_LANES for each tree of the repository, on one
    random ``size``^2 grid (SEED), ``rounds`` rounds of a process per tree
    and lane, odd rounds taking the trees in reverse order. Two versions
    compare only within one call on one machine. Every output must be
    byte-identical across trees and rounds."""
    work = Path(tempfile.mkdtemp(prefix="io-compare-", dir=_build.BUILD_DIR))
    try:
        grid, out = work / "grid.txt", work / "out.txt"
        text_grid.generate_to_file(str(grid), size, size, seed=SEED)
        runs = {str(t): {lane: [] for lane in IO_COMPARE_LANES} for t in trees}
        digests = {}
        for r in range(rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                for lane, flags in IO_COMPARE_LANES.items():
                    env = {**os.environ, platform_env.MESH_DEVICES_ENV: MESH_DEVICES,
                           "PYTHONPATH": os.pathsep.join(filter(None, [
                               str(tree), os.environ.get("PYTHONPATH")]))}
                    proc = subprocess.run(
                        [sys.executable, "-c", _REPEATED_MAIN, str(1 + IO_TIMED),
                         str(size), str(size), str(grid), "--variant", "tpu", *flags,
                         "--gen-limit", "1000", "--output", str(out)],
                        cwd=work, env=env, capture_output=True, text=True, timeout=900)
                    if proc.returncode != 0:
                        fail(f"{tree}: {lane} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
                    # One block of printed lines per run, each from its
                    # 'Reading file' line on.
                    blocks = proc.stdout.split("Reading file")[1:]
                    if len(blocks) != 1 + IO_TIMED:
                        fail(f"{tree}: {lane} printed {len(blocks)} runs")
                    timed = [_io_lines("Reading file" + b, float(re.search(
                        r"Execution time:\t([0-9.]+) msecs", b).group(1)))
                        for b in blocks[1:]]
                    digest = _digest(out)
                    if digests.setdefault(lane, digest) != digest:
                        fail(f"{tree}: {lane} output differs from the first tree's")
                    runs[str(tree)][lane] += timed
                    print(f"round {r} {tree} {lane}: {json.dumps(timed)}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"size": size, "rounds": rounds, "timed_per_process": IO_TIMED,
            "seed": SEED, "runs": runs}


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
        counts = by_path[f"game auto checkpoint {name}"]
        if counts["bandt_fast"] == 0 or counts["encode"] == 0 or counts["decode"] == 0:
            fail(f"--checkpoint-every 250 ({name}) launched no K1, E1 or D1: "
                 f"{_nonzero(counts)}")
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
# E1's and D1's kernel events in each profiled lane's capture: one per
# shard of a byte-state lane.
PROFILED_CODEC = {"game auto": 1, "game packed_io": 0, "tpu 4x1 auto": 4,
                  "tpu 2x2 auto": 4}
CODEC_EVENTS = ("pack_cells_kernel", "unpack_words_kernel")


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
    ``needle``, the profiled window (the capture's ``CAPTURE_REGION``
    range, stretched over any kernel that ends after it), the union of
    the kernel intervals over it, the time from the profiler's start to
    the first kernel (``_guard``'s idle before the body, and more), and
    the host ops that take the most of the window (top-level CPU ops by
    summed duration)."""
    if not trace_json.exists():
        fail(f"--profile wrote no {trace_json}")
    every = [e for e in json.loads(trace_json.read_text())["traceEvents"]
             if e.get("ph") == "X" and "dur" in e]
    events = [e for e in every if e.get("cat") != "Trace"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        fail(f"{trace_json}: the capture recorded no CUDA kernel")
    region = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == profiler.CAPTURE_REGION]
    if len(region) != 1:
        fail(f"{trace_json}: {len(region)} {profiler.CAPTURE_REGION} ranges, want 1")
    started = [e["ts"] for e in every if e.get("cat") == "Trace"]
    first = min(e["ts"] for e in kernels)
    lo = min(region[0]["ts"], first)
    hi = max(region[0]["ts"] + region[0]["dur"],
             max(e["ts"] + e["dur"] for e in kernels))
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    host = {}
    for e in events:
        if e.get("cat") == "cpu_op" and lo <= e["ts"] <= hi:
            n, t = host.get(e["name"], (0, 0.0))
            host[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(host.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "events": sum(needle in e["name"] for e in kernels),
        "kernel_events": len(kernels),
        "window_ms": (hi - lo) / 1e3,
        "kernel_busy_ms": busy / 1e3,
        "device_busy_share": busy / (hi - lo),
        "first_kernel_after_start_ms": (first - min(started)) / 1e3 if started else None,
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


def _captured(pdir: Path, needle: str) -> tuple[dict, dict]:
    """A profiled lane's capture: its summary and its kernel events named
    ``needle`` and each of CODEC_EVENTS."""
    summary = profile_summary(pdir / "trace.json", needle)
    summary["codec_events"] = {
        n: profile_summary(pdir / "trace.json", n)["events"] for n in CODEC_EVENTS}
    return summary, {needle: summary["events"], **summary["codec_events"]}


def _launched(counts: dict) -> dict:
    """The launch counters in the form of ``_captured``'s events: every
    ``bandt_kernel`` form, E1 and D1."""
    return {"bandt_kernel": sum(counts[k["key"]] for k in KERNELS
                                if "bandt_kernel" in k["name"]),
            "pack_cells_kernel": counts["encode"],
            "unpack_words_kernel": counts["decode"]}


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
        expected = {needle: count,
                    **{n: PROFILED_CODEC[lane] for n in CODEC_EVENTS}}
        summary, got = _captured(pdir, needle)
        if (got != expected
                and _launched(by_path[f"{lane} --profile (4d)"]) == expected):
            # The counters show every kernel launched, so the capture lost
            # records (seen before the capture's guard: 496 and 492 of 500,
            # the first kernels of the run): capture it once more, and keep
            # both captures' counts and busy shares in the lane's line.
            first_capture = {"kernel_events": got, **{k: summary[k] for k in (
                "device_busy_share", "first_kernel_after_start_ms")}}
            print(f"{lane} --profile: the first capture holds {json.dumps(first_capture)} "
                  f"of the kernels the run launched ({expected}); capturing again",
                  flush=True)
            shutil.rmtree(pdir)
            _zero_counters()
            exec_ms, _ = traced([*flags, "--profile", str(pdir)])
            by_path[f"{lane} --profile (4d)"] = _counts()
            summary, got = _captured(pdir, needle)
            summary["first_capture"] = first_capture
        if got != expected:
            fail(f"{lane} --profile: CUDA kernel events {got}, expected {expected}; "
                 f"the run's launch counters "
                 f"{_launched(by_path[f'{lane} --profile (4d)'])}; the first kernel "
                 f"{summary['first_kernel_after_start_ms']} ms after the "
                 "profiler's start")
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


def _trio() -> list:
    """JAX's mixed-fate trio at 32^2: a board that dies, a still life and
    a soup that runs to its limit, each with its exit reason."""
    dies = np.zeros((32, 32), np.uint8)
    dies[4, 4] = 1
    still = np.zeros((32, 32), np.uint8)
    still[3:5, 3:5] = 1
    return [(dies, "empty"), (still, "similar"),
            (text_grid.generate(32, 32, seed=7), "gen_limit")]


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
    trio = _trio()
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
# 4f. The server lane


def _http(method: str, url: str, body=None, raw: bytes | None = None,
          content_type: str = "application/json", accept: str | None = None,
          timeout: float = 120) -> tuple[int, str, bytes]:
    """One HTTP exchange: ``(status, response content type, body)``."""
    data = json.dumps(body).encode() if body is not None else raw
    headers = {"Content-Type": content_type} if data is not None else {}
    if accept:
        headers["Accept"] = accept
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _post_job(base: str, i: int, job) -> str:
    """POST one (board, convention, gen_limit) job: even pairs as JSON,
    odd pairs as a packed wire frame, so each bucket gets both formats."""
    board, convention, limit = job
    meta = {"convention": convention, "gen_limit": limit}
    if (i // 2) % 2:
        status, _, raw = _http("POST", f"{base}/jobs",
                               raw=wire.encode_frame(meta, grid=board),
                               content_type=wire.CONTENT_TYPE)
    else:
        status, _, raw = _http("POST", f"{base}/jobs", {
            "width": board.shape[1], "height": board.shape[0],
            "cells": text_grid.encode(board).decode("ascii"), **meta})
    if status != 202:
        fail(f"POST /jobs {i} answered {status}: {raw[:200]!r}")
    return json.loads(raw)["id"]


def _fetch_results(base: str, job_id: str):
    """``GET /result/<id>`` as JSON and as a packed frame: both decoded to
    ``(grid, generations, exit_reason)``."""
    status, _, raw = _http("GET", f"{base}/result/{job_id}")
    if status != 200:
        fail(f"GET /result/{job_id} answered {status}: {raw[:200]!r}")
    p = json.loads(raw)
    as_json = (text_grid.decode(p["grid"].encode("ascii"), p["width"], p["height"]),
               p["generations"], p["exit_reason"])
    status, ctype, raw = _http("GET", f"{base}/result/{job_id}",
                               accept=wire.CONTENT_TYPE)
    if status != 200 or not wire.is_packed(ctype):
        fail(f"packed GET /result/{job_id} answered {status} {ctype}")
    frame = wire.decode_frame(raw)
    return as_json, (frame.grid(), frame.meta["generations"],
                     frame.meta["exit_reason"])


def _same(got, want, reason: str) -> bool:
    """``got`` as ``(grid, generations, exit reason)`` equals the solo run
    ``want`` and the exit reason ``reason``."""
    return (np.array_equal(got[0], want.grid) and got[1] == want.generations
            and got[2] == reason)


def _solo(board, convention: str, limit: int):
    """The solo ``engine.simulate`` of one board (``--kernel auto`` where
    the width packs, ``pallas`` otherwise) and its exit reason, which a
    solo run does not report: that of the board batched alone."""
    cfg = GameConfig(convention=convention, gen_limit=limit)
    want = engine.simulate(board, cfg,
                           kernel="auto" if board.shape[1] % 32 == 0 else "pallas")
    return want, engine.simulate_batch([board], cfg)[0].exit_reason


def _server_load() -> tuple[list, list]:
    """bench.py's serving load (--suite pipeline at full size): 64 random
    256^2 boards and 64 random 250^2 boards at gen_limit 1000, C
    convention, interleaved, then the mixed-fate trio at 32^2 in both
    conventions. Returns the jobs and the trio's exit reasons."""
    rng = np.random.default_rng(SEED + 7)
    load = []
    for _ in range(BATCH_BOARDS):
        for side in BATCH_SIDES.values():
            load.append((rng.integers(0, 2, (side, side), dtype=np.uint8),
                         Convention.C, SERVER_LIMIT))
    reasons = []
    for convention in (Convention.C, Convention.CUDA):
        for board, reason in _trio():
            load.append((board, convention, 60))
            reasons.append(reason)
    return load, reasons


def _serve_once(work: Path, tag: str, kwargs: dict, load: list,
                profile_dir: Path | None = None, dev=None) -> dict:
    """One fresh ``GolServer`` with a journal: every job POSTed by eight
    client threads, then ``POST /drain``; jobs/s over first POST to the
    drain's answer. Returns the ids, the rates, the job latency quantiles
    of ``/metrics?format=json`` and each timeline segment's mean over the
    jobs (``GET /jobs/<id>/timeline``)."""
    srv = GolServer(port=0, **{"journal_dir": str(work / f"journal_{tag}"),
                               **kwargs})
    srv.start()
    try:
        base = srv.url
        with profiler.capture(str(profile_dir) if profile_dir else None,
                              dev or "cpu"):
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                ids = list(pool.map(lambda ij: _post_job(base, *ij),
                                    enumerate(load)))
            posted = time.perf_counter() - t0
            status, _, raw = _http("POST", f"{base}/drain", {})
            elapsed = time.perf_counter() - t0
        if status != 200 or not json.loads(raw)["drained"]:
            fail(f"{tag}: POST /drain answered {status}: {raw[:200]!r}")
        snap = json.loads(_http("GET", f"{base}/metrics?format=json")[2])
        hist = snap["histograms"]["job_latency_seconds"]
        counters = snap["counters"]
        results = {jid: _fetch_results(base, jid) for jid in ids}
        segments: dict = {}
        for jid in ids:
            for name, sec in json.loads(_http(
                    "GET", f"{base}/jobs/{jid}/timeline")[2])["segments"].items():
                segments[name] = segments.get(name, 0.0) + sec / len(ids)
    finally:
        srv.shutdown()
    if counters.get("jobs_completed_total") != len(load):
        fail(f"{tag}: {counters.get('jobs_completed_total')} of {len(load)} "
             "jobs completed")
    return {"ids": ids, "results": results, "elapsed_s": elapsed,
            "posted_s": posted, "mean_segments_s": segments,
            "jobs_per_sec": len(load) / elapsed,
            "boards_per_sec": counters["boards_total"] / elapsed,
            "batches": counters["batches_total"],
            "latency_p50_s": hist["p50"], "latency_p99_s": hist["p99"]}


def _cache_load():
    """bench.py's cache suite: 128 jobs over 16 unique random 256^2
    boards, Zipf repeat counts, shuffled."""
    rng = np.random.default_rng(SEED + 8)
    side = BATCH_SIDES["256x256/packed"]
    boards = [rng.integers(0, 2, (side, side), dtype=np.uint8)
              for _ in range(CACHE_UNIQUES)]
    weights = [1.0 / r for r in range(1, CACHE_UNIQUES + 1)]
    counts = [max(1, int(w * CACHE_JOBS / sum(weights))) for w in weights]
    counts[0] += CACHE_JOBS - sum(counts)
    order = [i for i, c in enumerate(counts) for _ in range(c)]
    rng.shuffle(order)
    return boards, order, counts


def _cache_lane(boards, order, cache=None) -> tuple[dict, list]:
    """One fresh ``Scheduler`` over the cache load; ``cache`` None is the
    cold lane. Returns the lane's rates and counters, and its jobs."""
    metrics = Metrics()
    if cache is not None:
        cache.metrics = metrics
    sched = Scheduler(metrics=metrics, cache=cache, flush_age=0.01)
    sched.start()
    t0 = time.perf_counter()
    jobs = [sched.submit(new_job(boards[i].shape[1], boards[i].shape[0],
                                 boards[i], gen_limit=SERVER_LIMIT))
            for i in order]
    if not sched.drain(timeout=300):
        fail("the cache lane did not drain in 300 s")
    elapsed = time.perf_counter() - t0
    sched.stop()
    c = metrics.snapshot()["counters"]
    return {"jobs_per_sec": len(jobs) / elapsed, "elapsed_s": elapsed,
            "hits": c.get("cache_hits_total", 0),
            "misses": c.get("cache_misses_total", 0),
            "coalesced": c.get("cache_inflight_coalesced_total", 0),
            "batches": c.get("batches_total", 0)}, jobs


def _start_serve(args: list, log: Path) -> tuple[subprocess.Popen, str]:
    """``python -m gol_tpu_torch serve --port 0 ...`` on the card, in a
    session of its own: returns the process and its URL once it serves."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", "serve", "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=log.open("a"), text=True,
        env=_subprocess_env(), start_new_session=True)
    line = proc.stdout.readline()
    if not line.startswith("serving on "):
        fail(f"serve exited {proc.wait()} before serving:\n{line}{log.read_text()}")
    return proc, line.split()[2]


def _stop(proc: subprocess.Popen | None) -> None:
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.stdout.close()


def _done_records(journal: Path) -> dict:
    done: dict = {}
    for rec in compaction.iter_records(str(journal)):
        if rec.get("event") == "done":
            done.setdefault(rec["id"], []).append(rec)
    return done


def restart_drill(work: Path) -> dict:
    """tools/serve_smoke.py's drill against ``python -m gol_tpu_torch
    serve`` on the card, with a journal and the result cache: 50 jobs
    across the 32^2 (packed) and 30^2 (masked) buckets in two waves — the
    first run to done, the second accepted and queued behind a 0.5 s
    flush age — SIGKILL, restart on the same journal, replay. Every
    accepted id has exactly one done record and its result equals the
    oracle. Then ``submit`` of 8 files against the restarted server writes
    outputs byte-equal to solo ``run``s, and ``gc`` reads its CAS."""
    journal = work / "drill_journal"
    log = work / "drill_serve.log"
    args = ["--journal-dir", str(journal), "--result-cache",
            "--flush-age", "0.5"]
    sides = [32 if i % 2 == 0 else 30 for i in range(DRILL_JOBS)]
    boards = [text_grid.generate(s, s, seed=1000 + i) for i, s in enumerate(sides)]
    proc = None
    try:
        proc, base = _start_serve(args, log)
        accepted = {}
        half = DRILL_JOBS // 2
        for i, board in enumerate(boards):
            if i == half:
                deadline = time.perf_counter() + 60
                while len(_done_records(journal)) < half:
                    if time.perf_counter() > deadline:
                        fail("the drill's first wave did not finish in 60 s")
                    time.sleep(0.05)
            status, _, raw = _http("POST", f"{base}/jobs", {
                "width": board.shape[1], "height": board.shape[0],
                "cells": text_grid.encode(board).decode("ascii"),
                "gen_limit": DRILL_LIMIT})
            if status != 202:
                fail(f"drill submit {i} answered {status}: {raw[:200]!r}")
            accepted[json.loads(raw)["id"]] = board
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
        proc = None
        done_before = len(_done_records(journal))
        t0 = time.perf_counter()
        proc, base = _start_serve(args, log)
        pending = set(accepted)
        deadline = time.perf_counter() + 120
        while pending and time.perf_counter() < deadline:
            for job_id in list(pending):
                status, _, raw = _http("GET", f"{base}/jobs/{job_id}")
                state = json.loads(raw).get("state") if status == 200 else None
                if status != 200 or state in ("failed", "cancelled"):
                    fail(f"drill job {job_id} after the restart: {status} {raw[:200]!r}")
                if state == "done":
                    pending.discard(job_id)
            time.sleep(0.05 if pending else 0)
        if pending:
            fail(f"{len(pending)} drill job(s) never completed after the restart")
        replay_s = time.perf_counter() - t0
        replay_segments: dict = {}
        for job_id in accepted:
            tl = json.loads(_http("GET", f"{base}/jobs/{job_id}/timeline")[2])
            if not tl.get("restored"):
                for name, sec in tl["segments"].items():
                    replay_segments[name] = replay_segments.get(name, 0.0) + sec
        done = _done_records(journal)
        lost, extra = set(accepted) - set(done), set(done) - set(accepted)
        dup = {k: len(v) for k, v in done.items() if len(v) != 1}
        if lost or extra or dup:
            fail(f"drill ledger: lost {lost}, unknown {extra}, duplicated {dup}")
        cfg = GameConfig(gen_limit=DRILL_LIMIT)
        for job_id, (rec,) in done.items():
            want = oracle.run(accepted[job_id], cfg)
            got = text_grid.decode(rec["grid"].encode("ascii"), rec["width"],
                                   rec["height"])
            if not np.array_equal(got, want.grid) or rec["generations"] != want.generations:
                fail(f"drill job {job_id}: its done record differs from the oracle")
        n_replayed = len(accepted) - done_before
        print(f"restart drill: {len(accepted)} accepted, {done_before} done "
              f"before the SIGKILL, the rest done {replay_s:.2f} s after the "
              "restart's exec, process start included (their mean timeline "
              "segments, ms: " + json.dumps(
                  {k: round(v / max(n_replayed, 1) * 1e3, 3)
                   for k, v in replay_segments.items()})
              + "); every accepted id has exactly one done record, all == "
              "the oracle", flush=True)

        # submit of 8 files against the restarted server, against solo runs.
        files = []
        for i in range(8):
            files.append(work / f"submit{i}.txt")
            text_grid.write_grid(str(files[i]), text_grid.generate(32, 32, seed=2000 + i))
        outdir = work / "submit_out"
        sub = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "submit", "32", "32",
             *map(str, files), "--server", base, "--gen-limit", str(DRILL_LIMIT),
             "--output-dir", str(outdir), "--wire", "packed"],
            capture_output=True, text=True, timeout=300, env=_subprocess_env())
        if sub.returncode != 0:
            fail(f"submit exited {sub.returncode}:\n{sub.stderr}")
        # Result lines print in the order the polls find jobs done.
        lines = {ln.split("\t")[0]: ln for ln in sub.stdout.splitlines()
                 if "Generations:" in ln}
        solo_out = work / "drill_solo.out"
        for path in files:
            line = lines.get(str(path), "")
            gens, _, _ = _cli(["32", "32", str(path), "--variant", "tpu", "--mesh",
                               "1x1", "--gen-limit", str(DRILL_LIMIT),
                               "--output", str(solo_out)])
            got = outdir / (path.name + ".out")
            if (got.read_bytes() != solo_out.read_bytes()
                    or f"Generations:\t{gens}\t" not in line):
                fail(f"submit output {got.name} ({line!r}) differs from the solo "
                     f"run (Generations {gens})")
        if len(lines) != len(files):
            fail(f"submit printed {len(lines)} result lines for {len(files)} files")
        status, _, raw = _http("POST", f"{base}/drain", {})
        if status != 200 or not json.loads(raw)["drained"]:
            fail(f"drill drain answered {status}: {raw[:200]!r}")
        os.killpg(proc.pid, signal.SIGTERM)
        if proc.wait(timeout=60) != 0:
            fail(f"serve exited {proc.returncode} on SIGTERM")
        replay_line = proc.stdout.read().strip()
        proc.stdout.close()
        proc = None
        if replay_line != f"replayed {DRILL_JOBS - done_before} unfinished job(s) from the journal":
            fail(f"the restarted serve printed {replay_line!r}")
        gc = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "gc", str(journal / "cache")],
            capture_output=True, text=True, timeout=120, env=_subprocess_env())
        entries = re.match(r".*: (\d+) entr\(ies\)", gc.stdout)
        if gc.returncode != 0 or not entries or int(entries.group(1)) < len(files):
            fail(f"gc exited {gc.returncode}:\n{gc.stdout}{gc.stderr}")
        print(f"submit of {len(files)} files --wire packed: every output == the solo "
              f"run's bytes and Generations; gc: {gc.stdout.splitlines()[0]}",
              flush=True)
    finally:
        _stop(proc)
    return {"accepted": len(accepted), "done_before_kill": done_before,
            "replay_s": replay_s, "replay_line": replay_line,
            "replayed_mean_segments_s": {k: v / max(n_replayed, 1)
                                         for k, v in replay_segments.items()}}


def server_lane(work: Path, dev) -> dict:
    """Phase 4f: the server lane at full width. (i) bench.py's pipeline
    load through a real ``GolServer`` with a journal, half the jobs as
    JSON and half as packed frames, at ``--pipeline-depth`` 1 and 2,
    ``--max-inflight 2`` and depth 1 without a journal, each on a fresh
    server (best of two), every
    result through both result formats == the solo ``engine.simulate``
    and the trio == the oracle; (ii) bench.py's cache load through the
    ``Scheduler`` with a ``ResultCache``, cold, warm and coalesced, every
    result == the engine's; (iii) the restart drill. The counters are
    zeroed just before (i) and (ii) and read just after each."""
    t_phase = time.perf_counter()
    load, trio_reasons = _server_load()
    lanes, launches = {}, {}
    _zero_counters()
    for name, kwargs in SERVER_LANES.items():
        runs = [_serve_once(work, f"{name}-{r}".replace(" ", "_"), kwargs, load)
                for r in range(2)]
        lanes[name] = max(runs, key=lambda r: r["jobs_per_sec"])
        lanes[name]["runs_jobs_per_sec"] = [r["jobs_per_sec"] for r in runs]
    launches["server lane (4f i)"] = _counts()
    for k in KERNELS + BATCH_KERNELS:
        if (k["key"] in ("batch_packed", "batch_masked")) != (
                launches["server lane (4f i)"][k["key"]] > 0):
            fail(f"{k['id']} launched {launches['server lane (4f i)'][k['key']]} "
                 "times on the server lane")
    prof_dir = work / "prof_server_depth2"
    busy = _serve_once(work, "profiled", SERVER_LANES["depth 2"], load,
                       prof_dir, dev)
    summary = profile_summary(prof_dir / "trace.json", "batch_")
    t0 = time.perf_counter()
    solo = [_solo(*job) for job in load]
    for name, lane in lanes.items():
        for i, jid in enumerate(lane["ids"]):
            as_json, as_frame = lane["results"][jid]
            if not (_same(as_json, *solo[i]) and _same(as_frame, *solo[i])):
                fail(f"{name}: job {i}'s result ({as_json[1]}, {as_json[2]}) differs "
                     f"from its solo run ({solo[i][0].generations}, {solo[i][1]})")
    for i, reason in enumerate(trio_reasons):
        board, convention, limit = load[2 * BATCH_BOARDS + i]
        want = oracle.run(board, GameConfig(convention=convention, gen_limit=limit))
        if not _same((want.grid, want.generations, reason), *solo[2 * BATCH_BOARDS + i]):
            fail(f"trio board {i} ({convention}) differs from the oracle")
    print(f"server lane: {len(load)} jobs x {len(lanes)} lanes, JSON and packed "
          "results == solo engine.simulate (grid, Generations, exit reason), the "
          f"trio == the oracle; solo checks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, lane in lanes.items():
        print(f"server {name}: {lane['jobs_per_sec']:.1f} jobs/s, "
              f"{lane['boards_per_sec']:.1f} boards/s over {lane['batches']} "
              f"batches, job latency p50 {lane['latency_p50_s'] * 1e3:.1f} ms, "
              f"p99 {lane['latency_p99_s'] * 1e3:.1f} ms (runs "
              f"{[round(r, 1) for r in lane['runs_jobs_per_sec']]} jobs/s); every "
              f"POST answered at {lane['posted_s'] * 1e3:.1f} ms; mean timeline "
              "segments, ms: " + json.dumps({k: round(v * 1e3, 3) for k, v in
                                             lane["mean_segments_s"].items()}),
              flush=True)
    print(f"profile server depth 2: {summary['events']} batch kernel events, busy "
          f"{summary['kernel_busy_ms']:.3f} ms of a {summary['window_ms']:.3f} ms "
          f"window = {summary['device_busy_share']:.3f} ({busy['jobs_per_sec']:.1f} "
          f"jobs/s under the profiler); host ops {summary['host_ops_ms']}",
          flush=True)

    boards, order, counts = _cache_load()
    _cache_lane(boards, order)  # every ladder rung the lanes hit, built
    _zero_counters()
    cache_lanes = {}
    cache_lanes["cold"], cold_jobs = _cache_lane(boards, order)
    warm = ResultCache(memory_entries=256)
    _cache_lane(boards, order, warm)
    cache_lanes["warm"], warm_jobs = _cache_lane(boards, order, warm)
    cache_lanes["coalesced"], co_jobs = _cache_lane(
        boards, order, ResultCache(memory_entries=256))
    launches["cache lane (4f ii)"] = _counts()
    if cache_lanes["warm"]["hits"] != CACHE_JOBS or not cache_lanes["coalesced"]["coalesced"]:
        fail(f"cache lanes: {cache_lanes}")
    want = [_solo(b, Convention.C, SERVER_LIMIT) for b in boards]
    for name, jobs in (("cold", cold_jobs), ("warm", warm_jobs),
                       ("coalesced", co_jobs)):
        for i, job in zip(order, jobs):
            r = job.result
            if not _same((r.grid, r.generations, r.exit_reason), *want[i]):
                fail(f"cache lane {name}: a result differs from the engine's")
    ratio = cache_lanes["warm"]["jobs_per_sec"] / cache_lanes["cold"]["jobs_per_sec"]
    print(f"cache lane: {CACHE_JOBS} jobs over {CACHE_UNIQUES} unique 256^2 boards "
          f"(Zipf {counts}), gen_limit {SERVER_LIMIT}: " + ", ".join(
              f"{n} {v['jobs_per_sec']:.1f} jobs/s (hits {v['hits']}, coalesced "
              f"{v['coalesced']}, batches {v['batches']})"
              for n, v in cache_lanes.items())
          + f"; warm / cold = {ratio:.1f}; every result == the engine's", flush=True)

    drill = restart_drill(work)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4f took {seconds:.1f} s", flush=True)
    return {"launches": launches, "seconds": seconds, "drill": drill,
            "lanes": {n: {k: v for k, v in lane.items() if k not in ("ids", "results")}
                      for n, lane in lanes.items()},
            "busy": summary, "cache": cache_lanes, "warm_over_cold": ratio}


# ---------------------------------------------------------------------------
# 4g. The resident ring


def _ring_load() -> dict:
    """bench.py's megabatch boards: 32 per side, from its seeds."""
    return {side: [text_grid.generate(side, side, seed=3000 + side + i)
                   for i in range(RING_BOARDS // 2)] for side in RING_SIDES}


def _ring_marginal(boards: list, side: int, depth: int) -> float:
    """A bucket's marginal rate (bench.py's): its batch runner timed at G
    and 3G generations, best of RING_REPEATS, the rate from the
    difference, so every fixed cost cancels."""
    chunk = boards[:RING_MAX_BATCH]
    pad = batcher.pad_dim(side)
    times = {}
    for g in (RING_LIMIT, 3 * RING_LIMIT):
        def staged():
            return engine.stage_batch(chunk, GameConfig(gen_limit=g),
                                      padded_shape=(pad, pad),
                                      pad_batch_to=RING_MAX_BATCH,
                                      temporal_depth=depth)
        engine.complete_batch(engine.dispatch_batch(staged()))
        best = float("inf")
        for _ in range(RING_REPEATS):
            s = staged()
            t0 = time.perf_counter()
            engine.complete_batch(engine.dispatch_batch(s))
            best = min(best, time.perf_counter() - t0)
        times[g] = best
    per_gen = max(times[3 * RING_LIMIT] - times[RING_LIMIT], 1e-9) / (2 * RING_LIMIT)
    return side * side * RING_MAX_BATCH / per_gen


def _ring_run(work: Path, tag: str, boards: dict, depth: int, resident: int = 0,
              temporal_depth: int = 1, profile_dir: Path | None = None,
              dev=None) -> dict:
    """One fresh ``Scheduler`` with a journal over the megabatch load (the
    sides interleaved, as bench.py submits them): its rate, jobs and ring
    counters."""
    batcher._PLAN = ServePlan(temporal_depth=temporal_depth)
    obs_registry.reset_default()
    try:
        journal = JobJournal(str(work / f"ring_journal_{tag}"))
        sched = Scheduler(journal=journal, flush_age=0.001,
                          max_batch=RING_MAX_BATCH, pipeline_depth=depth,
                          resident_ring=resident, max_queue_depth=4096)
        jobs = [new_job(side, side, boards[side][i // 2], gen_limit=RING_LIMIT)
                for i, side in zip(range(RING_BOARDS), RING_SIDES * RING_BOARDS)]
        for job in jobs:
            sched.submit(job)
        with profiler.capture(str(profile_dir) if profile_dir else None,
                              dev or "cpu"):
            sched.start()
            t0 = time.perf_counter()
            ok = sched.drain(timeout=600)
            elapsed = time.perf_counter() - t0
        rings = sched.stats().get("resident_rings", {})
        batches = sched.metrics.counter("batches_total")
        sched.stop(drain=False)
        journal.close()
    finally:
        batcher._reset_plan()
    if not ok or any(j.state != "done" for j in jobs):
        fail(f"ring lane {tag}: not every job ended DONE")
    drains = sum(v for k, v in rings.items() if k.endswith(".drains_total"))
    gap = obs_registry.default().snapshot()["histograms"].get(
        "dispatch_gap_seconds", {})
    work_cells = sum(side * side * len(b) for side, b in boards.items()) * RING_LIMIT
    return {"rate": work_cells / elapsed, "elapsed_s": elapsed, "jobs": jobs,
            "batches": batches, "drains": drains,
            "mean_occupancy": batches / drains / RING if drains else None,
            "gap_p50_s": gap.get("p50")}


def _ring_drill(work: Path) -> dict:
    """SIGKILL a resident-ring server mid-ring, restart it on the journal,
    replay: every id done exactly once, equal to the oracle; then ``top``
    and ``fleet-trace`` against the restarted server."""
    journal = work / "ring_drill_journal"
    trace_dir = work / "ring_drill_trace"
    log = work / "ring_drill.log"
    args = ["--resident-ring", str(RING), "--pipeline-depth", str(2 * RING),
            "--journal-dir", str(journal), "--trace", str(trace_dir),
            "--flush-age", "0.001", "--max-batch", str(RING_MAX_BATCH)]
    rng = np.random.default_rng(SEED + 9)
    boards = [rng.integers(0, 2, (256, 256), dtype=np.uint8)
              for _ in range(RING_DRILL_JOBS)]
    proc = None
    try:
        proc, base = _start_serve(args, log)
        accepted = {}
        for board in boards:
            status, _, raw = _http("POST", f"{base}/jobs", {
                "width": 256, "height": 256, "gen_limit": RING_DRILL_LIMIT,
                "cells": text_grid.encode(board).decode("ascii")})
            if status != 202:
                fail(f"ring drill submit answered {status}: {raw[:200]!r}")
            accepted[json.loads(raw)["id"]] = board
        deadline = time.perf_counter() + 120
        while not _done_records(journal):
            if time.perf_counter() > deadline:
                fail("the ring drill journaled no done record in 120 s")
            time.sleep(0.002)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
        proc = None
        done_before = len(_done_records(journal))
        t0 = time.perf_counter()
        proc, base = _start_serve(args, log)
        deadline = time.perf_counter() + 120
        while len(_done_records(journal)) < len(accepted):
            if time.perf_counter() > deadline:
                fail("the ring drill's replay did not finish in 120 s")
            time.sleep(0.05)
        replay_s = time.perf_counter() - t0
        done = _done_records(journal)
        lost, extra = set(accepted) - set(done), set(done) - set(accepted)
        dup = {k: len(v) for k, v in done.items() if len(v) != 1}
        if lost or extra or dup:
            fail(f"ring drill ledger: lost {lost}, unknown {extra}, duplicated {dup}")
        cfg = GameConfig(gen_limit=RING_DRILL_LIMIT)
        for job_id, (rec,) in done.items():
            want = oracle.run(accepted[job_id], cfg)
            got = text_grid.decode(rec["grid"].encode("ascii"), 256, 256)
            if not np.array_equal(got, want.grid) or rec["generations"] != want.generations:
                fail(f"ring drill job {job_id}: its done record differs from the oracle")
        print(f"ring drill: {len(accepted)} accepted, {done_before} done before the "
              f"SIGKILL mid-ring, the rest replayed and done {replay_s:.2f} s after "
              "the restart's exec; every id done exactly once, == the oracle",
              flush=True)
        top = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "top", "--server", base,
             "--iterations", "2", "--interval", "0.2", "--no-ansi"],
            capture_output=True, text=True, timeout=120, env=_subprocess_env())
        if top.returncode != 0 or "ring occupancy" not in top.stdout:
            fail(f"top exited {top.returncode} without the ring row:\n"
                 f"{top.stdout}{top.stderr}")
        print("top --iterations 2 --no-ansi, its last frame:\n"
              + top.stdout.split("gol top")[-1].rstrip(), flush=True)
        trace_out = work / "ring_fleet_trace.json"
        ftr = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "fleet-trace", "--server",
             base, "-o", str(trace_out)],
            capture_output=True, text=True, timeout=120, env=_subprocess_env())
        doc = json.loads(trace_out.read_text()) if trace_out.exists() else {}
        names = {e.get("name") for e in doc.get("traceEvents", [])}
        if (ftr.returncode != 0 or "serve.resident_loop" not in names
                or list(doc["otherData"]["processes"]) != ["router"]):
            fail(f"fleet-trace exited {ftr.returncode}, spans {sorted(names)}:\n"
                 f"{ftr.stderr}")
        loops = sum(e.get("name") == "serve.resident_loop"
                    for e in doc["traceEvents"])
        print(f"{ftr.stderr.strip()}; {loops} serve.resident_loop spans", flush=True)
    finally:
        _stop(proc)
    return {"accepted": len(accepted), "done_before_kill": done_before,
            "replay_s": replay_s, "resident_loop_spans": loops}


def ring_lane(work: Path, dev) -> dict:
    """Phase 4g (see the module docstring)."""
    t_phase = time.perf_counter()
    boards = _ring_load()
    marginal = {f"{side}xT{t}": _ring_marginal(boards[side], side, t)
                for side in RING_SIDES for t in (1, RING_T)}
    total = sum(side * side * len(b) for side, b in boards.items()) * RING_LIMIT
    combined = total / sum(
        side * side * len(boards[side]) * RING_LIMIT
        / max(v for k, v in marginal.items() if k.startswith(f"{side}x"))
        for side in RING_SIDES)
    solo = {}
    for side in RING_SIDES:
        for i, board in enumerate(boards[side]):
            solo[(side, i)] = engine.simulate_batch(
                [board], GameConfig(gen_limit=RING_LIMIT))[0]
    lanes, launches = {}, {}
    for name, kwargs in RING_LANES.items():
        _ring_run(work, f"{name}_warm", boards, **kwargs)
        runs = []
        for r in range(RING_REPEATS):
            _zero_counters()
            runs.append(_ring_run(work, f"{name}_{r}", boards, **kwargs))
            if r == 0:
                launches[f"ring lane {name} (4g)"] = _counts()
        for run in runs:
            for i, job in enumerate(run["jobs"]):
                want = solo[(RING_SIDES[i % 2], i // 2)]
                r = job.result
                if (not np.array_equal(r.grid, want.grid)
                        or (r.generations, r.exit_reason)
                        != (want.generations, want.exit_reason)):
                    fail(f"ring lane {name}: job {i} ({r.generations}, "
                         f"{r.exit_reason}) differs from its solo simulate_batch "
                         f"({want.generations}, {want.exit_reason})")
        best = max(runs, key=lambda r: r["rate"])
        lanes[name] = {k: v for k, v in best.items() if k != "jobs"}
        lanes[name]["rates"] = [r["rate"] for r in runs]
        lanes[name]["gap_ratio"] = best["rate"] / combined
    for k in KERNELS + BATCH_KERNELS:
        for lane in RING_LANES:
            n = launches[f"ring lane {lane} (4g)"][k["key"]]
            if (k["key"] in ("batch_packed", "batch_masked")) != (n > 0):
                fail(f"{k['id']} launched {n} times on ring lane {lane}")
    best_resident = max(v["rate"] for k, v in lanes.items()
                        if k.startswith("resident"))
    over = best_resident / lanes["depth1"]["rate"]
    print("ring lane marginal rates, cell-updates/s: "
          + json.dumps({k: round(v, 1) for k, v in marginal.items()})
          + f"; combined {combined:.4e}", flush=True)
    for name, lane in lanes.items():
        ring_part = ""
        if lane["drains"]:
            ring_part = (f", {lane['drains']} drains for {lane['batches']} batches "
                         f"(mean slot occupancy {lane['mean_occupancy']:.3f}), "
                         f"dispatch_gap_seconds p50 {lane['gap_p50_s']}")
        print(f"ring lane {name}: {lane['rate']:.4e} cell-updates/s (runs "
              f"{[f'{r:.4e}' for r in lane['rates']]}), gap ratio "
              f"{lane['gap_ratio']:.4f}, {lane['batches']} batches{ring_part}; "
              f"launches {_nonzero(launches[f'ring lane {name} (4g)'])}",
              flush=True)
    print(f"ring lane: every job DONE and == its solo simulate_batch in every run; "
          f"resident over depth 1 = {over:.3f} (the JAX package's gate for this "
          "suite: 1.5; not checked here)", flush=True)
    prof_dir = work / "prof_ring"
    _ring_run(work, "profiled", boards, profile_dir=prof_dir, dev=dev,
              **RING_LANES["resident_depth8"])
    busy = profile_summary(prof_dir / "trace.json", "batch_")
    print(f"profile ring lane resident_depth8: {busy['events']} batch kernel "
          f"events, busy {busy['kernel_busy_ms']:.3f} ms of a "
          f"{busy['window_ms']:.3f} ms window = {busy['device_busy_share']:.3f}",
          flush=True)
    drill = _ring_drill(work)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4g took {seconds:.1f} s", flush=True)
    return {"launches": launches, "marginal": marginal, "combined": combined,
            "lanes": lanes, "resident_over_depth1": over, "seconds": seconds,
            "busy": {m: busy[m] for m in ("events", "window_ms", "kernel_busy_ms",
                                          "device_busy_share")},
            "drill": drill}


# ---------------------------------------------------------------------------
# 4h. The tuner at full width


_TRIAL = re.compile(r"^\| (\S+)[^|]*\| ([0-9.]+) ms \| ([0-9.]+)x \| (\S+) \|$")


def tuner_lane(work: Path, path: dict) -> dict:
    """Phase 4h (see the module docstring)."""
    t_phase = time.perf_counter()
    plans_file, report = work / "tuned_plans.json", work / "tune_report.md"
    _zero_counters()
    rc, text = _cli_capture(["tune", *TUNE_ARGS, "--plan-cache", str(plans_file),
                             "--report", str(report)])
    counts = _counts()
    if rc != 0:
        fail(f"tune exited {rc}:\n{text}")
    body = report.read_text()
    if "excluded:" in body or "| error" in body or "mismatch" in body:
        fail(f"the tuner excluded a candidate:\n{body}")
    trials = {}
    for section in body.split("## ")[1:]:
        kind = section.split(":", 1)[0]
        rows = [m.groups() for m in map(_TRIAL.match, section.splitlines()) if m]
        trials[kind] = {label: float(ms) for label, ms, _, _ in rows}
        winner = re.search(r"winner: `([^`]+)` at ([0-9.]+)x", section)
        print(f"tune {kind}: winner {winner.group(1)} at {winner.group(2)}x the "
              "default; medians, ms: " + json.dumps(trials[kind]), flush=True)
        trials[f"{kind} winner"] = {winner.group(1): float(winner.group(2))}
    for key in ("bandt_fast", "band", "byte_band"):
        if not counts[key]:
            fail(f"the tuner's engine search launched no {key} kernel")
    print(f"tune launches: {_nonzero(counts)}", flush=True)

    # Run (a) under the tuned plan: the same bytes and Generations.
    out = work / "tuned_out.txt"
    env_key = tune_plans.ENV_CACHE_PATH
    saved, os.environ[env_key] = os.environ[env_key], str(plans_file)
    tune_select.reset()
    try:
        gens, ms, _ = _cli([str(SIZE), str(SIZE), str(path["inputs"]["random"]),
                            "--variant", "game", "--gen-limit", "1000",
                            "--output", str(out)])
    finally:
        os.environ[env_key] = saved
        tune_select.reset()
    if (gens, _digest(out)) != path["results"][("game", "random", 1000)]:
        fail(f"run (a) under the tuned plan (Generations {gens}) differs from "
             "phase 4's run (a)")
    base_ms = path["run_a"]["game auto"]["exec_ms"]
    print(f"run (a) under the tuned plan: Generations {gens}, bytes == phase 4's; "
          f"Execution {ms:.3f} ms (phase 4: {base_ms:.3f} ms)", flush=True)

    # serve --warm-plans under the plan: it boots and answers a job.
    env = {**_subprocess_env(), tune_plans.ENV_CACHE_PATH: str(plans_file)}
    log = work / "warm_serve.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", "serve", "--port", "0",
         "--warm-plans"], stdout=subprocess.PIPE, stderr=log.open("w"),
        text=True, env=env, start_new_session=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on "):
            fail(f"serve --warm-plans exited before serving:\n{log.read_text()}")
        base = line.split()[2]
        board = text_grid.generate(256, 256, seed=SEED + 10)
        status, _, raw = _http("POST", f"{base}/jobs", {
            "width": 256, "height": 256, "gen_limit": 1000,
            "cells": text_grid.encode(board).decode("ascii")})
        if status != 202:
            fail(f"serve --warm-plans: POST answered {status}")
        job_id = json.loads(raw)["id"]
        deadline = time.perf_counter() + 60
        while (status := _http("GET", f"{base}/result/{job_id}")[0]) != 200:
            if time.perf_counter() > deadline:
                fail(f"serve --warm-plans: no result in 60 s ({status})")
            time.sleep(0.05)
        got, _ = _fetch_results(base, job_id)
        want = engine.simulate(board, GameConfig(gen_limit=1000))
        if not np.array_equal(got[0], want.grid) or got[1] != want.generations:
            fail("serve --warm-plans: the job differs from its solo run")
    finally:
        _stop(proc)
    warmed = [ln for ln in log.read_text().splitlines() if ln.startswith("warmed")]
    if not warmed:
        fail(f"serve --warm-plans warmed nothing:\n{log.read_text()}")
    print(f"serve --warm-plans: {'; '.join(warmed)}; one 256^2 job == its solo run "
          f"(Generations {want.generations})", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4h took {seconds:.1f} s", flush=True)
    return {"launches": {"tuner search (4h)": counts}, "trials": trials,
            "tuned_run_a_ms": ms, "phase4_run_a_ms": base_ms, "seconds": seconds}


# ---------------------------------------------------------------------------
# 4i. The sparse and macro lanes


def _five_gliders(u: int, glider: np.ndarray) -> SparseBoard:
    """bench.py's sparse load: five gliders far apart in a u^2 universe."""
    board = SparseBoard(u, u, SPARSE_TILE)
    step = u // 5
    for k in range(5):
        board.place(glider, (k * step + step // 3) % (u - 8),
                    ((4 - k) * step + step // 2) % (u - 8))
    return board


def _gun_board(gun: str, u: int) -> SparseBoard:
    return SparseBoard.from_rle(gun, u, u, SPARSE_TILE, x=u // 2, y=u // 2)


@contextlib.contextmanager
def _port_device(name: str):
    """The port's entry points on ``name`` (``cpu``: T1's plain version)."""
    saved = os.environ[platform_env.DEVICE_ENV]
    os.environ[platform_env.DEVICE_ENV] = name
    try:
        yield
    finally:
        os.environ[platform_env.DEVICE_ENV] = saved


def _t1_counted(label: str, launches: dict, fn):
    """``fn()`` with the counters set to 0 just before and read just after;
    T1 must have launched."""
    _zero_counters()
    t0 = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t0
    counts = _counts()
    if not counts["tile_step"]:
        fail(f"{label} launched no T1")
    launches[label] = counts
    return out, seconds


def _same_result(a, b) -> bool:
    return (a.board.to_rle(), a.generations, a.exit_reason) == \
        (b.board.to_rle(), b.generations, b.exit_reason)


def _sparse_suite(dev, launches: dict) -> dict:
    """(i) bench.py's sparse suite: the five-glider load, tile 256, at
    4096^2 to 65536^2, 24 sparse generations (each the same run on the CPU
    too), and the dense lane for 4 generations up to 16384^2 (against a
    4-generation sparse run)."""
    glider = rle_codec.read_file(str(REPO / "patterns" / "glider.rle"))
    sizes = {}
    for u in SPARSE_SIZES:
        # Warm: each ladder rung's runner is built at its first call.
        simulate_sparse(_five_gliders(u, glider), GameConfig(gen_limit=1), TileMemo())
        board = _five_gliders(u, glider)
        occupancy = board.occupancy()
        result, sparse_s = _t1_counted(
            f"sparse {u}^2, {SPARSE_GENS} generations (4i)", launches,
            lambda: simulate_sparse(board, GameConfig(gen_limit=SPARSE_GENS),
                                    TileMemo()))
        with _port_device("cpu"):
            plain = simulate_sparse(_five_gliders(u, glider),
                                    GameConfig(gen_limit=SPARSE_GENS), TileMemo())
        if result.generations != SPARSE_GENS or not _same_result(result, plain):
            fail(f"sparse {u}^2 on the card differs from the same run on the CPU")
        entry = {"universe": f"{u}x{u}", "occupancy": occupancy,
                 "sparse_ms_per_gen": sparse_s * 1e3 / SPARSE_GENS,
                 "tiles_simulated": result.stats.tiles_active,
                 "tiles_per_generation": result.stats.tiles_per_generation(),
                 "tiles_computed": result.stats.tiles_computed}
        if u <= DENSE_MAX:
            cfg = GameConfig(gen_limit=DENSE_GENS)
            runner = engine.make_runner((u, u), cfg, "auto", dev)
            x = torch.from_numpy(_five_gliders(u, glider).to_dense()).to(dev)
            profiler.fence(runner(x)[0])  # warm
            t0 = time.perf_counter()
            final, gens = runner(x)
            profiler.fence(final)
            dense_s = time.perf_counter() - t0
            short = simulate_sparse(_five_gliders(u, glider), cfg, TileMemo())
            if int(gens) != short.generations or SparseBoard.from_dense(
                    final.cpu().numpy(), SPARSE_TILE) != short.board:
                fail(f"the dense lane at {u}^2 differs from the sparse lane")
            entry["dense_ms_per_gen"] = dense_s * 1e3 / DENSE_GENS
            entry["ratio_dense_over_sparse"] = (entry["dense_ms_per_gen"]
                                                / entry["sparse_ms_per_gen"])
        print(f"sparse {u}^2: {entry['sparse_ms_per_gen']:.3f} ms/gen "
              f"({entry['tiles_per_generation']:.3f} tiles/gen, occupancy "
              f"{occupancy:.6f}), == the CPU's run"
              + (f"; dense {entry['dense_ms_per_gen']:.3f} ms/gen, dense/sparse "
                 f"{entry['ratio_dense_over_sparse']:.3f}, == the sparse lane"
                 if "dense_ms_per_gen" in entry else "; dense: skipped (area)"),
              flush=True)
        sizes[f"u{u}"] = entry
    return sizes


def _macro_suite(work: Path, launches: dict) -> dict:
    """(ii) bench.py's macro suite: the Gosper gun, tile 256; sparse at
    8192^2 for 3000 generations; macro at 2^20 squared for 10^6 generations
    cold into a fresh CAS, then warm from it; macro to 3000 generations at
    8192^2 against the sparse run's RLE."""
    gun = (REPO / "patterns" / "gosper_gun.rle").read_text()
    simulate_sparse(_gun_board(gun, GUN_UNIVERSE), GameConfig(gen_limit=1), TileMemo())
    sparse, sparse_s = _t1_counted(
        f"sparse gun {GUN_UNIVERSE}^2, {GUN_GENS} generations (4i)", launches,
        lambda: simulate_sparse(_gun_board(gun, GUN_UNIVERSE),
                                GameConfig(gen_limit=GUN_GENS), TileMemo()))
    print(f"sparse gun {GUN_UNIVERSE}^2: {GUN_GENS} generations in "
          f"{sparse_s:.3f} s ({sparse_s * 1e3 / GUN_GENS:.3f} ms/gen, "
          f"{sparse.stats.tiles_per_generation():.3f} tiles/gen)", flush=True)
    shallow, shallow_s = _t1_counted(
        f"macro gun {GUN_UNIVERSE}^2, {GUN_GENS} generations (4i)", launches,
        lambda: simulate_macro(_gun_board(gun, GUN_UNIVERSE),
                               GameConfig(gen_limit=GUN_GENS),
                               MacroMemo(NodeStore(SPARSE_TILE))))
    if not _same_result(shallow, sparse):
        fail(f"macro to {GUN_GENS} generations differs from the sparse lane")
    print(f"macro gun {GUN_UNIVERSE}^2: {GUN_GENS} generations in "
          f"{shallow_s:.3f} s, RLE == the sparse lane's", flush=True)
    cas = str(work / "macro_cas")
    config = GameConfig(gen_limit=MACRO_GENS)
    cold, cold_s = _t1_counted(
        f"macro gun 2^20 squared, {MACRO_GENS} generations, cold (4i)", launches,
        lambda: simulate_macro(_gun_board(gun, MACRO_UNIVERSE), config,
                               MacroMemo(NodeStore(SPARSE_TILE), cas_dir=cas)))
    if (cold.generations, cold.exit_reason) != (MACRO_GENS, "gen_limit"):
        fail(f"macro cold: {cold.generations} generations, {cold.exit_reason}")
    _zero_counters()
    t0 = time.perf_counter()
    warm = simulate_macro(_gun_board(gun, MACRO_UNIVERSE), config,
                          MacroMemo(NodeStore(SPARSE_TILE), cas_dir=cas))
    warm_s = time.perf_counter() - t0
    warm_counts = _counts()
    if warm.board != cold.board or warm.stats.leaf_gen_steps != 0 \
            or warm_counts["tile_step"] != 0:
        fail("macro warm from the CAS differs from the cold run or stepped leaves")
    stats = {k: getattr(cold.stats, k) for k in (
        "supersteps", "node_hits", "node_misses", "cas_hits", "leaf_cases",
        "leaf_gen_steps")}
    print(f"macro gun 2^20 squared, {MACRO_GENS} generations: cold {cold_s:.3f} s "
          f"({json.dumps(stats)}, population {cold.board.population()}); warm "
          f"from the CAS {warm_s:.3f} s ({warm.stats.cas_hits} content hits, "
          f"{warm.stats.leaf_gen_steps} leaf steps, T1 launches "
          f"{warm_counts['tile_step']}), boards equal", flush=True)
    return {"sparse_gun_s": sparse_s, "sparse_gun_ms_per_gen": sparse_s * 1e3 / GUN_GENS,
            "sparse_gun_tiles_per_gen": sparse.stats.tiles_per_generation(),
            "macro_gun_3000_s": shallow_s, "macro_cold_s": cold_s,
            "macro_warm_s": warm_s, "macro_cold_stats": stats,
            "macro_warm_cas_hits": warm.stats.cas_hits,
            "population": cold.board.population()}


def _pattern_cli(work: Path, launches: dict) -> tuple[dict, bytes]:
    """(iii) the Gosper gun at 65536^2 through ``cli.main`` under --engine
    sparse, macro and auto: equal RLE bytes."""
    outs = {}
    u, at = CLI_UNIVERSE, CLI_UNIVERSE // 2
    for eng in ("sparse", "macro", "auto"):
        out = work / f"gun_{eng}.rle"
        (gens, ms, _), _ = _t1_counted(
            f"run --pattern --engine {eng} (4i)", launches,
            lambda: _cli(["--pattern", str(REPO / "patterns" / "gosper_gun.rle"),
                          "--universe", f"{u}x{u}", "--place", f"{at},{at}",
                          "--engine", eng, "--output", str(out)]))
        outs[eng] = {"generations": gens, "exec_ms": ms}
        outs[eng]["bytes"] = out.read_bytes()
    if len({o["bytes"] for o in outs.values()}) != 1 or \
            len({o["generations"] for o in outs.values()}) != 1:
        fail("run --pattern: --engine sparse, macro and auto differ")
    print(f"run --pattern gosper_gun.rle --universe {u}x{u} --place "
          f"{at},{at}: Generations " + str(outs["auto"]["generations"])
          + ", RLE bytes equal under sparse, macro and auto; Execution ms "
          + json.dumps({e: o["exec_ms"] for e, o in outs.items()}), flush=True)
    data = outs["auto"].pop("bytes")
    for o in outs.values():
        o.pop("bytes", None)
    return outs, data


def _sparse_server(work: Path, launches: dict, cli_rle: bytes) -> dict:
    """(iv) one sparse job and one macro job of (iii) through a real
    server: each answered ``rle`` equals the CLI's (its comment line aside)."""
    gun = (REPO / "patterns" / "gosper_gun.rle").read_text()
    body = {"width": CLI_UNIVERSE, "height": CLI_UNIVERSE, "rle": gun,
            "x": CLI_UNIVERSE // 2, "y": CLI_UNIVERSE // 2, "tile": SPARSE_TILE}
    want = cli_rle.decode().split("\n", 1)[1]

    def serve():
        srv = GolServer(port=0, journal_dir=str(work / "journal_sparse"),
                        flush_age=0.0, sample_interval=0)
        srv.start()
        try:
            answers = {}
            for name, extra in (("sparse", {}), ("macro", {"macro": True})):
                status, _, raw = _http("POST", f"{srv.url}/jobs", {**body, **extra})
                if status != 202:
                    fail(f"POST a {name} job answered {status}: {raw[:200]!r}")
                answers[name] = json.loads(raw)["id"]
            for name, job_id in answers.items():
                deadline = time.perf_counter() + 300
                while (status := _http("GET", f"{srv.url}/result/{job_id}")[0]) != 200:
                    if time.perf_counter() > deadline:
                        fail(f"the {name} job: no result in 300 s ({status})")
                    time.sleep(0.05)
                answers[name] = json.loads(_http("GET", f"{srv.url}/result/{job_id}")[2])
            return answers
        finally:
            srv.shutdown()

    answers, seconds = _t1_counted("serve: a sparse and a macro job (4i)",
                                   launches, serve)
    for name, payload in answers.items():
        if payload.get("rle") != want:
            fail(f"the server's {name} job differs from the CLI's RLE")
    print(f"serve: one sparse and one macro job ({CLI_UNIVERSE}^2, gun, 1000 "
          "generations) "
          f"answered the CLI's RLE in {seconds:.3f} s", flush=True)
    return {"seconds": seconds}


# The tuner's loud refusal when its dense probes show no slope (JAX's
# fit_crossover): on the card the quick probes (1024^2, 2048^2) sit at the
# dense lane's per-run host floor, so a run may measure one or not.
NO_SLOPE = "gol: dense cost did not grow with area over the probe"


def _crossover(work: Path, launches: dict) -> dict:
    """(v) ``tune --sparse-crossover --quick`` into the smoke's plan cache:
    either a crossover inside the tuner's admissible band is persisted, or
    the tuner refuses with JAX's no-slope error and persists none."""
    plans_file = os.environ[tune_plans.ENV_CACHE_PATH]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        (rc, text), _ = _t1_counted(
            "tune --sparse-crossover (4i)", launches,
            lambda: _cli_capture(["tune", "--sparse-crossover", "--quick",
                                  "--plan-cache", plans_file, "--report",
                                  str(work / "crossover_report.md")]))
    sys.stderr.write(err.getvalue())
    tune_select.reset()
    entry = tune_plans.PlanStore(plans_file).entries().get(
        tune_select.sparse_fingerprint())
    lines = [ln for ln in err.getvalue().splitlines() if "sparse-crossover" in ln]
    if rc == 1 and err.getvalue().rstrip().splitlines()[-1].startswith(NO_SLOPE) \
            and entry is None:
        print("tune --sparse-crossover: the dense probes showed no slope and "
              "the tuner refused, persisting nothing: " + json.dumps(lines),
              flush=True)
        return {"refused": NO_SLOPE, "probes": lines}
    if rc != 0 or entry is None:
        fail(f"tune --sparse-crossover exited {rc}:\n{text}\n{err.getvalue()}")
    measured = entry["measured"]
    if not tune_select.SPARSE_AREA_FLOOR <= measured["auto_area"] \
            <= tune_select.SPARSE_AREA_CEIL:
        fail(f"tune --sparse-crossover persisted {measured['auto_area']} cells")
    print(f"tune --sparse-crossover: dense overtakes sparse at "
          f"{measured['auto_area']} cells (~{int(measured['auto_area'] ** 0.5)}^2; "
          f"bundled default {1 << 25}); " + json.dumps(measured), flush=True)
    return measured


def _lanes_busy(work: Path, dev) -> dict:
    """The device-busy share of a sparse run (65536^2, five gliders, 24
    generations) and a macro run (the gun at 8192^2 to 1000 generations,
    fresh memo) under ``torch.profiler``: T1's events, the union of the
    kernel intervals over the window, the top host ops."""
    glider = rle_codec.read_file(str(REPO / "patterns" / "glider.rle"))
    gun = (REPO / "patterns" / "gosper_gun.rle").read_text()
    runs = {
        "sparse 65536^2, 24 generations": lambda: simulate_sparse(
            _five_gliders(SPARSE_SIZES[-1], glider),
            GameConfig(gen_limit=SPARSE_GENS), TileMemo()),
        f"macro gun {GUN_UNIVERSE}^2, 1000 generations": lambda: simulate_macro(
            _gun_board(gun, GUN_UNIVERSE), GameConfig(gen_limit=1000),
            MacroMemo(NodeStore(SPARSE_TILE))),
    }
    out = {}
    for i, (label, run) in enumerate(runs.items()):
        prof_dir = work / f"profile_4i_{i}"
        with profiler.capture(str(prof_dir), dev):
            run()
        out[label] = summary = profile_summary(prof_dir / "trace.json", "tile_step")
        print(f"profile {label}: {summary['events']} T1 events, busy "
              f"{summary['kernel_busy_ms']:.3f} ms of a {summary['window_ms']:.3f} ms "
              f"window = {summary['device_busy_share']:.4f}; host ops "
              + json.dumps(summary["host_ops_ms"]), flush=True)
    return out


def sparse_macro_lanes(work: Path, dev) -> dict:
    """Phase 4i (see the module docstring)."""
    t_phase = time.perf_counter()
    launches = {}
    sizes = _sparse_suite(dev, launches)
    macro = _macro_suite(work, launches)
    busy = _lanes_busy(work, dev)
    cli_runs, cli_rle = _pattern_cli(work, launches)
    server = _sparse_server(work, launches, cli_rle)
    crossover = _crossover(work, launches)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4i took {seconds:.1f} s", flush=True)
    return {"launches": launches, "sparse": sizes, "macro": macro,
            "busy": busy, "cli": cli_runs, "server": server,
            "crossover": crossover, "seconds": seconds}


# ---------------------------------------------------------------------------
# 4j. The fleet, its router and chaos, and the sharded single-job lane


def _oracle_job(args):
    """One board's oracle run ``(grid, generations)``: a process pool's
    task, so it takes and returns plain numpy."""
    board, freq, limit = args
    want = oracle.run(board, GameConfig(gen_limit=limit, similarity_frequency=freq))
    return want.grid, int(want.generations)


def _oracle_pool():
    """A spawned process pool for the port's numpy oracle (the loads'
    boards run 6000-10000 generations each)."""
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 4),
        mp_context=multiprocessing.get_context("spawn"))


def _load_boards(freqs, seed0: int) -> list:
    """bench.py's fleet- and chaos-suite boards: FLEET_PER_BUCKET random
    160^2 boards per similarity frequency (one bucket each)."""
    return [(f, text_grid.generate(FLEET_SIDE, FLEET_SIDE, seed=seed0 + 100 * f + i))
            for f in freqs for i in range(FLEET_PER_BUCKET)]


def _submit_load(base: str, boards: list, limit: int, headers=None) -> list:
    """POST every (frequency, board) through the router, eight at a time,
    riding the fault contracts of bench.py's chaos suite (a 502/503/504/429
    or a dropped connection is sent again); returns the job ids."""
    body = lambda f, b: {  # noqa: E731
        "width": FLEET_SIDE, "height": FLEET_SIDE,
        "cells": text_grid.encode(b).decode("ascii"),
        "gen_limit": limit, "similarity_frequency": f}

    def one(fb):
        for _ in range(60):
            try:
                status, payload = fleet_client.http_json(
                    "POST", f"{base}/jobs", body(*fb), headers=headers,
                    timeout=60)
            except (OSError, ConnectionError):
                time.sleep(0.05)
                continue
            if status == 202:
                return payload["id"]
            if status not in (502, 503, 504, 429):
                fail(f"fleet submit answered {status}: {payload}")
            time.sleep(0.05)
        fail("a fleet submit never landed after 60 tries")

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(one, boards))


def _await_done(base: str, ids: list, timeout: float = 600) -> None:
    pending, deadline = set(ids), time.perf_counter() + timeout
    while pending:
        if time.perf_counter() > deadline:
            fail(f"{len(pending)} fleet job(s) not done within {timeout:.0f} s")
        for job_id in list(pending):
            try:
                status, job = fleet_client.http_json(
                    "GET", f"{base}/jobs/{job_id}", timeout=30)
            except (OSError, ConnectionError):
                continue
            if status == 200 and job.get("state") == "done":
                pending.discard(job_id)
            elif status == 200 and job.get("state") in ("failed", "cancelled"):
                fail(f"fleet job {job_id} ended {job['state']}: {job}")
        if pending:
            time.sleep(0.05)


def _completed(base: str) -> tuple[int, int]:
    """The fleet-merged jobs_completed_total and jobs_failed_total."""
    _, snap = fleet_client.http_json("GET", f"{base}/metrics?format=json",
                                     timeout=30)
    return (int(snap["counters"].get("jobs_completed_total", 0)),
            int(snap["counters"].get("jobs_failed_total", 0)))


def _timed_round(base: str, boards: list, limit: int, headers=None,
                 per_job: bool = False):
    """One round of the load: submit, wait until it is done -> (seconds,
    ids). As bench.py waits: on the fleet-merged completed count, or,
    where a resubmitted ambiguous 504 may leave an orphan that completes
    too (the chaos lanes), on every accepted id."""
    done0, _ = _completed(base)
    t0 = time.perf_counter()
    ids = _submit_load(base, boards, limit, headers)
    if per_job:
        _await_done(base, ids)
    else:
        deadline = time.perf_counter() + 600
        while True:
            done, failed = _completed(base)
            if failed:
                fail(f"{failed} fleet job(s) FAILED")
            if done - done0 >= len(ids):
                break
            if time.perf_counter() > deadline:
                fail("the fleet load did not finish within 600 s")
            time.sleep(0.05)
    return time.perf_counter() - t0, ids


def _check_results(base: str, ids: list, wants: list, where: str) -> None:
    """Every job's answered grid and generations equal its oracle run. A
    503 or a dropped connection (a faulted hop) is asked again."""
    for job_id, (grid, gens) in zip(ids, wants):
        for _ in range(60):
            try:
                status, res = fleet_client.http_json(
                    "GET", f"{base}/result/{job_id}", timeout=60)
            except (OSError, ConnectionError):
                status, res = None, "connection dropped"
            if status not in (None, 502, 503, 504):
                break
            time.sleep(0.05)
        if status != 200:
            fail(f"{where}: GET /result/{job_id} answered {status}: {res}")
        got = text_grid.decode(res["grid"].encode("ascii"), res["width"],
                               res["height"])
        if not np.array_equal(got, grid) or res["generations"] != gens:
            fail(f"{where}: job {job_id} differs from the oracle")


def _start_fleet(args: list, log: Path, env: dict):
    """``python -m gol_tpu_torch fleet --port 0 ...`` in a session of its
    own -> (process, router URL, seconds to its ``fleet router on``)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", "fleet", "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=log.open("a"), text=True, env=env,
        start_new_session=True)
    for line in proc.stdout:
        if line.startswith("fleet router on "):
            return proc, line.split()[3], time.perf_counter() - t0
    fail(f"fleet exited {proc.wait()} before serving:\n{log.read_text()[-3000:]}")


def _stop_fleet(proc: subprocess.Popen, orphans: tuple = ((), ())) -> None:
    """SIGTERM: the router drains every worker and terminates them; then
    nothing of its session may be left. ``orphans``: (pids, session) of
    workers whose fleet process was killed; this process, their
    subreaper, reaps them as they exit, or the router would wait on their
    zombies."""
    pids, session = orphans
    proc.send_signal(signal.SIGTERM)
    deadline = time.perf_counter() + 120
    while proc.poll() is None and time.perf_counter() < deadline:
        for pid in pids:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
        time.sleep(0.05)
    for group in (proc.pid, *session):
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(group, signal.SIGKILL)
    proc.wait()
    proc.stdout.close()
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)


def _manifest_pids(fleet_dir: Path) -> dict:
    doc = json.loads((fleet_dir / "manifest.json").read_text())
    return {p["id"]: p["pid"] for p in doc["partitions"]}


def _cpu_seconds(pid: int) -> float:
    """utime + stime of ``pid`` (/proc/<pid>/stat fields 14 and 15)."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        fields = f.read().rsplit(b")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _exit_stats(directory: Path) -> list:
    """The ``serve-<pid>.json`` reports of the drained workers."""
    return [json.loads(p.read_text())
            for p in sorted(directory.glob("serve-*.json"))]


def _summed(reports: list) -> dict:
    total: dict = {}
    for rep in reports:
        for k, n in rep["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def _shard_universe() -> SparseBoard:
    """bench.py's shard load: 16x16 gliders over the 256x256 tiles of a
    65536^2 universe, a few on a tile edge so halo frames carry live
    rings."""
    glider = np.zeros((3, 3), dtype=np.uint8)
    glider[0, 1] = glider[1, 2] = glider[2, 0] = glider[2, 1] = glider[2, 2] = 1
    board = SparseBoard(SHARD_UNIVERSE, SHARD_UNIVERSE, SPARSE_TILE)
    for i in range(SHARD_GRID):
        for j in range(SHARD_GRID):
            arr = np.zeros((SPARSE_TILE, SPARSE_TILE), dtype=np.uint8)
            if (i + j) % 8 == 0:
                arr[1:4, 126:129] = glider
            else:
                arr[126:129, 126:129] = glider
            board.set_tile((8 + 15 * i, 8 + 15 * j), arr)
    return board


def _shard_job(base: str, rle: str, gens: int) -> str:
    status, payload = fleet_client.http_json("POST", f"{base}/jobs", {
        "shard": True, "rle": rle, "x": 0, "y": 0,
        "width": SHARD_UNIVERSE, "height": SHARD_UNIVERSE, "tile": SPARSE_TILE,
        "convention": "c", "gen_limit": gens, "check_similarity": False,
        "checkpoint_every": SHARD_CKPT}, timeout=120)
    if status != 202:
        fail(f"shard submit answered {status}: {payload}")
    return payload["id"]


def _shard_result(base: str, job_id: str, on_step=None) -> dict:
    """Poll a shard job to done (``on_step(job)`` sees every running
    poll) and fetch its result."""
    while True:
        status, job = fleet_client.http_json("GET", f"{base}/jobs/{job_id}",
                                             timeout=30)
        if status != 200 or job.get("state") == "failed":
            fail(f"shard job {job_id}: {status} {job}")
        if job["state"] == "done":
            break
        if on_step is not None:
            on_step(job)
        time.sleep(0.005)
    status, res = fleet_client.http_json("GET", f"{base}/result/{job_id}",
                                         timeout=300)
    if status != 200:
        fail(f"shard result {job_id}: {status} {res}")
    return res


def _sha1(text: str) -> str:
    return hashlib.sha1(text.encode("ascii")).hexdigest()


def _shard_lane(base: str, fleet_dir: Path, rle: str, want_sha1: str) -> dict:
    """The uncut shard suite through the router: a warm job of 4
    generations, then SHARD_LIMIT generations timed; the makespan is the
    most CPU seconds any worker spent, as bench.py reads it."""
    _shard_result(base, _shard_job(base, rle, 4))
    pids = _manifest_pids(fleet_dir)
    cpu0 = {w: _cpu_seconds(p) for w, p in pids.items()}
    t0 = time.perf_counter()
    res = _shard_result(base, _shard_job(base, rle, SHARD_LIMIT))
    wall = time.perf_counter() - t0
    cpu = {w: _cpu_seconds(p) - cpu0[w] for w, p in pids.items()}
    if (res["generations"], res["exit_reason"]) != (SHARD_LIMIT, "gen_limit"):
        fail(f"shard lane: {res['generations']} generations, {res['exit_reason']}")
    if _sha1(res["rle"]) != want_sha1:
        fail(f"shard lane over {sorted(pids)}: RLE differs from --engine sparse's")
    makespan = max(cpu.values())
    return {"cell_updates": res["cell_updates"], "wall_s": wall,
            "makespan_cpu_s": makespan, "worker_cpu_s": cpu,
            "cell_updates_per_s_makespan": res["cell_updates"] / makespan,
            "cell_updates_per_s_wall": res["cell_updates"] / wall,
            "supersteps": res["supersteps"], "ownership": res["ownership"],
            "recoveries": res["recoveries"], "sha1": _sha1(res["rle"])}


def _shard_cli(work: Path, base: str, tag: str, want: tuple) -> None:
    """``run --pattern gosper_gun.rle --universe 65536x65536 --engine shard
    --shard-across URL``: printed lines (msecs masked) and RLE bytes equal
    to the ``--engine sparse`` run's."""
    out = work / f"gun_shard_{tag}.rle"
    _, _, text = _cli([*SHARD_CLI, "--engine", "shard", "--shard-across", base,
                       "--output", str(out)])
    if (_MSECS.sub("X msecs", text), out.read_bytes()) != want:
        fail(f"run --engine shard over {tag} differs from --engine sparse")


def _router_drill(work: Path, proc, base: str, fleet_args: list, log: Path,
                  env: dict, fleet_dir: Path):
    """TestRouterRestart on the card: 12 jobs (32^2 and 30^2, a third of
    them long), SIGKILL the ``fleet`` process (its workers live on),
    restart it on the same --fleet-dir, and every job answers through the
    new router, equal to the oracle, with one done record fleet-wide."""
    jobs = {}
    for i in range(12):
        side = 32 if i % 2 == 0 else 30
        board = text_grid.generate(side, side, seed=700 + i)
        limit = 12 if i % 3 else 400
        status, payload = fleet_client.http_json("POST", f"{base}/jobs", {
            "width": side, "height": side, "gen_limit": limit,
            "cells": text_grid.encode(board).decode("ascii")})
        if status != 202:
            fail(f"router drill submit answered {status}: {payload}")
        jobs[payload["id"]] = (board, limit)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    proc.stdout.close()
    proc2, base2, _ = _start_fleet(fleet_args, log, env)
    _await_done(base2, list(jobs))
    for job_id, (board, limit) in jobs.items():
        want = oracle.run(board, GameConfig(gen_limit=limit))
        _check_results(base2, [job_id], [(want.grid, want.generations)],
                       "router drill")
    done: dict = {}
    for part in sorted(p for p in fleet_dir.iterdir() if p.is_dir()):
        for job_id in _done_records(part):
            done.setdefault(job_id, []).append(part.name)
    twice = {j: ws for j, ws in done.items() if j in jobs and len(ws) != 1}
    if not set(jobs) <= set(done) or twice:
        fail(f"router drill: lost {set(jobs) - set(done)}, twice {twice}")
    orphans = (tuple(_manifest_pids(fleet_dir).values()), (proc.pid,))
    return proc2, base2, {"jobs": len(jobs), "answered_once": len(jobs)}, orphans


def _shard_kill_drill(base: str, fleet_dir: Path, rle: str, want_sha1: str) -> dict:
    """SIGKILL one shard worker mid-job (past the durable floor): the
    fleet respawns it, the coordinator recovers, the bytes stay equal."""
    victim = sorted(_manifest_pids(fleet_dir).items())[1]
    killed = {}

    def on_step(job):
        if not killed and job["superstep"] >= SHARD_CKPT + 2:
            os.kill(victim[1], signal.SIGKILL)
            killed["at"] = job["superstep"]

    res = _shard_result(base, _shard_job(base, rle, SHARD_LIMIT), on_step)
    if not killed:
        fail("shard kill drill: the job finished before the kill")
    if res["recoveries"] < 1 or _sha1(res["rle"]) != want_sha1:
        fail(f"shard kill drill: recoveries {res['recoveries']}, RLE sha1 "
             f"{_sha1(res['rle'])} against {want_sha1}")
    return {"worker": victim[0], "killed_at_superstep": killed["at"],
            "recoveries": res["recoveries"], "supersteps": res["supersteps"]}


def _boot_times(work: Path) -> dict:
    """One cold boot of ``serve`` (an empty --compile-cache: B1/B2 built
    by nvcc) and one warm (the same directory again), to ``serving on``."""
    cache = work / "cold-cache"
    out = {}
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        proc, _ = _start_serve(["--compile-cache", str(cache)],
                               work / f"boot-{tag}.log")
        out[f"{tag}_boot_s"] = time.perf_counter() - t0
        _stop(proc)
    return out


def _fleet_lanes(work: Path, launches: dict, boards: list, oracles) -> dict:
    """(i) and (iii): per N, ``python -m gol_tpu_torch fleet --workers N``
    with taskset slices; bench.py's fleet load (warm round, timed round,
    every job equal to the oracle), the shard suite's universe through
    the router (warm, timed) and the gun through ``run --engine shard``.
    At N = 2 the router drill, at N = 4 the shard worker kill."""
    if shutil.which("taskset") is None:
        fail("taskset is missing: fleet --cores-per-worker needs it")
    cores = os.cpu_count() or 4
    width = max(1, min(6, (cores - 2) // 4))
    t1 = time.perf_counter()
    universe = _shard_universe()
    rle = universe.to_rle()
    ref = simulate_sparse(universe, GameConfig(
        gen_limit=SHARD_LIMIT, check_similarity=False), TileMemo())
    want_sha1 = _sha1(ref.board.to_rle())
    sparse_out = work / "gun_sparse.rle"
    _, _, text = _cli([*SHARD_CLI, "--engine", "sparse", "--output", str(sparse_out)])
    cli_want = (_MSECS.sub("X msecs", text), sparse_out.read_bytes())
    print(f"the sparse references: {time.perf_counter() - t1:.1f} s", flush=True)
    lanes = {}
    for n in FLEET_NS:
        fleet_dir = work / f"fleet-n{n}"
        stats = work / f"stats-n{n}"
        log = work / f"fleet-n{n}.log"
        env = {**_subprocess_env(), cli.EXIT_STATS_ENV: str(stats)}
        args = ["--workers", str(n), "--fleet-dir", str(fleet_dir),
                "--cores-per-worker", str(width),
                "--compile-cache", str(_build.BUILD_DIR), *FLEET_SERVE]
        t_lane = time.perf_counter()
        proc, base, _ = _start_fleet(args, log, env)
        lane, orphans = {"workers": n}, ((), ())
        try:
            _timed_round(base, boards, FLEET_LIMIT)
            # The oracle pool ran beside the first boot and warm round;
            # no timed round runs beside it.
            wants = oracles()["fleet"]
            seconds, ids = _timed_round(base, boards, FLEET_LIMIT)
            _check_results(base, ids, wants, f"fleet n={n}")
            lane.update(seconds=seconds, jobs_per_s=len(ids) / seconds,
                        cell_updates_per_s=FLEET_SIDE ** 2 * FLEET_LIMIT
                        * len(ids) / seconds)
            lane["shard"] = _shard_lane(base, fleet_dir, rle, want_sha1)
            _shard_cli(work, base, f"n{n}", cli_want)
            if n == 2:
                proc, base, lane["router_drill"], orphans = _router_drill(
                    work, proc, base, args, log, env, fleet_dir)
            if n == 4:
                lane["shard_kill"] = _shard_kill_drill(base, fleet_dir, rle,
                                                        want_sha1)
        finally:
            _stop_fleet(proc, orphans)
        reports = _exit_stats(stats)
        lane["peak_device_bytes"] = {r["pid"]: r["peak_device_bytes"] for r in reports}
        lane["t1_launches_by_worker"] = {r["pid"]: r["launches"]["tile_step"]
                                         for r in reports}
        launches[f"fleet and shard lanes, N={n} (4j, workers)"] = counts = _summed(reports)
        needed = ("batch_packed", "tile_step") + (("batch_masked",) if n == 2 else ())
        for key in needed:
            if not counts.get(key):
                fail(f"the N={n} workers launched no {key}")
        lane["lane_s"] = time.perf_counter() - t_lane
        lanes[f"n{n}"] = lane
        print(f"fleet N={n} ({lane['lane_s']:.1f} s): {lane['jobs_per_s']:.2f} jobs/s ({seconds:.3f} s "
              f"for {len(ids)} jobs); shard "
              f"{lane['shard']['cell_updates_per_s_makespan']:.4e} cell-updates/s "
              f"(makespan {lane['shard']['makespan_cpu_s']:.3f} s CPU, wall "
              f"{lane['shard']['wall_s']:.3f} s, {lane['shard']['supersteps']} "
              f"supersteps); T1 by worker {lane['t1_launches_by_worker']}; peak "
              f"device bytes {lane['peak_device_bytes']}", flush=True)
    return lanes


def _chaos_lanes(work: Path, launches: dict, boards: list, wants) -> dict:
    """(ii) the chaos suite's two lanes, one timed round each after the
    warm ones: baseline (no defense) and defended (breakers and their
    ring, --retry-budget 50, X-Gol-Deadline) fleets of two workers, then
    the defended workers behind a router whose hop to one of them runs
    CHAOS_PLAN. The faulted round's jobs equal the oracle."""
    from gol_tpu_torch.chaos import ChaosPlan, ProxyPool
    from gol_tpu_torch.fleet.breaker import BreakerConfig
    from gol_tpu_torch.fleet.router import RouterServer
    from gol_tpu_torch.fleet.workers import Fleet
    from gol_tpu_torch.obs import propagate
    from gol_tpu_torch.obs.history import HistoryWriter

    class OneWorkerChaos(ProxyPool):
        def __init__(self, plan, victim_url):
            super().__init__(plan)
            self._victim = victim_url.rstrip("/")

        def url_for(self, upstream_url):
            if upstream_url.rstrip("/") != self._victim:
                return upstream_url
            return super().url_for(upstream_url)

    t_chaos = time.perf_counter()
    stats = work / "stats-chaos"
    fleets = {}
    saved = os.environ.get(cli.EXIT_STATS_ENV)
    os.environ[cli.EXIT_STATS_ENV] = str(stats)
    try:
        def boot(name, defended):
            serve = FLEET_SERVE + (["--retry-budget", "50"] if defended else [])
            fleet = Fleet(str(work / f"chaos-{name}"), serve_args=serve)
            fleet.spawn_fleet(2)
            fleets[name] = fleet

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda a: boot(*a), [("baseline", False),
                                               ("defended", True)]))
    finally:
        if saved is None:
            os.environ.pop(cli.EXIT_STATS_ENV)
        else:
            os.environ[cli.EXIT_STATS_ENV] = saved

    def breakers(fleet):
        return {"breakers": True,
                "breaker_config": BreakerConfig(cooldown_s=1.0),
                "breaker_history": HistoryWriter(
                    str(Path(fleet.fleet_dir) / "breaker-history"),
                    source="breaker")}

    headers = {propagate.DEADLINE_HEADER: propagate.encode_deadline(600.0)}
    routers = []
    out = {}
    try:
        base = RouterServer(fleets["baseline"], port=0)
        defended = RouterServer(fleets["defended"], port=0,
                                **breakers(fleets["defended"]))
        routers += [base, defended]
        for r in routers:
            r.start()
        _timed_round(base.url, boards, CHAOS_LIMIT, per_job=True)
        _timed_round(defended.url, boards, CHAOS_LIMIT, headers, True)
        out["baseline_s"], _ = _timed_round(base.url, boards, CHAOS_LIMIT,
                                            per_job=True)
        out["defended_s"], _ = _timed_round(defended.url, boards, CHAOS_LIMIT,
                                            headers, True)
        routers.remove(defended)
        defended.shutdown(cascade=False)
        victim = sorted(fleets["defended"].workers(), key=lambda w: w.id)[0]
        degraded = RouterServer(
            fleets["defended"], port=0, **breakers(fleets["defended"]),
            chaos=OneWorkerChaos(ChaosPlan.parse(CHAOS_PLAN), victim.url))
        routers.append(degraded)
        degraded.start()
        _timed_round(degraded.url, boards, CHAOS_LIMIT, headers, True)
        out["degraded_s"], ids = _timed_round(degraded.url, boards, CHAOS_LIMIT,
                                              headers, True)
        _check_results(degraded.url, ids, wants, "chaos degraded lane")
        out["injected"] = degraded.chaos.stats()
        out["breakers"] = degraded.breaker_states()
    finally:
        for r in routers:  # each takes its workers down with it
            r.shutdown(cascade=True)
        for fleet in fleets.values():  # whatever no router took down
            fleet.terminate()
    n = len(boards)
    for k in ("baseline", "defended", "degraded"):
        out[f"{k}_jobs_per_s"] = n / out[f"{k}_s"]
    out["defended_over_baseline"] = out["defended_jobs_per_s"] / out["baseline_jobs_per_s"]
    out["degraded_over_defended"] = out["degraded_jobs_per_s"] / out["defended_jobs_per_s"]
    reports = _exit_stats(stats)
    launches["chaos lanes (4j, workers)"] = counts = _summed(reports)
    if not counts.get("batch_packed"):
        fail("the chaos lanes' workers launched no B1")
    out["peak_device_bytes"] = {r["pid"]: r["peak_device_bytes"] for r in reports}
    print(f"chaos ({time.perf_counter() - t_chaos:.1f} s): baseline "
          f"{out['baseline_jobs_per_s']:.2f}, defended "
          f"{out['defended_jobs_per_s']:.2f}, degraded "
          f"{out['degraded_jobs_per_s']:.2f} jobs/s; defended/baseline "
          f"{out['defended_over_baseline']:.4f} (the JAX package gates 0.97), "
          f"degraded/defended {out['degraded_over_defended']:.4f} (gates 0.70) "
          f"under {CHAOS_PLAN} on one hop; injected {out['injected']}",
          flush=True)
    return out


def fleet_lanes(work: Path) -> dict:
    """Phase 4j (see the module docstring)."""
    t_phase = time.perf_counter()
    # The router drill kills a fleet process: its workers, orphans, are
    # reparented to this process, which reaps them (PR_SET_CHILD_SUBREAPER).
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    launches = {}
    fleet_boards = _load_boards(FLEET_FREQS, 4000)
    chaos_boards = _load_boards(CHAOS_FREQS, 7000)
    with _oracle_pool() as pool:
        # Submitted now, beside the sparse references and the first fleet's
        # boot and warm round, and read, all of them, before its timed
        # round; the boots are timed at the end, with the pool idle.
        wants = {"fleet": pool.map(_oracle_job, [(b, f, FLEET_LIMIT)
                                                 for f, b in fleet_boards]),
                 "chaos": pool.map(_oracle_job, [(b, f, CHAOS_LIMIT)
                                                 for f, b in chaos_boards])}

        def oracles():
            for k, v in wants.items():
                wants[k] = list(v)
            return wants

        lanes = _fleet_lanes(work, launches, fleet_boards, oracles)
        chaos = _chaos_lanes(work, launches, chaos_boards, oracles()["chaos"])
    boots = _boot_times(work)
    print(f"serve boot: cold {boots['cold_boot_s']:.2f} s, warm "
          f"{boots['warm_boot_s']:.2f} s", flush=True)
    n1, n4 = lanes["n1"], lanes["n4"]
    ratios = {"jobs_n4_over_n1": n4["jobs_per_s"] / n1["jobs_per_s"],
              "shard_n4_over_n1": (n4["shard"]["cell_updates_per_s_makespan"]
                                   / n1["shard"]["cell_updates_per_s_makespan"])}
    print(f"fleet N4 over N1 {ratios['jobs_n4_over_n1']:.3f} (the JAX package "
          f"gates 2.5); shard N4 over N1 {ratios['shard_n4_over_n1']:.3f} "
          "(gates 2)", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4j took {seconds:.1f} s", flush=True)
    return {"launches": launches, "boots": boots, "lanes": lanes,
            "chaos": chaos, "ratios": ratios, "seconds": seconds}


# ---------------------------------------------------------------------------
# 4k. Multi-process runs on the one card

# name: (ranks, shard slots per rank, flags, runs, kernels every rank must
# launch). The runs are phase 4's inputs, each held to phase 4's single-device
# --kernel auto bytes and Generations (the tpu and mpi variants take the C
# convention, as game does).
MP_LANES = {
    "tpu 4x1 auto, 4 ranks": (
        4, 1, ["--variant", "tpu", "--mesh", "4x1"],
        [("b", "random", 1003), ("d", "diagonal_corner", 1000)],
        ("bandtrow_fast", "bandtrow", "dist_band")),
    "tpu 2x2 auto, 4 ranks": (
        4, 1, ["--variant", "tpu", "--mesh", "2x2"],
        [("b", "random", 1003), ("c", "tromino_corner", 1000)],
        ("bandtg_fast", "bandtg", "dist_band")),
    "tpu 2x2 auto, 2 ranks x 2 slots": (
        2, 2, ["--variant", "tpu", "--mesh", "2x2"], [("a", "random", 1000)],
        ("bandtg_fast",)),
    "mpi 2x1, 2 ranks": (
        2, 1, ["--variant", "mpi", "--mesh", "2x1"], [("a", "random", 1000)],
        ("bandtrow_fast",)),
    "tpu 4x1 packed-io, 4 ranks": (
        4, 1, ["--variant", "tpu", "--mesh", "4x1", "--packed-io"],
        [("a", "random", 1000)], ("bandtrow_fast",)),
    "tpu 4x1 pallas, 4 ranks": (
        4, 1, ["--variant", "tpu", "--mesh", "4x1", "--kernel", "pallas"],
        [("a", "random", 1000)], ("dist_byte_band",)),
}
MP_CKPT_EVERY, MP_KILL_AT, MP_LOST_BOUND_S = 250, 500, 60
# Two ranks of NCCL on the one card: NCCL takes one card per rank, so this
# is expected to fail; its error text is printed.
NCCL_PROBE = r"""
import datetime, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=40))
x = torch.ones(4, device="cuda:0")
try:
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print("all_reduce ok", x.tolist())
except Exception as e:  # the probe reports what NCCL said
    print("NCCL error:", type(e).__name__, " ".join(str(e).split())[:400])
    sys.exit(3)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_run(argv: list, ranks: int, slots: int, run_dir: Path, per_rank=None,
              timeout: float = 300) -> list:
    """``python -m gol_tpu_torch argv`` in ``ranks`` processes launched as
    torchrun launches them (``GOL_MULTIHOST=1`` and env:// variables), each
    with ``slots`` shard slots on the card and ``GOL_TORCH_EXIT_STATS``.
    Per rank ``{"rc", "stdout", "stderr", "exit_s", "stats"}``; every rank
    is killed at the timeout, so none outlives the phase."""
    run_dir.mkdir(parents=True, exist_ok=True)
    stats = run_dir / "stats"
    port, base = _free_port(), _subprocess_env()
    base.pop("GOL_FAULTS", None)
    procs, t0 = [], time.monotonic()
    for r in range(ranks):
        env = {**base, "GOL_MULTIHOST": "1", "RANK": str(r), "WORLD_SIZE": str(ranks),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(ranks),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               platform_env.MESH_DEVICES_ENV: str(slots),
               cli.EXIT_STATS_ENV: str(stats), **(per_rank or {}).get(r, {})}
        with open(run_dir / f"out{r}", "w") as out, open(run_dir / f"err{r}", "w") as err:
            procs.append(subprocess.Popen([sys.executable, "-m", "gol_tpu_torch", *argv],
                                          cwd=run_dir, env=env, stdout=out, stderr=err))
    exits = {}
    try:
        while len(exits) < ranks and time.monotonic() - t0 < timeout:
            for r, p in enumerate(procs):
                if r not in exits and p.poll() is not None:
                    exits[r] = time.monotonic() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = {}
    for f in stats.glob("run-*.json") if stats.exists() else ():
        doc = json.loads(f.read_text())
        reports[doc["rank"]] = doc
    return [{"rc": p.returncode if r in exits else None,
             "stdout": (run_dir / f"out{r}").read_text(),
             "stderr": (run_dir / f"err{r}").read_text(),
             "exit_s": exits.get(r), "stats": reports.get(r)}
            for r, p in enumerate(procs)]


def _nccl_probe(work: Path) -> str:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, str(r), str(port)],
                              cwd=work, env=_subprocess_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out after 90 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = [ln for out in outs for ln in out.splitlines()
             if "NCCL error" in ln or "all_reduce ok" in ln or "timed out" in ln]
    text = " | ".join(lines) or "no line from the probe: " + " ".join(
        " ".join(outs).split())[-400:]
    print(f"NCCL probe, 2 ranks on the one card: rcs "
          f"{[p.returncode for p in procs]}: {text}", flush=True)
    return text


def _lane_report(tag: str, key: str, results: list, slots: int) -> dict:
    """Per rank: Execution ms, cell-updates/s, the backend, the halo and
    vote host time per pass (an 8-generation pass, or a generation where
    the lane has none: ``--kernel pallas``), and the launches."""
    ranks = []
    for r, res in enumerate(results):
        st = res["stats"]
        launches = st["launches"]
        passes = sum(launches.get(k, 0) for k in
                     ("bandtrow_fast", "bandtrow", "bandtg_fast", "bandtg")) \
            or launches.get("dist_byte_band", 0) or launches.get("dist_band", 0)
        ranks.append({
            "rank": r, "exec_ms": st["exec_ms"], "generations": st["generations"],
            "cell_updates_per_s": SIZE * SIZE * st["generations"]
            / max(st["exec_ms"] / 1000, 1e-9),
            "backend": st["backend"],
            "halo_phases": st["halo"]["phases"], "halo_ms": st["halo"]["seconds"] * 1e3,
            "votes": st["votes"]["votes"], "vote_ms": st["votes"]["seconds"] * 1e3,
            "kernel_launches": {k: n for k, n in launches.items() if n},
            "passes": max(1, passes // slots),
        })
    for x in ranks:
        x["halo_ms_per_pass"] = x["halo_ms"] / x["passes"]
        x["vote_ms_per_pass"] = x["vote_ms"] / x["passes"]
        print(f"  ({tag}) {key}: rank {x['rank']} over {x['backend']}: Execution "
              f"{x['exec_ms']:.3f} ms, {x['cell_updates_per_s']:.4e} cell-updates/s; "
              f"halo {x['halo_phases']} phases {x['halo_ms']:.3f} ms, votes "
              f"{x['votes']} {x['vote_ms']:.3f} ms; per pass "
              f"halo {x['halo_ms_per_pass']:.4f} ms, votes "
              f"{x['vote_ms_per_pass']:.4f} ms; launches {x['kernel_launches']}",
              flush=True)
    return {"ranks": ranks}


def multiprocess_lanes(work: Path, path: dict) -> dict:
    """Phase 4k: the distributed variants as N ranks of ``python -m
    gol_tpu_torch`` on the one card (over gloo: NCCL takes a card per
    rank), each lane's bytes and Generations against phase 4's single-device
    run, each rank's launches from its exit stats; then the checkpoint lane
    in 2 ranks with one rank SIGKILLed and ``--auto-resume``; and the NCCL
    probe."""
    t_phase = time.perf_counter()
    inputs, results = path["inputs"], path["results"]
    root = work / "mp"
    print("The ranks time-slice the one card: these numbers measure the "
          "multi-process host tier and its transport, not scale-out over "
          "cards.", flush=True)
    by_path, lanes = {}, {}
    for lane, (ranks, slots, flags, runs, needed) in MP_LANES.items():
        summed: dict = {}
        per_rank = [dict() for _ in range(ranks)]
        lanes[lane] = {}
        for tag, key, limit in runs:
            run_dir = root / f"{lane.replace(' ', '_').replace(',', '')}_{tag}_{key}"
            out = run_dir / "out.txt"
            t0 = time.perf_counter()
            res = _rank_run([str(SIZE), str(SIZE), str(inputs[key]), *flags,
                             "--gen-limit", str(limit), "--output", str(out)],
                            ranks, slots, run_dir)
            wall = time.perf_counter() - t0
            for r, x in enumerate(res):
                if x["rc"] != 0 or x["stats"] is None:
                    fail(f"4k {lane} ({tag}) {key}: rank {r} exited {x['rc']}:\n"
                         f"{x['stderr'][-3000:]}")
                gens = int(re.search(r"Generations:\t(\d+)", x["stdout"]).group(1))
                if gens != results[("game", key, limit)][0]:
                    fail(f"4k {lane} ({tag}) {key}: rank {r} printed Generations "
                         f"{gens}, phase 4: {results[('game', key, limit)][0]}")
                _check_codec(x["stats"]["launches"],
                             0 if "--packed-io" in flags or "pallas" in flags else slots,
                             f"4k {lane} ({tag}) {key} rank {r}")
                for k, n in x["stats"]["launches"].items():
                    summed[k] = summed.get(k, 0) + n
                    per_rank[r][k] = per_rank[r].get(k, 0) + n
            if (gens, _digest(out)) != results[("game", key, limit)]:
                fail(f"4k {lane} ({tag}) {key}: bytes differ from phase 4's "
                     "single-device --kernel auto run")
            print(f"({tag}) {key:15s} limit {limit}: {lane}: Generations {gens}, "
                  f"bytes == phase 4, {wall:.1f} s from launch to the last exit",
                  flush=True)
            lanes[lane][f"({tag}) {key}"] = {**_lane_report(tag, key, res, slots),
                                            "wall_s": wall}
        for r, counts in enumerate(per_rank):
            for k in needed:
                if not counts.get(k):
                    fail(f"4k {lane}: rank {r} launched no {k} in the lane's runs")
        by_path[f"multi-process {lane}"] = {k: summed.get(k, 0) for k in _counts()}
        print(f"multi-process {lane}: launches over its ranks {_nonzero(summed)}",
              flush=True)

    # The checkpoint lane in 2 ranks: rank 1 SIGKILLed at the generation-500
    # boundary; its peer must exit non-zero within the bound; --auto-resume
    # from generation 250 must write run (a)'s bytes.
    ck = root / "ckpt"
    argv = [str(SIZE), str(SIZE), str(inputs["random"]), "--variant", "tpu",
            "--mesh", "2x1", "--checkpoint-every", str(MP_CKPT_EVERY),
            "--checkpoint-dir", str(ck / "dir"), "--output", str(ck / "out.txt")]
    killed = _rank_run(argv, 2, 1, ck / "killed", per_rank={
        1: {"GOL_FAULTS": f"kill_at_gen={MP_KILL_AT},kill_mode=sigkill"}})
    if killed[1]["rc"] != -signal.SIGKILL:
        fail(f"4k drill: rank 1 exited {killed[1]['rc']}, not by its SIGKILL")
    lost_s = (killed[0]["exit_s"] or 1e9) - killed[1]["exit_s"]
    if killed[0]["rc"] in (0, None) or lost_s > MP_LOST_BOUND_S:
        fail(f"4k drill: the peer of the killed rank exited {killed[0]['rc']} "
             f"{lost_s:.1f} s after it (bound {MP_LOST_BOUND_S} s)")
    print(f"checkpoint drill: rank 1 SIGKILLed at generation {MP_KILL_AT}; rank 0 "
          f"exited {killed[0]['rc']} {lost_s:.2f} s later; manifests "
          f"{_manifests(ck / 'dir')}", flush=True)
    resumed = _rank_run(argv + ["--auto-resume"], 2, 1, ck / "resumed")
    for r, x in enumerate(resumed):
        if x["rc"] != 0 or f"restored checkpoint at generation {MP_CKPT_EVERY}" \
                not in x["stderr"]:
            fail(f"4k drill: resumed rank {r} exited {x['rc']} or restored no "
                 f"generation {MP_CKPT_EVERY}:\n{x['stderr'][-3000:]}")
    want = results[("game", "random", 1000)]
    gens = int(re.search(r"Generations:\t(\d+)", resumed[0]["stdout"]).group(1))
    if (gens, _digest(ck / "out.txt")) != want:
        fail("4k drill: the resumed run's Generations or bytes differ from "
             "phase 4's run (a)")
    drill = {"peer_rc": killed[0]["rc"], "peer_exit_after_kill_s": lost_s,
             "resumed_exec_ms": [x["stats"]["exec_ms"] for x in resumed]}
    print(f"checkpoint drill: --auto-resume in 2 ranks from generation "
          f"{MP_CKPT_EVERY}: Generations {gens}, bytes == phase 4 run (a); "
          f"Execution ms per rank {drill['resumed_exec_ms']}", flush=True)
    nccl = _nccl_probe(work)
    seconds = time.perf_counter() - t_phase
    print(f"phase 4k took {seconds:.1f} s", flush=True)
    return {"launches": by_path, "lanes": lanes, "drill": drill, "nccl": nccl,
            "seconds": seconds}


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
    out.update(_timed_tile(ops_per_s))
    out.update(_timed_codec(x_cells, x_words, ops_per_s))
    return out


def _timed_codec(cells: torch.Tensor, words: torch.Tensor, ops_per_s: float) -> dict:
    """E1 (``cells`` -> words) and D1 (``words`` -> cells) at the main
    path's grid: 100 launches in one CUDA graph, each from the same input
    into the same output (268 MB of cells: no launch finds them in L2),
    eager launches and the plain version beside them. The bytes are the
    cells and the words, each read or written once."""
    out = {}
    for key, src, dst, into, plain in (
            ("encode", cells, torch.empty_like(words), sp._encode_into, pm.encode),
            ("decode", words, torch.empty_like(cells), sp._decode_into, pm.decode)):
        launch = lambda i, a, b, src=src, dst=dst, into=into: into(src, dst)  # noqa: E731
        ms, wrapper_ms = profiler.ring_graph_ms(launch, [src], [dst], 100)
        eager_ms = _time(launch, [src], [dst], 100)
        plain_ms = _time(lambda i, a, b, src=src, plain=plain: plain(src),
                         [src], [dst], 10)
        nbytes = cells.numel() + words.numel() * words.element_size()
        ops = words.numel() * CODEC_OPS_PER_WORD[key]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        print(f"{key} at {tuple(cells.shape)} cells: {ms:.6f} ms/launch in a CUDA "
              f"graph (eager {eager_ms:.6f} ms, wrapper {wrapper_ms:.6f} ms on the "
              f"host, plain {plain_ms:.6f} ms); bytes {nbytes} -> {bytes_ms:.6f} ms, "
              f"ops {ops} -> {ops_ms:.6f} ms; bound share "
              f"{max(bytes_ms, ops_ms) / ms:.3f}", flush=True)
        out[key] = {
            "shape": list(cells.shape), "ms": ms, "eager_ms": eager_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
            "ops_ms": ops_ms, "logic_ops_per_s": ops_per_s,
        }
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


def _graph_rows_ms(launch, rows: torch.Tensor) -> float:
    """ms per launch of ``launch(k, flags)`` over ``len(rows)`` launches in
    one CUDA graph, launch k ORing into its own zeroed flag row."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(rows.shape[0]):
            launch(k, rows[k])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # warm, then timed
        rows.zero_()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / rows.shape[0]


def _timed_tile(ops_per_s: float) -> dict:
    """T1 at the sparse lane's top rung, 64 tiles of 256^2 into the compact
    interiors (each launch from the same uploaded blocks, as a generation
    of the lane launches), and at the macro lane's 64 leaf windows of 512^2
    ping-ponging two padded stacks with dead rings. 100 launches in one
    CUDA graph, each ORing into its own zeroed flag row; eager launches and
    the plain version beside them. The bytes are the blocks read once and
    the interiors and flags written once."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 12)
    shapes = []
    for batch, tile, form in ((64, 256, "compact"), (64, 512, "padded")):
        cells = rng.integers(0, 2, (batch, tile + 2, tile + 2), dtype=np.uint8)
        if form == "padded":
            cells[:, 0], cells[:, -1], cells[:, :, 0], cells[:, :, -1] = 0, 0, 0, 0
        x = torch.from_numpy(cells).to(dev)
        if form == "compact":
            y = torch.empty((batch, tile, tile), dtype=torch.uint8, device=dev)
            launch = lambda k, f, x=x, y=y: stl.tile_step_into(x, y, f)  # noqa: E731
        else:
            y = torch.zeros_like(x)
            bufs = (x, y)
            launch = lambda k, f, b=bufs: stl.tile_step_into(b[k % 2], b[(k + 1) % 2], f)  # noqa: E731
        rows = torch.zeros((100, batch, stl.TILE_FLAGS), dtype=torch.int32, device=dev)
        ms = _graph_rows_ms(launch, rows)
        eager_ms = _time(lambda i, a, b: launch(0, rows[0]), [x], [y], 100)
        plain_ms = _time(lambda i, a, b: stl._tile_step_plain(x), [x], [y], 10)
        nbytes = batch * ((tile + 2) ** 2 + tile * tile + stl.TILE_FLAGS * 4)
        ops = batch * tile * tile * OPS_PER_CELL
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        print(f"tile_step ({form}) at {batch} x {tile}^2: {ms:.6f} ms/launch in a "
              f"CUDA graph, fresh flags per launch (eager {eager_ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms); bytes {nbytes} -> {bytes_ms:.6f} ms, ops "
              f"{ops} -> {ops_ms:.6f} ms; bound share "
              f"{max(bytes_ms, ops_ms) / ms:.3f}", flush=True)
        shapes.append({
            "shape": [batch, tile + 2, tile + 2], "form": form, "ms": ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "logic_ops": ops,
            "ops_ms": ops_ms, "logic_ops_per_s": ops_per_s,
        })
    return {"tile_step": {**shapes[0], "by_shape": shapes}}


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--io-compare", metavar="DIR,DIR,...",
        help="only time the packed I/O lines of these repository trees "
             "against each other (io_compare), and print them as JSON")
    parser.add_argument("--size", type=int, default=SIZE, help="--io-compare's grid edge")
    parser.add_argument("--rounds", type=int, default=2, help="--io-compare's rounds")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card; this smoke test needs one",
              file=sys.stderr)
        return 2
    if args.io_compare:
        _build.BUILD_DIR.mkdir(exist_ok=True)
        doc = io_compare([Path(t).resolve() for t in args.io_compare.split(",")],
                         args.size, args.rounds)
        print(_smi())
        print(json.dumps(doc))
        return 0
    dev = torch.device("cuda", 0)
    # The CLI runs below, in this process and in the subprocesses, pick
    # their device from the environment: make it the card.
    os.environ[platform_env.DEVICE_ENV] = "cuda"
    # No plan cached on the machine may reroute a runner: every phase but
    # 4h's own runs the built-in plan.
    _build.BUILD_DIR.mkdir(exist_ok=True)
    os.environ[tune_plans.ENV_CACHE_PATH] = str(Path(tempfile.mkdtemp(
        prefix="plans-", dir=_build.BUILD_DIR)) / "plans.json")
    stats = {k["key"]: {"max_abs_err": 0, "checks": 0}
             for k in KERNELS + BATCH_KERNELS + TILE_KERNELS + CODEC_KERNELS}
    work = Path(tempfile.mkdtemp(prefix="smoke-", dir=_build.BUILD_DIR))
    try:
        phase("1. card and build")
        smi = card_and_build()
        phase("2. kernels against their plain versions")
        check_kernels(dev, stats)
        check_batch_kernels(dev, stats)
        check_tile_kernel(dev, stats)
        check_codec_kernels(dev, stats)
        phase("3. small flows through the CLI")
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
        phase("4f. the server lane")
        server = server_lane(work, dev)
        phase("4g. the resident ring")
        ring = ring_lane(work, dev)
        phase(f"4h. the tuner at {SIZE}x{SIZE}")
        tuner = tuner_lane(work, path)
        phase("4i. the sparse and macro lanes")
        lanes = sparse_macro_lanes(work, dev)
        phase("4j. the fleet, its router and chaos, and the shard lane")
        fleet = fleet_lanes(work)
        phase(f"4k. multi-process runs at {SIZE}x{SIZE} on the one card")
        multi = multiprocess_lanes(work, path)
        phase("5. timing")
        times = timing(dev)
        phase("6. the flag-cost roofline")
        roof, roof_counts = roofline_phase()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print("main path run (a): " + json.dumps({**path["run_a"], **mesh["run_a"]}))
    print("packed I/O run (a): " + json.dumps(mesh["io"]))
    print("checkpoint lane: " + json.dumps(ckpt["runs"]))
    print("observability: " + json.dumps({"runs": obs["runs"], "lanes": {
        lane: {k: v[k] for k in ("exec_ms", "window_ms", "kernel_busy_ms",
                                 "device_busy_share", "unprofiled_exec_ms",
                                 "kernel_busy_over_unprofiled",
                                 "first_kernel_after_start_ms", "first_capture")
                  if k in v}
        for lane, v in obs["lanes"].items()}}))
    print(json.dumps({"roofline": roof}))
    print("batch lane: " + json.dumps({
        "exec_ms": batch["exec_ms"], "boards_per_sec": batch["boards_per_sec"],
        "busy": {k: {m: v[m] for m in ("events", "window_ms", "kernel_busy_ms",
                                       "device_busy_share")}
                 for k, v in batch["busy"].items()}}))
    print("server lane: " + json.dumps({
        "seconds": server["seconds"], "lanes": server["lanes"],
        "busy": {m: server["busy"][m] for m in ("events", "window_ms",
                                                "kernel_busy_ms", "device_busy_share")},
        "cache": server["cache"], "warm_over_cold": server["warm_over_cold"],
        "drill": server["drill"]}))
    print("ring lane: " + json.dumps({k: v for k, v in ring.items()
                                      if k != "launches"}))
    print("tuner: " + json.dumps({k: v for k, v in tuner.items()
                                  if k != "launches"}))
    print("sparse and macro lanes: " + json.dumps({k: v for k, v in lanes.items()
                                                   if k != "launches"}))
    print("fleet lanes: " + json.dumps({k: v for k, v in fleet.items()
                                        if k != "launches"}))
    print("multi-process lanes: " + json.dumps({k: v for k, v in multi.items()
                                                if k != "launches"}))
    launches = {**path["launches"], **mesh["launches"], **ckpt["launches"],
                **obs["launches"], **batch["launches"], **server["launches"],
                **ring["launches"], **tuner["launches"], **lanes["launches"],
                **fleet["launches"], **multi["launches"],
                "tpu 2x2 auto 64x64 (one-word shards)": one_word,
                "roofline": roof_counts}
    table = []
    for k in KERNELS + BATCH_KERNELS + TILE_KERNELS + CODEC_KERNELS:
        key = k["key"]
        by_path = {p: n[key] for p, n in launches.items() if n.get(key)}
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
