"""Sharded single-job engine: one giant universe spanning N workers.

The sparse engine's tile grid is partitioned by rendezvous hashing
(``partition``), each worker advances its owned tiles through the exact
solo kernel path (``worker`` -> sparse.engine.step_tiles), boundary rings
cross the fleet as packed GOLP frames per super-step (``halo``), and a
leader-only coordinator lane in the router drives the barriers,
checkpoints, recovery, and elastic rebalance (``coordinator``) — the
distributed-memory half of the reference's ``game_mpi.c``, rebuilt on the
fleet's own wire, placement, and durability contracts.
"""
