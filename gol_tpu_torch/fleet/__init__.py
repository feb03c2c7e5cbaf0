"""The horizontal serving tier: a router front-end over N serve workers
(the port's copy of ``gol_tpu/fleet``).

``serve`` is one process on one card; this package is the fleet around it
— the analog of the reference promoting one rank's loop to an
``MPI_Cart_create`` topology of ranks:

- ``placement``  — deterministic bucket -> worker mapping (rendezvous
  hashing, so each bucket's runners and resident rings stay hot on one
  worker);
- ``workers``    — membership: spawn local ``python -m gol_tpu_torch
  serve`` subprocesses on journal partitions, or attach workers by URL;
  the manifest, health/burn probing, supervised respawn, fleet-wide drain;
- ``router``     — the HTTP front-end: single-server API unchanged,
  bucket-routed submits with 429/unreachable spillover, fleet-merged
  ``/metrics`` + ``/slo``, ``/fleet`` membership, cascaded ``/drain``, and
  the sharded single-job lane's coordinator (``shard/``);
- ``affinity``, ``breaker``, ``autoscale``, ``replicate`` — weighted
  placement, per-worker circuit breakers, the elastic control loop and
  the router replicas' shared state;
- ``client``     — the stdlib HTTP JSON client all of the above share;
- ``lease``      — SIGKILL-safe flock leases (the leader lease, the
  manifest lock, the journal compactor's lock).

The router owns no device and its modules import no torch, so a fleet
process boots (and restarts) quickly; its shard lane and fingerprint
routing load modules that import torch at their first use. The workers
own the card. Exactly-once across the fleet is the sum of the per-partition
journals — the router persists nothing but the membership manifest.
The manifest, journals and leases are the JAX package's formats, so a
fleet directory moves between the packages.
"""

from gol_tpu_torch.fleet.placement import PLACEMENT_QUANTUM, PlacementKey  # noqa: F401
from gol_tpu_torch.fleet.router import RouterServer  # noqa: F401
from gol_tpu_torch.fleet.workers import Fleet, Worker  # noqa: F401
