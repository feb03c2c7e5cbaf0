"""Async execution pipeline: overlap host work with device compute.

The port's counterpart of ``gol_tpu/pipeline/``:

- ``writer.AsyncCheckpointWriter``: ``--checkpoint-every`` saves split into
  a foreground device->host snapshot (``snapshot.HostSnapshot``, a copy on
  a side CUDA stream into pinned memory) and a background payload write;
  the manifest commits at the next boundary, the iwrite/Wait-at-next-step
  shape of the reference's async variant (src/game_mpi_async.c).
- ``inflight.Handoff``: the ordered FIFO between two pipeline stages
  (copied).

Wall-clock discipline: ``time.perf_counter()`` only.
"""

from gol_tpu_torch.pipeline.inflight import Handoff
from gol_tpu_torch.pipeline.snapshot import HostSnapshot
from gol_tpu_torch.pipeline.writer import AsyncCheckpointWriter

__all__ = ["AsyncCheckpointWriter", "Handoff", "HostSnapshot"]
