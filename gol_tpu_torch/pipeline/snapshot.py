"""Host copy of the port's state, taken on a side CUDA stream.

The port of ``gol_tpu/pipeline/snapshot.py``. The async checkpoint writer
must hold no reference to device state once ``save()`` returns: the next
segment runs as soon as it does, and the writer thread writes the payload
while it runs. ``HostSnapshot(state)`` is the foreground copy that makes
this safe. Per CUDA device:

1. an event is recorded on the compute stream (the stream the segment ran
   on), so the copy cannot start before the state is computed;
2. a side stream waits on that event and copies every shard of the device
   into pinned host memory (``non_blocking``, so the compute stream is
   free to take the next segment's launches meanwhile);
3. the side stream is synchronized before the constructor returns: the
   bytes are on the host when it does.

Without step 1 the copy could read a state the segment has not finished
writing; without step 3 a payload could hold a later state than its
manifest names (the CRCs would catch it only on restore).
``tests/test_torch_cuda.py`` pins both with a segment queued behind a
delay.

What the side stream buys today: nothing in time. ``save()`` runs on the
segment loop's thread and returns only after step 3, so the next segment
is not queued while the copy runs, and a blocking copy on the compute
stream would order and time the same. The side stream and its event are
the shape a snapshot that overlaps the next segment needs (queue the
segment, then wait for the copy on the writer's thread). The pipelined
packed I/O (ROADMAP Queue 1 item 2) overlaps the copies of a read or a
write with the host codec (``io/packed_io.py``); it does not overlap a
save with the next segment, which stays with the checkpoint lane's cost
(ROADMAP Queue 2b item 5).

``state`` is one tensor or a mesh's row-major list of shards (in a
multi-process run, this process's own shards only); ``.state``
is the host copy in the same structure, so every payload writer produces
from it the bytes it would produce from the live state, and the CRC
blocks come out the same. CPU shards (the CPU lane) are copied on the
host. ``SnapshotBuffers`` keeps the pinned buffers and side streams of one
writer: ``drain()`` precedes each snapshot, so one set serves every save.
"""

from __future__ import annotations

import torch


class SnapshotBuffers:
    """Host buffers (pinned for CUDA shards) and side streams, reused by
    every snapshot of one writer while the shards' shapes stay the same."""

    def __init__(self):
        self._host: list[torch.Tensor] = []
        self._streams: dict = {}

    def host(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        fits = len(self._host) == len(shards) and all(
            h.shape == s.shape and h.dtype == s.dtype
            for h, s in zip(self._host, shards))
        if not fits:
            self._host = [torch.empty(s.shape, dtype=s.dtype,
                                      pin_memory=s.device.type == "cuda")
                          for s in shards]
        return self._host

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]


class HostSnapshot:
    """Device->host copy of a state, shard structure preserved. The
    constructor blocks until every shard's bytes are on the host."""

    def __init__(self, state, buffers: SnapshotBuffers | None = None):
        is_list = isinstance(state, (list, tuple))
        shards = list(state) if is_list else [state]
        buffers = buffers or SnapshotBuffers()
        host = buffers.host(shards)
        by_device: dict = {}
        for s, h in zip(shards, host):
            by_device.setdefault(s.device, []).append((s, h))
        for device, pairs in by_device.items():
            if device.type != "cuda":
                for s, h in pairs:
                    h.copy_(s)
                continue
            side = buffers.stream(device)
            boundary = torch.cuda.current_stream(device).record_event()
            side.wait_event(boundary)
            with torch.cuda.stream(side):
                for s, h in pairs:
                    h.copy_(s, non_blocking=True)
            side.synchronize()
        self.state = list(host) if is_list else host[0]
