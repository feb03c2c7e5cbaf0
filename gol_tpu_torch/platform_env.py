"""Device choice for the PyTorch port.

The counterpart of ``JAX_PLATFORMS`` in the JAX package: the port runs on
the CUDA card unless the caller asks for the CPU, either with an explicit
``device=`` argument or, for the entry points, ``GOL_TORCH_DEVICE=cpu``.
A CUDA request on a host without a card raises ``NoDeviceError``; nothing
ever carries on on the CPU in its place.

``mesh_devices`` is the counterpart of XLA's device list: the shard slots
a mesh may place its shards on. ``GOL_TORCH_MESH_DEVICES=N`` lays N entries
round-robin over the process's devices, so N shards can share one card
(or the CPU), as the JAX test suite's 8 virtual CPU devices do. In a
multi-process run (``parallel/bootstrap.py``) each rank drives its own
card, ``cuda:{LOCAL_RANK % device_count}``, and the list is the world's, in
rank order: each rank's own slots, and a ``PeerSlot`` for each slot of
another rank, as ``jax.devices()`` lists every process's devices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import torch

DEVICE_ENV = "GOL_TORCH_DEVICE"
MESH_DEVICES_ENV = "GOL_TORCH_MESH_DEVICES"
DEFAULT_DEVICE = "cuda"


class NoDeviceError(RuntimeError):
    """The requested device is not present (or not a device the port runs on)."""


@dataclasses.dataclass(frozen=True)
class PeerSlot:
    """A shard slot of another rank of a multi-process run: its device
    belongs to that process."""

    rank: int
    index: int


# Set by ``parallel.bootstrap.initialize``: this process's rank and every
# rank's count of shard slots. None on a single process.
_WORLD: tuple[int, tuple[int, ...]] | None = None


def set_world(rank: int, slot_counts=()) -> None:
    """Record this process's rank and the world's slot counts, rank by
    rank (``parallel/bootstrap.py`` all-gathers them once, after recording
    the rank alone, from which on the process's slots are its own card's)."""
    global _WORLD
    _WORLD = (int(rank), tuple(int(n) for n in slot_counts))


def rank_device(local_rank: int) -> torch.device:
    """The device of the rank with this local rank: the CPU under
    ``$GOL_TORCH_DEVICE=cpu``, else ``cuda:{local_rank % device_count}``
    (ranks beyond the host's cards share them round-robin)."""
    dev = resolve_device()
    if dev.type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a run executes on: ``device``, else ``$GOL_TORCH_DEVICE``,
    else ``cuda``. Raises ``NoDeviceError`` for a CUDA request without a
    card, and for any device type other than ``cuda`` and ``cpu``."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or DEFAULT_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                f"device {str(dev)!r} requested but torch sees no CUDA card; "
                f"set {DEVICE_ENV}=cpu (or pass device='cpu') to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise NoDeviceError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")


def local_mesh_devices() -> list[torch.device]:
    """This process's shard slots: one per card torch sees (one ``cpu``
    entry on the CPU lane; in a multi-process run, the rank's own card),
    or, with ``$GOL_TORCH_MESH_DEVICES`` = N, N entries laid round-robin
    over them."""
    dev = resolve_device()
    if dev.type == "cuda" and _WORLD is None:
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    spec = os.environ.get(MESH_DEVICES_ENV)
    if not spec:
        return base
    if not spec.isdigit() or int(spec) < 1:
        raise ValueError(f"{MESH_DEVICES_ENV} must be a positive integer, got {spec!r}")
    return [base[i % len(base)] for i in range(int(spec))]


def mesh_devices() -> list:
    """The shard slots a mesh may use, in rank order: this process's
    (``local_mesh_devices``) on a single process; in a multi-process run
    every rank's, a ``PeerSlot`` standing for each slot of another rank."""
    local = local_mesh_devices()
    if _WORLD is None:
        return local
    rank, counts = _WORLD
    if len(local) != counts[rank]:
        raise ValueError(
            f"rank {rank} has {len(local)} shard slots now but declared "
            f"{counts[rank]} at bootstrap ({MESH_DEVICES_ENV} changed?)")
    out = []
    for r, n in enumerate(counts):
        out.extend(local if r == rank else [PeerSlot(r, i) for i in range(n)])
    return out


def slot_owners() -> list[int]:
    """The rank owning each entry of ``mesh_devices()``: all 0 on a single
    process."""
    if _WORLD is None:
        return [0] * len(local_mesh_devices())
    return [r for r, n in enumerate(_WORLD[1]) for _ in range(n)]


def process_rank() -> int:
    """This process's rank (0 on a single process)."""
    return 0 if _WORLD is None else _WORLD[0]


class _DynamicStderrHandler(logging.StreamHandler):
    """A StreamHandler that resolves ``sys.stderr`` at emit time: test
    harnesses swap the stream per run, and a handler pinned to a dead
    buffer would swallow every record."""

    def __init__(self, level=logging.NOTSET):
        logging.Handler.__init__(self, level)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        del value  # dynamic by design: redirect sys.stderr instead


def configure_cli_logging(level: int = logging.INFO) -> None:
    """Route the ``gol_tpu_torch`` logger tree to stderr for the entry
    points, as the JAX package's CLI routes ``gol_tpu``'s: checkpoint,
    retry and writer notices (``auto-resume: restored checkpoint ...``)
    reach stderr. Idempotent; a host application's own configuration
    wins."""
    lg = logging.getLogger("gol_tpu_torch")
    if any(isinstance(h, _DynamicStderrHandler) for h in lg.handlers):
        return
    handler = _DynamicStderrHandler()
    handler.setFormatter(logging.Formatter("gol_tpu_torch: %(message)s"))
    lg.addHandler(handler)
    if lg.level == logging.NOTSET or lg.level > level:
        lg.setLevel(level)
