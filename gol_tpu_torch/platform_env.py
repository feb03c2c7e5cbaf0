"""Device choice for the PyTorch port.

The counterpart of ``JAX_PLATFORMS`` in the JAX package: the port runs on
the CUDA card unless the caller asks for the CPU, either with an explicit
``device=`` argument or, for the entry points, ``GOL_TORCH_DEVICE=cpu``.
A CUDA request on a host without a card raises ``NoDeviceError``; nothing
ever carries on on the CPU in its place.

``mesh_devices`` is the counterpart of XLA's host device count: the devices
a mesh may place its shards on. ``GOL_TORCH_MESH_DEVICES=N`` lays N entries
round-robin over the platform's devices, so N shards can share one card
(or the CPU), as the JAX test suite's 8 virtual CPU devices do.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

DEVICE_ENV = "GOL_TORCH_DEVICE"
MESH_DEVICES_ENV = "GOL_TORCH_MESH_DEVICES"
DEFAULT_DEVICE = "cuda"


class NoDeviceError(RuntimeError):
    """The requested device is not present (or not a device the port runs on)."""


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


def mesh_devices() -> list[torch.device]:
    """The devices a mesh may use, one entry per shard slot: one per card
    torch sees (one ``cpu`` entry on the CPU lane), or, with
    ``$GOL_TORCH_MESH_DEVICES`` = N, N entries laid round-robin over them."""
    dev = resolve_device()
    if dev.type == "cuda":
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        base = [dev]
    spec = os.environ.get(MESH_DEVICES_ENV)
    if not spec:
        return base
    if not spec.isdigit() or int(spec) < 1:
        raise ValueError(f"{MESH_DEVICES_ENV} must be a positive integer, got {spec!r}")
    return [base[i % len(base)] for i in range(int(spec))]


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
