"""Device choice for the PyTorch port.

The counterpart of ``JAX_PLATFORMS`` in the JAX package: the port runs on
the CUDA card unless the caller asks for the CPU, either with an explicit
``device=`` argument or, for the entry points, ``GOL_TORCH_DEVICE=cpu``.
A CUDA request on a host without a card raises ``NoDeviceError``; nothing
ever carries on on the CPU in its place.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "GOL_TORCH_DEVICE"
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
