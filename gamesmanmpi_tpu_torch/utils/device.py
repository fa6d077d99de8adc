"""Device choice for the port's entry points.

Every entry point takes an explicit device and defaults to the card. A
request for ``cuda`` on a machine without one raises
:class:`DeviceUnavailable` (the CLI turns it into exit 2); nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`, checked to exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {device!r}")
    return dev
