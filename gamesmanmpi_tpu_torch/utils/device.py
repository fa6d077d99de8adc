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


def resolve_device(device="cuda", *, fork_safe: bool = False
                   ) -> torch.device:
    """torch.device for `device`, checked to exist.

    ``fork_safe=True`` checks for the card through NVML
    (``torch.cuda.device_count()`` before CUDA is initialized), which
    leaves the CUDA driver untouched: a process that checked so can still
    fork children that use the card (the serving supervisor).
    ``torch.cuda.is_available()`` initializes the driver, and a child
    forked after it fails at its first CUDA call."""
    dev = torch.device(device)
    present = ((lambda: torch.cuda.device_count() > 0) if fork_safe
               else torch.cuda.is_available)
    if dev.type == "cuda" and not present():
        raise DeviceUnavailable(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {device!r}")
    return dev
