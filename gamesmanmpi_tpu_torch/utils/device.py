"""Device choice for the port's entry points.

Every entry point takes an explicit device and defaults to the card. A
request for ``cuda`` on a machine without one raises
:class:`DeviceUnavailable` (the CLI turns it into exit 2); nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

import ctypes


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


#: The message every entry point gives when the card is missing.
NO_CARD = ("a CUDA device was requested but torch.cuda.is_available() is "
           "false; pass device='cpu' (CLI: --device cpu) to run on the CPU")


def nvml_device_count() -> int:
    """The cards NVML sees (torch.cuda's own pre-initialization count),
    0 where NVML is missing or fails. It loads neither torch nor the CUDA
    library, so a supervisor that only starts CUDA children (the registry's
    job runner) checks the card without a CUDA process's resident set."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    nvml.nvmlInit.argtypes = []
    nvml.nvmlInit.restype = ctypes.c_int
    nvml.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    nvml.nvmlDeviceGetCount_v2.restype = ctypes.c_int
    if nvml.nvmlInit() != 0:
        return 0
    count = ctypes.c_uint(0)
    if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
        return 0
    return count.value


def resolve_device(device="cuda", *, fork_safe: bool = False
                   ) -> torch.device:
    """torch.device for `device`, checked to exist.

    ``fork_safe=True`` checks for the card through NVML
    (``torch.cuda.device_count()`` before CUDA is initialized), which
    leaves the CUDA driver untouched: a process that checked so can still
    fork children that use the card (the serving supervisor).
    ``torch.cuda.is_available()`` initializes the driver, and a child
    forked after it fails at its first CUDA call."""
    import torch

    dev = torch.device(device)
    present = ((lambda: torch.cuda.device_count() > 0) if fork_safe
               else torch.cuda.is_available)
    if dev.type == "cuda" and not present():
        raise DeviceUnavailable(NO_CARD)
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {device!r}")
    return dev
