"""Profiler capture (port of gamesmanmpi_tpu/utils/profiling.py).

``--profile-dir DIR`` wraps the solve in ``torch.profiler.profile`` with
the CPU and, when the card is up, the CUDA activities, and writes one
Chrome trace (``trace_<pid>.json``, loadable in chrome://tracing or
Perfetto) into DIR when the block exits: the kernel timeline of the
solve, the window-gather kernel included. No directory, no profiler.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    """Context manager: a torch.profiler trace into ``trace_dir`` when a
    directory is given, else nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(trace_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(str(trace_dir), f"trace_{os.getpid()}.json"))
