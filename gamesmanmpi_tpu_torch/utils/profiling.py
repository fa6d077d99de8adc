"""Profiler capture (port of gamesmanmpi_tpu/utils/profiling.py).

``--profile-dir DIR`` wraps the solve in ``torch.profiler.profile`` with
the CPU and, when the card is up, the CUDA activities, and writes one
Chrome trace (``trace_<pid>.json``, loadable in chrome://tracing or
Perfetto) into DIR when the block exits: the kernel timeline of the
solve, the hand-written kernels included, and a traced solve's spans
(obs/tracing.py, ``profiler_ranges``) as profiler ranges, all inside one
``profile`` range (it also takes the one-time set-up of a session's
first range, ~0.1 ms, off the solve's first span). The installed
``--trace-events`` sink takes the trace's time base, so its file
overlays this one. No directory, no profiler.
"""

from __future__ import annotations

import contextlib
import os

from gamesmanmpi_tpu_torch.obs.tracing import (
    adopt_profiler_base,
    profiler_ranges,
)


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    """Context manager: a torch.profiler trace into ``trace_dir`` when a
    directory is given, else nothing."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(trace_dir), exist_ok=True)
    with profile(activities=activities) as prof, profiler_ranges(), \
            record_function("profile"):
        yield
    path = os.path.join(str(trace_dir), f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    adopt_profiler_base(path)
