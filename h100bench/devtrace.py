"""Device activity of a traced window, from torch.profiler (CUPTI).

Only the CUDA activity is recorded, so the host's own work is not slowed
by op recording. The trace is exported, read back and summed here:

- busy_s: the union of every kernel, copy and memset interval;
- by_name: device seconds per operation name (copies named by kind, such
  as "Memcpy HtoD (Pageable -> Device)");
- gaps: the idle time between device activity, summed by the pair of
  operations around each gap ("<before> -> <after>"), which says what the
  host was doing in between.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _short(name: str, n: int = 80) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def summarize(events: list, wall_s: float) -> dict:
    """Summary of chrome-trace device events [(name, cat, ts_us, dur_us)]."""
    ivs = sorted((ts, ts + dur, name) for name, _cat, ts, dur in events)
    by_name: dict = {}
    for name, _cat, _ts, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    busy = 0.0
    gaps: dict = {}
    cur_s = cur_e = None
    last_name = None
    for s, e, name in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                key = f"{_short(last_name)} -> {_short(name)}"
                gaps[key] = gaps.get(key, 0.0) + (s - cur_e) / 1e6
            cur_s, cur_e, last_name = s, e, name
        elif e >= cur_e:
            cur_e, last_name = e, name
    if cur_e is not None:
        busy += cur_e - cur_s
    copies = {k: v for k, v in by_name.items() if k.startswith("Memcpy")}
    return {
        "busy_s": busy / 1e6,
        "window_s": wall_s,
        "events": len(events),
        "by_name": by_name,
        "copy_s": sum(copies.values()),
        "copies": copies,
        "gaps": gaps,
    }


def read_chrome_trace(path: str) -> list:
    """Device events [(name, category, ts_us, dur_us)] of an exported
    trace."""
    with open(path) as fh:
        doc = json.load(fh)
    return [(ev.get("name", "?"), ev["cat"], float(ev["ts"]),
             float(ev.get("dur", 0.0)))
            for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]


class DeviceTrace:
    """start() / stop() around a window; summary() after stop().
    scratch: a directory for the exported trace (deleted once read)."""

    def __init__(self, scratch: str):
        self.scratch = scratch
        self.prof = None
        self.wall_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def summary(self) -> dict:
        os.makedirs(self.scratch, exist_ok=True)
        path = os.path.join(self.scratch, f"trace_{os.getpid()}.json")
        try:
            self.prof.export_chrome_trace(path)
            events = read_chrome_trace(path)
        finally:
            if os.path.exists(path):
                os.remove(path)
        return summarize(events, self.wall_s)


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
