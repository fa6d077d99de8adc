"""Solver heartbeat: periodic liveness + resource records (port of
gamesmanmpi_tpu/obs/heartbeat.py).

A big-board solve is hours of silence between per-level records — longer
than the environment's relay MTBF — and when it wedges the operator has
nothing to distinguish "slow level" from "dead backend". The heartbeat
is a daemon thread that every ``interval`` seconds emits one record with:

* the solver's current progress (phase + level + frontier size — a
  ``progress`` callable supplied by the owner, read without locking:
  the dict is replaced atomically, never mutated in place);
* host RSS (``/proc/self/statm`` when available, ``resource`` else);
* per-card memory stats once this process has initialised CUDA
  (``torch.cuda.memory_allocated`` and the card's total memory, labelled
  ``cuda:<i>``; absent on the CPU — omitted, never fatal).

Records go to the shared JSONL logger (``{"phase": "heartbeat", ...}``)
and to registry gauges (``gamesman_rss_bytes``,
``gamesman_device_bytes_in_use{device=...}``,
``gamesman_heartbeat_beats_total``), so a wedged solve is visible both
in the artifact file and on a live ``/metrics`` scrape.

Enable via ``Solver(heartbeat_secs=...)``, the ``--heartbeat-secs`` CLI
flag, or ``GAMESMAN_HEARTBEAT_SECS``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry, default_registry


def rss_bytes() -> Optional[int]:
    """Resident set size of this process, None when undeterminable.

    None, not 0: a containerized /proc-less host (or a masked
    ``/proc/self/statm``) is a *measurement* failure, and a heartbeat
    stream full of ``rss_bytes: 0`` reads as "the solver uses no
    memory" — the record carries ``null`` instead and the gauge is
    simply not set. Never raises (the beat must not be able to
    traceback once per interval on an exotic host)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        # ru_maxrss: bytes on macOS, KiB on Linux — peak, not current,
        # but a usable fallback where /proc is absent.
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except Exception:  # exotic platforms / faked failures in tests
        return None


def process_rank():
    """This process's rank in a multi-process run, None single-process.

    Reads sys.modules instead of importing torch: the heartbeat must work
    (and stay cheap) in torch-free consumers like the query server, and
    must never be the thing that first initialises a process group."""
    try:
        import sys

        torch = sys.modules.get("torch")
        dist = getattr(torch, "distributed", None) if torch else None
        if (dist is not None and dist.is_available()
                and dist.is_initialized() and dist.get_world_size() > 1):
            return int(dist.get_rank())
    except Exception:  # uninitialized distributed state: single-process
        pass
    return None


def device_memory_stats() -> dict:
    """{"cuda:<i>": {bytes_in_use, bytes_limit}} for every visible card,
    {} when torch is not imported or CUDA is not initialised in this
    process: a forked serving worker (whose parent never touched the
    driver) must not be the thing that first initialises CUDA, and
    asking the allocator does not. ``bytes_in_use`` is the caching
    allocator's live bytes (``torch.cuda.memory_allocated``),
    ``bytes_limit`` the card's total memory (``mem_get_info``). Never
    raises: the heartbeat must not be able to kill or wedge the solve
    it is watching."""
    out: dict = {}
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return {}
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
            }
    except Exception:
        return {}
    return out


class Heartbeat:
    """Periodic progress/RSS/device-memory reporter (daemon thread).

    ``progress``: zero-arg callable returning a dict merged into every
    beat (the solver passes its current phase/level). ``stop()`` joins
    the thread; it is also a context manager. A beat is also emitted at
    stop() time when at least one interval elapsed since the last one,
    so short runs still leave a final resource sample.
    """

    def __init__(self, interval: float, *,
                 progress: Optional[Callable[[], dict]] = None,
                 logger=None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.monotonic):
        if interval <= 0:
            raise ValueError("heartbeat interval must be positive")
        self.interval = float(interval)
        self.progress = progress
        self.logger = logger
        self.registry = registry or default_registry()
        self.beats = 0
        self._clock = clock
        self._t0 = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="gamesman-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ---------------------------------------------------------------- beat

    def beat(self) -> dict:
        """Emit one record now (also callable directly — tests, a final
        sample at stop)."""
        rec: dict = {
            "phase": "heartbeat",
            "uptime_secs": round(self._clock() - self._t0, 3),
            # None (JSON null) when /proc and the resource fallback are
            # both unavailable — a masked /proc must degrade the one
            # field, not traceback every beat (tests fake the failure).
            "rss_bytes": rss_bytes(),
        }
        rank = process_rank()
        if rank is not None:
            # Rank-stamped so N processes' interleaved heartbeat streams
            # stay attributable (docs/DISTRIBUTED.md); single-process
            # records are byte-identical to before.
            rec["rank"] = rank
        if self.progress is not None:
            try:
                # Nested, not merged: the solver's progress dict carries
                # its own "phase" key, which must not masquerade as a
                # per-level record in the shared JSONL stream.
                rec["progress"] = dict(self.progress() or {})
            except Exception:  # the watched solver owns its own errors
                pass
        try:
            dev = device_memory_stats()
        except Exception:  # noqa: BLE001 - belt-and-braces: never a
            dev = {}       # traceback-per-beat, whatever the backend does
        if dev:
            rec["devices"] = dev
        self.beats += 1
        reg = self.registry
        reg.counter(
            "gamesman_heartbeat_beats_total", "heartbeat records emitted"
        ).inc()
        if rec["rss_bytes"] is not None:
            reg.gauge(
                "gamesman_rss_bytes",
                "resident set size of the solver process",
            ).set(rec["rss_bytes"])
        for label, stats in dev.items():
            if "bytes_in_use" in stats:
                reg.gauge(
                    "gamesman_device_bytes_in_use",
                    "per-device allocator bytes in use",
                    device=label,
                ).set(stats["bytes_in_use"])
            if "bytes_limit" in stats:
                reg.gauge(
                    "gamesman_device_bytes_limit",
                    "per-device allocator byte limit",
                    device=label,
                ).set(stats["bytes_limit"])
        if self.logger is not None:
            self.logger.log(rec)
        return rec

    def _run(self) -> None:
        last = self._clock()
        while not self._stop.wait(self.interval):
            self.beat()
            last = self._clock()
        if self._clock() - last >= self.interval:
            self.beat()
