"""Per-level watchdog: turn an observed wedge into a recoverable abort
(port of gamesmanmpi_tpu/resilience/supervisor.py).

The heartbeat (obs/heartbeat.py) reports WHERE a solve stopped; it does
nothing about it. A wedged accelerator call cannot be interrupted from
Python — the only honest recovery is to dump diagnostics and abort the
process while the checkpoint prefix is intact (every save is atomic, so
a restart resumes exactly). The watchdog is the thread that makes that
call: it polls the solver's ``progress`` dict (already replaced
atomically at every phase/level boundary for the heartbeat) and, when
progress stalls past a deadline derived from recent level times, dumps
the last known progress, the recent level durations, and every thread's
stack, then runs its abort action (default ``os._exit(124)``).

Deadline model: levels in one solve vary by orders of magnitude, so a
fixed timeout is either useless or trigger-happy. The deadline is::

    max(min_secs, factor * max(recent level durations))

— a level may take ``factor``x longer than the slowest level seen so
far before it is declared wedged. ``min_secs`` covers the first level
(no history yet) and compilation stalls.

Enable with ``GAMESMAN_WATCHDOG_SECS`` (the ``min_secs`` floor;
``--watchdog-secs`` is the CLI spelling; 0/unset = off) and tune with
``GAMESMAN_WATCHDOG_FACTOR`` (default 10).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.utils.env import env_float as _env_float

WATCHDOG_EXIT_CODE = 124


def _default_action() -> None:  # pragma: no cover - kills the process
    os._exit(WATCHDOG_EXIT_CODE)


class Watchdog:
    """Stall detector over a ``progress`` callable (daemon thread).

    ``progress`` is the same zero-arg callable the heartbeat reads: a
    dict replaced (never mutated) at each phase/level boundary. Any
    change of the dict counts as progress; the duration of each finished
    segment feeds the adaptive deadline. ``action`` (default: hard
    process exit) runs once after diagnostics are dumped — tests inject
    a callback instead of dying.
    """

    def __init__(self, progress: Callable[[], dict], *, min_secs: float,
                 factor: float = 10.0, history: int = 8,
                 poll: Optional[float] = None, action=None, logger=None,
                 registry=None, clock=time.monotonic):
        if min_secs <= 0:
            raise ValueError("watchdog min_secs must be positive")
        self.progress = progress
        self.min_secs = float(min_secs)
        self.factor = float(factor)
        self.action = action or _default_action
        self.logger = logger
        self.registry = registry or default_registry()
        self.recent: deque = deque(maxlen=history)
        self.expired = False
        self._clock = clock
        self._poll = poll if poll is not None else max(0.05, min_secs / 4)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="gamesman-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- watching

    def deadline(self) -> float:
        """Current stall budget: factor x slowest recent segment, floored
        at min_secs."""
        if not self.recent:
            return self.min_secs
        return max(self.min_secs, self.factor * max(self.recent))

    def _snapshot(self) -> dict:
        try:
            return dict(self.progress() or {})
        except Exception:  # the watched solver owns its own errors
            return {}

    def _run(self) -> None:
        last = self._snapshot()
        seg_t0 = self._clock()
        while not self._stop.wait(self._poll):
            now = self._clock()
            cur = self._snapshot()
            if cur != last:
                self.recent.append(now - seg_t0)
                last = cur
                seg_t0 = now
                continue
            stalled = now - seg_t0
            if stalled > self.deadline():
                self._expire(cur, stalled)
                return

    def _expire(self, snapshot: dict, stalled: float) -> None:
        self.expired = True
        rec = {
            "phase": "watchdog_abort",
            "progress": snapshot,
            "stalled_secs": round(stalled, 3),
            "deadline_secs": round(self.deadline(), 3),
            "recent_segment_secs": [round(s, 3) for s in self.recent],
        }
        sys.stderr.write(f"[watchdog] stall detected: {rec}\n")
        # Every thread's stack: the one artifact that distinguishes "device
        # call never returned" from "host loop deadlocked".
        try:
            import faulthandler

            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        sys.stderr.flush()
        self.registry.counter(
            "gamesman_watchdog_expired_total",
            "watchdog stall aborts",
        ).inc()
        if self.logger is not None:
            try:
                self.logger.log(rec)
            except Exception:
                pass
        # Post-mortem before the abort action: the flight
        # recorder names the last completed level and the spans that
        # were in flight when progress stopped — the diagnosis an
        # exit-124 used to need a rerun under instrumentation for.
        # (Watchdog thread, never a signal handler — locking is fine.)
        from gamesmanmpi_tpu_torch.obs import flightrec

        flightrec.record("watchdog_abort",
                         stalled_secs=round(stalled, 3))
        flightrec.dump("watchdog_abort")
        self.action()


def maybe_watchdog(progress, *, logger=None) -> Optional[Watchdog]:
    """Env-gated watchdog the engines wrap their solve with: started
    when ``GAMESMAN_WATCHDOG_SECS`` > 0, else None."""
    secs = _env_float("GAMESMAN_WATCHDOG_SECS", 0.0)
    if secs <= 0:
        return None
    return Watchdog(
        progress,
        min_secs=secs,
        factor=_env_float("GAMESMAN_WATCHDOG_FACTOR", 10.0),
        logger=logger,
    ).start()
