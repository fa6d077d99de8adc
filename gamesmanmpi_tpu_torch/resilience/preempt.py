"""Preemption grace (port of gamesmanmpi_tpu/resilience/preempt.py):
SIGTERM/SIGUSR1 -> stop at the next level boundary -> exit 75.

* The CLI installs :func:`install_grace_handler` around a checkpointed
  solve. SIGTERM/SIGUSR1 set a flag (plain attribute stores: the handler
  takes no lock, since it runs on the main thread between bytecodes of
  the code it interrupted) and arm a one-shot grace deadline.
* The engines call :func:`check` at every level boundary, where
  everything before it is sealed. The sharded engine in a world first
  folds every rank's flag into a consensus round
  (parallel/sharded.ShardedSolver._check_preempt), so all ranks stop at
  the same boundary.
* :class:`PreemptionRequested` unwinds the solve, and the CLI exits
  :data:`GRACE_EXIT_CODE` (75, EX_TEMPFAIL: resumable).
* A solve that never reaches a boundary within the grace window
  (``GAMESMAN_PREEMPT_GRACE_SECS``, default 30) is force-exited 124.
  Every payload write is tmp + os.replace and every seal an atomic
  manifest replace, so the worst case is an unsealed stray that resume
  ignores.

The reference's preemption counter and flight-recorder dump belong to
the observability layer, not ported yet.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import Optional

from gamesmanmpi_tpu_torch.utils.env import env_float

#: EX_TEMPFAIL: the solve stopped resumable under preemption grace.
GRACE_EXIT_CODE = 75

#: The force-exit code when the grace deadline passes (the reference
#: watchdog's resumable-abort code).
WATCHDOG_EXIT_CODE = 124

#: Signals that request graceful preemption.
GRACE_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class PreemptionRequested(Exception):
    """Raised at a level boundary after a grace signal: the solve stops
    here, with everything complete so far sealed."""


#: Written only by the signal handler (main thread), read by check().
_requested = False
_signum: Optional[int] = None
_deadline_timer: Optional[threading.Timer] = None


def requested() -> bool:
    """Has a grace signal arrived?"""
    return _requested


def reset() -> None:
    """Clear the flag and disarm the deadline."""
    global _requested, _signum, _deadline_timer
    _requested = False
    _signum = None
    t = _deadline_timer
    _deadline_timer = None
    if t is not None:
        t.cancel()


def _force_exit(grace_secs: float) -> None:  # pragma: no cover - kills
    sys.stderr.write(
        f"[preempt] grace deadline ({grace_secs:.0f}s) expired before a "
        "level boundary; forcing resumable abort\n")
    sys.stderr.flush()
    os._exit(WATCHDOG_EXIT_CODE)


def _on_grace_signal(signum, frame) -> None:
    # Lock-free: attribute stores and a daemon-timer start only. A second
    # signal while draining is a no-op (the first deadline stands).
    global _requested, _signum, _deadline_timer
    if _requested:
        return
    _requested = True
    _signum = signum
    grace = env_float("GAMESMAN_PREEMPT_GRACE_SECS", 30.0)
    sys.stderr.write(f"[preempt] signal {signum}: draining to the next "
                     f"level boundary (grace {grace:.0f}s)\n")
    sys.stderr.flush()
    if grace > 0:
        t = threading.Timer(grace, _force_exit, args=(grace,))
        t.daemon = True
        t.start()
        _deadline_timer = t


def install_grace_handler():
    """Install the grace handlers; returns a zero-arg restore callable
    (which also clears the flag and the deadline). Off the main thread it
    installs nothing and the restore is a no-op but for the reset."""
    previous = {}
    for sig in GRACE_SIGNALS:
        try:
            previous[sig] = signal.signal(sig, _on_grace_signal)
        except ValueError:  # not the main thread
            pass

    def restore():
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        reset()

    return restore


def check(phase: str, level=None) -> None:
    """Level-boundary preemption point: raise PreemptionRequested when a
    grace signal has arrived."""
    if not _requested:
        return
    raise PreemptionRequested(
        f"grace signal {_signum} at {phase} boundary"
        + (f" (level {level})" if level is not None else ""))
