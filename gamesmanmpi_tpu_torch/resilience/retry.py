"""Transient/fatal classification + bounded exponential-backoff retry
(port of gamesmanmpi_tpu/resilience/retry.py).

The engines' unit of recovery is one level step: forward expand+dedup,
or a backward resolve. Each step's inputs (the frontier, the window
triples, the stored provenance) stay referenced on the host across the
step, so re-dispatching the kernels after a transient runtime error is
idempotent — the same property that makes checkpoint resume exact. The
retry wrapper here is what turns that property into behavior: classify
the error, back off, optionally re-dispatch (``reset``), and re-raise
anything fatal untouched.

What counts as transient: injected :class:`TransientFault`, and runtime
errors whose message carries a known transient marker (the gRPC-ish
status words a remote-relay backend surfaces when the transport
hiccups). ``RESOURCE_EXHAUSTED`` and torch's ``OutOfMemoryError`` ("CUDA
out of memory") are deliberately NOT transient — an OOM
at a fixed shape will OOM again; retrying it would just triple the time
to the real failure. Extend the marker list for a specific deployment
with ``GAMESMAN_RETRY_MARKERS`` (comma-separated substrings).

Knobs: ``GAMESMAN_RETRY_ATTEMPTS`` (total tries per step, default 3;
1 disables retry), ``GAMESMAN_RETRY_BASE_SECS`` (first backoff, default
0.25, doubling per retry).
"""

from __future__ import annotations

import sys
import time

from gamesmanmpi_tpu_torch.obs import default_registry, flightrec
from gamesmanmpi_tpu_torch.resilience.faults import FatalFault, TransientFault
from gamesmanmpi_tpu_torch.utils.env import env_float as _env_float
from gamesmanmpi_tpu_torch.utils.env import env_int as _env_int
from gamesmanmpi_tpu_torch.utils.env import env_str

#: Message substrings (matched case-insensitively) that mark a runtime
#: error as transient. Conservative: transport/scheduling words only,
#: never OOM or compile errors.
TRANSIENT_MARKERS = (
    "injected transient",
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "aborted",
    "cancelled",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "transport closed",
)


def is_transient(exc: BaseException) -> bool:
    """Would retrying the failed step plausibly succeed?"""
    if isinstance(exc, TransientFault):
        return True
    if isinstance(exc, FatalFault):
        return False
    # An allocation that failed at a fixed shape fails again: torch's
    # OutOfMemoryError is a RuntimeError, so it is refused by type before
    # any marker can match its message.
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(exc, torch.OutOfMemoryError):
        return False
    # Device runtime errors subclass RuntimeError; transport-level
    # failures can also surface as bare OSError from the relay socket.
    if not isinstance(exc, (RuntimeError, OSError)):
        return False
    msg = str(exc).lower()
    extra = tuple(
        m.strip().lower()
        for m in env_str("GAMESMAN_RETRY_MARKERS", "").split(",")
        if m.strip()
    )
    return any(m in msg for m in TRANSIENT_MARKERS + extra)


def retry_call(fn, *, point: str, reset=None, level=None, attempts=None,
               base_secs=None, logger=None, on_retry=None, registry=None,
               classify=is_transient, sleep=time.sleep):
    """Call ``fn`` with bounded exponential-backoff retry on transients.

    ``reset`` runs before each re-attempt (re-dispatch kernels from the
    step's held inputs — e.g. drop a stale speculative expand and re-run
    from the frontier). ``on_retry(attempt, exc)`` lets the owner count
    retries into its stats; every retry also lands in
    ``gamesman_retries_total{point=...}`` and, when a logger is given,
    as a ``{"phase": "retry", ...}`` JSONL record (the per-level stream
    tools/obs_report.py folds into its retries column).

    Fatal errors re-raise immediately; exhausted transients re-raise the
    last error — the caller's existing failure path is unchanged.
    """
    attempts = (
        _env_int("GAMESMAN_RETRY_ATTEMPTS", 3) if attempts is None
        else int(attempts)
    )
    attempts = max(1, attempts)
    base = (
        _env_float("GAMESMAN_RETRY_BASE_SECS", 0.25) if base_secs is None
        else float(base_secs)
    )
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified just below
            if attempt >= attempts or not classify(e):
                raise
            reg = registry or default_registry()
            reg.counter(
                "gamesman_retries_total",
                "transient step failures absorbed by retry",
                point=point,
            ).inc()
            if on_retry is not None:
                on_retry(attempt, e)
            # Retries are post-mortem gold: a death minutes after a burst
            # of absorbed transients reads differently from one out of
            # the blue.
            flightrec.record(
                "retry", point=point, attempt=attempt,
                level=level, error=str(e)[:120],
            )
            if logger is not None:
                rec = {
                    "phase": "retry",
                    "point": point,
                    "attempt": attempt,
                    "error": str(e)[:200],
                }
                if level is not None:
                    rec["level"] = int(level)
                logger.log(rec)
            if base > 0:
                sleep(base * (2 ** (attempt - 1)))
            if reset is not None:
                reset()
