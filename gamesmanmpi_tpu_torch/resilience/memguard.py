"""Host-memory guard: turn a looming OOM into a clean resumable death
(port of gamesmanmpi_tpu/resilience/memguard.py).

The campaign regime's fourth failure class (after crash, preemption,
and disk exhaustion) is memory exhaustion. Uncaught it is the WORST
death the stack can take: the kernel OOM-killer delivers SIGKILL with
no log line to classify, mid-level, possibly mid-write — a death the
campaign supervisor can only read as an anonymous ``signal``. This
module converts it into the best one: the engines call :func:`check`
at every level boundary (the same program point as the preemption
check — everything before it is sealed or sealable by the solve's
``finally``); when resident-set size crosses
``GAMESMAN_HOST_MEM_LIMIT_MB`` (0 = off, the default) the solve raises
:class:`HostMemoryExceeded` — a ``MemoryError``, so never transient
(``resilience.retry``: an OOM at a fixed shape OOMs again) — whose
message carries ``RESOURCE_EXHAUSTED``, the marker the campaign's
log-tail death classifier maps to ``oom``. The campaign then answers
with geometry escalation — more shards, smaller store cache
(``resilience/campaign.py``) — instead of retrying the same shape into
the same wall.

Under multi-process execution the raise is rank-local by design: the
peers unwind through the collective deadline (exit 124), and the whole
world's next attempt runs at the escalated geometry.
"""

from __future__ import annotations

import time

from gamesmanmpi_tpu_torch.obs.heartbeat import rss_bytes
from gamesmanmpi_tpu_torch.utils.env import env_float


class HostMemoryExceeded(MemoryError):
    """Raised at a level boundary when host RSS crossed the guard
    limit: a clean, classifiable stand-in for the allocator failure or
    kernel OOM-kill that was coming. Deliberately a MemoryError —
    ``resilience.retry.is_transient`` must never retry it."""


def limit_mb() -> float:
    """The guard threshold (``GAMESMAN_HOST_MEM_LIMIT_MB``; 0 = off)."""
    return env_float("GAMESMAN_HOST_MEM_LIMIT_MB", 0.0)


def check(phase: str, level=None, logger=None) -> None:
    """Level-boundary memory guard: raise :class:`HostMemoryExceeded`
    when host RSS exceeds the configured limit. One env read + one
    ``/proc/self/statm`` read per level boundary when armed; a single
    falsy check when off."""
    lim = limit_mb()
    if lim <= 0:
        return
    rss = rss_bytes()
    if rss is None:
        # RSS unmeasurable on this host (masked /proc, exotic platform):
        # an armed guard that cannot read memory must not fail the solve
        # — the kernel OOM-killer path remains, exactly as if unarmed.
        return
    rss_mb = rss / (1 << 20)
    if rss_mb <= lim:
        return
    from gamesmanmpi_tpu_torch.obs import default_registry

    default_registry().counter(
        "gamesman_oom_guard_trips_total",
        "solves stopped at a level boundary by the host-memory guard",
        phase=phase,
    ).inc()
    rec = {"phase": "oom_guard", "in_phase": phase,
           "rss_mb": round(rss_mb, 1), "limit_mb": lim,
           "wall_time": time.time()}
    if level is not None:
        rec["level"] = int(level)
    if logger is not None:
        try:
            logger.log(rec)
        except Exception:  # noqa: BLE001 - the guard must win
            pass
    raise HostMemoryExceeded(
        f"host RSS {rss_mb:.0f} MiB exceeds "
        f"GAMESMAN_HOST_MEM_LIMIT_MB={lim:.0f} at {phase} boundary"
        + (f" (level {level})" if level is not None else "")
        + " — RESOURCE_EXHAUSTED: out of memory; the checkpoint prefix"
        " is sealed and resumable — escalate shards or shrink"
        " GAMESMAN_STORE_CACHE_MB (the campaign's oom policy does both)"
    )
