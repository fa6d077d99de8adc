"""Deterministic fault injection (port of
gamesmanmpi_tpu/resilience/faults.py).

Named fault points sit on the solve's host-side level paths (engine level
steps, checkpoint seals and loads) and are armed
from one environment variable, so every failure the checkpoint claims to
survive can be injected on demand: in-process by tests, or into a
subprocess for kill + resume + identical-tables chaos.

Grammar (``GAMESMAN_FAULTS``, comma-separated directives)::

    point:kind[:when]

* ``point`` — a name of the reference's :data:`KNOWN_POINTS`. Only the
  points the port fires (:data:`PORTED_POINTS`) can be armed; arming one
  the port does not have yet, or an unknown name, is a ``ValueError``, so
  a chaos run never passes silently because its fault never fired.
* ``kind`` — ``transient`` (raise :class:`TransientFault`), ``fatal``
  (raise :class:`FatalFault`), ``delay=SECS`` (sleep), ``kill[=CODE]``
  (``os._exit``, default 77), ``torn`` (truncate the file the call site
  just wrote to half its bytes, then ``os._exit(86)``), ``enospc`` (raise
  ``OSError(ENOSPC)``) or ``oom`` (raise ``MemoryError``).
* ``when`` — the Nth visit (default 1), ``always``, or ``pPROB@SEED`` (a
  seeded Bernoulli draw per visit: random chaos that replays exactly).

The table is read from the environment at the first visit of any point
(or set by :func:`configure`); a disarmed process pays one falsy check
per visit. The reference's registry counter and flight-recorder event
belong to the observability layer, not ported yet.
"""

from __future__ import annotations

import errno
import os
import random
import sys
import time

from gamesmanmpi_tpu_torch.utils.env import env_opt


class FaultError(RuntimeError):
    """Base of injected faults (never raised itself)."""


class TransientFault(FaultError):
    """Injected error a retry would absorb."""


class FatalFault(FaultError):
    """Injected error that must fail fast."""


#: Exit codes of the process-killing kinds, distinct from real crash
#: codes so a chaos harness can tell the injected death happened.
KILL_EXIT_CODE = 77
TORN_EXIT_CODE = 86

#: The points the port fires, each where the reference fires it.
PORTED_POINTS = {
    "engine.forward": "single-device forward: top of each level step",
    "engine.dedup": "single-device forward: before the level's dedup sync",
    "engine.backward": "single-device backward: before each resolved "
                       "(not checkpoint-loaded) level",
    "ckpt.save_frontier": "checkpoint: after a frontier level is sealed",
    "ckpt.save_level": "checkpoint: after a solved level is sealed",
    "ckpt.load_level": "checkpoint: at the top of a resume level load",
}

#: Every point of the reference (gamesmanmpi_tpu/resilience/faults.py
#: KNOWN_POINTS): the ported ones, and those whose subsystem the port
#: does not have yet.
KNOWN_POINTS = dict(PORTED_POINTS, **{p: "not yet ported" for p in (
    "sharded.forward", "sharded.backward", "sharded.collective",
    "coord.barrier", "coord.handshake", "db.probe", "serve.flush",
    "serve.block_decode", "serve.worker_spawn", "serve.heartbeat",
    "serve.reload", "registry.fetch", "registry.publish",
    "registry.install", "jobs.claim", "store.writebehind",
)})

KINDS = ("transient", "fatal", "delay", "kill", "torn", "enospc", "oom")


class _Directive:
    """One armed ``point:kind:when`` with its per-run schedule state."""

    __slots__ = ("point", "kind", "arg", "when", "visits", "rng")

    def __init__(self, point: str, kind: str, arg, when):
        self.point = point
        self.kind = kind
        self.arg = arg
        self.when = when  # int | "always" | ("p", prob, seed)
        self.visits = 0
        self.rng = (random.Random(when[2]) if isinstance(when, tuple)
                    else None)

    def due(self) -> bool:
        if self.when == "always":
            return True
        if isinstance(self.when, int):
            return self.visits == self.when
        return self.rng.random() < self.when[1]


#: point -> [directives]; empty when disarmed (the fast-path check).
_ARMED: dict = {}
#: Whether the table has been set (from the environment or configure()).
_LOADED = False


def _parse_when(tok: str):
    if tok == "always":
        return "always"
    if tok.startswith("p"):
        prob, _, seed = tok[1:].lstrip("=").partition("@")
        return ("p", float(prob), int(seed or 0))
    n = int(tok)
    if n < 1:
        raise ValueError(f"fault visit index must be >= 1, got {n}")
    return n


def _parse_directive(text: str) -> _Directive:
    parts = text.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"bad fault directive {text!r}: expected point:kind[:when]")
    point = parts[0].strip()
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: "
                         + ", ".join(sorted(KNOWN_POINTS)))
    if point not in PORTED_POINTS:
        raise ValueError(
            f"fault point {point!r} is not yet ported to the torch port "
            "(its subsystem is not); armable: "
            + ", ".join(sorted(PORTED_POINTS)))
    kind, _, argtxt = parts[1].strip().partition("=")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {text!r}")
    arg = float(argtxt) if argtxt else None
    when = _parse_when(parts[2].strip()) if len(parts) == 3 else 1
    return _Directive(point, kind, arg, when)


def configure(spec: str | None) -> dict:
    """(Re)arm from a ``GAMESMAN_FAULTS`` spec string, replacing the whole
    table (schedules restart from visit 0). Raises ValueError on a bad
    spec, leaving the table as it was."""
    global _LOADED
    table: dict = {}
    for text in (spec or "").split(","):
        text = text.strip()
        if text:
            d = _parse_directive(text)
            table.setdefault(d.point, []).append(d)
    _ARMED.clear()
    _ARMED.update(table)
    _LOADED = True
    return dict(_ARMED)


def configure_from_env() -> dict:
    """Arm from GAMESMAN_FAULTS (the CLI calls this before a solve)."""
    return configure(env_opt("GAMESMAN_FAULTS"))


def clear() -> None:
    """Disarm every fault point."""
    global _LOADED
    _ARMED.clear()
    _LOADED = True


def _inject(d: _Directive, point: str, path, ctx: dict) -> None:
    where = f"{point} (visit {d.visits}{', ' + repr(ctx) if ctx else ''})"
    sys.stderr.write(f"[faults] injecting {d.kind} at {where}\n")
    sys.stderr.flush()
    if d.kind == "transient":
        raise TransientFault(f"injected transient fault at {where}")
    if d.kind == "fatal":
        raise FatalFault(f"injected fatal fault at {where}")
    if d.kind == "delay":
        time.sleep(d.arg if d.arg is not None else 0.05)
        return
    if d.kind == "enospc":
        raise OSError(errno.ENOSPC,
                      f"No space left on device (injected at {where})",
                      str(path) if path is not None else None)
    if d.kind == "oom":
        raise MemoryError(
            f"injected oom (RESOURCE_EXHAUSTED: out of memory) at {where}")
    if d.kind == "torn":
        if path is not None and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(max(1, size // 2))
            sys.stderr.write(f"[faults] tore {path} ({size} -> {size // 2})\n")
            sys.stderr.flush()
        os._exit(TORN_EXIT_CODE)
    if d.kind == "kill":
        os._exit(int(d.arg) if d.arg is not None else KILL_EXIT_CODE)


def fire(point: str, path=None, **ctx) -> None:
    """Visit a fault point; inject whatever is armed for it. ``path``
    names the file a checkpoint call site just wrote (the ``torn`` kind's
    target); ``ctx`` is echoed into the injection banner."""
    if not _LOADED:
        configure_from_env()
    if not _ARMED:
        return
    for d in _ARMED.get(point, ()):
        d.visits += 1
        if d.due():
            _inject(d, point, path, ctx)
