"""Flight recorder: a bounded in-memory ring of recent solve events
(port of gamesmanmpi_tpu/obs/flightrec.py).

A multi-hour campaign attempt that dies with exit 124 (watchdog,
collective deadline), a crash, or a SIGKILL leaves log tails and a
checkpoint prefix — but not the *sequence of recent events* that led to
the death: which spans were in flight, which levels had just sealed,
which retries and faults fired, which store I/O was pending. Rerunning
under instrumentation to find out costs hours. The flight recorder is
the always-on answer (the same discipline the Pentago solve,
arXiv:1404.0743, applied with per-phase instrumentation at scale): every
process keeps a cheap ring of its last ``GAMESMAN_FLIGHTREC_EVENTS``
events, and every abnormal exit path dumps it as
``flightrec_<rank>.json``:

* the watchdog's stall abort (resilience/supervisor.py);
* the preemption grace deadline (resilience/preempt.py) and the CLI's
  preempted/oom/coordinated-abort/crash handlers;
* the sharded collective-deadline abort (parallel/sharded.py).

A SIGKILL leaves no in-process exit path at all, so the engines also
checkpoint the ring at every level boundary (``boundary``) when
``GAMESMAN_FLIGHTREC_DIR`` is set (the CLI defaults it to the
checkpoint directory), so even ``kill -9`` leaves a post-mortem naming
the last completed level and the spans that were in flight at the last
boundary.

Cost discipline: events are recorded at span/level/retry/fault/store
rates (host-side, a handful per level), never per position; a record is
one lock acquisition and one deque append. Dumps are tmp+``os.replace``
(atomic — a dump torn by the death it is recording would be worthless).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from gamesmanmpi_tpu_torch.utils.env import env_int, env_opt

#: Default ring capacity (events). Override: GAMESMAN_FLIGHTREC_EVENTS.
DEFAULT_EVENTS = 2048


def _clean_fields(fields: dict) -> dict:
    """JSON-safe scalars only (numpy ints arrive via span payloads)."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, bool) or v is None or isinstance(v, str):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = v
        else:
            try:
                out[k] = int(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


class FlightRecorder:
    """One process's ring of recent events + in-flight span table.

    Thread-safe: the solve thread, span exits, retry/fault hooks, and
    the store's background workers all record concurrently; dumps run
    on whatever thread is dying (watchdog, deadline timer, main).
    NEVER call from a signal handler — ``record`` takes the ring lock
    (the GM205 rule); the dump paths all run on ordinary threads.
    """

    def __init__(self, capacity: Optional[int] = None, *, clock=time.time):
        if capacity is None:
            capacity = env_int("GAMESMAN_FLIGHTREC_EVENTS", DEFAULT_EVENTS)
        self.capacity = max(int(capacity), 16)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity
        )  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        #: sid -> (name, t0, fields) of spans begun but not ended.
        self._inflight: dict = {}  # guarded-by: _lock
        #: phase -> deepest/last level completed (the headline a
        #: post-mortem reader wants first).
        self._last_completed: dict = {}  # guarded-by: _lock

    # ------------------------------------------------------------ recording

    def record(self, kind: str, /, **fields) -> None:
        # Positional-only `kind` + rename-on-collision: span payloads
        # legitimately carry their own "kind" field (checkpoint spans'
        # kind=frontier|level) which must not clobber the event kind.
        ev = {"t": round(self._clock(), 6), "kind": str(kind)}
        for k, v in _clean_fields(fields).items():
            if k in ("t", "kind"):
                k = f"field_{k}"
            ev[k] = v
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    def span_begin(self, sid: int, name: str, fields: dict) -> None:
        # COPY the fields: the span owner keeps mutating its dict via
        # .set()/end(**fields) with no lock shared with the recorder —
        # snapshotting a live dict mid-mutation can raise, and a dump
        # runs on dying-path threads that must reach their os._exit.
        with self._lock:
            self._inflight[sid] = (str(name), self._clock(), dict(fields))

    def span_end(self, sid: int, name: str, secs: float,
                 fields: dict) -> None:
        with self._lock:
            self._inflight.pop(sid, None)
        payload = {
            k: v for k, v in _clean_fields(fields).items()
            if k not in ("span", "secs")
        }
        self.record("span", span=str(name), secs=round(float(secs), 6),
                    **payload)

    def level_complete(self, phase: str, level) -> None:
        """A level boundary passed: remember it (the dump's headline)
        and ring-record it."""
        with self._lock:
            self._last_completed = {
                **self._last_completed, phase: int(level),
            }
        self.record("level", phase=phase, level=int(level))

    # -------------------------------------------------------------- reading

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            events = list(self._events)
            inflight = [
                {
                    "span": name,
                    "age_secs": round(now - t0, 6),
                    **_clean_fields(dict(fields)),
                }
                for name, t0, fields in self._inflight.values()
            ]
            return {
                "capacity": self.capacity,
                "dropped": self._dropped,
                "last_completed": dict(self._last_completed),
                "inflight_spans": inflight,
                "events": events,
            }

    def dump(self, reason: str, directory=None,
             rank=None) -> Optional[str]:
        """Write ``flightrec_<rank>.json`` (atomic) into ``directory``
        (default: ``GAMESMAN_FLIGHTREC_DIR``). With neither an explicit
        directory nor the env var the dump is a no-op: a crashing
        ad-hoc solve with no checkpoint dir must not litter the cwd
        (the CLI defaults the env var to the checkpoint directory, the
        campaign to its log dir). Returns the path, or None — a
        post-mortem writer must never add its own crash to the one it
        is recording."""
        # The WHOLE dump is never-raise, snapshot included: the callers
        # are forced-exit paths (watchdog, collective deadline, grace
        # deadline) where an escaped exception would cancel the
        # os._exit they guarantee and leave a wedged rank behind.
        try:
            if directory is None:
                directory = env_opt("GAMESMAN_FLIGHTREC_DIR")
                if not directory:
                    return None
            if rank is None:
                rank = env_opt("GAMESMAN_PROCESS_ID") or "0"
            body = {
                "reason": str(reason),
                "wall_time": time.time(),
                "pid": os.getpid(),
                "rank": str(rank),
                **self.snapshot(),
            }
            path = os.path.join(str(directory), f"flightrec_{rank}.json")
            # Thread-unique tmp: a boundary dump on the solve thread and
            # a deadline/watchdog dump on a timer thread may run
            # concurrently — sharing one tmp name would tear the very
            # post-mortem the atomic replace exists to protect.
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        except Exception:  # noqa: BLE001 - post-mortem writer only
            return None
        try:
            os.makedirs(str(directory), exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(body, fh, default=str)
            os.replace(tmp, path)
            return path
        except (OSError, TypeError, ValueError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[FlightRecorder] = None


def default_recorder() -> FlightRecorder:
    """The process-wide recorder every hook records into (capacity read
    from the env at first use; tests construct their own instances)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = FlightRecorder()
        return _DEFAULT


def record(kind: str, **fields) -> None:
    default_recorder().record(kind, **fields)


def dump(reason: str, directory=None, rank=None) -> Optional[str]:
    return default_recorder().dump(reason, directory=directory, rank=rank)


def boundary(phase: str, level) -> None:
    """Level-boundary hook the engines call where ``progress`` is
    replaced: notes the completed level, and — when
    ``GAMESMAN_FLIGHTREC_DIR`` is set (the campaign sets it per
    attempt) — checkpoints the ring to disk so even a SIGKILL leaves a
    post-mortem from the last boundary."""
    rec = default_recorder()
    rec.level_complete(phase, level)
    if env_opt("GAMESMAN_FLIGHTREC_DIR"):
        rec.dump("boundary")
