"""Span / trace_span: phase-level wall-time tracing (port of
gamesmanmpi_tpu/obs/tracing.py).

A ``Span`` measures one named phase (a solver level's forward expand, a
backward resolve, a checkpoint write, a serving batch). Ending a span
fans out to up to three sinks:

* the metrics registry — ``gamesman_span_seconds{span=...}`` histogram
  plus ``gamesman_span_payload_total{span=...,key=...}`` counters for
  every integer payload field (frontier/children/batch sizes), so phase
  time AND phase volume are queryable from ``/metrics``;
* the per-level JSONL stream — the span re-emits exactly the record the
  engine's hand-rolled ``logger.log`` calls used to write
  (``{"phase": name, **fields, "secs": dur}``), so bench.py and every
  existing JSONL consumer parse unchanged;
* the installed ``TraceEventSink`` — one Chrome trace-event "complete"
  event (``ph: "X"``) per span, nested spans stacking naturally per
  thread in chrome://tracing / Perfetto. ``--trace-events out.json``
  installs a sink for the CLI.

The clock is injectable (``clock=``) so span timing is testable against
a fake clock without sleeping. A span reads the host clock only: it adds
no device synchronisation, so the engines end their spans where they
already wait for the device (a level's host copy, a dedup count).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

from gamesmanmpi_tpu_torch.obs import flightrec
from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry, default_registry

#: Registry families spans record into.
SPAN_SECONDS = "gamesman_span_seconds"
SPAN_PAYLOAD = "gamesman_span_payload_total"

# Process-wide trace sink (None = tracing off). One writer installs it
# (the CLI, a test); every Span checks it at end() time, so spans cost
# one None check when tracing is off.
_SINK_LOCK = threading.Lock()
_SINK: Optional["TraceEventSink"] = None


def set_trace_sink(sink: Optional["TraceEventSink"]) -> Optional["TraceEventSink"]:
    """Install (or clear, with None) the process trace sink; returns the
    previous one so scopes can restore it."""
    global _SINK
    with _SINK_LOCK:
        prev = _SINK
        _SINK = sink
    return prev


def get_trace_sink() -> Optional["TraceEventSink"]:
    return _SINK


class TraceEventSink:
    """Collects Chrome trace-event JSON "complete" events, thread-safe.

    The output loads in chrome://tracing, Perfetto, and speedscope:
    ``{"traceEvents": [{"ph": "X", "name", "ts", "dur", "pid", "tid",
    "args"}, ...]}`` with ts/dur in microseconds.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._pid = os.getpid()

    def add_complete(self, name: str, t0: float, dur: float, tid: int,
                     args: Optional[dict] = None) -> None:
        """t0/dur in SECONDS on the span clock; stored as microseconds."""
        ev = {
            "ph": "X",
            "name": str(name),
            "ts": round(t0 * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": self._pid,
            "tid": int(tid),
        }
        if args:
            # Trace args must be JSON-serializable; stringify anything
            # exotic (numpy scalars already went through int()/float()).
            ev["args"] = {
                k: (v if isinstance(v, (int, float, bool, str, type(None)))
                    else str(v))
                for k, v in args.items()
            }
        with self._lock:
            self._events.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def span_names(self) -> set:
        with self._lock:
            return {e["name"] for e in self._events}

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
            }

    def dump(self, path) -> None:
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh)
        os.replace(tmp, path)


class Span:
    """One timed phase. Construction starts the clock; ``end()`` stops it
    and fans out (idempotent — a with-block exit after an explicit end is
    a no-op). ``set()`` attaches payload fields; they ride into the JSONL
    record, the trace event's args, and (integers only) the payload
    counters."""

    __slots__ = ("name", "fields", "_clock", "_registry", "_logger",
                 "_t0", "_secs", "_log")

    def __init__(self, name: str, *, logger=None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None, log: bool = True, **fields):
        self.name = name
        self.fields = dict(fields)
        self._clock = clock or time.perf_counter
        self._registry = registry
        self._logger = logger
        self._log = log
        self._secs: Optional[float] = None
        self._t0 = self._clock()
        # Flight recorder (obs/flightrec.py): every span registers as
        # in-flight at construction so a post-mortem dump can name what
        # was running when the process died; end() converts it to a
        # ring event. One lock + dict op per span — span rate is
        # per-level/per-batch, never per-position. Guarded: the
        # recorder is an auxiliary surface and must never be able to
        # kill the solve it is recording.
        try:
            flightrec.default_recorder().span_begin(
                id(self), name, self.fields
            )
        except Exception:  # noqa: BLE001 - diagnostics only
            pass

    def set(self, **fields) -> "Span":
        self.fields.update(fields)
        return self

    @property
    def secs(self) -> Optional[float]:
        """Elapsed seconds; None until ended."""
        return self._secs

    def end(self, log: Optional[bool] = None, **fields) -> float:
        if self._secs is not None:  # idempotent
            return self._secs
        self._secs = self._clock() - self._t0
        if fields:
            self.fields.update(fields)
        if log is not None:
            self._log = log
        reg = self._registry or default_registry()
        reg.histogram(
            SPAN_SECONDS, "wall seconds per traced phase", span=self.name
        ).observe(self._secs)
        for k, v in self.fields.items():
            # Payload volume: integer fields are sizes/counts by
            # convention (bools are flags, not sizes; `level` is a
            # coordinate — summing it would be meaningless).
            if k != "level" and isinstance(v, int) and not isinstance(v, bool):
                reg.counter(
                    SPAN_PAYLOAD,
                    "summed integer payload fields of traced phases",
                    span=self.name, key=k,
                ).inc(v)
        try:
            flightrec.default_recorder().span_end(
                id(self), self.name, self._secs, self.fields
            )
        except Exception:  # noqa: BLE001 - diagnostics only
            pass
        sink = _SINK
        if sink is not None:
            sink.add_complete(
                self.name, self._t0, self._secs,
                threading.get_ident(), self.fields,
            )
        if self._logger is not None and self._log:
            self._logger.log(
                {"phase": self.name, **self.fields,
                 "secs": self._secs}
            )
        return self._secs


@contextlib.contextmanager
def trace_span(name: str, *, logger=None,
               registry: Optional[MetricsRegistry] = None,
               clock=None, log: bool = True, **fields):
    """Context-manager form: ``with trace_span("dedup", level=k):``.

    Yields the Span (call ``.set()`` to attach fields discovered inside
    the block); ends it on exit, exceptions included — a span around an
    aborted phase still records the time it consumed."""
    span = Span(name, logger=logger, registry=registry, clock=clock,
                log=log, **fields)
    try:
        yield span
    finally:
        span.end()


@contextlib.contextmanager
def trace_events_scope(path):
    """Install a fresh TraceEventSink for the duration of the block and
    dump it to ``path`` on exit (the ``--trace-events`` implementation;
    restores any previously installed sink)."""
    if not path:
        yield None
        return
    sink = TraceEventSink()
    prev = set_trace_sink(sink)
    try:
        yield sink
    finally:
        set_trace_sink(prev)
        sink.dump(path)
