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

**A solve's span tree** (``SpanTree``). A solve reads ``tracing_on()``
once at entry: on while a ``torch.profiler`` records in the process (any
activities, a CUDA-only profiler included) or a sink is installed.
Only then does it build a tree: spans joined to it (``tree=``) carry the
solve's id and their parent (the innermost open span of the tree). Under
the program's own profiler (``profiler_ranges``, which
``utils/profiling.maybe_profile`` enters: CPU activity recorded) each
also opens a profiler range (the RecordFunction under
``torch.profiler.record_function``), so the spans appear in the
profiler's export beside the kernels and copies. Under any other
profiler they open none: torch does not say which activities a session
records, and one without CPU activity (the benchmark's device trace)
would drop every range after paying for it. A *detail* span
(``detail=True``) writes nothing when it ends: the tree keeps it, and
``SpanTree.finish()`` folds the solve's spans into ``{span: {"n", "s"}}``
(the solve's ``stats["trace"]``), observes each detail span's total once
into ``gamesman_span_seconds`` and hands the detail spans to the sink.
With the switch off no tree, no detail span and no profiler range
exists: the engine's only cost is its branch on ``tree is None``.

The dense solve's spans (solve/dense.py), each with its parent:
``dense_solve`` (the root, ``solve()`` entry to return) over
``dense_enter`` (up to the first level), per level ``backward`` and
``dense_record`` (the level's fan-out, record, status and boundary, up
to the next level), and ``dense_exit`` (the root read, reach and miss
counts, stats) over ``dense_drain`` (the root read alone: the host's
wait for every kernel on the kernels' stream and every copy on the copy
stream that the solve queued); ``backward`` over
``dense_pack`` (the level's constants built and sent up),
``dense_launch`` (the rest of the enqueue), ``dense_download`` (the
level's cells to the host: on the card a pinned block from torch's
caching host allocator and the copy's enqueue on the solver's copy
stream behind an event on the kernels' stream, with no wait unless a
seal follows; the blocking ``.cpu()`` on the CPU or where no block can
be pinned) and ``checkpoint``. Beside them the solve counts
``host_syncs``, its blocking reads of device values (a level's download
only where the host waits for it), ``pinned_downloads``, the levels
whose copy ran on the copy stream without a wait, and
``pinned_alloc_bytes``, the bytes the host allocator newly pinned during
the solve (0 once its cache holds a solve's blocks).

**The clock.** A span times itself on ``time.perf_counter``
(CLOCK_MONOTONIC; injectable with ``clock=`` so timing is testable
against a fake clock without sleeping). The sink stamps its events on
the profiler's clock: torch.profiler's Chrome export (Kineto) writes
``ts`` in microseconds since ``baseTimeNanoseconds``, on CLOCK_REALTIME
(PyTorch 2.11.0+cu128 on an H100, and 2.13 on the CPU, alike; CUDA
activity is carried onto the same clock). The sink maps a span-clock
reading onto CLOCK_REALTIME by the offset between the two clocks, read
when the sink is made, and writes ``ts`` since its own
``baseTimeNanoseconds``: its creation time to the whole second, or a
profiler trace's base once ``adopt_profiler_base`` read it from that
trace's export (the CLI does so under ``--profile-dir``), so the two
files overlay. A span's clock reading and its range's stamp are two
readings a few microseconds apart, and further where the host stalls
between them (single offsets of 0.1-0.3 ms on the card). A span adds no device synchronisation,
so the engines end their spans where they already wait for the device
(a classic level's host copy, a dedup count) or, in the dense solve,
where the host has enqueued its work: there a span times the host.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
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


# Whether a solve's spans open profiler ranges: set while the program's
# own profiler records (profiler_ranges), never read per span.
_RANGES = False


@contextlib.contextmanager
def profiler_ranges():
    """Mark the block as recorded by a profiler with CPU activity: span
    trees made inside it open a profiler range per span."""
    global _RANGES
    prev, _RANGES = _RANGES, True
    try:
        yield
    finally:
        _RANGES = prev


def tracing_on() -> bool:
    """The switch a solve reads once at entry: a sink installed or a
    torch.profiler recording, whatever its activities (none can record
    while torch is not imported)."""
    if _SINK is not None:
        return True
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _realtime_offset_ns() -> int:
    """CLOCK_REALTIME minus time.perf_counter, in nanoseconds."""
    return time.time_ns() - time.perf_counter_ns()


def adopt_profiler_base(trace_path) -> None:
    """Give the installed sink the ``baseTimeNanoseconds`` of an exported
    torch.profiler trace (0 where the export has none: its ``ts`` are
    then since the epoch), so the sink's ``ts`` and the trace's share
    their origin. No sink: nothing to do."""
    sink = _SINK
    if sink is None:
        return
    with open(trace_path) as fh:
        sink.base_ns = int(json.load(fh).get("baseTimeNanoseconds", 0))


class TraceEventSink:
    """Collects Chrome trace-event JSON "complete" events, thread-safe.

    The output loads in chrome://tracing, Perfetto, and speedscope:
    ``{"traceEvents": [{"ph": "X", "name", "ts", "dur", "pid", "tid",
    "args"}, ...], "baseTimeNanoseconds": ...}`` with ts/dur in
    microseconds, ts since the base on CLOCK_REALTIME (the module
    docstring). ``offset_ns`` maps the span clock (time.perf_counter)
    onto CLOCK_REALTIME, measured when the sink is made; ``base_ns`` is
    the origin of ``ts``: then, to the whole second.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[tuple[int, dict]] = []
        self._pid = os.getpid()
        self.offset_ns = _realtime_offset_ns()
        self.base_ns = time.time_ns() // 10**9 * 10**9

    def add_complete(self, name: str, t0: float, dur: float, tid: int,
                     args: Optional[dict] = None) -> None:
        """t0/dur in SECONDS on the span clock; stored as microseconds."""
        ev = {
            "ph": "X",
            "name": str(name),
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
        wall_ns = round(t0 * 1e9) + self.offset_ns
        with self._lock:
            self._events.append((wall_ns, ev))

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def span_names(self) -> set:
        with self._lock:
            return {e["name"] for _, e in self._events}

    def to_dict(self) -> dict:
        with self._lock:
            events = [dict(e, ts=round((wall_ns - self.base_ns) / 1e3, 3))
                      for wall_ns, e in self._events]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": self.base_ns,
        }

    def dump(self, path) -> None:
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh)
        os.replace(tmp, path)


#: Solve ids of the process's span trees, from 1.
_SOLVE_IDS = itertools.count(1)


class SpanTree:
    """One solve's spans, built only with the switch on (``tracing_on``):
    every span joined to the tree (``Span(..., tree=self)``) takes the
    innermost open one as its parent (the first is the root), and
    ``finish()`` fans the ended detail spans out once. Made inside
    ``profiler_ranges``, every span of the tree opens a profiler
    range."""

    def __init__(self):
        self.solve = next(_SOLVE_IDS)
        if _RANGES:
            # record_function's own enter/exit, without its Python
            # wrapper (a quarter of the cost per range).
            from torch._C._autograd import (
                _record_function_with_args_enter as enter,
                _record_function_with_args_exit as leave,
            )

            self._ranges = (enter, leave)
        else:
            self._ranges = None
        self._open: list = []
        self._ended: list = []

    def _enter(self, span: "Span"):
        """-> (parent name or None, the profiler range or None)."""
        parent = self._open[-1].name if self._open else None
        self._open.append(span)
        rf = None
        if self._ranges is not None:
            rf = self._ranges[0](span.name)
        return parent, rf

    def _leave(self, span: "Span") -> None:
        if span._rf is not None:
            self._ranges[1](span._rf)
        self._open.remove(span)
        self._ended.append(span)

    def finish(self) -> dict:
        """Observe each detail span's total into the registry and hand
        the detail spans to the sink -> ``{span: {"n": spans, "s":
        seconds}}`` over the tree's ended spans."""
        out: dict = {}
        for sp in self._ended:
            e = out.setdefault(sp.name, {"n": 0, "s": 0.0})
            e["n"] += 1
            e["s"] += sp._secs
        reg = default_registry()
        for name in {sp.name for sp in self._ended if sp._detail}:
            reg.histogram(SPAN_SECONDS, "wall seconds per traced phase",
                          span=name).observe(out[name]["s"])
        sink = _SINK
        if sink is not None:
            tid = threading.get_ident()
            for sp in self._ended:
                if sp._detail:
                    sink.add_complete(sp.name, sp._t0, sp._secs, tid,
                                      sp._trace_args())
        return out


class Span:
    """One timed phase. Construction starts the clock; ``end()`` stops it
    and fans out (idempotent — a with-block exit after an explicit end is
    a no-op). ``set()`` attaches payload fields; they ride into the JSONL
    record, the trace event's args, and (integers only) the payload
    counters.

    ``tree``: the solve's SpanTree to join (its parent and solve id ride
    into the trace event's args, a profiler range spans it while the
    tree profiles). ``detail``: a span of the tree that the tree fans
    out at its finish instead (no registry, flight recorder, JSONL or
    sink of its own)."""

    __slots__ = ("name", "fields", "_clock", "_registry", "_logger",
                 "_t0", "_secs", "_log", "_tree", "_detail", "_parent",
                 "_rf", "_ended")

    def __init__(self, name: str, *, logger=None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None, log: bool = True,
                 tree: Optional[SpanTree] = None, detail: bool = False,
                 **fields):
        self.name = name
        self.fields = dict(fields)
        self._clock = clock or time.perf_counter
        self._registry = registry
        self._logger = logger
        self._log = log
        self._secs: Optional[float] = None
        self._ended = False
        self._tree = tree
        self._detail = detail
        self._parent = self._rf = None
        # A span's profiler range opens after its clock is read and closes
        # before it is read again: the range lies inside the span, and the
        # span times the range's own cost.
        self._t0 = self._clock()
        if tree is not None:
            self._parent, self._rf = tree._enter(self)
        if detail:
            return
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

    def _trace_args(self) -> dict:
        if self._tree is None:
            return self.fields
        return {**self.fields, "solve": self._tree.solve,
                "parent": self._parent}

    def stop(self) -> float:
        """Stop the clock (and leave the tree) without fanning out: end()
        does that. A span of a tree stops before its next sibling opens,
        so its own fan-out is timed inside the sibling."""
        if self._secs is None:
            if self._tree is not None:
                self._tree._leave(self)
            self._secs = self._clock() - self._t0
        return self._secs

    def end(self, log: Optional[bool] = None, **fields) -> float:
        if self._ended:  # idempotent
            return self._secs
        self._ended = True
        self.stop()
        if fields:
            self.fields.update(fields)
        if not self._detail:
            self._fan_out(log)
        return self._secs

    def _fan_out(self, log: Optional[bool]) -> None:
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
                threading.get_ident(), self._trace_args(),
            )
        if self._logger is not None and self._log:
            self._logger.log(
                {"phase": self.name, **self.fields,
                 "secs": self._secs}
            )


@contextlib.contextmanager
def trace_span(name: str, *, logger=None,
               registry: Optional[MetricsRegistry] = None,
               clock=None, log: bool = True,
               tree: Optional[SpanTree] = None, **fields):
    """Context-manager form: ``with trace_span("dedup", level=k):``.

    Yields the Span (call ``.set()`` to attach fields discovered inside
    the block); ends it on exit, exceptions included — a span around an
    aborted phase still records the time it consumed."""
    span = Span(name, logger=logger, registry=registry, clock=clock,
                log=log, tree=tree, **fields)
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
