"""Query-path distributed tracing: traceparent, spans, tail sampling
(port of gamesmanmpi_tpu/obs/qtrace.py).

The solve side traces *phases* (obs/tracing.py: one Span per level or
batch). The serving side needs the other axis: one trace per *request*,
attributing a single slow or shed query to the stage that ate its
latency — batcher queue wait, the canonicalize/searchsorted probe, a v2
block decode, a cold store read. This module is that read-side twin:

* ``parse_traceparent`` / ``format_traceparent`` / ``mint_trace_ids`` —
  the W3C ``traceparent`` wire form (``00-<32hex>-<16hex>-<2hex>``), so
  a client (``tools/load_gen.py``) can mint a trace id, send it with the
  query, and later join its own p99 outlier record to the server-side
  trace by id.
* ``QueryTrace`` — one request's trace: ids, route, wall start, and an
  append-only list of span dicts (name, start offset, duration, fields).
* ``activate``/``qspan`` — thread-local activation. The batcher
  coalesces many requests into one reader probe, so activation takes a
  *list* of traces and every span recorded inside the window appends to
  all of them (one decode, N attributions — exactly what coalescing
  means for latency accounting). When no trace is active — every solve
  code path — ``qspan`` yields immediately without reading a clock, so
  the hooks woven into db/reader.py and store/blockstore.py cost one
  tuple check.
* ``TraceRing`` — bounded per-worker ring with TAIL-based sampling:
  the keep decision runs at trace end, when the outcome is known. Every
  error/shed/tripped trace is kept, anything slower than
  ``GAMESMAN_TRACE_SLOW_MS`` is kept, and 1-in-``GAMESMAN_TRACE_HEAD_N``
  is kept regardless (the healthy-baseline sample). Kept traces also
  enter a small outbox the fleet worker drains into its heartbeat
  beats, which is how the supervisor aggregates fleet-wide traces
  without being able to HTTP-address an individual worker (all workers
  share one accept queue).

``GAMESMAN_TRACE=0`` turns the whole machinery into no-ops (the bench
A/B arm measures exactly this delta).

Span *names* recorded through ``qspan`` are part of the span-name
registry contract (GM405): literal first arguments, documented in
docs/OBSERVABILITY.md's "Span name registry" table.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry, default_registry
from gamesmanmpi_tpu_torch.utils.env import env_bool, env_float, env_int

#: Registry families the trace ring records into.
TRACE_KEPT = "gamesman_trace_kept_total"
TRACE_DROPPED = "gamesman_trace_dropped_total"

#: Trace outcomes that are always kept (tail sampling's whole point).
ALWAYS_KEEP = ("error", "shed", "tripped")

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def trace_enabled() -> bool:
    """Master switch: ``GAMESMAN_TRACE`` (default on)."""
    return env_bool("GAMESMAN_TRACE", True)


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def mint_trace_ids() -> Tuple[str, str]:
    """Fresh (trace_id, span_id) pair for a root that got no context."""
    return _hex_id(16), _hex_id(8)


def format_traceparent(trace_id: str, span_id: str,
                       flags: str = "01") -> str:
    return f"00-{trace_id}-{span_id}-{flags}"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) from a ``traceparent`` header, or None
    when absent/malformed/all-zero (a malformed header must not kill the
    request — the server just mints a fresh root)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


class QueryTrace:
    """One request's trace. Spans are plain dicts so the ring snapshot,
    the heartbeat outbox, and ``GET /traces`` serialize them as-is."""

    __slots__ = ("trace_id", "parent_id", "root_id", "route", "start",
                 "spans", "status", "code", "keep_reason", "worker",
                 "_t0", "_secs", "_lock")

    def __init__(self, *, traceparent: Optional[str] = None,
                 route: str = "", worker=None, clock=None):
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            self.trace_id, self.parent_id = parsed
        else:
            self.trace_id, self.parent_id = _hex_id(16), None
        self.root_id = _hex_id(8)
        self.route = route
        self.worker = worker
        self.start = time.time()
        self._t0 = (clock or time.perf_counter)()
        self._secs: Optional[float] = None
        self.spans: List[dict] = []
        self.status = "ok"
        self.code = 200
        self.keep_reason: Optional[str] = None
        # Spans can land from the batcher worker thread while the
        # handler thread finishes the trace; appends are tiny.
        self._lock = threading.Lock()

    def add_span(self, name: str, start_offset: float, secs: float,
                 **fields) -> dict:
        """Record one span. ``start_offset``/``secs`` in seconds relative
        to the trace root; stored as milliseconds (the operator unit for
        request latency)."""
        span = {
            "name": str(name),
            "start_ms": round(start_offset * 1e3, 3),
            "dur_ms": round(secs * 1e3, 3),
        }
        for k, v in fields.items():
            span[k] = (v if isinstance(v, (int, float, bool, str,
                                           type(None))) else str(v))
        with self._lock:
            self.spans.append(span)
        return span

    def offset(self, clock=None) -> float:
        """Seconds since the trace root started (span start offsets)."""
        return (clock or time.perf_counter)() - self._t0

    def finish(self, *, status: str = "ok", code: int = 200,
               clock=None) -> float:
        """Stop the trace clock (idempotent); returns duration seconds."""
        if self._secs is None:
            self._secs = (clock or time.perf_counter)() - self._t0
        self.status = status
        self.code = int(code)
        return self._secs

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self._secs is None else self._secs * 1e3

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        out = {
            "trace_id": self.trace_id,
            "span_id": self.root_id,
            "parent_id": self.parent_id,
            "route": self.route,
            "start": self.start,
            "status": self.status,
            "code": self.code,
            "dur_ms": (None if self._secs is None
                       else round(self._secs * 1e3, 3)),
            "spans": spans,
        }
        if self.worker is not None:
            out["worker"] = self.worker
        if self.keep_reason is not None:
            out["keep"] = self.keep_reason
        return out


# Thread-local active-trace set. A tuple (not a list): activation swaps
# the whole binding, readers never see a half-updated container.
_TLS = threading.local()


def active_traces() -> Tuple[QueryTrace, ...]:
    return getattr(_TLS, "traces", ())


@contextlib.contextmanager
def activate(traces: Sequence[QueryTrace]):
    """Bind ``traces`` as this thread's active set for the block. The
    batcher activates the whole coalesced batch around ``lookup_best``;
    the HTTP handler activates its single request trace."""
    prev = getattr(_TLS, "traces", ())
    _TLS.traces = tuple(t for t in traces if t is not None)
    try:
        yield
    finally:
        _TLS.traces = prev


@contextlib.contextmanager
def qspan(name: str, **fields):
    """Record one named span onto every active query trace.

    The no-trace fast path (every solve call site) is one attribute
    fetch and a tuple truth-test — no clock read, no allocation. Fields
    set on the yielded dict-like handle after the block starts are
    merged into the recorded span.
    """
    traces = getattr(_TLS, "traces", ())
    if not traces:
        yield None
        return
    t0 = time.perf_counter()
    extra: dict = {}
    try:
        yield extra
    finally:
        secs = time.perf_counter() - t0
        if extra:
            fields = {**fields, **extra}
        for tr in traces:
            tr.add_span(name, t0 - tr._t0, secs, **fields)


class TraceRing:
    """Bounded ring of finished traces with tail-based sampling.

    ``offer()`` is the single decision point: error/shed/tripped always
    kept, slow (>= ``slow_ms``) kept, then 1-in-``head_n`` head
    sampling. Kept traces also enter the outbox (bounded) the fleet
    worker drains into heartbeat beats. All state behind one lock —
    offer rate is per-request, never per-position.
    """

    def __init__(self, *, capacity: Optional[int] = None,
                 slow_ms: Optional[float] = None,
                 head_n: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = max(1, int(
            capacity if capacity is not None
            else env_int("GAMESMAN_TRACE_RING", 512)
        ))
        self.slow_ms = float(
            slow_ms if slow_ms is not None
            else env_float("GAMESMAN_TRACE_SLOW_MS", 100.0)
        )
        self.head_n = max(1, int(
            head_n if head_n is not None
            else env_int("GAMESMAN_TRACE_HEAD_N", 50)
        ))
        self.enabled = (trace_enabled() if enabled is None
                        else bool(enabled))
        self._registry = registry or default_registry()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._outbox: deque = deque(maxlen=64)
        self._seen = 0
        self._kept = 0
        self._dropped = 0

    def decide(self, trace: QueryTrace) -> Optional[str]:
        """The sampling verdict alone (no mutation): keep reason or
        None. Split out so tests can hammer the policy directly."""
        if trace.status in ALWAYS_KEEP:
            return trace.status
        dur = trace.duration_ms
        if dur is not None and dur >= self.slow_ms:
            return "slow"
        return None

    def offer(self, trace: QueryTrace) -> Optional[str]:
        """Finished trace in; keep reason out (None = dropped)."""
        if not self.enabled:
            return None
        reason = self.decide(trace)
        with self._lock:
            self._seen += 1
            if reason is None and (self._seen % self.head_n) == 1 % self.head_n:
                reason = "head"
            if reason is None:
                self._dropped += 1
                self._registry.counter(
                    TRACE_DROPPED,
                    "finished query traces the tail sampler dropped",
                ).inc()
                return None
            trace.keep_reason = reason
            rec = trace.to_dict()
            self._ring.append(rec)
            self._outbox.append(rec)
            self._kept += 1
        self._registry.counter(
            TRACE_KEPT, "query traces kept by the tail sampler",
            reason=reason,
        ).inc()
        return reason

    def drain_outbox(self, n: int = 8) -> List[dict]:
        """Up to ``n`` newly kept traces for the heartbeat beat; what's
        drained never re-ships."""
        out: List[dict] = []
        with self._lock:
            while self._outbox and len(out) < int(n):
                out.append(self._outbox.popleft())
        return out

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The ``GET /traces`` payload: newest-last kept traces plus the
        sampler's own accounting."""
        with self._lock:
            traces = list(self._ring)
            seen, kept, dropped = self._seen, self._kept, self._dropped
        if limit is not None and limit >= 0:
            traces = traces[-int(limit):]
        return {
            "kind": "qtrace_ring",
            "seen": seen,
            "kept": kept,
            "dropped": dropped,
            "capacity": self.capacity,
            "slow_ms": self.slow_ms,
            "head_n": self.head_n,
            "enabled": self.enabled,
            "traces": traces,
        }

    def find(self, trace_id: str) -> Optional[dict]:
        """Newest kept trace with this id (tests and debugging joins)."""
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("trace_id") == trace_id:
                    return rec
        return None
