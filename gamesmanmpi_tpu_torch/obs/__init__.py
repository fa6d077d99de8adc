"""obs: the observability layer (port of gamesmanmpi_tpu/obs/).

* ``MetricsRegistry`` (registry.py): process-wide counters / gauges /
  bucketed histograms, thread-safe, snapshot-able to a dict and
  renderable as Prometheus (v0.0.4) or OpenMetrics text.
  ``default_registry()`` is the process singleton every component records
  into unless handed an explicit registry.
* ``Span`` / ``trace_span`` (tracing.py): wall-time spans around solver
  phases (forward, dedup, backward, checkpoint, db export) that land in
  the registry (``gamesman_span_seconds``), re-emit the per-level JSONL
  records and stream Chrome trace events through an installed
  ``TraceEventSink`` (``--trace-events out.json``). A span reads the host
  clock only; it adds no device synchronisation.
* ``Heartbeat`` (heartbeat.py): a daemon thread that periodically logs
  level progress, RSS and per-card memory (only once CUDA is up).
* ``StatusServer`` / ``SolveStatusTracker`` (status.py): a read-only
  ``/status`` + ``/metrics`` endpoint served from the solver process
  (``GAMESMAN_STATUS_PORT``), with a level-schedule ETA and, on rank 0 of
  a world, the fleet-merged per-rank view.
* ``FlightRecorder`` (flightrec.py): an always-on bounded ring of recent
  spans/levels/retries/faults/store events dumped as
  ``flightrec_<rank>.json`` on every abnormal exit.
* ``QueryTrace`` / ``qspan`` / ``TraceRing`` (qtrace.py): per-request
  tracing for the serving fleet — W3C ``traceparent`` at ingress,
  queue/probe/decode/store spans, a tail-sampled per-worker ring behind
  ``GET /traces``.
* ``SloEngine`` (slo.py): declared availability + p99-latency objectives
  per route with multi-window burn rates; fast-burn folds into
  ``/healthz`` as ``degraded``.

Stdlib only (the heartbeat asks ``torch.cuda`` only when torch is
already imported and CUDA initialised). docs/OBSERVABILITY.md is the
operator guide; the series, span and phase names are the reference's.
"""

from gamesmanmpi_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
    render_prometheus,
)
from gamesmanmpi_tpu_torch.obs.tracing import (
    Span,
    TraceEventSink,
    get_trace_sink,
    set_trace_sink,
    trace_span,
)
from gamesmanmpi_tpu_torch.obs.heartbeat import Heartbeat
from gamesmanmpi_tpu_torch.obs.flightrec import (
    FlightRecorder,
    default_recorder,
)
from gamesmanmpi_tpu_torch.obs.qtrace import (
    QueryTrace,
    TraceRing,
    activate,
    active_traces,
    format_traceparent,
    mint_trace_ids,
    parse_traceparent,
    qspan,
    trace_enabled,
)
from gamesmanmpi_tpu_torch.obs.slo import SloEngine
from gamesmanmpi_tpu_torch.obs.status import (
    SolveStatusTracker,
    StatusServer,
    maybe_status_server,
)

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "render_prometheus",
    "Span",
    "TraceEventSink",
    "get_trace_sink",
    "set_trace_sink",
    "trace_span",
    "Heartbeat",
    "FlightRecorder",
    "default_recorder",
    "SolveStatusTracker",
    "StatusServer",
    "maybe_status_server",
    "QueryTrace",
    "TraceRing",
    "activate",
    "active_traces",
    "format_traceparent",
    "mint_trace_ids",
    "parse_traceparent",
    "qspan",
    "trace_enabled",
    "SloEngine",
]
