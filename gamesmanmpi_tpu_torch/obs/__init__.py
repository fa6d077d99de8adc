"""obs: the observability the serving layer needs (port of the
gamesmanmpi_tpu/obs/ modules ``registry``, ``qtrace`` and ``slo``).

* ``MetricsRegistry`` (registry.py): process-wide counters / gauges /
  bucketed histograms, thread-safe, snapshot-able to a dict and
  renderable as Prometheus (v0.0.4) or OpenMetrics text.
  ``default_registry()`` is the process singleton every component records
  into unless handed an explicit registry.
* ``QueryTrace`` / ``qspan`` / ``TraceRing`` (qtrace.py): per-request
  tracing for the serving fleet — W3C ``traceparent`` at ingress,
  queue/probe/decode/store spans, a tail-sampled per-worker ring behind
  ``GET /traces``.
* ``SloEngine`` (slo.py): declared availability + p99-latency objectives
  per route with multi-window burn rates; fast-burn folds into
  ``/healthz`` as ``degraded``.

Stdlib only. docs/OBSERVABILITY.md is the operator guide; the series
names are the reference's.
"""

from gamesmanmpi_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
    render_prometheus,
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

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "render_prometheus",
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
