"""MetricsRegistry: counters, gauges, bucketed histograms (port of
gamesmanmpi_tpu/obs/registry.py).

One registry is a flat namespace of metric FAMILIES; a family has a
name, a help string, a kind, and one child per distinct label set (the
Prometheus data model, stdlib-only). All mutation goes through a single
registry lock — these are bookkeeping increments on host code paths
(request handling, per-level phase boundaries), never per-position work,
so one lock is simpler than per-child atomics and cheap at the call
rates involved.

Two read forms:

* ``snapshot()`` — plain nested dict, the JSON side (``/metrics.json``,
  ``--metrics-out``).
* ``render_prometheus()`` — text exposition format v0.0.4, the form
  Prometheus/curl consume from ``GET /metrics``. Histograms render the
  spec's cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``;
  ``le`` boundaries are INCLUSIVE (a sample equal to a boundary lands in
  that bucket).

``default_registry()`` returns the process-wide singleton. Components
default to it so a solve and the server that later serves its DB land in
one exposition without plumbing; tests wanting isolation construct their
own ``MetricsRegistry`` and pass it explicitly.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

# Span/latency default buckets: sub-millisecond serving probes up to
# multi-minute solve levels (seconds).
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# Size-ish default buckets (batch sizes, queue depths): powers of 4.
DEFAULT_SIZE_BUCKETS = (
    1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
)


def _check_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    if name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(s: str) -> str:
    return (
        s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _format_value(v: float) -> str:
    """Prometheus value spelling: integral floats print as integers
    (counter increments stay readable), +Inf/NaN in Go spellings."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _format_le(b: float) -> str:
    return "+Inf" if math.isinf(b) else _format_value(b)


class _Child:
    """Common base: one (family, label set) instrument."""

    __slots__ = ("_family", "_labels")

    def __init__(self, family: "_Family", labels: Tuple[Tuple[str, str], ...]):
        self._family = family
        self._labels = labels


class Counter(_Child):
    """Monotonic accumulator. ``inc(n)`` with n >= 0."""

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        reg = self._family.registry
        with reg._lock:
            self._family.values[self._labels] = (
                self._family.values.get(self._labels, 0.0) + amount
            )

    @property
    def value(self) -> float:
        with self._family.registry._lock:
            return self._family.values.get(self._labels, 0.0)


class Gauge(_Child):
    """Set-to-current-value instrument (RSS, queue depth, start time)."""

    def set(self, value: float) -> None:
        with self._family.registry._lock:
            self._family.values[self._labels] = float(value)

    def inc(self, amount: float = 1.0) -> None:
        reg = self._family.registry
        with reg._lock:
            self._family.values[self._labels] = (
                self._family.values.get(self._labels, 0.0) + amount
            )

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._family.registry._lock:
            return self._family.values.get(self._labels, 0.0)


class Histogram(_Child):
    """Bucketed distribution. Buckets are per-FAMILY (the exposition
    format requires one boundary set per family); ``observe`` finds the
    first bucket whose inclusive upper bound holds the sample."""

    def observe(self, value: float,
                exemplar: Optional[dict] = None) -> None:
        fam = self._family
        value = float(value)
        with fam.registry._lock:
            counts, total, count = fam.values.get(
                self._labels, (None, 0.0, 0)
            )
            if counts is None:
                counts = [0] * len(fam.buckets)
            for i, b in enumerate(fam.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            fam.values[self._labels] = (counts, total + value, count + 1)
            if exemplar:
                # OpenMetrics-style exemplar: last-write-wins per child
                # (the serving path attaches the trace id of the most
                # recent slow observation, which is exactly the one an
                # operator wants to chase). Rides snapshot() and the
                # openmetrics render; the default v0.0.4 exposition is
                # untouched.
                fam.exemplars[self._labels] = {
                    "labels": {str(k): str(v)
                               for k, v in exemplar.items()},
                    "value": value,
                    "ts": fam.registry._clock(),
                }

    @property
    def count(self) -> int:
        with self._family.registry._lock:
            got = self._family.values.get(self._labels)
            return 0 if got is None else got[2]

    @property
    def sum(self) -> float:
        with self._family.registry._lock:
            got = self._family.values.get(self._labels)
            return 0.0 if got is None else got[1]


class _Family:
    __slots__ = ("registry", "name", "help", "kind", "buckets", "values",
                 "children", "exemplars")

    def __init__(self, registry, name, help_, kind, buckets=None):
        self.registry = registry
        self.name = name
        self.help = help_
        self.kind = kind  # "counter" | "gauge" | "histogram"
        #: histogram boundaries, always ending in +Inf; None otherwise
        self.buckets = buckets
        self.values: dict = {}  # guarded-by: _lock (the registry's)
        self.children: dict = {}  # guarded-by: _lock (the registry's)
        #: label-key -> last exemplar dict; histograms only
        self.exemplars: dict = {}  # guarded-by: _lock (the registry's)


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``counter``/``gauge``/``histogram`` get-or-create: the first call
    fixes the family's help text (and a histogram's buckets); later
    calls with a different kind raise — one name, one meaning, per
    process."""

    def __init__(self, *, clock=time.time):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}  # guarded-by: _lock
        self._constant_labels: Dict[str, str] = {}  # guarded-by: _lock
        self._clock = clock

    def set_constant_labels(self, **labels) -> None:
        """Labels stamped onto every child created afterwards (explicit
        per-call labels win on collision). The multi-process rank label
        rides here: one call after the process group is up and every
        ``gamesman_*`` series this process emits carries
        ``rank="<process_index>"`` — call sites stay unchanged, and a
        single-process run's exposition is byte-identical to before."""
        with self._lock:
            self._constant_labels.update(
                {str(k): str(v) for k, v in labels.items()}
            )

    # -------------------------------------------------------- registration

    def _family(self, name: str, help_: str, kind: str,
                buckets=None) -> _Family:
        _check_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    self, name, help_, kind, buckets
                )
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}"
                )
            return fam

    def _child(self, fam: _Family, labels: dict, cls):
        with self._lock:
            if self._constant_labels:
                labels = {**self._constant_labels, **labels}
            key = _labels_key(labels)
            for k, _ in key:
                _check_name(k)
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = cls(fam, key)
                # Seed zero at registration (the standard client-library
                # behavior): a scrape taken before the first write must
                # show 0, not "no data" — an error-rate alert cannot
                # distinguish an unseeded counter from a counter reset.
                if fam.kind == "histogram":
                    fam.values.setdefault(
                        key, ([0] * len(fam.buckets), 0.0, 0)
                    )
                else:
                    fam.values.setdefault(key, 0.0)
            return child

    def counter(self, name: str, help_: str = "", **labels) -> Counter:
        return self._child(
            self._family(name, help_, "counter"), labels, Counter
        )

    def gauge(self, name: str, help_: str = "", **labels) -> Gauge:
        return self._child(self._family(name, help_, "gauge"), labels, Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        # The whole get-or-create must hold the (reentrant) lock: a
        # racing first-registration pair would otherwise both miss the
        # family check and disagree about the bucket set.
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                bounds = sorted(
                    float(b)
                    for b in (buckets if buckets is not None
                              else DEFAULT_TIME_BUCKETS)
                )
                if not bounds:
                    raise ValueError("histogram needs at least one bucket")
                if not math.isinf(bounds[-1]):
                    bounds.append(math.inf)
                fam = self._family(name, help_, "histogram", tuple(bounds))
            elif fam.kind != "histogram":
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    "not histogram"
                )
            return self._child(fam, labels, Histogram)

    # -------------------------------------------------------------- reading

    def snapshot(self) -> dict:
        """Plain-dict view: {name: {type, help, values: [...]}}; histogram
        values carry NON-cumulative per-bucket counts plus sum/count."""
        out: dict = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                rows = []
                for key in sorted(fam.values):
                    labels = dict(key)
                    if fam.kind == "histogram":
                        counts, total, count = fam.values[key]
                        rows.append({
                            "labels": labels,
                            "buckets": {
                                _format_le(b): c
                                for b, c in zip(fam.buckets, counts)
                            },
                            "sum": total,
                            "count": count,
                            # Estimated quantiles (bucket interpolation):
                            # the one derivation site — /status payloads,
                            # obs tooling, and tests read these instead of
                            # re-deriving from the raw buckets.
                            "quantiles": {
                                _quantile_key(q): v
                                for q, v in estimate_quantiles(
                                    fam.buckets, counts
                                ).items()
                            },
                        })
                        ex = fam.exemplars.get(key)
                        if ex is not None:
                            rows[-1]["exemplar"] = dict(ex)
                    else:
                        rows.append(
                            {"labels": labels, "value": fam.values[key]}
                        )
                out[name] = {
                    "type": fam.kind, "help": fam.help, "values": rows,
                }
        return out

    def render_prometheus(self) -> str:
        """Text exposition format v0.0.4."""
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam.values):
                    if fam.kind == "histogram":
                        counts, total, count = fam.values[key]
                        cum = 0
                        for b, c in zip(fam.buckets, counts):
                            cum += c
                            lines.append(
                                _sample(
                                    name + "_bucket",
                                    key + (("le", _format_le(b)),),
                                    cum,
                                )
                            )
                        lines.append(_sample(name + "_sum", key, total))
                        lines.append(_sample(name + "_count", key, count))
                    else:
                        lines.append(_sample(name, key, fam.values[key]))
        return "\n".join(lines) + ("\n" if lines else "")

    def render_openmetrics(self) -> str:
        """OpenMetrics-style exposition: the v0.0.4 body plus histogram
        bucket exemplars (``# {trace_id="..."} value ts`` on the first
        bucket whose boundary holds the exemplar value) and the
        mandatory ``# EOF`` trailer. Served from ``GET /metrics`` only
        under ``Accept: application/openmetrics-text`` — the default
        exposition stays byte-identical to before exemplars existed."""
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam.values):
                    if fam.kind == "histogram":
                        counts, total, count = fam.values[key]
                        ex = fam.exemplars.get(key)
                        cum = 0
                        for b, c in zip(fam.buckets, counts):
                            cum += c
                            line = _sample(
                                name + "_bucket",
                                key + (("le", _format_le(b)),),
                                cum,
                            )
                            if ex is not None and ex["value"] <= b:
                                line += " # {%s} %s %s" % (
                                    ",".join(
                                        f'{k}="{_escape_label_value(v)}"'
                                        for k, v in sorted(
                                            ex["labels"].items()
                                        )
                                    ),
                                    _format_value(ex["value"]),
                                    repr(float(ex["ts"])),
                                )
                                ex = None
                            lines.append(line)
                        lines.append(_sample(name + "_sum", key, total))
                        lines.append(_sample(name + "_count", key, count))
                    else:
                        lines.append(_sample(name, key, fam.values[key]))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: Quantiles every histogram snapshot estimates (p50/p95/p99 — the
#: operator set; consumers wanting others call estimate_quantiles).
SNAPSHOT_QUANTILES = (0.5, 0.95, 0.99)


def estimate_quantiles(bounds, counts, qs=SNAPSHOT_QUANTILES):
    """Estimate quantiles from histogram buckets by linear interpolation.

    ``bounds`` are the inclusive upper bucket boundaries (ending +Inf),
    ``counts`` the NON-cumulative per-bucket counts. Within a bucket the
    distribution is assumed uniform (the standard Prometheus
    ``histogram_quantile`` model); a quantile landing in the +Inf bucket
    returns the last finite bound (the estimate is saturated, never
    invented). Returns ``{q: value | None}`` — None when the histogram
    is empty. One implementation, so ``/status``, ``--metrics-out``
    consumers, obs_report, and tests stop re-deriving it from raw
    buckets independently.
    """
    total = sum(counts)
    out: dict = {}
    finite = [b for b in bounds if not math.isinf(b)]
    top = finite[-1] if finite else 0.0
    for q in qs:
        if total == 0:
            out[q] = None
            continue
        target = q * total
        cum = 0
        value = top
        for i, (b, c) in enumerate(zip(bounds, counts)):
            if c == 0:
                cum += c
                continue
            if cum + c >= target:
                if math.isinf(b):
                    value = top
                else:
                    lo = 0.0 if i == 0 else (
                        bounds[i - 1]
                        if not math.isinf(bounds[i - 1]) else 0.0
                    )
                    value = lo + (b - lo) * (target - cum) / c
                break
            cum += c
        out[q] = value
    return out


def _quantile_key(q: float) -> str:
    """0.5 -> "p50", 0.99 -> "p99" (snapshot key spelling)."""
    s = f"{q * 100:g}".replace(".", "_")
    return f"p{s}"


def _sample(name: str, labels: Tuple[Tuple[str, str], ...],
            value: float) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in labels
        )
        return f"{name}{{{inner}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    return (registry or default_registry()).render_prometheus()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every component records into by default."""
    return _DEFAULT
