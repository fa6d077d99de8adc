"""Torch port's observability (obs/registry, obs/qtrace, obs/slo) against
the JAX package on the same inputs.

The same seeded numpy workload drives the reference's module and the
port's: the Prometheus text is equal byte for byte, the OpenMetrics text
and the snapshot dict (quantiles included) are equal under one fixed
clock, ``estimate_quantiles`` agrees on random bucket counts, the W3C
traceparent helpers and the tail sampler make the same decisions, and
the SLO engine reports the same burn rates. Everything here is exact
arithmetic on the same floats, so tolerance zero.
"""

import numpy as np
import pytest

from gamesmanmpi_tpu.obs import qtrace as ref_qtrace
from gamesmanmpi_tpu.obs import registry as ref_registry
from gamesmanmpi_tpu.obs import slo as ref_slo
from gamesmanmpi_tpu_torch import obs
from gamesmanmpi_tpu_torch.obs import qtrace, registry, slo


def _fill(mod, seed):
    """A registry with counters, gauges and histograms (labeled, with
    exemplars and constant labels) from a seeded workload."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry(clock=lambda: 1700000000.25)
    if seed % 2:
        reg.set_constant_labels(worker="3")
    for i in range(int(rng.integers(3, 8))):
        reg.counter("gamesman_http_requests_total", "requests",
                    route=f"r{i % 3}").inc(float(rng.integers(1, 50)))
    reg.gauge("gamesman_serve_worker_up", "up", worker="0").set(1)
    reg.gauge("gamesman_shm_bytes", "bytes").set(float(rng.integers(0, 1e9)))
    lat = reg.histogram("gamesman_http_request_seconds", "latency")
    for v in rng.exponential(0.01, size=200):
        lat.observe(float(v), exemplar=(
            {"trace_id": "ab" * 16} if v > 0.03 else None))
    size = reg.histogram("gamesman_batch_size", "positions per batch",
                         buckets=mod.DEFAULT_SIZE_BUCKETS)
    for v in rng.integers(1, 5000, size=64):
        size.observe(float(v))
    reg.counter("gamesman_odd_help_total",
                'help with \\ backslash and\nnewline',
                label='quote " and \\ slash').inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_registry_text_and_snapshot_match_the_reference(seed):
    ref, port = _fill(ref_registry, seed), _fill(registry, seed)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.render_openmetrics() == ref.render_openmetrics()
    assert port.snapshot() == ref.snapshot()
    assert obs.render_prometheus(port) == ref_registry.render_prometheus(ref)


def test_registry_refuses_what_the_reference_refuses():
    for mod in (ref_registry, registry):
        reg = mod.MetricsRegistry()
        reg.counter("gamesman_x_total", "x")
        with pytest.raises(ValueError):
            reg.gauge("gamesman_x_total", "x")
        with pytest.raises(ValueError):
            reg.counter("bad name", "x")
    assert isinstance(obs.default_registry(), registry.MetricsRegistry)
    assert obs.default_registry() is obs.default_registry()


@pytest.mark.parametrize("seed", range(4))
def test_estimate_quantiles_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    bounds = sorted(set(float(b) for b in rng.exponential(1.0, 12)))
    bounds.append(float("inf"))
    counts = [int(c) for c in rng.integers(0, 20, len(bounds))]
    qs = (0.5, 0.9, 0.95, 0.99, 0.999)
    assert registry.estimate_quantiles(bounds, counts, qs) == \
        ref_registry.estimate_quantiles(bounds, counts, qs)
    empty = [0] * len(bounds)
    assert registry.estimate_quantiles(bounds, empty) == \
        ref_registry.estimate_quantiles(bounds, empty)


def test_traceparent_helpers_match_the_reference():
    good = "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-" \
        + "00f067aa0ba902b7" + "-01"
    cases = [good, good.upper(), None, "", "00-zz-11-01",
             "ff-" + good[3:], "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
             good + "-extra"]
    for h in cases:
        assert qtrace.parse_traceparent(h) == ref_qtrace.parse_traceparent(h)
    assert qtrace.format_traceparent("a" * 32, "b" * 16) == \
        ref_qtrace.format_traceparent("a" * 32, "b" * 16)
    tid, sid = qtrace.mint_trace_ids()
    assert ref_qtrace.parse_traceparent(
        qtrace.format_traceparent(tid, sid)) == (tid, sid)


def _traces(mod, seed):
    """Finished traces with fixed span timings, from a seeded workload."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        ticks = iter([0.0, float(rng.exponential(0.05))])
        tr = mod.QueryTrace(route=f"r{i % 2}", worker=1,
                            clock=lambda ticks=ticks: next(ticks))
        tr.trace_id, tr.root_id = f"{i:032x}", f"{i:016x}"
        tr.start = 1700000000.0 + i
        tr.add_span("canonicalize", 0.0001, 0.002, queries=3)
        code = int(rng.choice([200, 200, 200, 500, 503]))
        tr.finish(status="ok" if code == 200 else "error", code=code,
                  clock=lambda ticks=ticks: next(ticks))
        out.append(tr)
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_tail_sampler_keeps_what_the_reference_keeps(seed):
    rings = []
    for mod in (ref_qtrace, qtrace):
        reg = (ref_registry if mod is ref_qtrace else registry
               ).MetricsRegistry()
        ring = mod.TraceRing(capacity=16, slow_ms=60.0, head_n=5,
                             enabled=True, registry=reg)
        decisions = [ring.offer(t) for t in _traces(mod, seed)]
        rings.append((decisions, ring.snapshot(), ring.drain_outbox(100),
                      reg.render_prometheus()))
    assert rings[0] == rings[1]


def test_qspan_attributes_to_every_active_trace():
    for mod in (ref_qtrace, qtrace):
        a, b = mod.QueryTrace(), mod.QueryTrace()
        with mod.qspan("outside") as sp:
            assert sp is None  # no active trace: a no-op
        with mod.activate([a, b]):
            with mod.qspan("searchsorted", level=4) as sp:
                sp["queries"] = 2
        for t in (a, b):
            assert [s["name"] for s in t.spans] == ["searchsorted"]
            assert t.spans[0]["level"] == 4 and t.spans[0]["queries"] == 2


@pytest.mark.parametrize("seed", [0, 5])
def test_slo_engine_burns_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    events = [(float(t), f"r{int(r)}", float(s), int(c), bool(sh))
              for t, r, s, c, sh in zip(
                  np.cumsum(rng.exponential(0.5, 400)),
                  rng.integers(0, 3, 400), rng.exponential(0.1, 400),
                  rng.choice([200, 200, 200, 200, 500], 400),
                  rng.random(400) < 0.02)]
    snaps = []
    for mod, rmod in ((ref_slo, ref_registry), (slo, registry)):
        now = [1700000000.0]
        reg = rmod.MetricsRegistry()
        eng = mod.SloEngine(p99_ms=150.0, avail_target=0.99,
                            latency_target=0.95, fast_window=30.0,
                            slow_window=300.0, fast_burn=5.0,
                            min_requests=10, registry=reg,
                            clock=lambda: now[0])
        trail = []
        for t, route, secs, code, shed in events:
            now[0] = 1700000000.0 + t
            eng.observe(route, secs, code, shed=shed)
            trail.append(eng.fast_burning())
        snaps.append((trail, eng.snapshot(), reg.render_prometheus()))
    assert snaps[0] == snaps[1]
