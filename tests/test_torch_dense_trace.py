"""A traced dense solve (solve/dense.py over obs/tracing.py), on the CPU.

The switch is read once per solve: a trace sink installed or a
torch.profiler recording turns it on, and then the solve's spans tile it
under dense_solve, carry the solve's id, their level and their parent,
and land once in stats["trace"], the registry and the sink; the
program's profiler export holds the same spans on the sink's clock. Off,
the level loop builds no span tree, opens no profiler range and reads
the clock no more often than its one backward span needs. The count of
blocking device reads is held to a hand count of the board's sync sites.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.obs import MetricsRegistry, set_trace_sink, tracing
from gamesmanmpi_tpu_torch.obs.tracing import (
    SpanTree,
    TraceEventSink,
)
from gamesmanmpi_tpu_torch.solve import dense
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer
from gamesmanmpi_tpu_torch.utils.profiling import maybe_profile

torch.set_num_threads(1)

SPEC = "connect4:w=4,h=4"
LEVELS = 17  # 0..16
PER_LEVEL = ("backward", "dense_pack", "dense_launch", "dense_download",
             "dense_record")
PARENT = {"dense_solve": None, "dense_enter": "dense_solve",
          "backward": "dense_solve", "dense_pack": "backward",
          "dense_launch": "backward", "dense_download": "backward",
          "dense_record": "dense_solve", "dense_exit": "dense_solve"}


@pytest.fixture(scope="module")
def game():
    g = get_game(SPEC)
    DenseSolver(g, device="cpu").reachable_counts()  # cached per process
    return g


@pytest.fixture
def sink():
    s = TraceEventSink()
    prev = set_trace_sink(s)
    yield s
    set_trace_sink(prev)


def _events(sink, solve=None):
    """The sink's events of one solve (its span tree's id)."""
    return [e for e in sink.to_dict()["traceEvents"]
            if solve is None or e.get("args", {}).get("solve") == solve]


def test_traced_solve_records_every_span_with_parent_and_level(game, sink):
    r = DenseSolver(game, device="cpu").solve()
    tr = r.stats["trace"]
    assert set(tr) == set(PARENT) | {"host_syncs"}
    for name in PER_LEVEL:
        assert tr[name]["n"] == LEVELS, name
    for name in ("dense_solve", "dense_enter", "dense_exit"):
        assert tr[name]["n"] == 1, name
    solve = _events(sink)[-1]["args"]["solve"]
    evs = _events(sink, solve)
    assert len(evs) == 3 + LEVELS * len(PER_LEVEL)
    for e in evs:
        assert e["args"]["parent"] == PARENT[e["name"]], e
        assert ("level" in e["args"]) == (e["name"] in PER_LEVEL), e
    for name in PER_LEVEL:
        levels = sorted(e["args"]["level"] for e in evs if e["name"] == name)
        assert levels == list(range(LEVELS)), name
    # The backward span carries its level and nothing it would sum.
    back = next(e for e in evs if e["name"] == "backward")
    assert set(back["args"]) == {"level", "solve", "parent"}
    assert (r.value, r.remoteness) == (3, 16)


def _nested_within(evs, parent, children, slack_us=1.0):
    """Each child event lies inside an event of `parent`."""
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in evs if e["name"] == parent]
    for e in evs:
        if e["name"] in children:
            assert any(a - slack_us <= e["ts"] and
                       e["ts"] + e["dur"] <= b + slack_us
                       for a, b in outer), e


def test_the_spans_tile_the_solve(game, sink):
    tr = DenseSolver(game, device="cpu").solve().stats["trace"]
    s = {k: v["s"] for k, v in tr.items() if isinstance(v, dict)}
    solve_parts = (s["dense_enter"] + s["backward"] + s["dense_record"]
                   + s["dense_exit"])
    level_parts = s["dense_pack"] + s["dense_launch"] + s["dense_download"]
    assert 0 <= s["dense_solve"] - solve_parts <= 0.05 * s["dense_solve"]
    assert 0 <= s["backward"] - level_parts <= 0.05 * s["backward"]
    evs = _events(sink, _events(sink)[-1]["args"]["solve"])
    _nested_within(evs, "dense_solve", {"dense_enter", "backward",
                                        "dense_record", "dense_exit"})
    _nested_within(evs, "backward", {"dense_pack", "dense_launch",
                                     "dense_download"})


def test_registry_takes_each_detail_span_once_per_solve(game, sink,
                                                        monkeypatch):
    reg = MetricsRegistry()
    monkeypatch.setattr(tracing, "default_registry", lambda: reg)
    DenseSolver(game, device="cpu").solve()
    text = reg.render_prometheus()
    for name in ("dense_solve", "dense_enter", "dense_pack", "dense_launch",
                 "dense_download", "dense_record", "dense_exit"):
        assert f'gamesman_span_seconds_count{{span="{name}"}} 1' in text
    # backward keeps its own per-level series, without payload counters.
    assert f'gamesman_span_seconds_count{{span="backward"}} {LEVELS}' in text
    assert "gamesman_span_payload_total" not in text


def test_untraced_solve_builds_no_tree_range_or_extra_clock_read(
        game, monkeypatch):
    counts = {"tree": 0, "detail": 0, "range": 0, "clock": 0}
    made = SpanTree.__init__
    span_init = tracing.Span.__init__
    clock = tracing.time.perf_counter
    enter = torch._C._autograd._record_function_with_args_enter
    rf_init = torch.profiler.record_function.__init__

    def tree_init(self, *a, **k):
        counts["tree"] += 1
        made(self, *a, **k)

    def span(self, name, **k):
        counts["detail"] += bool(k.get("detail") or k.get("tree"))
        span_init(self, name, **k)

    def ranged(*a, **k):
        counts["range"] += 1
        return enter(*a, **k)

    def rf(self, *a, **k):
        counts["range"] += 1
        rf_init(self, *a, **k)

    def tick():
        counts["clock"] += 1
        return clock()

    monkeypatch.setattr(SpanTree, "__init__", tree_init)
    monkeypatch.setattr(tracing.Span, "__init__", span)
    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", ranged)
    monkeypatch.setattr(torch.profiler.record_function, "__init__", rf)
    monkeypatch.setattr(tracing.time, "perf_counter", tick)
    assert not tracing.tracing_on()
    r = DenseSolver(game, device="cpu").solve()
    assert "trace" not in r.stats
    assert counts["tree"] == counts["detail"] == counts["range"] == 0
    # The backward span's start and end per level, and the solve's three
    # own readings (its start, its end, the reach counts' start).
    assert counts["clock"] == 2 * LEVELS + 3


def test_profiler_export_holds_the_spans_on_the_sinks_clock(game, sink,
                                                            tmp_path):
    """Under the program's profiler (the CLI's --profile-dir, CPU
    activity) each profiler range lies inside its span of the sink, to
    within 20 us at each end: the two share a clock. Each span name's
    median begin offset lies within 100 us (a host stall between a
    span's clock read and its range's stamp moves single offsets)."""
    with maybe_profile(tmp_path / "prof"):
        r = DenseSolver(game, device="cpu").solve()
    assert "trace" in r.stats
    (path,) = (tmp_path / "prof").iterdir()
    doc = json.loads(path.read_text())
    ranges: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in PARENT:
            ts = float(e["ts"])
            ranges.setdefault(e["name"], []).append((ts, ts + e["dur"]))
    mine = sink.to_dict()
    assert mine["baseTimeNanoseconds"] == doc.get("baseTimeNanoseconds", 0)
    solve = _events(sink)[-1]["args"]["solve"]
    spans: dict = {}
    for e in _events(sink, solve):
        spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert set(ranges) == set(spans) == set(PARENT)
    for name, mine_spans in spans.items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(mine_spans), name
        pairs = list(zip(sorted(mine_spans), theirs))
        for (s0, s1), (r0, r1) in pairs:
            assert r0 >= s0 - 20.0, (name, s0, r0)
            assert r1 <= s1 + 20.0, (name, s1, r1)
        begins = sorted(r0 - s0 for (s0, _), (r0, _) in pairs)
        assert abs(begins[len(begins) // 2]) < 100.0, (name, begins)


@pytest.mark.parametrize("swept", [False, True], ids=["counts_cached",
                                                      "counts_swept"])
def test_host_syncs_match_the_hand_count(game, sink, swept, monkeypatch):
    if swept:
        monkeypatch.delitem(dense._REACH_COUNTS, (4, 4, 4))
    r = DenseSolver(game, device="cpu").solve()
    tr = r.stats["trace"]
    # A download per level, a miss count per level below the top, the
    # root; a sweep reads a reach count per level above 0.
    assert tr["host_syncs"] == LEVELS + (LEVELS - 1) + 1 + (
        LEVELS - 1 if swept else 0)
    assert r.stats["reach_counts_source"] == ("sweep" if swept
                                              else "process")


def test_traced_checkpointed_solve_keeps_its_records(game, sink, tmp_path):
    """The checkpoint span joins the tree inside backward; the JSONL
    records are the untraced solve's, no detail span among them."""

    class Records:
        def __init__(self):
            self.records = []

        def log(self, rec):
            self.records.append(rec)

    def shape(logger):
        return [(r["phase"], r.get("level"), r.get("classes"),
                 r.get("class_size")) for r in logger.records]

    traced = Records()
    r = DenseSolver(game, device="cpu", logger=traced,
                    checkpointer=LevelCheckpointer(str(tmp_path / "a"))
                    ).solve()
    assert r.stats["trace"]["checkpoint"]["n"] == LEVELS
    ck = [e for e in _events(sink, _events(sink)[-1]["args"]["solve"])
          if e["name"] == "checkpoint"]
    assert {e["args"]["parent"] for e in ck} == {"backward"}
    set_trace_sink(None)
    plain = Records()
    DenseSolver(game, device="cpu", logger=plain,
                checkpointer=LevelCheckpointer(str(tmp_path / "b"))).solve()
    assert shape(traced) == shape(plain)
    assert not any(p.startswith("dense_") and p not in (
        "dense_backward", "dense_backward_resume") for p, *_ in shape(traced))


def test_sink_stamps_the_realtime_clock_since_its_base():
    """A span-clock reading maps onto CLOCK_REALTIME by the sink's
    offset; ts counts from its base, which a profiler trace's replaces."""
    s = TraceEventSink()
    s.offset_ns, s.base_ns = 5_000, 1_000
    s.add_complete("x", 2.0, 0.5, 1)
    assert s.to_dict()["traceEvents"][0]["ts"] == (2e9 + 5_000 - 1_000) / 1e3
    s.base_ns = 2_000
    assert s.to_dict()["traceEvents"][0]["ts"] == (2e9 + 5_000 - 2_000) / 1e3
    assert s.to_dict()["baseTimeNanoseconds"] == 2_000
    live = TraceEventSink()
    assert live.base_ns % 10**9 == 0
    assert abs(live.offset_ns - tracing._realtime_offset_ns()) < 10**7


def test_a_profiler_alone_turns_tracing_on(game):
    """The benchmark's case: no sink, a profiler that is not the
    program's recording; the solve's trace is in its stats, the profiler
    gets no range of it (it may record no CPU activity), and nothing is
    left open."""
    assert tracing.get_trace_sink() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.tracing_on()
        r = DenseSolver(game, device="cpu").solve()
    assert not tracing.tracing_on()
    assert r.stats["trace"]["backward"]["n"] == LEVELS
    names = {e.name for e in prof.events()}
    assert not set(PARENT) & names
