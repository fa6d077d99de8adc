"""Torch port's solve instrumentation against the JAX package's.

The --jsonl streams of the classic, dense and sharded engines follow the
reference's (phase, level) sequence with its integer fields (the fields
left out or different are listed below, one reason each); spans, the
Chrome trace sink, the flight recorder, the heartbeat, the watchdog, the
host-memory guard, the live status server and the profiler each behave
as the reference's, with injected clocks and fakes where time or memory
would make a test slow or flaky; and the CLI's abnormal exits (out of
memory, watchdog, crash) leave their diagnostics. Integers and JSON
documents throughout: no tolerance.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from urllib.request import urlopen

import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.obs import status as ref_status
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.obs import (
    FlightRecorder,
    Heartbeat,
    MetricsRegistry,
    Span,
    TraceEventSink,
    default_recorder,
    flightrec,
    heartbeat,
    set_trace_sink,
    trace_span,
)
from gamesmanmpi_tpu_torch.obs import status
from gamesmanmpi_tpu_torch.obs.tracing import trace_events_scope
from gamesmanmpi_tpu_torch.parallel.launch import REPO, launch, start_world
from gamesmanmpi_tpu_torch.resilience import faults, memguard
from gamesmanmpi_tpu_torch.resilience.supervisor import Watchdog
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.utils.metrics import RankLogger
from gamesmanmpi_tpu_torch.utils.profiling import maybe_profile

torch.set_num_threads(1)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, record):
        self.records.append(dict(record))

    def close(self):
        pass


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def disarmed():
    """Faults armed by a test are cleared after it."""
    yield
    faults.configure(None)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


# ------------------------------------------------------ the JSONL stream

#: Integer fields of the reference's records that the port does not
#: compare: left out of the port's records, or measuring something else.
NOT_COMPARED = {
    "dispatches": "XLA dispatch accounting; eager torch has no "
                  "dispatches to count",
    "dispatches_total": "the same, summed over the solve",
    "bytes_sorted": "analytic operand bytes at the reference's "
                    "power-of-two capacity buckets; the port runs every "
                    "level at its exact size and does not model them",
    "bytes_gathered": "the same, for the gathers",
    "bytes_hbm": "the same, summed",
    "bytes_routed": "the same, for the sharded exchange (the port's "
                    "exchange_bytes are measured, in the done record)",
    "route_cap": "the reference's padded route capacity; the port "
                 "exchanges exact splits (parallel/exchange.py)",
    "bytes_host": "the port moves states on its int64 carrier (8 B) "
                  "where the reference's uint32 games move 4 B, and "
                  "uploads unpadded levels",
    "fused": "the reference's fused megakernel mode, not ported",
    "edges_bytes_disk": "the reference's disk tier for spilled edges, "
                        "not ported (edges stay in host RAM)",
    "spill_retries": "the reference's route-capacity spill loop, not "
                     "ported",
    "writebehind_queue_depth": "each package's own process-wide store, "
                               "its peak since the process started",
}


def _ints(rec):
    return {k: v for k, v in rec.items()
            if isinstance(v, (int, bool)) and k not in NOT_COMPARED}


def _compare_streams(mine, ref):
    ref = [r for r in ref if r["phase"] != "heartbeat"]
    assert ([(r["phase"], r.get("level")) for r in mine]
            == [(r["phase"], r.get("level")) for r in ref])
    for a, b in zip(mine, ref):
        ref_only = {k for k, v in b.items()
                    if isinstance(v, (int, bool)) and k not in a}
        assert ref_only <= set(NOT_COMPARED), (b["phase"], ref_only)
        common = set(_ints(a)) & set(_ints(b))
        assert {k: a[k] for k in common} == {k: b[k] for k in common}, (
            b["phase"], b.get("level"))


@pytest.mark.parametrize("game,extra", [
    ("tictactoe", []),
    ("connect4:w=3,h=3", ["--engine", "dense"]),
    ("tictactoe", ["--devices", "4"]),
], ids=["classic", "dense", "sharded"])
def test_jsonl_stream_matches_the_references(game, extra, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    mine, ref = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    rc, out, _ = _run(cli.main, ["solve", game, *extra, "--device", "cpu",
                                 "--jsonl", str(mine)])
    assert rc == 0
    assert _run(jax_cli.main, [game, *extra, "--jsonl", str(ref)])[0] == 0
    recs = _records(mine)
    _compare_streams(recs, _records(ref))
    done = recs[-1]
    assert done["phase"] == "done"
    if "--engine" in extra:
        assert done["reachable_per_level"] == _records(ref)[-1][
            "reachable_per_level"]
    # positions/s from the records is the report's throughput line.
    line = next(ln for ln in out.splitlines()
                if ln.startswith("throughput:"))
    rate = done["positions"] / done["secs_total"]
    assert f"throughput: {rate:.0f} positions/sec" == line


def test_verbose_prints_the_records(capsys):
    assert cli.main(["solve", "nim:heaps=2-3", "--device", "cpu", "-v"]) == 0
    err = capsys.readouterr().err
    assert "[forward] level=0 frontier=1" in err
    assert "[done] level=- game=nim" in err


# ------------------------------------------------------------ the units


def test_span_fans_out_to_logger_registry_and_sink():
    clock, logger, reg = FakeClock(), ListLogger(), MetricsRegistry()
    sink = TraceEventSink()
    prev = set_trace_sink(sink)
    try:
        sp = Span("forward", logger=logger, registry=reg, clock=clock,
                  level=3)
        clock.t += 2.5
        sp.set(frontier=7)
        assert sp.end(children=11) == 2.5
        assert sp.end() == 2.5  # idempotent
        with trace_span("dedup", registry=reg, clock=clock, level=3):
            clock.t += 0.5
    finally:
        set_trace_sink(prev)
    assert logger.records == [{"phase": "forward", "level": 3,
                               "frontier": 7, "children": 11, "secs": 2.5}]
    snap = reg.snapshot()
    text = reg.render_prometheus()
    assert 'gamesman_span_seconds_count{span="forward"} 1' in text
    assert 'gamesman_span_seconds_count{span="dedup"} 1' in text
    assert ('gamesman_span_payload_total{key="children",span="forward"} 11'
            in text)
    assert 'key="level"' not in text  # a coordinate, not a volume
    assert "gamesman_span_seconds" in json.dumps(snap)
    ev = sink.to_dict()["traceEvents"]
    assert [(e["name"], e["ph"], e["ts"], e["dur"]) for e in ev] == [
        ("forward", "X", 100e6, 2.5e6), ("dedup", "X", 102.5e6, 0.5e6)]
    assert ev[0]["args"] == {"level": 3, "frontier": 7, "children": 11}
    assert sink.span_names() == {"forward", "dedup"}


def test_trace_events_scope_writes_chrome_json(tmp_path):
    path = tmp_path / "t.json"
    with trace_events_scope(str(path)):
        with trace_span("checkpoint", level=1, kind="level"):
            pass
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in doc["traceEvents"]] == ["checkpoint"]
    with trace_events_scope(None) as sink:
        assert sink is None


def test_flight_recorder_ring_dump_and_boundary(tmp_path, monkeypatch):
    clock = FakeClock(5.0)
    rec = FlightRecorder(capacity=16, clock=clock)
    for i in range(20):
        rec.record("retry", point="engine.forward", attempt=i, kind="x")
    rec.span_begin(1, "backward", {"level": 4})
    clock.t = 7.0
    rec.level_complete("forward", 9)
    snap = rec.snapshot()
    assert snap["capacity"] == 16 and snap["dropped"] == 5
    assert snap["events"][-1] == {"t": 7.0, "kind": "level",
                                  "phase": "forward", "level": 9}
    assert snap["events"][0]["field_kind"] == "x"
    assert snap["inflight_spans"] == [{"span": "backward", "age_secs": 2.0,
                                       "level": 4}]
    assert snap["last_completed"] == {"forward": 9}
    assert rec.dump("test") is None  # no directory: no litter
    path = rec.dump("test", directory=str(tmp_path), rank=3)
    body = json.loads(open(path).read())
    assert body["reason"] == "test" and body["rank"] == "3"
    monkeypatch.setenv("GAMESMAN_FLIGHTREC_DIR", str(tmp_path / "b"))
    flightrec.boundary("backward", 2)
    body = json.loads((tmp_path / "b" / "flightrec_0.json").read_text())
    assert body["reason"] == "boundary"
    assert body["last_completed"]["backward"] == 2


def test_heartbeat_beats_with_progress_and_rss():
    clock, logger, reg = FakeClock(), ListLogger(), MetricsRegistry()
    progress = {"phase": "backward", "level": 5, "n": 10}
    hb = Heartbeat(2.0, progress=lambda: progress, logger=logger,
                   registry=reg, clock=clock)
    clock.t += 3.0
    rec = hb.beat()
    assert rec["phase"] == "heartbeat" and rec["uptime_secs"] == 3.0
    assert rec["progress"] == progress
    assert isinstance(rec["rss_bytes"], int) and rec["rss_bytes"] > 0
    assert "devices" not in rec  # no card initialised here
    assert logger.records == [rec]
    text = reg.render_prometheus()
    assert "gamesman_heartbeat_beats_total 1" in text
    assert "gamesman_rss_bytes" in text
    with pytest.raises(ValueError):
        Heartbeat(0)


def test_heartbeat_and_status_never_initialise_cuda(monkeypatch):
    """A forked serving worker's parent never touched the driver: asking
    for card memory there must not initialise CUDA, and the status
    server asks nothing of torch.cuda at all."""
    def refuse(*a, **k):
        raise AssertionError("torch.cuda called before CUDA is up")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("init", "device_count", "memory_allocated",
                 "mem_get_info", "is_available", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert heartbeat.device_memory_stats() == {}
    assert "devices" not in Heartbeat(1.0, registry=MetricsRegistry()).beat()
    tracker = status.SolveStatusTracker()
    srv = status.StatusServer(tracker.snapshot, port=0,
                              registry=MetricsRegistry()).start()
    try:
        got = status.fetch_status(f"127.0.0.1:{srv.port}", timeout=5)
    finally:
        srv.stop()
    assert got["positions_solved"] == 0
    # Once CUDA is up: the card's numbers under the reference's keys.
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 123)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (5, 1000))
    assert heartbeat.device_memory_stats() == {
        "cuda:0": {"bytes_in_use": 123, "bytes_limit": 1000}}
    reg = MetricsRegistry()
    assert Heartbeat(1.0, registry=reg).beat()["devices"] == {
        "cuda:0": {"bytes_in_use": 123, "bytes_limit": 1000}}
    assert ('gamesman_device_bytes_in_use{device="cuda:0"} 123'
            in reg.render_prometheus())


def test_watchdog_deadline_and_injected_abort():
    fired = threading.Event()
    reg = MetricsRegistry()
    wd = Watchdog(lambda: {"phase": "backward", "level": 3}, min_secs=0.2,
                  factor=10.0, poll=0.02, action=fired.set, registry=reg)
    assert wd.deadline() == 0.2
    wd.recent.extend([0.01, 0.05])
    assert wd.deadline() == pytest.approx(0.5)
    wd.recent.clear()
    t0 = time.monotonic()
    with wd:
        assert fired.wait(5)
    assert wd.expired and 0.2 <= time.monotonic() - t0 < 5
    assert "gamesman_watchdog_expired_total 1" in reg.render_prometheus()


def test_memguard_over_a_fake_rss(monkeypatch):
    logger = ListLogger()
    monkeypatch.setattr(memguard, "rss_bytes", lambda: 300 << 20)
    monkeypatch.delenv("GAMESMAN_HOST_MEM_LIMIT_MB", raising=False)
    memguard.check("forward", level=1)  # off by default
    monkeypatch.setenv("GAMESMAN_HOST_MEM_LIMIT_MB", "400")
    memguard.check("forward", level=1)  # under the limit
    monkeypatch.setenv("GAMESMAN_HOST_MEM_LIMIT_MB", "200")
    with pytest.raises(memguard.HostMemoryExceeded) as e:
        memguard.check("backward", level=4, logger=logger)
    assert isinstance(e.value, MemoryError)
    assert "RESOURCE_EXHAUSTED" in str(e.value) and "level 4" in str(e.value)
    assert logger.records[0]["phase"] == "oom_guard"
    assert logger.records[0]["rss_mb"] == 300.0
    monkeypatch.setattr(memguard, "rss_bytes", lambda: None)
    memguard.check("backward", level=4)  # unmeasurable: never fails


def _drive_tracker(mod, clock):
    t = mod.SolveStatusTracker(clock=clock)
    t.begin(game="g", engine="classic", world=1, rank=0)
    t.forward_level(0, 1, 0.5)
    t.forward_level(1, 9, 0.25)
    t.set_schedule({0: 1, 1: 9, 2: 72})
    clock.t += 4.0
    t.backward_level(2, 72, 2.0)
    t.backward_level(1, 9, 0.0, resumed=True)
    return t


def test_status_snapshot_is_the_references():
    mine = _drive_tracker(status, FakeClock()).snapshot(
        {"phase": "backward", "level": 1, "n": 9})
    ref = _drive_tracker(ref_status, FakeClock()).snapshot(
        {"phase": "backward", "level": 1, "n": 9})
    assert mine == ref
    assert mine["eta_secs"] == 0.028 and mine["levels_solved"] == 2


def test_merge_fleet_is_the_references():
    snaps = {r: {"levels": {"3": {"fwd_secs": 1.0 + r, "bwd_secs": 0.5},
                            "4": {"fwd_secs": 0.1}},
                 "phase": "backward", "level": 3, "positions_solved": 10,
                 "eta_secs": 2.0 * (r + 1)} for r in range(3)}
    snaps[2]["levels"]["3"]["fwd_secs"] = 30.0
    mine = status.merge_fleet(snaps, world=3, factor=1.5)
    assert mine == ref_status.merge_fleet(snaps, world=3, factor=1.5)
    assert [s["rank"] for s in mine["stragglers"]] == [2]
    assert mine["eta_secs"] == 6.0


def test_maybe_profile(tmp_path):
    with maybe_profile(None):
        pass
    assert not any(tmp_path.iterdir())
    with maybe_profile(str(tmp_path / "prof")):
        torch.arange(1000).sum()
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name.startswith("trace_") and trace.suffix == ".json"
    assert json.loads(trace.read_text())["traceEvents"]


def test_transient_fault_under_retry_is_recorded(monkeypatch, disarmed):
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    faults.configure("engine.forward:transient:2")
    logger = ListLogger()
    r = Solver(get_game("tictactoe"), device="cpu", logger=logger).solve()
    assert (r.value, r.remoteness, r.stats["retries"]) == (3, 9, 1)
    events = [e for e in default_recorder().snapshot()["events"]
              if e.get("point") == "engine.forward"]
    assert [e["kind"] for e in events[-2:]] == ["fault", "retry"]
    assert events[-2]["fault_kind"] == "transient"
    assert events[-1]["level"] == 1 and events[-1]["attempt"] == 1
    retry = [x for x in logger.records if x["phase"] == "retry"]
    assert retry[0]["point"] == "engine.forward" and retry[0]["level"] == 1


# ---------------------------------------------------------------- the CLI


def test_cli_artifacts_heartbeat_and_live_status(tmp_path, monkeypatch,
                                                 disarmed):
    """A slowed solve with every flag: /status answers mid-solve, the
    heartbeat beats, the trace is Chrome JSON of registered spans, and
    --metrics-out holds the span histogram."""
    addr = tmp_path / "addr"
    monkeypatch.setenv("GAMESMAN_STATUS_ADDR_FILE", str(addr))
    monkeypatch.setenv("GAMESMAN_FAULTS", "engine.backward:delay=0.12:always")
    seen = {}

    def scrape():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and "status" not in seen:
            if addr.exists():
                got = status.fetch_status(addr.read_text(), timeout=2)
                if (got and got.get("phase") == "backward"
                        and got.get("levels_solved", 0) >= 2):
                    seen["status"] = got
                    with urlopen(f"http://{addr.read_text()}/metrics",
                                 timeout=2) as resp:
                        seen["metrics"] = resp.read().decode()
            time.sleep(0.05)

    th = threading.Thread(target=scrape)
    th.start()
    paths = {k: tmp_path / f"x.{k}" for k in ("jsonl", "trace", "metrics")}
    rc, _, _ = _run(cli.main, [
        "solve", "tictactoe", "--device", "cpu", "--jsonl",
        str(paths["jsonl"]), "--trace-events", str(paths["trace"]),
        "--metrics-out", str(paths["metrics"]), "--heartbeat-secs", "0.2",
        "--status-port", "0"])
    th.join()
    assert rc == 0
    snap = seen["status"]
    assert snap["game"] == "tictactoe_3x3x3" and snap["engine"] == "classic"
    assert snap["positions_discovered"] == 5478
    assert snap["levels_total"] == 10 and snap["eta_secs"] is not None
    assert "gamesman_span_seconds" in seen["metrics"]
    recs = _records(paths["jsonl"])
    beats = [r for r in recs if r["phase"] == "heartbeat"]
    assert beats and beats[-1]["progress"]["phase"] in ("backward", "done")
    events = json.loads(paths["trace"].read_text())["traceEvents"]
    assert {e["name"] for e in events} == {"forward", "dedup", "backward"}
    assert all(e["ph"] == "X" for e in events)
    assert sum(e["name"] == "backward" for e in events) == 10
    metrics = json.loads(paths["metrics"].read_text())
    assert "gamesman_span_seconds" in metrics
    # The flag's env twin is restored after the solve.
    assert os.environ.get("GAMESMAN_STATUS_PORT") is None


def test_cli_out_of_memory_exits_1_with_diagnostics(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_HOST_MEM_LIMIT_MB", "1")
    monkeypatch.setenv("GAMESMAN_FLIGHTREC_DIR", str(tmp_path))
    jsonl = tmp_path / "r.jsonl"
    rc, out, err = _run(cli.main, ["solve", "tictactoe", "--device", "cpu",
                                   "--jsonl", str(jsonl)])
    assert rc == 1 and "positions:" not in out
    assert "out of memory: host RSS" in err and "\nprogress: {" in err
    phases = [r["phase"] for r in _records(jsonl)]
    assert phases == ["oom_guard", "oom"]
    dump = json.loads((tmp_path / "flightrec_0.json").read_text())
    assert dump["reason"] == "oom"


def test_cli_crash_dumps_and_still_writes_metrics(tmp_path, monkeypatch,
                                                  disarmed):
    monkeypatch.setenv("GAMESMAN_FAULTS", "engine.backward:fatal:1")
    monkeypatch.setenv("GAMESMAN_FLIGHTREC_DIR", str(tmp_path))
    metrics = tmp_path / "m.json"
    with pytest.raises(faults.FatalFault):
        cli.main(["solve", "tictactoe", "--device", "cpu", "--metrics-out",
                  str(metrics)])
    assert "gamesman_span_seconds" in json.loads(metrics.read_text())
    dump = json.loads((tmp_path / "flightrec_0.json").read_text())
    assert dump["reason"] == "crash"
    # The recorder is the process's: its headline holds this solve's
    # forward, and the backward level that crashed is in flight.
    assert dump["last_completed"]["forward"] == 9
    assert {"span": "backward", "level": 9} in [
        {"span": s["span"], "level": s.get("level")}
        for s in dump["inflight_spans"]]


def test_watchdog_exit_124_leaves_a_resumable_prefix(tmp_path):
    """A backward level stalled by an injected 60 s delay: the watchdog
    exits 124 within seconds, the flight recorder in the checkpoint
    directory names the stalled level, and a rerun resumes the sealed
    prefix to the known answer."""
    ck = tmp_path / "ck"
    args = [sys.executable, "-m", "gamesmanmpi_tpu_torch", "solve",
            "connect4:w=3,h=3,connect=3", "--device", "cpu",
            "--checkpoint-dir", str(ck)]
    env = dict(os.environ, **ONE_THREAD,
               GAMESMAN_FAULTS="engine.backward:delay=60:3")
    t0 = time.monotonic()
    proc = subprocess.run(args + ["--watchdog-secs", "2"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 124, proc.stderr[-2000:]
    assert time.monotonic() - t0 < 40
    assert "[watchdog] stall detected" in proc.stderr
    dump = json.loads((ck / "flightrec_0.json").read_text())
    assert dump["reason"] == "watchdog_abort"
    assert dump["last_completed"]["backward"] == 8
    stalled = [s for s in dump["inflight_spans"] if s["span"] == "backward"]
    assert [s["level"] for s in stalled] == [7]
    env.pop("GAMESMAN_FAULTS")
    proc = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "positions: 694" in proc.stdout and "remoteness: 9" in proc.stdout


def test_world_artifacts_are_per_rank(tmp_path):
    """N processes given one --jsonl/--metrics-out/--trace-events path
    write rank-qualified siblings, every record stamped with its rank."""
    base = {k: str(tmp_path / f"w.{k}") for k in ("jsonl", "json", "trace")}
    ranks = launch(["solve", "connect4:w=3,h=3,connect=3", "--device",
                    "cpu", "--devices", "4", "--jsonl", base["jsonl"],
                    "--metrics-out", base["json"], "--trace-events",
                    base["trace"]], processes=2, log_dir=str(tmp_path),
                   timeout=240, env=ONE_THREAD)
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    assert not os.path.exists(base["jsonl"])
    for rank in (0, 1):
        recs = _records(tmp_path / f"w.rank{rank}.jsonl")
        assert recs and {r["rank"] for r in recs} == {rank}
        assert recs[-1]["phase"] == "done"
        assert (tmp_path / f"w.rank{rank}.json").exists()
        assert (tmp_path / f"w.rank{rank}.trace").exists()
    logger = ListLogger()
    RankLogger(logger, 1).log({"phase": "x"})
    assert logger.records == [{"rank": 1, "phase": "x"}]


def test_world_status_on_rank_0_is_fleet_merged(tmp_path):
    """In a 2-process world rank 1 announces its /status address to the
    coordinator, and rank 0's /status folds both ranks into the fleet
    view (obs/status.merge_fleet)."""
    addr = tmp_path / "addr"
    world = start_world(
        ["solve", "connect4:w=3,h=3,connect=3", "--device", "cpu",
         "--devices", "4", "--status-port", "0"], processes=2,
        log_dir=str(tmp_path),
        env=dict(ONE_THREAD, GAMESMAN_STATUS_ADDR_FILE=str(addr),
                 GAMESMAN_FAULTS="sharded.backward:delay=0.25:always"))
    fleet = None
    deadline = time.monotonic() + 120
    while fleet is None and time.monotonic() < deadline:
        if addr.exists():
            snap = status.fetch_status(addr.read_text(), timeout=2) or {}
            if len(snap.get("fleet", {}).get("ranks_reporting", [])) == 2:
                fleet = snap["fleet"]
        time.sleep(0.1)
    ranks = world.wait(240)
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    assert fleet is not None, "rank 0 never served a two-rank fleet view"
    assert fleet["world"] == 2 and fleet["ranks_reporting"] == [0, 1]
    assert set(fleet["ranks"]) == {"0", "1"}
