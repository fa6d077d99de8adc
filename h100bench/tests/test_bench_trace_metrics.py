"""The readers of the program's dense spans and counters: a traced run of
the dense cell at 4x4 on the CPU reads a number from each, whichever of
the program's two switches turns its tracing on (a profiler recording, as
the harness's device trace does on the card, or a trace sink), and none
where the program traced nothing."""

import argparse

import pytest

from conftest import BENCH

TRACE_METRICS = ("dense_pack_ms.solve", "dense_launch_ms.solve",
                 "dense_download_ms.solve", "dense_record_ms.solve",
                 "dense_edges_ms.solve", "dense_host_syncs.solve")


def _tracer(switch):
    """A stand-in for devtrace.DeviceTrace on the CPU, which has no device
    activity: it turns the program's tracing on over the window."""
    from torch.profiler import ProfilerActivity, profile

    from gamesmanmpi_tpu_torch.obs.tracing import (
        TraceEventSink,
        set_trace_sink,
    )

    class Tracer:
        def __init__(self, scratch):
            self.prof = None

        def start(self):
            if switch == "profiler":
                self.prof = profile(activities=[ProfilerActivity.CPU])
                self.prof.start()
            else:
                set_trace_sink(TraceEventSink())

        def stop(self):
            if self.prof is not None:
                self.prof.stop()
            set_trace_sink(None)

        def summary(self):
            return None

    return Tracer


@pytest.mark.parametrize("switch", ["profiler", "sink"])
def test_a_traced_run_reads_each_span_metric(tmp_path, monkeypatch, switch):
    import torch

    import devtrace
    import run
    from conftest import small_root

    torch.set_num_threads(2)
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    monkeypatch.setattr(devtrace, "DeviceTrace", _tracer(switch))
    root = small_root(tmp_path)  # the dense cell's board is 4x4 here
    cell = argparse.Namespace(workload="c4_5x5_dense.solve", seed=2 ** 33,
                              seconds=0.5, trace=1, rates=None)
    out = run.run_cell(cell, "cpu", root=root)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(TRACE_METRICS) <= set(got)
    assert all(got[k] > 0 for k in TRACE_METRICS)
    # 17 downloads, 16 miss counts and the root; the counts are cached.
    assert got["dense_host_syncs.solve"] == 34


def test_the_readers_read_nothing_from_an_untraced_program():
    import run

    ctx = {"stats": [{"positions": 1}, {"positions": 1}], "solves": 2}
    for name in TRACE_METRICS:
        read = run.load_reader(BENCH / "metrics" / f"{name}.py")
        assert read(ctx) is None, name
        assert read({"stats": []}) is None, name
