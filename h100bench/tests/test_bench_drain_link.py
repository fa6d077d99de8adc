"""The readers of a dense solve's drain span and of the host link's share
(metrics/dense_drain_ms.solve.py, metrics/dense_link_pct.solve.py), on the
stats of two traced 4x4 solves on the CPU and a made-up device summary:
each value against a hand count, and None wherever what it reads is
missing, as on a program that has no such span."""

import pytest

from conftest import BENCH

#: Every cell of the 4x4 board: its 17 levels' P * C.
CELLS_4X4 = 201_755
#: Device seconds of the window's copies by kind, as devtrace.summarize
#: gives them: 6 us of pinned and 2 us of pageable device-to-host copies.
COPIES = {"Memcpy DtoH (Device -> Pinned)": 6e-6,
          "Memcpy DtoH (Device -> Pageable)": 2e-6,
          "Memcpy HtoD (Pinned -> Device)": 1.0}
#: The dense configs' solver: every level's cells kept on the host.
CONFIG = {"solver": {"call": "gamesmanmpi_tpu_torch.solve.dense:DenseSolver",
                     "kwargs": {"store_tables": True}}}


def _reader(name):
    import run

    return run.load_reader(BENCH / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def stats():
    """Two traced 4x4 dense solves' stats (a trace sink turns the
    program's tracing on)."""
    import torch

    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.obs.tracing import (
        TraceEventSink,
        set_trace_sink,
    )
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    torch.set_num_threads(2)
    game = get_game("connect4:w=4,h=4")
    prev = set_trace_sink(TraceEventSink())
    try:
        return [dict(DenseSolver(game, device="cpu").solve().stats)
                for _ in range(2)]
    finally:
        set_trace_sink(prev)


def _ctx(stats, copies=COPIES, config=CONFIG):
    return {"stats": stats, "solves": len(stats), "config": config,
            "trace": {"copies": dict(copies), "copy_s": sum(copies.values())}}


def test_the_drain_reads_the_span_per_solve(stats):
    read = _reader("dense_drain_ms.solve")
    spans = [s["trace"]["dense_drain"] for s in stats]
    assert [sp["n"] for sp in spans] == [1, 1]
    want = 1e3 * (spans[0]["s"] + spans[1]["s"]) / 2
    assert read(_ctx(stats)) == pytest.approx(want, rel=1e-12)
    assert 0 < want <= 1e3 * max(s["trace"]["dense_exit"]["s"]
                                 for s in stats)


def test_the_link_share_reads_bytes_over_dtoh_time(stats):
    read = _reader("dense_link_pct.solve")
    assert [s["encodable_positions"] for s in stats] == [CELLS_4X4] * 2
    # 403,510 B in 8 us of DtoH copies (the HtoD second not counted) is
    # 50.44 GB/s, 78.81% of 64 GB/s.
    got = read(_ctx(stats))
    assert got == pytest.approx(100 * 2 * CELLS_4X4 / 8e-6 / 64e9,
                                rel=1e-12)
    assert 78.8 < got < 78.82


@pytest.mark.parametrize("name", ["dense_drain_ms.solve",
                                  "dense_link_pct.solve"])
def test_nothing_to_read_reads_none(stats, name):
    read = _reader(name)
    untraced = [{k: v for k, v in s.items() if k != "trace"} for s in stats]
    assert read(dict(_ctx(untraced), trace=None)) is None
    assert read(_ctx([])) is None
    assert read({}) is None


def test_the_drain_needs_the_span_in_every_solve(stats):
    """One solve of the window without the span, as on a program that has
    none: nothing to read."""
    read = _reader("dense_drain_ms.solve")
    older = dict(stats[0], trace={k: v for k, v in stats[0]["trace"].items()
                                  if k != "dense_drain"})
    assert read(_ctx([older] + stats[1:])) is None


def test_the_link_share_needs_a_trace_and_a_dtoh_copy(stats):
    read = _reader("dense_link_pct.solve")
    assert read({"stats": stats, "solves": 2, "config": CONFIG}) is None
    assert read(dict(_ctx(stats), trace=None)) is None
    htod = {"Memcpy HtoD (Pinned -> Device)": 1.0}
    assert read(_ctx(stats, htod)) is None
    assert read(_ctx(stats, {})) is None


def test_the_link_share_needs_every_cell_sent_down(stats):
    """Tables left on the device, or levels resumed rather than solved
    and sent down: the cells' count is not the bytes copied."""
    read = _reader("dense_link_pct.solve")
    kept_none = {"solver": dict(CONFIG["solver"],
                                kwargs={"store_tables": False})}
    assert read(_ctx(stats, config=kept_none)) is None
    resumed = [dict(stats[0], levels_resumed=8)] + stats[1:]
    assert read(_ctx(resumed)) is None
