"""A traced dense solve on the card: the profiler's clock and the program's,
and each level's cells going down into pinned host memory.

Marked `cuda`: skips without an NVIDIA card. Imports nothing of JAX; on
the machine with the card run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_dense_trace_cuda.py

- The CLI's 5x5 dense solve under --profile-dir and --trace-events: each
  level's device-to-pinned copy is issued inside that level's
  dense_download range of the profile (joined to its issuing call by
  correlation id, as the root and miss-count reads issue pinned copies
  too; the copy itself may run after the range ends), one per range, and
  no copy of the solve goes to pageable memory. Each range of the
  profile lies inside its span of the --trace-events file (20 us of
  slack at each end) and begins within 100 us of it. The device copies
  can be placed only where the profile's device clock keeps to its host
  clock: no copy may start more than the slack before the host call
  that issued it. Where CUPTI's conversion drifts (up to 5.0 ms early by
  half a second into a session on torch 2.11.0+cu128), that check fails
  first and names it.
- A profiler with CUDA activity alone (the benchmark's) turns the
  program's tracing on, records no range of its own, and the solve's
  count of blocking device reads meets its hand count; the root read's
  wait lies inside dense_exit; a warm solve pins no new block for its
  cells.
- Each level's copy runs on the solver's copy stream (the profile's
  stream of each download's copy is not the kernels'); on 5x4 and 5x5
  every level's host cells are the CPU solve's, and the device's peak
  is two adjacent levels, as where every level goes down by the
  pageable copy; the solve leaves the caller's stream and device
  current.
- A kept result's cells are the CPU solve's, pinned, and stay as they
  were while later solves, each with its own copy stream, take their
  blocks from the allocator's cache; a checkpointed
  solve seals its cells; a level that cannot be pinned goes down by the
  pageable copy, with the same cells.
"""

import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
SLACK_US = 20.0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the level kernels have no CPU "
                    "mode)")


def test_cli_profile_holds_each_download_inside_its_span(tmp_path):
    _need_card()
    prof_dir, events = tmp_path / "prof", tmp_path / "spans.json"
    env = dict(os.environ, GAMESMAN_DENSE_COUNTS_FILE="0")
    proc = subprocess.run(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch", "solve",
         "connect4:w=5,h=5", "--engine", "dense", "--profile-dir",
         str(prof_dir), "--trace-events", str(events)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "positions: 69763700" in proc.stdout
    (path,) = prof_dir.iterdir()
    doc = json.loads(path.read_text())
    mine = json.loads(events.read_text())
    assert mine["baseTimeNanoseconds"] == doc["baseTimeNanoseconds"]
    ranges: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                ("dense_", "backward")):
            ranges.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    downloads = sorted(ranges["dense_download"])
    assert len(downloads) == 26
    pageable = [e["name"] for e in doc["traceEvents"]
                if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
                and "Pageable" in e["name"]]
    assert not pageable, pageable
    issued = sorted(_issuing_calls(doc, "Pinned"))
    kernel_streams = {e["args"].get("stream") for e in doc["traceEvents"]
                      if e.get("cat") == "kernel"
                      and "dense_step" in e["name"]}
    early = max(t0 - s for t0, _, s, _, _ in issued)
    assert early <= SLACK_US, (
        f"a copy starts up to {early:.1f} us before the host call that "
        f"issued it: the profile's device clock has drifted from its "
        f"host clock in this session")
    after, copy_streams = [], set()
    for i, (a, b) in enumerate(downloads):
        mine_copies = [c for c in issued if a <= c[0] <= b]
        near = [(round(c[0] - a, 3), round(c[2] - a, 3)) for c in issued
                if a - 50_000 <= c[0] <= b + 50_000]
        assert len(mine_copies) == 1, (i, round(b - a, 3), near)
        after.append(mine_copies[0][3] - b)
        copy_streams.add(mine_copies[0][4])
    # Each level's copy runs on the solver's copy stream, not the
    # kernels'.
    assert kernel_streams and None not in kernel_streams, kernel_streams
    assert len(copy_streams) == 1 and not copy_streams & kernel_streams, (
        copy_streams, kernel_streams)
    print(f"\ndownloads issued in their spans: 26 of 26, to pinned memory "
          f"on stream {copy_streams}, the kernels on {kernel_streams}; "
          f"copy end after span end {min(after):.3f}..{max(after):.3f} us")
    _assert_overlay(mine, ranges)


def _issuing_calls(doc, kind: str) -> list:
    """(host call start, its return, copy start, copy end, stream) of each
    device-to-host copy of `kind` in the profile, joined to its call by
    correlation id."""
    host = {e["args"]["correlation"]: (float(e["ts"]),
                                       float(e["ts"]) + float(e["dur"]))
            for e in doc["traceEvents"]
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    return [(*host[e["args"]["correlation"]], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]), e["args"].get("stream"))
            for e in doc["traceEvents"]
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
            and kind in e["name"]
            and e.get("args", {}).get("correlation") in host]


def _assert_overlay(mine: dict, ranges: dict) -> None:
    """The --trace-events file on the profile's clock: every profiler
    range lies inside its span, which opens just before it and closes
    just after, to within SLACK_US at each end, and begins within 100 us
    of it."""
    offsets: dict = {}
    outside = []
    for name, spans in _by_name(mine).items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(spans), name
        for (s0, s1), (r0, r1) in zip(sorted(spans), theirs):
            offsets.setdefault(name, []).append(r0 - s0)
            early = r0 < s0 - SLACK_US
            if early or r1 > s1 + SLACK_US:
                outside.append((name, round(r0 - s0, 3), round(s1 - r1, 3)))
    med = {k: sorted(v)[len(v) // 2] for k, v in offsets.items()}
    worst = {k: max(v, key=abs) for k, v in offsets.items()}
    print("profile range begin minus trace-events span begin (us), median "
          f"{json.dumps({k: round(v, 3) for k, v in med.items()})}, worst "
          f"{json.dumps({k: round(v, 3) for k, v in worst.items()})}")
    assert not outside, outside
    assert all(abs(v) < 100.0 for v in worst.values()), worst


def _by_name(doc) -> dict:
    out: dict = {}
    for e in doc["traceEvents"]:
        if e["name"].startswith(("dense_", "backward")):
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def test_a_cuda_only_profiler_turns_tracing_on(tmp_path):
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.ops import dense_level
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    game = get_game("connect4:w=5,h=5")
    DenseSolver(game).solve()  # kernels built, counts cached
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = DenseSolver(game).solve()
        torch.cuda.synchronize()
    tr = r.stats["trace"]
    print(f"\n5x5 stats['trace']: {json.dumps(tr)}")
    assert tr["backward"]["n"] == 26
    # 25 miss counts (the top level has none) and the root; no level's
    # download is waited for.
    assert tr["host_syncs"] == 26
    assert tr["pinned_downloads"] == 26
    # The root read that waits for the queued kernels and copies is the
    # drain inside dense_exit.
    assert 0 < tr["dense_drain"]["s"] <= tr["dense_exit"]["s"]
    # The warm solve's cells go into the first solve's blocks again. What
    # it may still pin is the level packs' staging (ops/dense_level
    # kernel_pack, each freed once its upload is enqueued), until the
    # cache holds as many blocks as the host has had in flight ahead of
    # the device: at most one block per level, at its rounded size.
    packs = sum(1 << (dense_level.kernel_pack(r._tables, L, False).nbytes
                      - 1).bit_length() for L in range(26))
    assert tr["pinned_alloc_bytes"] <= packs, (tr["pinned_alloc_bytes"],
                                               packs)
    path = tmp_path / "cuda_only.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]}
    assert not cats & {"user_annotation", "gpu_user_annotation"}, cats


_CPU_CELLS: dict = {}


def _cpu_cells(spec: str) -> dict:
    """Every level's cells of the board's dense solve on the CPU (the
    plain steps, no stream), solved once per test process."""
    if spec not in _CPU_CELLS:
        from gamesmanmpi_tpu_torch.games import get_game
        from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

        _CPU_CELLS[spec] = DenseSolver(get_game(spec),
                                       device="cpu").solve().cells
    return _CPU_CELLS[spec]


@pytest.mark.parametrize("spec", ["connect4:w=5,h=4", "connect4:w=5,h=5"])
def test_copies_on_their_stream_keep_the_cells_and_two_levels(spec,
                                                              monkeypatch):
    """Each level's copy on the solver's copy stream: every level's host
    cells are the CPU solve's, and the device holds two adjacent levels,
    the same peak as where every level goes down by the blocking pageable
    copy on the kernels' stream (no block pinned). Each solve starts from
    an empty device cache (a block the allocator hands out again may be
    larger than its request, and the peak counts the block), and its
    peak is taken above what was allocated before it (the first solver's
    level packs are gone before the second solve)."""
    _need_card()
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.solve import dense

    game = get_game(spec)
    dense.DenseSolver(game).solve()  # the board's reach counts, cached

    def solve_above_base():
        solver = dense.DenseSolver(game)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        stream = torch.cuda.current_stream()
        device = torch.cuda.current_device()
        result = solver.solve()
        # The copies' stream was current only while each copy was issued.
        assert torch.cuda.current_stream() == stream
        assert torch.cuda.current_device() == device
        return result, result.stats["peak_mem_bytes"] - base

    r, peak = solve_above_base()
    cpu = _cpu_cells(spec)
    assert sorted(r.cells) == sorted(cpu)
    for L, c in r.cells.items():
        assert torch.from_numpy(c).is_pinned(), L
        assert c.tobytes() == cpu[L].tobytes(), L
    empty = torch.empty

    def no_pin(*a, **k):
        if k.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return empty(*a, **k)

    monkeypatch.setattr(dense.torch, "empty", no_pin)
    pageable, pageable_peak = solve_above_base()
    monkeypatch.undo()
    assert not torch.from_numpy(pageable.cells[0]).is_pinned()
    t = r._tables
    sizes = [len(t.profiles[L]) * t.class_size[L]
             for L in range(t.ncells + 1)]
    two = max(a + b for a, b in zip(sizes, sizes[1:]))
    print(f"\n{spec}: peak {peak} B, pageable {pageable_peak} B, two "
          f"widest adjacent levels {two} B")
    assert two <= peak == pageable_peak


def test_a_kept_result_is_never_overwritten():
    """One result held while later solves run, each later solver's copies
    on a copy stream of its own: the kept cells are the CPU solve's,
    pinned, and stay byte for byte as they were; the later solves' cells
    are the same in blocks of their own."""
    _need_card()
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    game = get_game("connect4:w=5,h=5")
    DenseSolver(game).solve()  # its blocks go back to the cache
    kept = DenseSolver(game).solve()
    before = {L: c.copy() for L, c in kept.cells.items()}
    assert len(before) == 26
    cpu = _cpu_cells("connect4:w=5,h=5")
    for L, c in before.items():
        assert c.tobytes() == cpu[L].tobytes(), L
    for _ in range(2):
        later = DenseSolver(game).solve()
        for L, c in later.cells.items():
            assert c.ctypes.data != kept.cells[L].ctypes.data, L
            assert c.tobytes() == before[L].tobytes(), L
        del later
    for L, c in kept.cells.items():
        assert torch.from_numpy(c).is_pinned(), L
        assert c.tobytes() == before[L].tobytes(), L


def test_a_checkpointed_solve_seals_its_cells(tmp_path):
    """Each seal waits for its level alone and reads the bytes the
    result keeps: one host wait per sealed level in the hand count."""
    _need_card()
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.obs.tracing import (
        TraceEventSink,
        set_trace_sink,
    )
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
    from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

    game = get_game("connect4:w=5,h=5")
    ckpt = LevelCheckpointer(str(tmp_path / "ckpt"))
    prev = set_trace_sink(TraceEventSink())
    try:
        r = DenseSolver(game, checkpointer=ckpt).solve()
    finally:
        set_trace_sink(prev)
    tr = r.stats["trace"]
    assert tr["checkpoint"]["n"] == 26
    assert tr["host_syncs"] == 26 + 25 + 1
    assert tr["pinned_downloads"] == 0
    assert ckpt.dense_levels() == list(range(26))
    for L in range(26):
        assert torch.from_numpy(r.cells[L]).is_pinned(), L
        assert ckpt.load_dense_level(L).tobytes() == r.cells[L].tobytes(), L


def test_an_unpinnable_level_falls_back_to_the_pageable_copy(monkeypatch):
    """Where the host allocator cannot pin a level's block, the level
    goes down by the blocking pageable copy, one host wait each, into the
    same cells as the pinned path's."""
    _need_card()
    from gamesmanmpi_tpu_torch.games import get_game
    from gamesmanmpi_tpu_torch.obs.tracing import (
        TraceEventSink,
        set_trace_sink,
    )
    from gamesmanmpi_tpu_torch.solve import dense

    game = get_game("connect4:w=5,h=5")
    pinned = dense.DenseSolver(game).solve()
    empty = torch.empty

    def no_pin(*a, **k):
        if k.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return empty(*a, **k)

    monkeypatch.setattr(dense.torch, "empty", no_pin)
    prev = set_trace_sink(TraceEventSink())
    try:
        r = dense.DenseSolver(game).solve()
    finally:
        set_trace_sink(prev)
    monkeypatch.undo()
    tr = r.stats["trace"]
    assert tr["pinned_downloads"] == 0
    assert tr["host_syncs"] == 26 + 25 + 1
    for L in range(26):
        assert not torch.from_numpy(r.cells[L]).is_pinned(), L
        assert r.cells[L].tobytes() == pinned.cells[L].tobytes(), L
