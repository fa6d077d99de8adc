"""A traced dense solve on the card: the profiler's clock and the program's.

Marked `cuda`: skips without an NVIDIA card. Imports nothing of JAX; on
the machine with the card run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_dense_trace_cuda.py

- The CLI's 5x5 dense solve under --profile-dir and --trace-events: each
  level's device-to-host copy is issued inside that level's
  dense_download range of the profile and runs inside it (20 us of
  slack at each end), and each range of the profile lies inside its span
  of the --trace-events file (the same slack) and begins within 100 us
  of it. The device copies can be placed only where the profile's
  device clock keeps to its host clock: no copy may start more than the
  slack before the host call that issued it, nor end more than the slack
  after that call returns. Where CUPTI's conversion drifts (up to 5.0 ms
  early by half a second into a session on torch 2.11.0+cu128), that
  check fails first and names it.
- A profiler with CUDA activity alone (the benchmark's) turns the
  program's tracing on, records no range of its own, and the solve's
  count of blocking device reads meets its hand count.
"""

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
    copies = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     "Pageable" in e["name"])
                    for e in doc["traceEvents"]
                    if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])
    downloads = sorted(ranges["dense_download"])
    assert len(downloads) == 26
    pageable = [c for c in copies if c[2]]
    assert len(pageable) == 26, len(pageable)
    issued = sorted(_issuing_calls(doc, "Pageable"))
    assert len(issued) == 26, len(issued)
    for (a, b), (t, *_) in zip(downloads, issued):
        assert a <= t <= b, (a, t, b)
    early = max(t0 - s for t0, _, s, _ in issued)
    late = max(e - t1 for _, t1, _, e in issued)
    assert early <= SLACK_US and late <= SLACK_US, (
        f"a download's copy starts up to {early:.1f} us before the host "
        f"call that issued it, or ends up to {late:.1f} us after the call "
        f"returns: the profile's device clock has drifted from its host "
        f"clock in this session")
    first, last = [], []
    for i, (a, b) in enumerate(downloads):
        mine_copies = [(s, t) for s, t, _ in copies
                       if a - SLACK_US <= s <= b + SLACK_US]
        near = [(round(s - a, 3), round(t - a, 3), p) for s, t, p in copies
                if a - 50_000 <= s <= b + 50_000]
        assert len(mine_copies) == 1, (i, round(b - a, 3), near)
        s, t = mine_copies[0]
        assert a - SLACK_US <= s and t <= b + SLACK_US, (i, a, b, s, t)
        first.append(s - a)
        last.append(b - t)
    print(f"\ndownloads in their spans: 26 of 26; copy start after span "
          f"start {min(first):.3f}..{max(first):.3f} us, span end after "
          f"copy end {min(last):.3f}..{max(last):.3f} us")
    _assert_overlay(mine, ranges)


def _issuing_calls(doc, kind: str) -> list:
    """(host call start, its return, copy start, copy end) of each
    device-to-host copy of `kind` in the profile, joined to its call by
    correlation id."""
    host = {e["args"]["correlation"]: (float(e["ts"]),
                                       float(e["ts"]) + float(e["dur"]))
            for e in doc["traceEvents"]
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    return [(*host[e["args"]["correlation"]], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
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
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    game = get_game("connect4:w=5,h=5")
    DenseSolver(game).solve()  # kernels built, counts cached
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = DenseSolver(game).solve()
        torch.cuda.synchronize()
    tr = r.stats["trace"]
    print(f"\n5x5 stats['trace']: {json.dumps(tr)}")
    assert tr["backward"]["n"] == 26
    # 26 downloads, 25 miss counts (the top level has none), the root.
    assert tr["host_syncs"] == 52
    path = tmp_path / "cuda_only.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]}
    assert not cats & {"user_annotation", "gpu_user_annotation"}, cats
