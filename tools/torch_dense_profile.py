"""Where the torch port's dense solve spends its time on the card.

    python tools/torch_dense_profile.py [--game connect4:w=5,h=5]
                                        [--out chiprun_out/torch_dense_profile.json]

Needs an NVIDIA card; exits 1 without one. One JSON line per phase on
stdout, the full per-kernel table in --out:

1. warm — builds the kernels, then one window-gather solve (backward and
   the reachability sweep, which is then cached in-process), with its
   per-level window-gather misses.
2. ab — backward-only solves in turns plain, window, window, plain: the
   gather kernel against the torch index, end to end, on one card.
3. profile — one window-gather backward under torch.profiler: device time
   by kernel name, the window-gather kernel's share, the device's busy
   share of the wall time, and how long the host waited on a full launch
   queue (a sign that the device, not the host, sets the pace).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gamesmanmpi_tpu_torch.games import get_game  # noqa: E402
from gamesmanmpi_tpu_torch.kernels import build  # noqa: E402
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--game", default="connect4:w=5,h=5")
    ap.add_argument("--out", default="chiprun_out/torch_dense_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dense_profile: no CUDA device", file=sys.stderr)
        return 1
    game = get_game(args.game)
    name = torch.cuda.get_device_name(0)
    build.build_all()

    warm = DenseSolver(game).solve()
    s = warm.stats
    print(json.dumps({
        "phase": "warm", "device": name, "game": game.name,
        "positions": warm.num_positions,
        "root": [warm.value, warm.remoteness],
        "secs_backward": s["secs_backward"],
        "secs_count_reachable": s["secs_count_reachable"],
        "gather_nmiss": s["gather_nmiss"],
        "gather_nmiss_per_level": s["gather_nmiss_per_level"],
        "peak_mem_bytes": s["peak_mem_bytes"],
    }), flush=True)

    ab = []
    for mode in ("plain", "window", "window", "plain"):
        r = DenseSolver(game, store_tables=False, gather_mode=mode).solve()
        ab.append({"gather_mode": mode,
                   "secs_backward": r.stats["secs_backward"]})
    print(json.dumps({"phase": "ab", "device": name, "runs": ab}),
          flush=True)

    solver = DenseSolver(game, store_tables=False)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side rows only: a CPU op's row repeats the time of the
    # kernels it launched. CUPTI's "Command Buffer Full" overhead row
    # (the host waiting for room in the launch queue) is not kernel time.
    rows, queue_full_us = [], 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if "Command Buffer Full" in evt.key:
            queue_full_us += us
        elif us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "device_us": us,
                         "calls": evt.count})
    rows.sort(key=lambda r: -r["device_us"])
    busy_us = sum(r["device_us"] for r in rows)
    gather_us = sum(r["device_us"] for r in rows
                    if "window_gather_kernel" in r["name"])
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": name, "game": game.name,
                               "wall_s": wall, "kernels": rows}, indent=1))
    print(json.dumps({
        "phase": "profile", "device": name, "wall_s_profiled": wall,
        "device_busy_s": busy_us / 1e6,
        "busy_share": busy_us / 1e6 / wall if wall else None,
        "window_gather_s": gather_us / 1e6,
        "window_gather_share_of_busy": gather_us / busy_us if busy_us else None,
        "kernel_launches": sum(r["calls"] for r in rows),
        "launch_queue_full_s": queue_full_us / 1e6,
        "top": rows[:12],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
