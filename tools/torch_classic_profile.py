"""Where the torch port's classic (level-BFS) solve spends its time on the card.

    python tools/torch_classic_profile.py [--game connect4:w=5,h=5]
                                          [--out PATH.json]

Needs an NVIDIA card; exits 1 without one. One JSON line per phase on
stdout, and the full per-kernel table in --out when given:

1. warm — one solve as the CLI runs it (every level's table downloaded to
   the host): forward/backward seconds, positions/s, peak device memory.
2. ab — solves in turns: tables kept on the host or not (kept, dropped,
   dropped, kept), then the provenance backward against the lookup join
   (provenance, join, join, provenance, tables dropped): what the host
   downloads and the join cost end to end, on one card.
3. profile — one CLI-like solve under torch.profiler: device time by
   kernel name, grouped (sort, unique/scan, gather/index, copies to the
   host, elementwise), the device's busy share of the wall time, and the
   host's wait on a full launch queue.
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
from gamesmanmpi_tpu_torch.solve.engine import Solver  # noqa: E402

#: kernel-name fragments -> group, first match wins.
GROUPS = (
    ("copy to host", ("Memcpy DtoH",)),
    ("copy to device", ("Memcpy HtoD",)),
    ("sort", ("Radix", "radix", "Sort", "sort", "Merge", "merge")),
    ("unique/scan", ("unique", "Unique", "Scan", "scan", "adjacent")),
    ("gather/index", ("index", "Index", "gather", "Gather", "searchsorted")),
)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _group(name: str) -> str:
    for group, frags in GROUPS:
        if any(f in name for f in frags):
            return group
    return "elementwise/other"


def _solve(game, **kw) -> dict:
    r = Solver(game, **kw).solve()
    s = r.stats
    return {"secs_forward": s["secs_forward"],
            "secs_backward": s["secs_backward"],
            "positions_per_sec": s["positions_per_sec"],
            "peak_mem_bytes": s["peak_mem_bytes"], "misses": s["misses"],
            "positions": r.num_positions, "root": [r.value, r.remoteness]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--game", default="connect4:w=5,h=5")
    ap.add_argument("--out", default=None,
                    help="write the full per-kernel table here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_classic_profile: no CUDA device", file=sys.stderr)
        return 1
    game = get_game(args.game)
    name = torch.cuda.get_device_name(0)

    warm = _solve(game)
    print(json.dumps({"phase": "warm", "device": name, "game": game.name,
                      **warm}), flush=True)

    ab = []
    for keep in (True, False, False, True):
        ab.append({"store_tables": keep, **_solve(game, store_tables=keep)})
    for prov in (True, False, False, True):
        ab.append({"use_provenance": prov,
                   **_solve(game, store_tables=False, use_provenance=prov)})
    print(json.dumps({"phase": "ab", "device": name, "runs": ab}),
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        Solver(game).solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side rows only: a CPU op's row repeats the time of the
    # kernels it launched. CUPTI's "Command Buffer Full" row (the host
    # waiting for room in the launch queue) is not kernel time.
    rows, queue_full_us = [], 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if "Command Buffer Full" in evt.key:
            queue_full_us += us
        elif us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key, "group": _group(evt.key),
                         "device_us": us, "calls": evt.count})
    rows.sort(key=lambda r: -r["device_us"])
    busy_us = sum(r["device_us"] for r in rows)
    groups: dict = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["device_us"] / 1e6
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": name, "game": game.name,
                                   "wall_s": wall, "kernels": rows}, indent=1))
    print(json.dumps({
        "phase": "profile", "device": name, "wall_s_profiled": wall,
        "device_busy_s": busy_us / 1e6,
        "busy_share": busy_us / 1e6 / wall if wall else None,
        "groups_s": groups,
        "kernel_launches": sum(r["calls"] for r in rows),
        "launch_queue_full_s": queue_full_us / 1e6,
        "top": rows[:14],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
