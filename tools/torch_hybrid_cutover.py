"""The torch port's hybrid engine across cutovers, on the card.

    python tools/torch_hybrid_cutover.py [--game connect4:w=5,h=5]
                                         [--cutovers 8,12,14,16,18,20,22]

Needs an NVIDIA card; exits 1 without one. Builds the kernels, solves the
board once with the dense and once with the classic engine (warm-up and
the yardsticks), then the hybrid at each cutover K, in turns up and down
the list (each K twice), with tables kept on the host as the CLI keeps
them. One JSON line per solve: the seconds of each hybrid phase (the
reach sweep to K+1, the frontier extraction, the BFS region, the
boundary join, the dense levels K-1..0), the positions in each region,
the window gather's launches and the peak device memory; then the
median total per K and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gamesmanmpi_tpu_torch import kernels  # noqa: E402
from gamesmanmpi_tpu_torch.bench.kernel_cases import (  # noqa: E402
    nvidia_smi_line,
)
from gamesmanmpi_tpu_torch.games import get_game  # noqa: E402
from gamesmanmpi_tpu_torch.kernels import build  # noqa: E402
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver  # noqa: E402
from gamesmanmpi_tpu_torch.solve.engine import Solver  # noqa: E402
from gamesmanmpi_tpu_torch.solve.hybrid import HybridSolver  # noqa: E402


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--game", default="connect4:w=5,h=5")
    p.add_argument("--cutovers", default="8,12,14,16,18,20,22")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_hybrid_cutover: needs an NVIDIA card", file=sys.stderr)
        return 1
    build.build_all()
    game = get_game(args.game)
    d = DenseSolver(game).solve()
    emit(engine="dense", secs_backward=d.stats["secs_backward"],
         secs_count_reachable=d.stats["secs_count_reachable"],
         peak_mem_bytes=d.stats["peak_mem_bytes"])
    del d
    c = Solver(game).solve()
    emit(engine="classic", secs_forward=c.stats["secs_forward"],
         secs_backward=c.stats["secs_backward"],
         peak_mem_bytes=c.stats["peak_mem_bytes"])
    del c
    cutovers = [int(k) for k in args.cutovers.split(",")]
    totals = {K: [] for K in cutovers}
    for K in cutovers + cutovers[::-1]:
        kernels.reset_launches()
        h = HybridSolver(game, cutover=K).solve()
        s = h.stats
        rest = (s["secs_total"] - s["secs_forward"] - s["secs_bfs"]
                - s["secs_boundary"])
        emit(engine="hybrid", cutover=K, value=h.value,
             remoteness=h.remoteness, positions=h.num_positions,
             secs_total=s["secs_total"], secs_reach=s["secs_reach"],
             secs_extract=s["secs_forward"] - s["secs_reach"],
             secs_bfs=s["secs_bfs"], secs_boundary=s["secs_boundary"],
             secs_dense_below=rest,
             positions_dense_region=s["positions_dense_region"],
             positions_bfs_region=s["positions_bfs_region"],
             frontier_at_boundary=s["frontier_at_boundary"],
             gather_launches=kernels.LAUNCHES["monotone_window_gather"],
             peak_mem_bytes=s["peak_mem_bytes"])
        totals[K].append(s["secs_total"])
        del h
    emit(median_secs_total={K: statistics.median(v)
                            for K, v in totals.items()},
         device=nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
