"""The control of the benchmark's comparison: the plain reference put in
the program's place at a lower precision, which the comparison has to
reject.

    python3 h100bench/control.py --workload CELL --seeds A,B,C [--seconds S]

The configurations state an exact strong solve: every value and
remoteness exact, remoteness held in 6 bits. The control keeps remoteness
in one bit fewer than the board's deepest game needs (4 bits at 5x5,
saturating at 15, where remoteness reaches 25): the step a cheaper table
would take. Its output takes the program's form (a solve's cells, judged
on the reachable positions as every engine's output is, or the answers
to a window's queries at the cell's rate) and goes through the same
check the runs use; each line
printed gives the numbers compared and their limits. Not part of a
benchmark run; it needs no program, and runs on the card when there is
one (CPU otherwise).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import loadgen  # noqa: E402
import reference  # noqa: E402


def control_bits(board: reference.Board) -> int:
    """One bit fewer than the deepest game (ncells plies) needs."""
    return board.ncells.bit_length() - 1


def answers(board: reference.Board, sol: reference.Solution, states):
    """What a server over `sol`'s tables answers: value names, remoteness,
    and the best child by sol's own values."""
    s = torch.as_tensor(states, dtype=torch.int64).to(board.device)
    cell, _ = reference.lookup(board, sol, s)
    kids, legal = board.children(s)
    kcell, kok = reference.lookup(board, sol, kids.reshape(-1))
    kv = (kcell & 3).reshape(kids.shape)
    kr = (kcell >> 2).reshape(kids.shape)
    legal &= kok.reshape(kids.shape)
    v = cell & 3
    need = torch.tensor([0, reference.LOSE, reference.WIN, reference.TIE],
                        device=board.device)[v]
    fit = legal & (kv == need[:, None])
    key = torch.where(v[:, None] == reference.WIN, kr, -kr)
    key = torch.where(fit, key, 1 << 40)
    pick = key.argmin(1)
    best = kids.gather(1, pick[:, None])[:, 0]
    has = fit.any(1)
    names = [reference.VALUE_NAMES.get(int(x), "?") for x in v.tolist()]
    return (names, (cell >> 2).tolist(),
            [int(b) if h else None for b, h in zip(best.tolist(),
                                                    has.tolist())])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--root", default=str(HERE.parent))
    args = ap.parse_args(argv)
    root = Path(args.root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = json.loads((root / "h100bench" / "workloads"
                       / f"{args.workload}.json").read_text())
    config = json.loads((root / "h100bench" / "configs"
                         / f"{cell['config']}.json").read_text())
    mix = json.loads((root / "h100bench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    w, h, connect = reference.parse_connect4(config["game"])
    board = reference.Board(w, h, connect, device=device)
    ref = board.solve()
    bits = control_bits(board)
    ctl = board.solve(remoteness_bits=bits)
    for seed in (int(x) for x in args.seeds.split(",")):
        if mix["kind"] == "http_query":
            seed = seed % 2 ** 63
            pool = loadgen.playout_pool(reference.Board(w, h, connect),
                                        int(mix["pool"]), seed)
            _, batches = loadgen.requests(pool, mix, float(cell["rate_qps"]),
                                          seconds,
                                          np.random.default_rng(seed + 1))
            q = batches.reshape(-1)
            names, rems, bests = answers(board, ctl, q)
            checks = {"answer_mismatches": reference.check_answers(
                board, ref, q, names, rems, bests)}
        else:
            # A solve's tables in any form (cells or per-level tables)
            # are judged on the same reachable positions: one count.
            checks = {"position_mismatches": reference.check_solve(
                board, ref, ctl.cells, None, device)}
        if mix["kind"] == "solve_loop":
            checks["root_mismatch"] = int((ctl.value, ctl.remoteness)
                                          != (ref.value, ref.remoteness))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_remoteness_bits": bits,
                          "checks": {k: {"value": v, "limit": 0}
                                     for k, v in checks.items()},
                          "rejected": any(v > 0 for v in checks.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
