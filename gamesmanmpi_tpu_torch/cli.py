"""Command line of the torch port: the `solve` subcommand.

    gamesman-solve-torch solve GAME [--engine auto|dense|classic]
                         [--device cuda|cpu] [--no-tables] [--paranoid]
                         [--table-out PATH] [--checkpoint-dir DIR]
                         [--query POS]...
    python -m gamesmanmpi_tpu_torch.cli solve connect4:w=5,h=5

It prints the reference CLI's rank-0 block (gamesmanmpi_tpu/cli.py
`_report`): game, devices, positions, value, remoteness, elapsed,
throughput, the table file, and one line per --query. The solve runs on
the card unless --device cpu is given; without a card it exits 2 with a
message.

Engines, routed as the reference routes one device: `dense` takes a
Connect-4 board with sym=0 and no --paranoid/--table-out; `classic` (the
level-BFS engine) takes every game; `auto` picks dense where it is
eligible, the solve runs on the card and no --checkpoint-dir is given,
classic otherwise. GameSpec ``.json`` files are not ported yet and exit 2.

--checkpoint-dir seals every solved level into DIR (the reference's
directory format: either package resumes the other's) and a rerun on the
same DIR resumes from what is sealed. Only a checkpointed solve installs
the preemption grace handlers: SIGTERM/SIGUSR1 stop it at the next level
boundary with "preempted: ..." on stderr and exit 75. With --no-tables,
--query answers from the directory's files. GAMESMAN_FAULTS arms fault
points (resilience/faults.py): an injected kill exits 77, a torn seal 86.

It returns 0 once solved, 75 when preempted, and 2 on a usage error, an
unknown or not-yet-ported game, an engine the game cannot take, a bad
GAMESMAN_FAULTS, or a missing CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from gamesmanmpi_tpu_torch.core.values import value_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gamesman-solve-torch",
        description="Strong solver for two-player games (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("solve", help="solve a game and print the root block")
    s.add_argument("game", help="game spec, e.g. connect4:w=5,h=5")
    s.add_argument(
        "--engine", choices=("auto", "dense", "classic"), default="auto",
        help="'classic' = level-BFS engine (every game); 'dense' = "
        "class-partitioned perfect-indexing engine (Connect-4 family, "
        "sym=0); 'auto' picks dense when eligible on the card")
    s.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the solve runs (default: the card)")
    s.add_argument(
        "--no-tables", action="store_true",
        help="keep only the root on the host (queries then answer "
        "'not reachable')")
    s.add_argument(
        "--paranoid", action="store_true",
        help="classic engine: sync and check each level's consistency "
        "counter, raising on the first miss")
    s.add_argument(
        "--table-out", default=None, metavar="PATH",
        help="dump the full solved table as .npz (packed cells per level)")
    s.add_argument(
        "--checkpoint-dir", default=None, metavar="DIR",
        help="seal each solved level into DIR and resume from what DIR "
        "holds (routes auto to the classic engine; dense on request)")
    s.add_argument(
        "--query", action="append", default=None, metavar="POS",
        help="after solving, print the value/remoteness of this packed "
        "position (decimal or 0x-hex; repeatable)")
    return p


def _report(result, devices: int, elapsed: float, args) -> None:
    """The rank-0 output block, line for line the reference's."""
    print(f"game: {result.game.name}")
    print(f"devices: {devices}")
    print(f"positions: {result.num_positions}")
    print(f"value: {value_name(result.value)}")
    print(f"remoteness: {result.remoteness}")
    print(f"elapsed: {elapsed:.3f}s")
    print(
        f"throughput: {result.stats['positions_per_sec']:.0f} positions/sec"
    )
    if args.table_out:
        from gamesmanmpi_tpu_torch.utils.checkpoint import save_result_npz

        save_result_npz(args.table_out, result)
        print(f"table written: {args.table_out}")
    ckpt = None
    if args.query and args.checkpoint_dir:
        from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

        ckpt = LevelCheckpointer(args.checkpoint_dir)
    for q in args.query or ():
        try:
            state = int(q, 0)
            try:
                value, rem = result.lookup(state)
            except KeyError:
                # --no-tables keeps only the root on the host, but a
                # checkpointed solve has every solved cell on disk.
                hit = (_lookup_checkpoint(result.game, ckpt, state)
                       if ckpt is not None else None)
                if hit is None:
                    print(f"query {q}: not reachable")
                    continue
                value, rem = hit
            print(f"query {q}: value={value_name(value)} remoteness={rem}")
        except (ValueError, OverflowError) as e:
            print(f"query {q}: invalid position ({e})")


def _lookup_checkpoint(game, checkpointer, state):
    """(value, remoteness) of one position from a checkpoint directory, or
    None. Dense directories locate the cell by perfect index in one
    dense_NNNN.npz; classic ones canonicalize and level the query as the
    engine does, then probe that level's file.

    Never raises: the solve already succeeded, so an unreadable file
    degrades this one query to unanswerable."""
    try:
        dense_levels = checkpointer.load_manifest().get("dense_levels")
        if dense_levels:
            from gamesmanmpi_tpu_torch.solve.dense import tables_for

            t = tables_for(game.width, game.height, game.connect)
            level, row, rank = t.locate(int(state))
            if (level not in dense_levels
                    or t.current_player_has_line(level, row, rank)):
                # Never solved (interrupted run), or a placeholder cell
                # (the player to move already has a line).
                return None
            cache = getattr(checkpointer, "_dense_query_cache", None)
            if cache is not None and cache[0] == level:
                cells = cache[1]
            else:
                # The last level read is memoized: queries cluster.
                cells = checkpointer.load_dense_level(level)
                checkpointer._dense_query_cache = (level, cells)
            cell = int(cells[row * t.class_size[level] + rank])
            return cell & 3, cell >> 2
        from gamesmanmpi_tpu_torch.solve.engine import canonical_scalar

        canon, level = canonical_scalar(game, state)
        return checkpointer.lookup_level_state(level, canon)
    except Exception as e:  # noqa: BLE001 - per-query degradation
        print(f"warning: checkpoint query failed ({e!r})", file=sys.stderr)
        return None


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def solve_main(argv=None) -> tuple[int, Optional[object]]:
    """main() that also hands back the solve result (None on error)."""
    from gamesmanmpi_tpu_torch.games import Connect4, NotPortedError, get_game
    from gamesmanmpi_tpu_torch.resilience import faults, preempt
    from gamesmanmpi_tpu_torch.utils.device import (
        DeviceUnavailable,
        resolve_device,
    )

    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    t0 = time.perf_counter()
    try:
        faults.configure_from_env()
    except ValueError as e:
        return _error(f"GAMESMAN_FAULTS: {e}"), None
    try:
        game = get_game(args.game)
    except NotPortedError as e:
        return _error(str(e)), None
    except (KeyError, ValueError) as e:
        return _error(f"bad game spec {args.game!r}: {e}"), None
    family_base = (isinstance(game, Connect4) and not game.sym
                   and not args.paranoid and not args.table_out)
    # An explicit --engine dense accepts --checkpoint-dir (per-level cell
    # restart); auto routes a checkpointed solve to the classic engine.
    dense_eligible = (family_base if args.engine == "dense"
                      else family_base and not args.checkpoint_dir)
    if args.engine == "dense" and not dense_eligible:
        return _error(
            "--engine dense needs a Connect-4-family game with sym=0 and "
            "no --paranoid/--table-out (those live in the classic "
            "engine)"), None
    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        return _error(str(e)), None

    checkpointer = None
    if args.checkpoint_dir:
        from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

        checkpointer = LevelCheckpointer(args.checkpoint_dir)
    # Same platform policy as the reference: the dense engine is the
    # accelerator's pick; on the CPU, auto runs the classic engine.
    if args.engine == "dense" or (args.engine == "auto" and dense_eligible
                                  and device.type == "cuda"):
        from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

        solver = DenseSolver(game, store_tables=not args.no_tables,
                             device=device, checkpointer=checkpointer)
    else:
        from gamesmanmpi_tpu_torch.solve.engine import Solver

        solver = Solver(game, device=device, paranoid=args.paranoid,
                        store_tables=not args.no_tables,
                        checkpointer=checkpointer)
    # Only a checkpointed solve gets the grace handlers: exit 75 promises
    # "rerun me on the same directory", and a solve with nothing sealed
    # should keep dying promptly on SIGTERM.
    restore_grace = (preempt.install_grace_handler()
                     if checkpointer is not None else (lambda: None))
    try:
        result = solver.solve()
    except preempt.PreemptionRequested as e:
        print(f"preempted: {e}", file=sys.stderr)
        sys.stderr.flush()
        return preempt.GRACE_EXIT_CODE, None
    finally:
        restore_grace()
    _report(result, 1, time.perf_counter() - t0, args)
    return 0, result


def main(argv=None) -> int:
    return solve_main(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
