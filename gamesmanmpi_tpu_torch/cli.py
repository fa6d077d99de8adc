"""Command line of the torch port: `solve`, `export-db`, `query` and
`serve`.

    gamesman-solve-torch solve GAME [--engine auto|dense|classic|hybrid]
                         [--hybrid-cutover K]
                         [--device cuda|cpu] [--no-tables] [--paranoid]
                         [--table-out PATH] [--checkpoint-dir DIR]
                         [--query POS]... [--devices N]
                         [--coordinator HOST:PORT --num-processes P
                          --process-id I]
    gamesman-solve-torch solve path/to/module.py [--device cuda|cpu] ...
    gamesman-solve-torch export-db GAME --out DIR [--from-checkpoint DIR]
                         [--overwrite] [--compress] [--book-plies N]
                         [--device cuda|cpu]
    gamesman-solve-torch query DB POS... [--device cuda|cpu]
    gamesman-solve-torch serve DB [--workers N] [--fleet-manifest F]
                         [--control-port P] [--port P] [--device cuda|cpu]
    python -m gamesmanmpi_tpu_torch.cli solve connect4:w=5,h=5

`solve` prints the reference CLI's rank-0 block (gamesmanmpi_tpu/cli.py
`_report`): game, devices, positions, value, remoteness, elapsed,
throughput, the table file, and one line per --query. A path to a
reference-style game module is solved the reference's compat way: by
the host oracle, or, when the module declares `level_of`, on the
classic engine through compat.TensorizedModule (`--engine dense` exits
2 there).

Engines, routed as the reference routes them: `dense` takes a Connect-4
board with sym=0 and no --paranoid/--table-out; `hybrid` (solve/
hybrid.py: dense up to --hybrid-cutover K, level-BFS above) takes any
Connect-4 board, sym=1 included, and no --checkpoint-dir/--paranoid/
--table-out, and a cutover outside [0, cells) exits 2; `classic` (the
level-BFS engine) takes every game; `auto` picks dense where it is
eligible, the solve runs on the card on one device and no
--checkpoint-dir is given, classic otherwise. Compat modules refuse
`dense` and `hybrid`. GameSpec ``.json`` files are not ported yet and
exit 2.

--devices N (N > 1) runs the hash-partitioned sharded engine
(parallel/sharded.py) over N shards, for `auto` and `classic` and for a
compat module with `level_of`: in one process on the visible cards
(sharing one card needs GAMESMAN_FAKE_DEVICES >= N), or across a
``torch.distributed`` world of processes set by --coordinator,
--num-processes and --process-id or their GAMESMAN_* env twins
(parallel/launch.py starts one). In a world --table-out becomes
rank-qualified (``T.rank<i>.npz``, every rank writes the same global
table), GAMESMAN_COORD_ADDR defaults to the coordinator's port+1 (the
retry consensus), rank 0 stamps and seals the checkpoint and every
metric carries a ``rank`` label. `--engine dense --devices N` splits
every dense level step's lanes over N shards in one process, and
`--engine hybrid --devices N` adds the sharded BFS above the cutover;
both are single-controller and exit 2 in a world. A world that agrees
to abort, or loses a peer, exits 124 with its sealed prefix resumable.

--checkpoint-dir seals every solved level into DIR (the reference's
directory format: either package resumes the other's, one device or
sharded, at another shard count too unless GAMESMAN_RESHARD=0) and a
rerun on the same DIR resumes from what is sealed. Only a checkpointed
solve installs the preemption grace handlers: SIGTERM/SIGUSR1 stop it at
the next level boundary with "preempted: ..." on stderr and exit 75 (in
a world every rank stops at the same boundary). With --no-tables,
--query answers from the directory's files. GAMESMAN_FAULTS arms fault
points (resilience/faults.py): an injected kill exits 77, a torn seal 86.

`export-db` writes a solved-position database (db/), the reference's
format byte for byte: from a fresh classic solve streamed level by level
into the writer, or converted from a classic --checkpoint-dir
(--from-checkpoint). --compress (default GAMESMAN_DB_COMPRESS) writes
format v2; --book-plies (default GAMESMAN_BOOK_PLIES) seals an opening
book. `query` answers positions from a database, each with its best
move, the reference's lines. `serve` answers queries over HTTP, the
reference's endpoints, bodies and status codes (serve/server.py): one
in-process server, or with --workers N (or --fleet-manifest) a
supervised fleet of N worker processes on one port (serve/supervisor.py),
whose readers run on --device after the fork.

Every command runs on the card unless --device cpu is given; without a
card it exits 2 with a message. It returns 0 on success, 75 when
preempted, and 2 on a usage error, an unknown or not-yet-ported game, an
engine the game cannot take, an invalid game module or database, a bad
GAMESMAN_FAULTS, or a missing CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import Optional

from gamesmanmpi_tpu_torch.core.values import value_name


def _device_arg(p, what: str) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help=f"where {what} runs (default: the card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gamesman-solve-torch",
        description="Strong solver for two-player games (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("solve", help="solve a game and print the root block")
    s.add_argument("game", help="game spec, e.g. connect4:w=5,h=5, or a "
                   "path to a reference-style game module")
    s.add_argument(
        "--engine", choices=("auto", "dense", "classic", "hybrid"),
        default="auto",
        help="'classic' = level-BFS engine (every game); 'dense' = "
        "class-partitioned perfect-indexing engine (Connect-4 family, "
        "sym=0); 'hybrid' = dense below --hybrid-cutover, BFS above "
        "(Connect-4 family); 'auto' picks dense when eligible on the card")
    s.add_argument(
        "--hybrid-cutover", type=int, default=None, metavar="K",
        help="last dense level of --engine hybrid (default "
        "GAMESMAN_HYBRID_CUTOVER, else 2/3 of the board's cells)")
    _device_arg(s, "the solve")
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
    s.add_argument(
        "--devices", type=int, default=1, metavar="N",
        help="shards to partition the solve over (1 = one device; N > 1 "
        "= the sharded engine; one card holds N shards when "
        "GAMESMAN_FAKE_DEVICES >= N)")
    s.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="rendezvous of a multi-process run's torch.distributed "
        "group (env GAMESMAN_COORDINATOR)")
    s.add_argument(
        "--num-processes", type=int, default=None,
        help="processes in the run (env GAMESMAN_NUM_PROCESSES)")
    s.add_argument(
        "--process-id", type=int, default=None,
        help="this process's rank in [0, num-processes) (env "
        "GAMESMAN_PROCESS_ID)")

    e = sub.add_parser(
        "export-db",
        help="build an immutable DB from a fresh solve or a checkpoint dir")
    e.add_argument("game", help="built-in game spec")
    e.add_argument("--out", required=True, help="DB output directory")
    e.add_argument(
        "--from-checkpoint", default=None, metavar="DIR",
        help="convert an existing classic --checkpoint-dir instead of "
        "re-solving")
    e.add_argument("--overwrite", action="store_true",
                   help="replace an existing DB in --out")
    e.add_argument(
        "--compress", action="store_true", default=None,
        help="write format v2: block-compressed levels, decoded per "
        "probed block (default from GAMESMAN_DB_COMPRESS)")
    e.add_argument(
        "--book-plies", type=int, default=None, metavar="N",
        help="also seal the opening book: every position within N plies "
        "of the initial position, scored through the finished DB "
        "(default from GAMESMAN_BOOK_PLIES; 0 = no book)")
    _device_arg(e, "the solve and the book")

    q = sub.add_parser("query", help="probe a DB offline (no server)")
    q.add_argument("db", help="DB directory (from export-db)")
    q.add_argument("positions", nargs="+",
                   help="packed positions, decimal or 0x-hex")
    _device_arg(q, "canonicalization")

    ps = sub.add_parser(
        "serve", help="serve POST /query, GET /healthz, GET /metrics")
    ps.add_argument("db", nargs="?", default=None,
                    help="DB directory (from export-db); omit when "
                    "--fleet-manifest names the DBs")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8947,
                    help="0 = ephemeral (the bound port is printed)")
    ps.add_argument(
        "--workers", type=int, default=None, metavar="N",
        help="fleet mode: supervise N worker processes sharing this "
        "port's accept queue (heartbeat liveness, backoff restart, "
        "rolling reload; docs/SERVING.md). 0/unset = single in-process "
        "server (env GAMESMAN_SERVE_WORKERS)")
    ps.add_argument(
        "--fleet-manifest", default=None, metavar="FILE",
        help="route multiple game DBs from one fleet manifest JSON "
        '({"version": 1, "games": [{"name": ..., "db": ...}]}); '
        "POST /query/<name> selects the game. Implies fleet mode; "
        "SIGHUP or POST /reload on the control port rolls the fleet "
        "onto a re-read manifest")
    ps.add_argument(
        "--control-port", type=int, default=0, metavar="P",
        help="fleet mode: supervisor control endpoint port (fleet-level "
        "GET /healthz aggregating per-worker state, GET /metrics, "
        "POST /reload); 0 = ephemeral (printed in the banner)")
    ps.add_argument(
        "--batch-window-ms", type=float, default=2.0,
        help="micro-batch coalescing window: concurrent requests arriving "
        "within it flush as ONE vectorized DB probe")
    ps.add_argument("--cache-size", type=int, default=65536,
                    help="LRU hot-position cache entries (0 disables)")
    ps.add_argument(
        "--request-timeout-ms", type=float, default=None,
        help="per-request deadline on the batcher: a request not "
        "answered within it gets 503 + Retry-After instead of hanging "
        "(env GAMESMAN_REQUEST_TIMEOUT in seconds; 0 = no deadline)")
    ps.add_argument(
        "--max-queue", type=int, default=1024,
        help="load shedding: refuse (503) new queries when this many "
        "requests are already parked in the coalescing queue")
    ps.add_argument("--jsonl", default=None,
                    help="write per-batch serving metrics to this JSONL file")
    ps.add_argument(
        "--no-trace", action="store_true",
        help="disable query-path tracing + tail sampling (sets "
        "GAMESMAN_TRACE=0 for this process and, in fleet mode, every "
        "worker; GET /traces then serves an empty ring)")
    ps.add_argument("-v", "--verbose", action="store_true")
    _device_arg(ps, "canonicalization and best-move expansion")
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


def _device(name: str, fork_safe: bool = False):
    """-> (torch.device, None), or (None, exit code 2) without the card."""
    from gamesmanmpi_tpu_torch.utils.device import (
        DeviceUnavailable,
        resolve_device,
    )

    try:
        if fork_safe:
            return resolve_device(name, fork_safe=True), None
        return resolve_device(name), None
    except DeviceUnavailable as e:
        return None, _error(str(e))


def _get_game(spec: str):
    """-> (game, None), or (None, exit code 2) for a bad or unported spec."""
    from gamesmanmpi_tpu_torch.games import NotPortedError, get_game

    try:
        return get_game(spec), None
    except NotPortedError as e:
        return None, _error(str(e))
    except (KeyError, ValueError) as e:
        return None, _error(f"bad game spec {spec!r}: {e}")


def solve_main(argv=None) -> tuple[int, Optional[object]]:
    """main() that also hands back the solve's SolveResult (None on an
    error, for an oracle-solved module, and for export-db and query)."""
    from gamesmanmpi_tpu_torch.resilience import faults

    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    t0 = time.perf_counter()
    try:
        faults.configure_from_env()
    except ValueError as e:
        return _error(f"GAMESMAN_FAULTS: {e}"), None
    if args.command == "export-db":
        return _export_db(args, t0), None
    if args.command == "query":
        return _query(args), None
    if args.command == "serve":
        return _serve(args), None
    if (pathlib.Path(args.game).is_file()
            and not args.game.lower().endswith(".json")):
        return _solve_module(args, t0)
    return _solve(args, t0)


def _rank_path(path: str, rank: int) -> str:
    """``out.npz`` -> ``out.rank0.npz``: ranks never race onto one file."""
    import os

    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def _join_world(args, device) -> tuple[int, Optional[int]]:
    """Join the process group when a coordinator is given (flag, then env
    GAMESMAN_COORDINATOR) -> (world size, None), or (0, exit code 2).

    Then the reference's rank plumbing: a rank-qualified --table-out,
    GAMESMAN_COORD_ADDR defaulting to the coordinator's host at port+1
    (the retry consensus), and a ``rank`` label on every metric."""
    import os

    from gamesmanmpi_tpu_torch.parallel.mesh import (
        init_distributed,
        process_identity,
    )
    from gamesmanmpi_tpu_torch.utils.env import env_opt

    coordinator, world, rank = process_identity(
        args.coordinator, args.num_processes, args.process_id)
    if not coordinator:
        return 1, None
    if (args.num_processes is None
            and env_opt("GAMESMAN_NUM_PROCESSES") is None) or (
            args.process_id is None
            and env_opt("GAMESMAN_PROCESS_ID") is None):
        return 0, _error("a coordinator (--coordinator / "
                         "GAMESMAN_COORDINATOR) requires --num-processes and "
                         "--process-id (or their GAMESMAN_* env twins)")
    if args.devices < world or args.devices % world:
        return 0, _error(f"--devices {args.devices} must be a multiple of "
                         f"the {world} processes")
    backend = init_distributed(device, coordinator, world, rank)
    print(f"world: rank {rank} of {world}, backend {backend}",
          file=sys.stderr, flush=True)
    if world <= 1:
        return world, None
    if args.table_out:
        args.table_out = _rank_path(args.table_out, rank)
    if not env_opt("GAMESMAN_COORD_ADDR"):
        host, _, port = coordinator.rpartition(":")
        try:
            os.environ["GAMESMAN_COORD_ADDR"] = (
                f"{host or '127.0.0.1'}:{int(port) + 1}")
        except ValueError:
            pass  # unparsable port: coordination stays unconfigured
    from gamesmanmpi_tpu_torch.obs import default_registry

    default_registry().set_constant_labels(rank=str(rank))
    return world, None


def _sharded_solver(game, args, device, checkpointer):
    """The sharded engine over --devices shards -> (solver, None), or
    (None, exit code 2) when the shards do not fit the devices."""
    from gamesmanmpi_tpu_torch.parallel import ShardedSolver

    try:
        return ShardedSolver(game, num_shards=args.devices, device=device,
                             paranoid=args.paranoid,
                             store_tables=not args.no_tables,
                             checkpointer=checkpointer), None
    except ValueError as e:
        return None, _error(str(e))


def _single_controller(args) -> Optional[int]:
    """Exit 2 for --engine dense/hybrid in a world: their meshes span one
    process's shards, as the reference's span one controller's devices."""
    from gamesmanmpi_tpu_torch.parallel.mesh import process_identity

    coordinator, world, _ = process_identity(
        args.coordinator, args.num_processes, args.process_id)
    if coordinator and world > 1:
        return _error(f"--engine {args.engine} is single-controller: run "
                      "it in one process (--devices N shards it there), "
                      "not in a world of processes")
    return None


def _solve(args, t0: float) -> tuple[int, Optional[object]]:
    from gamesmanmpi_tpu_torch.games import Connect4

    game, rc = _get_game(args.game)
    if game is None:
        return rc, None
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
    # The hybrid takes sym=1: its BFS region keeps the mirror reduction
    # and its dense region runs a sym-free twin (solve/hybrid.py).
    if args.engine == "hybrid" and not (
            isinstance(game, Connect4) and not args.paranoid
            and not args.table_out and not args.checkpoint_dir):
        return _error(
            "--engine hybrid needs a Connect-4-family game and no "
            "--checkpoint-dir/--paranoid/--table-out (those live in the "
            "classic engine)"), None
    if args.engine in ("dense", "hybrid"):
        rc = _single_controller(args)
        if rc is not None:
            return rc, None
    device, rc = _device(args.device)
    if device is None:
        return rc, None
    world, rc = _join_world(args, device)
    if rc is not None:
        return rc, None

    checkpointer = _checkpointer(args)
    if args.engine == "hybrid":
        from gamesmanmpi_tpu_torch.solve.hybrid import HybridSolver

        try:
            solver = HybridSolver(game, cutover=args.hybrid_cutover,
                                  store_tables=not args.no_tables,
                                  device=device, devices=args.devices)
        except ValueError as e:  # a bad cutover or --devices
            return _error(str(e)), None
    # Same platform policy as the reference: the dense engine is the
    # accelerator's pick on one device; on the CPU, and with --devices N
    # (the sharded BFS shards memory, the meshed dense engine does not),
    # auto runs the classic or sharded engine.
    elif args.engine == "dense" or (
            args.engine == "auto" and dense_eligible
            and device.type == "cuda" and args.devices == 1 and world == 1):
        from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

        try:
            solver = DenseSolver(game, store_tables=not args.no_tables,
                                 device=device, checkpointer=checkpointer,
                                 devices=args.devices)
        except ValueError as e:  # --devices past the visible devices
            return _error(str(e)), None
    elif args.devices > 1 or world > 1:
        solver, rc = _sharded_solver(game, args, device, checkpointer)
        if solver is None:
            return rc, None
    else:
        from gamesmanmpi_tpu_torch.solve.engine import Solver

        solver = Solver(game, device=device, paranoid=args.paranoid,
                        store_tables=not args.no_tables,
                        checkpointer=checkpointer)
    return _run_solve(solver.solve, checkpointer, args, t0)


def _checkpointer(args):
    if not args.checkpoint_dir:
        return None
    from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

    return LevelCheckpointer(args.checkpoint_dir)


def _run_solve(solve, checkpointer, args, t0: float):
    """Run `solve()` and report it -> (exit code, SolveResult or None)."""
    import os

    from gamesmanmpi_tpu_torch.resilience import preempt
    from gamesmanmpi_tpu_torch.resilience.coordination import (
        CoordinatedAbort,
    )

    # Only a checkpointed solve gets the grace handlers: exit 75 promises
    # "rerun me on the same directory", and a solve with nothing sealed
    # should keep dying promptly on SIGTERM.
    restore_grace = (preempt.install_grace_handler()
                     if checkpointer is not None else (lambda: None))
    try:
        result = solve()
    except preempt.PreemptionRequested as e:
        print(f"preempted: {e}", file=sys.stderr)
        sys.stderr.flush()
        return preempt.GRACE_EXIT_CODE, None
    except CoordinatedAbort as e:
        # The world agreed to stop (a peer died, diverged or timed out):
        # the reference's resumable-abort contract, exit 124. os._exit: a
        # clean exit could block tearing down a group with a dead peer.
        print(f"coordinated abort: {e}", file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(preempt.WATCHDOG_EXIT_CODE)
    finally:
        restore_grace()
    _report(result, args.devices, time.perf_counter() - t0, args)
    _leave_world()
    return 0, result


def _leave_world() -> None:
    """Tear the process group down after a finished solve."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _solve_module(args, t0: float) -> tuple[int, Optional[object]]:
    """The compat path (the reference's `_solve_main` module branch): a
    module that declares `level_of` runs on the classic engine through
    compat.TensorizedModule (on the sharded engine with --devices > 1 or
    in a world); any other module is solved by the host oracle, and
    --devices/--paranoid/--checkpoint-dir are then ignored with a
    warning. --engine dense applies to the built-in Connect-4 family only
    and exits 2."""
    from gamesmanmpi_tpu_torch.compat import (
        load_game_module,
        solve_module,
        solve_module_tensorized,
    )

    if args.engine in ("dense", "hybrid"):
        return _error(f"--engine {args.engine} applies to the built-in "
                      "Connect-4 family, not compat game modules"), None
    try:
        module = load_game_module(args.game)
    except (AttributeError, ImportError) as e:
        return _error(f"invalid game module {args.game!r}: {e}"), None
    device, rc = _device(args.device)
    if device is None:
        return rc, None
    engine_capable = hasattr(module, "level_of")
    world = 1
    if engine_capable:
        world, rc = _join_world(args, device)
        if rc is not None:
            return rc, None
    for flag, name in ((args.devices > 1, "--devices"),
                       (args.paranoid, "--paranoid"),
                       (args.checkpoint_dir, "--checkpoint-dir")):
        if flag and not engine_capable:
            print(f"warning: {name} needs the tensorized compat path and "
                  "is ignored on the host solve; define level_of(pos) in "
                  "the module (max_moves is auto-derived) to drive the "
                  "engine", file=sys.stderr)
    if engine_capable:
        checkpointer = _checkpointer(args)
        kwargs = {"checkpointer": checkpointer}
        if args.devices > 1 or world > 1:
            kwargs["devices"] = max(args.devices, world)
        return _run_solve(
            lambda: solve_module_tensorized(
                module, device=device, paranoid=args.paranoid,
                store_tables=not args.no_tables, **kwargs),
            checkpointer, args, t0)
    value, remoteness, table = solve_module(module)
    print(f"game: {pathlib.Path(args.game).stem} (compat module)")
    print(f"positions: {len(table)}")
    print(f"value: {value_name(value)}")
    print(f"remoteness: {remoteness}")
    print(f"elapsed: {time.perf_counter() - t0:.3f}s")
    if args.table_out:
        from gamesmanmpi_tpu_torch.utils.checkpoint import save_table_npz

        save_table_npz(args.table_out, table)
        print(f"table written: {args.table_out}")
    for q in args.query or ():
        try:
            hit = table.get(int(q, 0))
        except ValueError as e:
            print(f"query {q}: invalid position ({e})")
            continue
        if hit is None:
            print(f"query {q}: not reachable")
        else:
            print(f"query {q}: value={value_name(hit[0])} "
                  f"remoteness={hit[1]}")
    return 0, None


def _export_db(args, t0: float) -> int:
    """The reference's `_cmd_export_db`: a fresh classic solve streamed
    into the writer (Solver(store_tables=False, level_sink=...)), or a
    checkpoint directory converted; then the optional opening book."""
    from gamesmanmpi_tpu_torch.db import (
        DbFormatError,
        DbWriter,
        export_checkpoint,
    )
    from gamesmanmpi_tpu_torch.utils.env import env_bool, env_int

    game, rc = _get_game(args.game)
    if game is None:
        return rc
    device, rc = _device(args.device)
    if device is None:
        return rc
    compress = (env_bool("GAMESMAN_DB_COMPRESS", False)
                if args.compress is None else bool(args.compress))
    try:
        if args.from_checkpoint:
            from gamesmanmpi_tpu_torch.utils.checkpoint import (
                LevelCheckpointer,
            )

            if not pathlib.Path(args.from_checkpoint).is_dir():
                # Check BEFORE LevelCheckpointer: its constructor mkdirs,
                # so a typo'd path would be created on disk and misreported
                # as "no completed levels".
                return _error(f"no such checkpoint directory: "
                              f"{args.from_checkpoint}")
            manifest = export_checkpoint(
                LevelCheckpointer(args.from_checkpoint), game, args.game,
                args.out, overwrite=args.overwrite, compress=compress)
        else:
            from gamesmanmpi_tpu_torch.solve.engine import Solver

            writer = DbWriter(args.out, game, args.game,
                              overwrite=args.overwrite, compress=compress)
            try:
                Solver(game, device=device, store_tables=False,
                       level_sink=writer.add_level_table).solve()
                manifest = writer.finalize()
            except BaseException:  # incl. Ctrl-C mid-solve: the old
                writer.abort()     # DB keeps serving, staging is gone
                raise
    except (DbFormatError, FileNotFoundError) as e:
        # FileNotFoundError: a torn checkpoint (a manifest-listed level
        # file deleted) — a usage-visible input problem, not a crash.
        return _error(str(e))
    book_plies = (env_int("GAMESMAN_BOOK_PLIES", 0)
                  if args.book_plies is None else int(args.book_plies))
    if book_plies > 0:
        # After finalize on purpose: the book is scored through a real
        # reader over the sealed DB, and sealing it rewrites the manifest
        # exactly once more.
        from gamesmanmpi_tpu_torch.db.book import build_book

        manifest["book"] = build_book(args.out, book_plies, game=game,
                                      device=device)
    print(f"database written: {args.out}")
    print(f"game: {manifest['game']}")
    print(f"levels: {len(manifest['levels'])}")
    print(f"positions: {manifest['num_positions']}")
    book_rec = manifest.get("book")
    if book_rec:
        print(f"opening book: {book_rec['count']} entries to "
              f"{book_rec['plies']} plies")
    comp = manifest.get("compression")
    if comp:
        ratio = comp["raw_bytes"] / max(comp["stored_bytes"], 1)
        print(f"compressed: {comp['stored_bytes']} bytes "
              f"({ratio:.2f}x vs raw cells)")
    print(f"elapsed: {time.perf_counter() - t0:.3f}s")
    return 0


def _query(args) -> int:
    """The reference's `_cmd_query`, line for line."""
    from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader
    from gamesmanmpi_tpu_torch.db.format import parse_position

    device, rc = _device(args.device)
    if device is None:
        return rc
    try:
        reader = DbReader(args.db, device=device)
    except DbFormatError as e:
        return _error(str(e))
    with reader:
        states = []
        order = []  # (query string, index into states or None)
        for q in args.positions:
            try:
                state = parse_position(reader.game, q)
                order.append((q, len(states)))
                states.append(state)
            except ValueError as e:
                order.append((q, None))
                print(f"query {q}: invalid position ({e})")
        if not states:
            return 0
        values, rem, found, best = reader.lookup_best(states)
        sentinel = int(reader.game.sentinel)
        for q, i in order:
            if i is None:
                continue
            if not found[i]:
                print(f"query {q}: not in database")
                continue
            line = (f"query {q}: value={value_name(values[i])} "
                    f"remoteness={int(rem[i])}")
            if int(best[i]) != sentinel:
                line += f" best={hex(int(best[i]))}"
            print(line)
    return 0


def _build_logger(args):
    """The --jsonl/--verbose logger of `serve` (the reference's
    ``_build_logger``), or None when neither flag is set."""
    from gamesmanmpi_tpu_torch.utils.metrics import (
        JsonlLogger,
        StdoutLogger,
        TeeLogger,
    )

    if not (args.jsonl or args.verbose):
        return None
    return TeeLogger(JsonlLogger(args.jsonl) if args.jsonl else None,
                     StdoutLogger() if args.verbose else None)


def _logger_scope(logger):
    """Context that closes `logger` on exit, or a no-op without one."""
    import contextlib

    return logger if logger is not None else contextlib.nullcontext()


def _serve(args) -> int:
    """The reference's `_cmd_serve`: one in-process QueryServer until
    SIGINT/SIGTERM, which drain it; --workers N or --fleet-manifest hand
    over to the supervised fleet."""
    import os
    import signal
    import threading

    from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader
    from gamesmanmpi_tpu_torch.serve import QueryServer
    from gamesmanmpi_tpu_torch.utils.env import env_int

    workers = (env_int("GAMESMAN_SERVE_WORKERS", 0)
               if args.workers is None else args.workers)
    if args.no_trace:
        # Env, not a constructor knob: workers (fork and exec) inherit
        # the environment, so one setting covers the whole fleet.
        os.environ["GAMESMAN_TRACE"] = "0"
    if args.db is None and not args.fleet_manifest:
        return _error("serve needs a DB directory (or --fleet-manifest)")
    if workers > 0 or args.fleet_manifest:
        return _serve_fleet(args, max(1, workers))
    device, rc = _device(args.device)
    if device is None:
        return rc
    try:
        reader = DbReader(args.db, device=device)
    except DbFormatError as e:
        return _error(str(e))
    logger = _build_logger(args)
    with _logger_scope(logger):
        try:
            server = QueryServer(
                reader, host=args.host, port=args.port,
                window=args.batch_window_ms / 1e3,
                cache_size=args.cache_size, max_queue=args.max_queue,
                request_timeout=(args.request_timeout_ms / 1e3
                                 if args.request_timeout_ms is not None
                                 else None),
                logger=logger)
        except OSError as e:  # port in use / unbindable host
            return _error(f"cannot bind {args.host}:{args.port} ({e})")
        print(f"serving {reader.game.name} ({reader.num_positions} "
              f"positions) on http://{args.host}:{server.port} "
              "(POST /query, GET /healthz, GET /metrics, GET /traces)",
              flush=True)  # a harness tailing the pipe needs the banner
        # SIGINT/SIGTERM flip /healthz to "draining" (new queries 503),
        # let in-flight requests and the coalescing batch finish, then
        # tear down.
        stop = threading.Event()
        previous = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                previous[sig] = signal.signal(sig,
                                              lambda *_: stop.set())
            except ValueError:  # not the main thread (programmatic use)
                pass
        server.start()
        try:
            stop.wait()
            print("draining: refusing new queries, flushing in-flight "
                  "batches", file=sys.stderr)
            server.begin_drain()
        finally:
            server.stop()
            reader.close()
            for sig, handler in previous.items():
                signal.signal(sig, handler)
    return 0


def _serve_fleet(args, workers: int) -> int:
    """The reference's `_cmd_serve_fleet`: the supervised multi-worker
    fleet. The parent checks for the card through NVML and opens its
    readers without a device, so it never initializes CUDA and may fork
    its workers (serve/supervisor.ServeSupervisor._use_fork).
    SIGTERM/SIGINT drain the whole fleet; SIGHUP rolls it onto a re-read
    manifest."""
    import signal

    from gamesmanmpi_tpu_torch.db import DbFormatError
    from gamesmanmpi_tpu_torch.serve import (
        ServeSupervisor,
        load_fleet_manifest,
        single_db_entries,
    )

    if args.fleet_manifest and args.db:
        return _error("pass a DB directory or --fleet-manifest, not both")
    device, rc = _device(args.device, fork_safe=True)
    if device is None:
        return rc
    logger = _build_logger(args)
    with _logger_scope(logger):
        try:
            entries = (load_fleet_manifest(args.fleet_manifest)
                       if args.fleet_manifest
                       else single_db_entries(args.db))
            supervisor = ServeSupervisor(
                entries, workers=workers, host=args.host, port=args.port,
                control_port=args.control_port,
                manifest_path=args.fleet_manifest,
                server_config={
                    "window": args.batch_window_ms / 1e3,
                    "cache_size": args.cache_size,
                    "max_queue": args.max_queue,
                    "request_timeout": (
                        args.request_timeout_ms / 1e3
                        if args.request_timeout_ms is not None else None),
                },
                jsonl=args.jsonl, logger=logger, device=args.device)
        except (ValueError, DbFormatError) as e:
            return _error(str(e))
        except OSError as e:  # port in use / unbindable host
            return _error(f"cannot bind {args.host}:{args.port} ({e})")
        games = ", ".join(e.name or "default" for e in entries)
        print(f"serving fleet [{games}] on "
              f"http://{args.host}:{supervisor.port} with {workers} "
              f"worker(s) (control http://{args.host}:"
              f"{supervisor.control_port} — GET /healthz, GET /metrics, "
              "GET /traces, POST /reload)", flush=True)
        previous = {}
        for sig, handler in (
                (signal.SIGINT, lambda *_: supervisor.request_stop()),
                (signal.SIGTERM, lambda *_: supervisor.request_stop()),
                (signal.SIGHUP, lambda *_: supervisor.request_reload())):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread (programmatic use)
                pass
        try:
            return supervisor.run()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)


def main(argv=None) -> int:
    return solve_main(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
