"""Command line of the torch port: `solve`, `export-db`, `query`,
`serve` and `registry`.

    gamesman-solve-torch [solve] GAME|--spec SPEC.json
                         [--engine auto|dense|classic|hybrid]
                         [--hybrid-cutover K]
                         [--device cuda|cpu] [--no-tables] [--paranoid]
                         [--table-out PATH] [--checkpoint-dir DIR]
                         [--query POS]... [--devices N]
                         [--coordinator HOST:PORT --num-processes P
                          --process-id I]
                         [--jsonl F] [-v] [--trace-events F]
                         [--metrics-out F] [--heartbeat-secs S]
                         [--status-port P] [--watchdog-secs S]
                         [--profile-dir DIR] [--backward-block N]
                         [--window-block N] [--device-store-mb MB]
                         [--backward edges|lookup]
    gamesman-solve-torch solve path/to/module.py [--device cuda|cpu] ...
    gamesman-solve-torch export-db GAME|--spec SPEC.json --out DIR
                         [--from-checkpoint DIR] [--overwrite]
                         [--compress] [--book-plies N]
                         [--device cuda|cpu] [--jsonl F] [-v]
    gamesman-solve-torch query DB POS... [--device cuda|cpu]
    gamesman-solve-torch serve DB [--workers N] [--fleet-manifest F]
                         [--control-port P] [--port P] [--device cuda|cpu]
    gamesman-solve-torch registry serve --root DIR [--jobs] [--port P]
                         [--device cuda|cpu]
    gamesman-solve-torch registry publish DB --root DIR [--name NAME]
    gamesman-solve-torch registry run-jobs --root DIR [--once]
                         [--book-plies N] [--device cuda|cpu]
    python -m gamesmanmpi_tpu_torch connect4:w=5,h=5

The flat grammar (a game first, no `solve`) solves, as the reference's
CLI does; it is what a campaign attempt runs
(resilience/campaign.py).

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
`dense` and `hybrid`. A GameSpec ``.json`` file (as GAME or --spec,
never both) is compiled by gamedsl; a compiled game is not of the
Connect-4 class, so auto runs it on the classic (or sharded) engine and
`dense`/`hybrid` refuse it, as the reference does.

Instrumentation, the reference's flags: --jsonl (and -v on stderr)
writes one record per level and phase (``forward``, ``backward``,
``dense_backward``, ``done``, ...), --trace-events the spans as Chrome
trace JSON, --metrics-out the registry's JSON snapshot at exit (a failed
solve's too), --heartbeat-secs periodic progress/RSS/card-memory
records, --status-port a live ``/status`` and ``/metrics`` endpoint,
--watchdog-secs an exit 124 with the stacks and the flight recorder
dumped when a level stalls, --profile-dir a torch.profiler Chrome trace.
Every abnormal exit (preempted, out of memory, coordinated abort, crash)
dumps the flight recorder into GAMESMAN_FLIGHTREC_DIR, which defaults to
--checkpoint-dir. A host MemoryError (GAMESMAN_HOST_MEM_LIMIT_MB's guard
at a level boundary) prints "out of memory: ..." and exits 1.

The capacity flags spell env knobs and win over them for the solve:
--backward-block (GAMESMAN_BACKWARD_BLOCK), --window-block
(GAMESMAN_WINDOW_BLOCK), --device-store-mb (GAMESMAN_DEVICE_STORE_MB)
and --backward (GAMESMAN_BACKWARD). A compat module solved on the host
ignores them with the reference's warning.

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
whose readers run on --device after the fork. `registry` (registry/)
publishes DB epochs into a sha256-sealed catalog, serves it over HTTP
with ranged blob reads and, with --jobs, a solve-on-demand queue; and
`run-jobs` drives each queued job through the campaign, export-db and
publish, every child on --device.

Every command runs on the card unless --device cpu is given; without a
card it exits 2 with a message. It returns 0 on success, 75 when
preempted, 1 out of host memory, 124 on a watchdog or coordinated
abort, and 2 on a usage error, an unknown or not-yet-ported game, an
engine the game cannot take, an invalid game module or database, a bad
GAMESMAN_FAULTS, or a missing CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Optional

from gamesmanmpi_tpu_torch.core.values import value_name


def _device_arg(p, what: str) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help=f"where {what} runs (default: the card)")


def _spec_arg(p) -> None:
    p.add_argument(
        "--spec", default=None, metavar="SPEC.json",
        help="declarative GameSpec file compiled by gamedsl "
        "(docs/GAMEDSL.md) — equivalent to passing the path as GAME")


def _records_args(p, what: str) -> None:
    p.add_argument("--jsonl", default=None,
                   help=f"write {what} to this JSONL file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-level progress lines to stderr")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gamesman-solve-torch",
        description="Strong solver for two-player games (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("solve", help="solve a game and print the root block")
    s.add_argument("game", nargs="?", default=None,
                   help="game spec, e.g. connect4:w=5,h=5, a path to a "
                   "declarative GameSpec .json file (docs/GAMEDSL.md), or "
                   "a path to a reference-style game module; omit when "
                   "--spec is given")
    _spec_arg(s)
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
    # Capacity knobs: CLI spellings of the GAMESMAN_* env knobs the
    # engines read at construction; the flag wins when both are set.
    s.add_argument(
        "--backward-block", type=int, default=None, metavar="POSITIONS",
        help="resolve levels in column blocks of this many positions "
        "(bounds backward temporaries; 0 = never block; env "
        "GAMESMAN_BACKWARD_BLOCK)")
    s.add_argument(
        "--window-block", type=int, default=None, metavar="POSITIONS",
        help="sharded: spill window levels wider than this (per shard) to "
        "pinned host memory and stream them back through the device in "
        "blocks (0 = never spill; env GAMESMAN_WINDOW_BLOCK)")
    s.add_argument(
        "--device-store-mb", type=int, default=None, metavar="MB",
        help="device-resident budget for discovered levels + provenance "
        "between forward and backward; excess spills to host (env "
        "GAMESMAN_DEVICE_STORE_MB)")
    s.add_argument(
        "--backward", choices=("edges", "lookup"), default=None,
        help="sharded backward strategy: 'edges' (default) resolves each "
        "level from the forward pass's stored edge indices, falling back "
        "to 'lookup' per level where edges are missing; 'lookup' forces "
        "the owner-routed search join everywhere (env GAMESMAN_BACKWARD)")
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
    _records_args(s, "per-level structured metrics")
    s.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the solve (CPU and CUDA "
        "activities, Chrome trace JSON) into this directory")
    s.add_argument(
        "--trace-events", default=None, metavar="OUT.json",
        help="dump Chrome trace-event JSON of the solver's phase spans "
        "(forward/dedup/backward/checkpoint/db_export) — loads in "
        "chrome://tracing / Perfetto")
    s.add_argument(
        "--metrics-out", default=None, metavar="OUT.json",
        help="dump the process metrics-registry snapshot (span "
        "histograms, solve counters) as JSON when the solve finishes, "
        "also when it fails")
    s.add_argument(
        "--heartbeat-secs", type=float, default=None, metavar="S",
        help="emit a heartbeat record (phase/level progress, RSS, card "
        "memory) every S seconds (env GAMESMAN_HEARTBEAT_SECS; 0 = off)")
    s.add_argument(
        "--status-port", type=int, default=None, metavar="PORT",
        help="serve read-only live solve status on this port: GET /status "
        "(phase/level, positions solved, per-level progress model with "
        "ETA, fleet-merged per-rank view on rank 0) and GET /metrics "
        "(Prometheus text). 0 = ephemeral port (published via "
        "GAMESMAN_STATUS_ADDR_FILE); env GAMESMAN_STATUS_PORT; unset = off")
    s.add_argument(
        "--watchdog-secs", type=float, default=None, metavar="S",
        help="abort (exit 124, diagnostics dumped, checkpoint prefix "
        "intact) when a level stalls longer than max(S, "
        "GAMESMAN_WATCHDOG_FACTOR x slowest recent level) (env "
        "GAMESMAN_WATCHDOG_SECS; 0 = off)")

    e = sub.add_parser(
        "export-db",
        help="build an immutable DB from a fresh solve or a checkpoint dir")
    e.add_argument("game", nargs="?", default=None,
                   help="built-in game spec, or a GameSpec .json file (the "
                   "manifest embeds the canonical spec document, so the DB "
                   "stays self-describing); omit when --spec is given")
    _spec_arg(e)
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
    _records_args(e, "per-level export metrics")

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

    pr = sub.add_parser(
        "registry",
        help="DB registry: publish epochs, serve the catalog, run "
        "solve-on-demand jobs (docs/SERVING.md)")
    rsub = pr.add_subparsers(dest="registry_cmd", required=True)
    rserve = rsub.add_parser(
        "serve", help="serve the sha256-sealed catalog + blob streams over "
        "HTTP")
    rserve.add_argument("--root", required=True,
                        help="registry root directory (catalog.json + dbs/)")
    rserve.add_argument("--host", default="127.0.0.1")
    rserve.add_argument("--port", type=int, default=0,
                        help="0 = ephemeral (the bound port is printed)")
    rserve.add_argument(
        "--jobs", action="store_true",
        help="accept POST /solve: unregistered-game queries become "
        "durable solve-on-demand jobs in <root>/jobs.jsonl")
    _device_arg(rserve, "the registry's solves (checked, not used: "
                "run-jobs solves them)")
    rpub = rsub.add_parser(
        "publish",
        help="copy a DB into the registry and seal a new catalog epoch")
    rpub.add_argument("db", help="DB directory (from export-db)")
    rpub.add_argument("--root", required=True,
                      help="registry root directory")
    rpub.add_argument("--name", default=None,
                      help="catalog name (default: the DB's game name)")
    rrun = rsub.add_parser(
        "run-jobs",
        help="claim queued solve-on-demand jobs and drive each through "
        "campaign solve -> export-db -> publish")
    rrun.add_argument("--root", required=True,
                      help="registry root directory")
    rrun.add_argument("--work-dir", default=None,
                      help="checkpoint/export scratch (default <root>/work)")
    rrun.add_argument("--book-plies", type=int, default=0, metavar="N",
                      help="also build an N-ply opening book before publish")
    rrun.add_argument("--once", action="store_true",
                      help="run at most one job, then exit")
    _device_arg(rrun, "every job's campaign, export and book")
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


#: The subcommands; any other first token is a game (the flat grammar).
_DB_COMMANDS = ("export-db", "serve", "query", "registry")
_COMMANDS = ("solve",) + _DB_COMMANDS


def solve_main(argv=None) -> tuple[int, Optional[object]]:
    """main() that also hands back the solve's SolveResult (None on an
    error, for an oracle-solved module, and for export-db and query)."""
    from gamesmanmpi_tpu_torch.resilience import faults

    argv = list(sys.argv[1:] if argv is None else argv)
    # The flat grammar (game first) solves, as the reference's CLI does:
    # no game is named like a command, and -h/--help stays top-level.
    if argv and argv[0] not in _COMMANDS + ("-h", "--help"):
        argv = ["solve", *argv]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    try:
        faults.configure_from_env()
    except ValueError as e:
        return _error(f"GAMESMAN_FAULTS: {e}"), None
    if args.command in ("solve", "export-db"):
        rc = _game_or_spec(args)
        if rc is not None:
            return rc, None
    if args.command == "export-db":
        return _export_db(args, t0), None
    if args.command == "query":
        return _query(args), None
    if args.command == "serve":
        return _serve(args), None
    if args.command == "registry":
        return _registry(args), None
    with _solve_env(args):
        if (pathlib.Path(args.game).is_file()
                and not args.game.lower().endswith(".json")):
            return _solve_module(args, t0)
        return _solve(args, t0)


def _game_or_spec(args) -> Optional[int]:
    """GAME or --spec, never both (the reference's rule and messages):
    --spec becomes the game argument -> None, or exit code 2."""
    if args.spec is not None:
        if args.game is not None:
            return _error("pass either GAME or --spec, not both")
        args.game = args.spec
    elif args.game is None:
        return _error("a game is required: GAME or --spec SPEC.json")
    return None


@contextlib.contextmanager
def _solve_env(args):
    """Flags that spell env knobs the engines read at construction, set
    for the solve and restored after it (a programmatic main() must not
    leak them into the next call). Flight-recorder dumps land next to the
    checkpoints unless GAMESMAN_FLIGHTREC_DIR says otherwise."""
    import os

    from gamesmanmpi_tpu_torch.utils.env import env_opt

    flightrec_dir = (args.checkpoint_dir
                     if args.checkpoint_dir
                     and not env_opt("GAMESMAN_FLIGHTREC_DIR") else None)
    saved = {}
    for flag, env in ((args.backward_block, "GAMESMAN_BACKWARD_BLOCK"),
                      (args.window_block, "GAMESMAN_WINDOW_BLOCK"),
                      (args.device_store_mb, "GAMESMAN_DEVICE_STORE_MB"),
                      (args.heartbeat_secs, "GAMESMAN_HEARTBEAT_SECS"),
                      (args.watchdog_secs, "GAMESMAN_WATCHDOG_SECS"),
                      (args.backward, "GAMESMAN_BACKWARD"),
                      (args.status_port, "GAMESMAN_STATUS_PORT"),
                      (flightrec_dir, "GAMESMAN_FLIGHTREC_DIR")):
        if flag is not None:
            saved[env] = env_opt(env)
            os.environ[env] = str(flag)
    try:
        yield
    finally:
        for env, old in saved.items():
            if old is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old


def _rank_path(path: str, rank: int) -> str:
    """``out.jsonl`` -> ``out.rank0.jsonl``: ranks never race onto one
    file."""
    import os

    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def _world_rank() -> int:
    """This process's rank in the process group (0 outside one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _join_world(args, device) -> tuple[int, Optional[int]]:
    """Join the process group when a coordinator is given (flag, then env
    GAMESMAN_COORDINATOR) -> (world size, None), or (0, exit code 2).

    Then the reference's rank plumbing: rank-qualified file artifacts
    (--jsonl/--metrics-out/--trace-events/--table-out, so N processes
    given one path never clobber it), GAMESMAN_COORD_ADDR defaulting to
    the coordinator's host at port+1 (the retry consensus), and a
    ``rank`` label on every metric."""
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
    for field in ("jsonl", "metrics_out", "trace_events", "table_out"):
        val = getattr(args, field, None)
        if val:
            setattr(args, field, _rank_path(val, rank))
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


def _sharded_solver(game, args, device, checkpointer, logger):
    """The sharded engine over --devices shards -> (solver, None), or
    (None, exit code 2) when the shards do not fit the devices."""
    from gamesmanmpi_tpu_torch.parallel import ShardedSolver

    try:
        return ShardedSolver(game, num_shards=args.devices, device=device,
                             paranoid=args.paranoid,
                             store_tables=not args.no_tables,
                             checkpointer=checkpointer,
                             logger=logger), None
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
    logger = _solve_logger(args, world)
    # The logger closes even when a solve aborts mid-level; the obs scope
    # nests inside, so --trace-events and --metrics-out are written when
    # the solve raises too.
    with _logger_scope(logger), _obs_scope(args):
        return _solve_with(game, args, t0, device, world, logger,
                           dense_eligible)


def _solve_with(game, args, t0: float, device, world: int, logger,
                dense_eligible: bool):
    """Build the engine `_solve` routed to, with the solve's logger, and
    run it."""
    checkpointer = _checkpointer(args)
    if args.engine == "hybrid":
        from gamesmanmpi_tpu_torch.solve.hybrid import HybridSolver

        try:
            solver = HybridSolver(game, cutover=args.hybrid_cutover,
                                  store_tables=not args.no_tables,
                                  device=device, devices=args.devices,
                                  logger=logger)
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
                                 devices=args.devices, logger=logger)
        except ValueError as e:  # --devices past the visible devices
            return _error(str(e)), None
    elif args.devices > 1 or world > 1:
        solver, rc = _sharded_solver(game, args, device, checkpointer,
                                     logger)
        if solver is None:
            return rc, None
    else:
        from gamesmanmpi_tpu_torch.solve.engine import Solver

        solver = Solver(game, device=device, paranoid=args.paranoid,
                        store_tables=not args.no_tables,
                        checkpointer=checkpointer, logger=logger)
    return _run_solve(solver.solve, checkpointer, args, t0, logger, world,
                      lambda: getattr(solver, "progress", {}))


def _checkpointer(args):
    if not args.checkpoint_dir:
        return None
    from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

    return LevelCheckpointer(args.checkpoint_dir)


def _abnormal_exit(logger, phase: str, line: str, key: str, err,
                   progress: dict) -> None:
    """stderr's "<line>" and "progress: ..." lines and the ``phase``
    record; progress's own "phase" is kept as "in_phase", so the record
    never reads as a level row."""
    print(f"{line}\nprogress: {progress}", file=sys.stderr)
    sys.stderr.flush()
    if logger is not None:
        logger.log({"phase": phase, key: str(err)[:200],
                    **{("in_phase" if k == "phase" else k): v
                       for k, v in progress.items()
                       if isinstance(v, (int, str, float))}})
        logger.close()


def _run_solve(solve, checkpointer, args, t0: float, logger=None,
               world: int = 1, progress=dict):
    """Run `solve()` under --profile-dir and report it -> (exit code,
    SolveResult or None). Every abnormal exit dumps the flight recorder
    into GAMESMAN_FLIGHTREC_DIR (the checkpoint directory by default) and
    writes its record; `progress()` is the solver's last progress."""
    import os

    from gamesmanmpi_tpu_torch.obs import flightrec
    from gamesmanmpi_tpu_torch.resilience import preempt
    from gamesmanmpi_tpu_torch.resilience.coordination import (
        CoordinatedAbort,
    )
    from gamesmanmpi_tpu_torch.resilience.supervisor import (
        WATCHDOG_EXIT_CODE,
    )
    from gamesmanmpi_tpu_torch.utils.profiling import maybe_profile

    # Only a checkpointed solve gets the grace handlers: exit 75 promises
    # "rerun me on the same directory", and a solve with nothing sealed
    # should keep dying promptly on SIGTERM.
    restore_grace = (preempt.install_grace_handler()
                     if checkpointer is not None else (lambda: None))
    try:
        with maybe_profile(args.profile_dir):
            result = solve()
    except preempt.PreemptionRequested as e:
        flightrec.dump("preempted")
        _abnormal_exit(logger, "preempted", f"preempted: {e}", "detail", e,
                       progress())
        return preempt.GRACE_EXIT_CODE, None
    except MemoryError as e:
        # Host memory: memguard's HostMemoryExceeded at a level boundary,
        # or a real MemoryError mid-level. The sealed prefix is intact;
        # the "out of memory" line is what a supervisor classifies.
        flightrec.dump("oom")
        _abnormal_exit(logger, "oom", f"out of memory: {e}", "error", e,
                       progress())
        if world > 1:
            # A clean exit could block tearing down a group whose peers
            # are unwinding through the collective deadline.
            sys.stdout.flush()
            os._exit(1)
        return 1, None
    except CoordinatedAbort as e:
        # The world agreed to stop (a peer died, diverged or timed out):
        # the reference's resumable-abort contract, exit 124. os._exit: a
        # clean exit could block tearing down a group with a dead peer.
        flightrec.dump("coordinated_abort")
        _abnormal_exit(logger, "coordinated_abort",
                       f"coordinated abort: {e}", "error", e, progress())
        sys.stdout.flush()
        os._exit(WATCHDOG_EXIT_CODE)
    except Exception:
        # Any other death leaves the post-mortem (last completed level,
        # spans in flight) before the traceback propagates.
        flightrec.dump("crash")
        raise
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
    --devices/--paranoid/--checkpoint-dir and the capacity flags are
    then ignored with a warning. --engine dense applies to the built-in
    Connect-4 family only and exits 2."""
    from gamesmanmpi_tpu_torch.compat import load_game_module

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
    logger = _solve_logger(args, world)
    with _logger_scope(logger), _obs_scope(args):
        return _solve_module_with(module, args, t0, device, world, logger)


def _solve_module_with(module, args, t0: float, device, world: int,
                       logger):
    """The compat solve itself, inside the logger and obs scopes."""
    from gamesmanmpi_tpu_torch.compat import (
        solve_module,
        solve_module_tensorized,
    )
    from gamesmanmpi_tpu_torch.utils.profiling import maybe_profile

    engine_capable = hasattr(module, "level_of")
    for flag, name in (
            (args.devices > 1, "--devices"),
            (args.paranoid, "--paranoid"),
            (args.checkpoint_dir, "--checkpoint-dir"),
            (args.backward_block is not None, "--backward-block"),
            (args.window_block is not None, "--window-block"),
            (args.device_store_mb is not None, "--device-store-mb")):
        if flag and not engine_capable:
            # The reference's words, "TPU" included.
            print(f"warning: {name} needs the tensorized compat path and "
                  "is ignored on the host solve; define level_of(pos) in "
                  "the module (max_moves is auto-derived) to drive the "
                  "TPU engine", file=sys.stderr)
    if engine_capable:
        checkpointer = _checkpointer(args)
        kwargs = {"checkpointer": checkpointer, "logger": logger}
        if args.devices > 1 or world > 1:
            kwargs["devices"] = max(args.devices, world)
        return _run_solve(
            lambda: solve_module_tensorized(
                module, device=device, paranoid=args.paranoid,
                store_tables=not args.no_tables, **kwargs),
            checkpointer, args, t0, logger, world)
    with maybe_profile(args.profile_dir):
        value, remoteness, table = solve_module(module)
    elapsed = time.perf_counter() - t0
    print(f"game: {pathlib.Path(args.game).stem} (compat module)")
    print(f"positions: {len(table)}")
    print(f"value: {value_name(value)}")
    print(f"remoteness: {remoteness}")
    print(f"elapsed: {elapsed:.3f}s")
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
    if logger is not None:
        logger.log({"phase": "done", "game": pathlib.Path(args.game).stem,
                    "compat": True, "positions": len(table),
                    "secs_total": elapsed})
    return 0, None


def _export_db(args, t0: float) -> int:
    """The reference's `_cmd_export_db`: a fresh classic solve streamed
    into the writer (Solver(store_tables=False, level_sink=...)), or a
    checkpoint directory converted; then the optional opening book."""
    from gamesmanmpi_tpu_torch.utils.env import env_bool

    game, rc = _get_game(args.game)
    if game is None:
        return rc
    device, rc = _device(args.device)
    if device is None:
        return rc
    compress = (env_bool("GAMESMAN_DB_COMPRESS", False)
                if args.compress is None else bool(args.compress))
    logger = _build_logger(args)
    with _logger_scope(logger):
        return _export_db_with(args, t0, game, device, compress, logger)


def _export_db_with(args, t0: float, game, device, compress: bool,
                    logger) -> int:
    """The export itself, inside the logger's scope."""
    from gamesmanmpi_tpu_torch.db import (
        DbFormatError,
        DbWriter,
        export_checkpoint,
    )
    from gamesmanmpi_tpu_torch.utils.env import env_int

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
                args.out, overwrite=args.overwrite, logger=logger,
                compress=compress)
        else:
            from gamesmanmpi_tpu_torch.solve.engine import Solver

            writer = DbWriter(args.out, game, args.game,
                              overwrite=args.overwrite, compress=compress)
            try:
                Solver(game, device=device, store_tables=False,
                       level_sink=writer.add_level_table,
                       logger=logger).solve()
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
    """The --jsonl/--verbose logger every command shares (the
    reference's ``_build_logger``), or None when neither flag is set."""
    from gamesmanmpi_tpu_torch.utils.metrics import (
        JsonlLogger,
        StdoutLogger,
        TeeLogger,
    )

    if not (args.jsonl or args.verbose):
        return None
    return TeeLogger(JsonlLogger(args.jsonl) if args.jsonl else None,
                     StdoutLogger() if args.verbose else None)


def _solve_logger(args, world: int):
    """The solve's logger; in a world every record carries ``rank``."""
    from gamesmanmpi_tpu_torch.utils.metrics import RankLogger

    logger = _build_logger(args)
    if logger is not None and world > 1:
        logger = RankLogger(logger, _world_rank())
    return logger


def _logger_scope(logger):
    """Context that closes `logger` on exit, or a no-op without one."""
    return logger if logger is not None else contextlib.nullcontext()


@contextlib.contextmanager
def _obs_scope(args):
    """--trace-events / --metrics-out lifetime: a trace sink for the solve,
    and both artifacts written on exit, a failed solve's too (a partial
    trace of a dead solve is when it is most wanted). --metrics-out is
    the registry's snapshot as JSON, as the reference writes it."""
    from gamesmanmpi_tpu_torch.obs import default_registry
    from gamesmanmpi_tpu_torch.obs.tracing import trace_events_scope

    with trace_events_scope(args.trace_events):
        try:
            yield
        finally:
            if args.metrics_out:
                with open(args.metrics_out, "w") as fh:
                    json.dump(default_registry().snapshot(), fh, indent=1)


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


def _registry(args) -> int:
    """The reference's `_cmd_registry`: publish, run-jobs, serve."""
    import signal
    import threading

    from gamesmanmpi_tpu_torch.db.format import DbFormatError, read_manifest
    from gamesmanmpi_tpu_torch.registry.jobs import JobQueue, run_pending
    from gamesmanmpi_tpu_torch.registry.server import (
        RegistryServer,
        publish_db,
    )

    root = pathlib.Path(args.root)
    if args.registry_cmd == "publish":
        try:
            name = args.name or str(read_manifest(args.db)["game"])
            record = publish_db(root, name, args.db)
        except (DbFormatError, ValueError, OSError) as e:
            return _error(str(e))
        print(json.dumps({"name": name, "epoch": record["epoch"],
                          "files": len(record["files"])}))
        return 0
    # The solves run in children on --device; this process only checks
    # that the card exists, through NVML, and never loads torch: a job
    # runner holding a CUDA process's resident set would tax every job.
    from gamesmanmpi_tpu_torch.utils.device import NO_CARD, nvml_device_count

    if args.device == "cuda" and nvml_device_count() <= 0:
        return _error(NO_CARD)
    if args.registry_cmd == "run-jobs":
        queue = JobQueue(root / "jobs.jsonl")
        work = pathlib.Path(args.work_dir) if args.work_dir else root / "work"
        results = run_pending(queue, root, work, book_plies=args.book_plies,
                              device=args.device, once=args.once,
                              log=_jsonl_stderr)
        print(json.dumps({"ran": len(results), "results": results},
                         default=str))
        return 0 if all(r["ok"] for r in results) else 1
    queue = JobQueue(root / "jobs.jsonl") if args.jobs else None
    srv = RegistryServer(root, host=args.host, port=args.port, queue=queue)
    print(f"registry [{root}] on {srv.url} "
          f"({'with' if queue else 'no'} solve-on-demand queue)",
          flush=True)
    stop = threading.Event()
    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[sig] = signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not the main thread (programmatic use)
            pass
    srv.start()
    try:
        stop.wait()
    finally:
        srv.stop()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return 0


def _jsonl_stderr(record) -> None:
    sys.stderr.write(json.dumps(record, default=str) + "\n")
    sys.stderr.flush()


def main(argv=None) -> int:
    return solve_main(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
