"""Start an N-process ``torch.distributed`` world of the port's CLI (the
port's twin of tools/launch_multihost.py, the ``mpirun -np N`` analog).

It starts N fresh interpreters running ``python -m gamesmanmpi_tpu_torch
<args>`` (never a fork: a child forked after CUDA is initialized fails at
its first CUDA call) and wires the group through the environment:
``GAMESMAN_COORDINATOR`` / ``GAMESMAN_NUM_PROCESSES`` /
``GAMESMAN_PROCESS_ID`` (the CLI's env twins of its flags), the retry
consensus at ``GAMESMAN_COORD_ADDR`` (rank 0 hosts it), and
``GAMESMAN_FAKE_DEVICES`` = the shards each process holds, so they may
share one card. Each rank's stdout and stderr go to files: the ranks are
coupled by collectives, and blocking on one rank's unread pipe could
stall the whole world.

Per-rank chaos: ``per_rank_env={1: {"GAMESMAN_FAULTS": "..."}}``, or
``GAMESMAN_FAULTS_RANK_<i>`` in the environment, arms faults on rank i
only; a world-wide ``GAMESMAN_FAULTS`` is not passed on.

CLI::

    python -m gamesmanmpi_tpu_torch.parallel.launch --processes 2 \\
        -- solve connect4:w=3,h=3,connect=3 --device cpu --devices 4

Library::

    from gamesmanmpi_tpu_torch.parallel.launch import launch
    ranks = launch(["solve", "nim:heaps=2-3-4", "--device", "cpu",
                    "--devices", "4"], processes=2)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

#: Shards each process holds by default: 2 keeps the world genuinely
#: multi-shard AND multi-process at the smallest cost.
DEFAULT_LOCAL_SHARDS = 2

#: The repository root: children run the package from it.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class RankResult:
    rank: int
    returncode: Optional[int]  # None = killed at the deadline
    stdout: str
    stderr: str


def _child_env(base: dict, rank: int, processes: int, coordinator: str,
               coord_addr: str, local_shards: int,
               per_rank: Optional[dict]) -> dict:
    env = dict(base)
    env["GAMESMAN_FAKE_DEVICES"] = str(local_shards)
    env["GAMESMAN_COORDINATOR"] = coordinator
    env["GAMESMAN_NUM_PROCESSES"] = str(processes)
    env["GAMESMAN_PROCESS_ID"] = str(rank)
    env["GAMESMAN_COORD_ADDR"] = coord_addr
    env.pop("GAMESMAN_FAULTS", None)
    ranked = base.get(f"GAMESMAN_FAULTS_RANK_{rank}")
    if ranked:
        env["GAMESMAN_FAULTS"] = ranked
    for k in list(env):
        if k.startswith("GAMESMAN_FAULTS_RANK_"):
            env.pop(k)
    if per_rank:
        env.update({k: str(v) for k, v in per_rank.items()})
    return env


class World:
    """A started world the caller can signal and wait on (the campaign,
    resilience/campaign.py, forwards preemption to every rank and waits
    with its own policy)."""

    def __init__(self, procs, files, log_dir: str):
        self._procs = procs
        self._files = files
        self.log_dir = log_dir
        self._results: Optional[List[RankResult]] = None

    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def send_signal(self, sig) -> None:
        """Deliver `sig` to every rank still running (preemption grace
        forwards SIGTERM this way; an unwinding campaign SIGKILLs)."""
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def stderr_of(self, rank: int) -> str:
        """What rank `rank` has written to stderr so far."""
        err_f = self._files[rank][1]
        err_f.flush()
        with open(err_f.name) as fh:
            return fh.read()

    def wait(self, timeout: Optional[float]) -> List[RankResult]:
        """Wait until every rank exits or `timeout` seconds pass, then
        kill the stragglers (their returncode reads None). Idempotent."""
        if self._results is not None:
            return self._results
        deadline = (time.monotonic() + timeout if timeout is not None
                    else None)
        results = []
        for rank, (p, (out_f, err_f)) in enumerate(zip(self._procs,
                                                       self._files)):
            rc: Optional[int] = None
            try:
                rc = p.wait(timeout=None if deadline is None
                            else max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            out_f.seek(0)
            err_f.seek(0)
            results.append(RankResult(rank, rc, out_f.read(), err_f.read()))
            out_f.close()
            err_f.close()
        self._results = results
        return results


def start_world(args: Sequence[str], *, processes: int = 2,
                log_dir: Optional[str] = None,
                local_shards: int = DEFAULT_LOCAL_SHARDS,
                env: Optional[dict] = None,
                per_rank_env: Optional[Dict[int, dict]] = None) -> World:
    """Start `processes` ranks of ``python -m gamesmanmpi_tpu_torch
    args...`` and return at once (see :class:`World`). Logs go to
    ``log_dir`` (default: a new temporary directory) as
    ``rank<i>_<port>.out`` / ``.err``."""
    base = dict(os.environ)
    if env:
        base.update({k: str(v) for k, v in env.items()})
    port = free_port()
    coordinator = f"127.0.0.1:{port}"
    coord_addr = f"127.0.0.1:{free_port()}"
    log_dir = log_dir or tempfile.mkdtemp(prefix="gamesman-world-")
    os.makedirs(log_dir, exist_ok=True)
    procs, files = [], []
    for rank in range(processes):
        out_f = open(os.path.join(log_dir, f"rank{rank}_{port}.out"), "w+")
        err_f = open(os.path.join(log_dir, f"rank{rank}_{port}.err"), "w+")
        files.append((out_f, err_f))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch", *args],
            cwd=REPO,
            env=_child_env(base, rank, processes, coordinator, coord_addr,
                           local_shards, (per_rank_env or {}).get(rank)),
            stdout=out_f, stderr=err_f))
    return World(procs, files, log_dir)


def launch(args: Sequence[str], *, processes: int = 2,
           timeout: Optional[float] = 600.0, log_dir: Optional[str] = None,
           local_shards: int = DEFAULT_LOCAL_SHARDS,
           env: Optional[dict] = None,
           per_rank_env: Optional[Dict[int, dict]] = None
           ) -> List[RankResult]:
    """Run a world to its end (start_world + World.wait)."""
    return start_world(args, processes=processes, log_dir=log_dir,
                       local_shards=local_shards, env=env,
                       per_rank_env=per_rank_env).wait(timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Start an N-process torch.distributed world of the "
        "port's CLI. Everything after -- goes to the CLI verbatim.")
    p.add_argument("--processes", type=int, default=None,
                   help="world size (env GAMESMAN_NUM_PROCESSES; default 2)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="stragglers are killed after this many seconds")
    p.add_argument("--log-dir", default=None,
                   help="directory for per-rank stdout/stderr files "
                   "(default: a new temporary directory)")
    p.add_argument("--local-shards", type=int, default=DEFAULT_LOCAL_SHARDS,
                   help="shards each process holds (GAMESMAN_FAKE_DEVICES "
                   "of each rank)")
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="-- then the CLI's arguments")
    args = p.parse_args(argv)
    cli_args = [a for a in args.cli_args if a != "--"]
    if not cli_args:
        p.error("no CLI arguments (put them after --)")
    from gamesmanmpi_tpu_torch.utils.env import env_int

    processes = (args.processes if args.processes is not None
                 else env_int("GAMESMAN_NUM_PROCESSES", 2))
    results = launch(cli_args, processes=processes, timeout=args.timeout,
                     log_dir=args.log_dir, local_shards=args.local_shards)
    worst = 0
    for r in results:
        rc = "killed" if r.returncode is None else r.returncode
        print(f"--- rank {r.rank}: rc={rc} ---")
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
        worst = worst or (124 if r.returncode is None else r.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
