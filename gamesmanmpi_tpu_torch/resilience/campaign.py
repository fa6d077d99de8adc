"""Self-healing solve campaigns: auto-resume supervision above the solve
(port of gamesmanmpi_tpu/resilience/campaign.py and its command
tools/run_campaign.py, which is this module's :func:`main`).

    python -m gamesmanmpi_tpu_torch.resilience.campaign GAME \\
        --checkpoint-dir DIR [--processes N] [--chaos SPEC]... \\
        [--status-port P] [...] -- [solve flags, e.g. --device cpu]

The layers below already turn every failure they can into a clean,
resumable death: level-step retry, the coordinated abort and the
watchdog (exit 124), preemption grace (exit 75), the memory guard
("out of memory", exit 1). One :class:`Campaign` drives one game to
completion above them:

* **attempts** - each attempt is a fresh ``python -m
  gamesmanmpi_tpu_torch <solver args> --checkpoint-dir DIR`` child (or a
  whole parallel/launch.py world of them); every death is classified
  from exit codes and log tails, and resume is just the next attempt;
* **backoff** - bounded exponential between failed attempts, reset
  whenever an attempt sealed something new;
* **no-progress breaker** - K consecutive attempts that seal nothing new
  abort with a diagnosis bundle (progress, quarantine, log tails);
* **disk budget** - free space under the soft threshold (or an ENOSPC
  death) runs retention GC (utils/checkpoint.gc_superseded); under the
  hard floor after GC the campaign aborts, prefix intact;
* **adaptive geometry** - an oom death doubles ``--devices`` (under
  ``max_shards``; ``GAMESMAN_FAKE_DEVICES`` lets the shards share one
  card) and halves the store cache; with ``elastic_ranks`` a lost rank
  retries the world at W-1 ranks; an escalation that asks for more
  devices than exist is stepped back down;
* **ledger** - an append-only ``campaign.jsonl``, one fsync'd record per
  event, in the reference's record names and fields.

Exit codes: 0 solved, 2 usage, 3 no-progress breaker / attempts
exhausted, 4 disk hard floor, 75 campaign preempted (SIGTERM is
forwarded to the attempt, which drains; rerun the same command).

The campaign process never imports torch (GC imports the checkpointer,
which imports torch but touches no CUDA): a parent holding a CUDA
context would cost every attempt device and host memory, and a child
forked from it would fail at its first CUDA call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.obs import flightrec
from gamesmanmpi_tpu_torch.obs import status as obs_status
from gamesmanmpi_tpu_torch.resilience.faults import (
    KILL_EXIT_CODE,
    TORN_EXIT_CODE,
)
from gamesmanmpi_tpu_torch.resilience.preempt import GRACE_EXIT_CODE
from gamesmanmpi_tpu_torch.resilience.supervisor import WATCHDOG_EXIT_CODE
from gamesmanmpi_tpu_torch.utils.env import env_bool, env_float, env_int

#: Campaign exit codes (the reference's names and values).
SOLVED_EXIT_CODE = 0
USAGE_EXIT_CODE = 2
NO_PROGRESS_EXIT_CODE = 3
DISK_FLOOR_EXIT_CODE = 4

#: The campaign CLI's complete exit-code contract, held against
#: ``classify`` and the docstring's "Exit codes:" list by gamesman-lint's
#: exit-code-parity rules.
CAMPAIGN_EXIT_CODES = {
    SOLVED_EXIT_CODE: "solved",
    USAGE_EXIT_CODE: "usage",
    NO_PROGRESS_EXIT_CODE: "no-progress breaker / attempts exhausted",
    DISK_FLOOR_EXIT_CODE: "disk hard floor",
    GRACE_EXIT_CODE: "campaign preempted",
}

#: Log-tail markers of disk exhaustion (the injected ``enospc`` kind and
#: the real OSError both match).
ENOSPC_MARKERS = ("ENOSPC", "No space left on device", "[Errno 28]")

#: Log-tail markers of memory exhaustion: the injected ``oom`` kind, the
#: host-memory guard, a bare MemoryError, torch's allocator
#: (``torch.OutOfMemoryError: CUDA out of memory. Tried to allocate``)
#: and the glibc/errno spellings. The kernel OOM-killer's SIGKILL stays
#: ``signal``: it leaves no tail to read.
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "MemoryError", "HostMemoryExceeded",
    "out of memory", "Out of memory", "Cannot allocate memory",
    "ENOMEM", "[Errno 12]", "oom-kill",
)

#: Log-tail marker of parallel/mesh.make_mesh's "requested N shards but
#: only M devices": an oom escalation past what this host can hold (past
#: GAMESMAN_FAKE_DEVICES, or in a world) is stepped back down instead of
#: crash-looping into the breaker.
MESH_INFEASIBLE_MARKER = "shards but only"

#: Causes that read as "a rank was lost": with ``elastic_ranks`` the next
#: attempt runs the world at W-1 ranks (the tree reshards on resume).
LOST_RANK_CAUSES = ("killed", "signal", "deadline_abort", "timeout")

#: Bytes of each attempt log kept for classification and diagnosis.
LOG_TAIL_BYTES = 4000

_REPO = pathlib.Path(__file__).resolve().parents[2]


def checkpoint_progress(directory) -> dict:
    """What the checkpoint tree has sealed, read from its manifest alone
    (no torch): the campaign's progress observable. A missing or torn
    manifest reads as nothing sealed."""
    path = pathlib.Path(directory) / "manifest.json"
    try:
        manifest = json.loads(path.read_text())
    except (OSError, ValueError):
        manifest = {}
    solved = {int(k) for k in manifest.get("levels", [])}
    solved |= {int(k) for k in manifest.get("sharded_levels", {})}
    forward = {int(k) for k in manifest.get("forward_levels", [])}
    forward |= {int(k) for k in manifest.get("forward_level_shards", {})}
    dense = [int(k) for k in manifest.get("dense_levels", [])]
    # Sealed geometry: the shard counts the tree's shard artifacts carry
    # and the last stamped world size (each attempt's ledger record shows
    # it, so every reshard adoption is auditable).
    counts = set()
    if manifest.get("frontier_shards"):
        counts.add(int(manifest["frontier_shards"]))
    for v in manifest.get("forward_level_shards", {}).values():
        counts.add(int(v))
    for v in manifest.get("sharded_levels", {}).values():
        counts.add(int(v))
    counts.discard(0)
    run = manifest.get("run", {})
    return {
        "solved_levels": sorted(solved),
        "deepest_solved": max(solved) if solved else None,
        "forward_levels": len(forward),
        "frontiers_complete": bool(
            manifest.get("frontiers_complete") or manifest.get("frontiers")
            or manifest.get("frontier_shards")
        ),
        "dense_levels": len(dense),
        "epoch": int(run.get("epoch", 0)),
        "shard_counts": sorted(counts),
        "shards": next(iter(counts)) if len(counts) == 1 else None,
        "num_processes": (
            int(run["num_processes"]) if "num_processes" in run else None
        ),
    }


def progress_score(progress: dict) -> tuple:
    """Monotone progress, compared lexicographically by phase: a complete
    forward beats any forward count (consolidating the frontier snapshot
    deletes the per-level forward seals), a newly solved level beats
    anything within the backward."""
    return (
        int(progress["frontiers_complete"]),
        len(progress["solved_levels"]),
        progress["forward_levels"],
        progress["dense_levels"],
    )


class _Ledger:
    """Append-only JSONL, one fsync'd line per record: appends never tear
    earlier records, and a reader skips a torn last line."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict) -> None:
        line = json.dumps({"wall_time": time.time(), **record},
                          default=str)
        with open(self.path, "a") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())


@dataclasses.dataclass
class CampaignConfig:
    """One campaign's shape. Every numeric default reads its
    ``GAMESMAN_CAMPAIGN_*`` / ``GAMESMAN_CKPT_DISK_*`` env twin, so flags
    and env agree."""

    solver_args: List[str]  # game spec + solve CLI flags (no ckpt flag)
    checkpoint_dir: str
    processes: int = 1  # >1 = a parallel/launch.py world per attempt
    max_attempts: int = None  # type: ignore[assignment]
    no_progress_limit: int = None  # type: ignore[assignment]
    backoff_base_secs: float = None  # type: ignore[assignment]
    backoff_max_secs: float = None  # type: ignore[assignment]
    attempt_timeout_secs: float = None  # type: ignore[assignment]
    disk_soft_mb: float = None  # type: ignore[assignment]
    disk_floor_mb: float = None  # type: ignore[assignment]
    #: oom death -> shards double (under max_shards) and the store cache
    #: halves (to cache_floor_mb) for the next attempt.
    oom_escalate: bool = None  # type: ignore[assignment]
    max_shards: int = None  # type: ignore[assignment]
    cache_floor_mb: int = None  # type: ignore[assignment]
    #: lost-rank death -> retry the world at W-1 ranks (floor 1). Opt-in.
    elastic_ranks: bool = None  # type: ignore[assignment]
    ledger_path: Optional[str] = None  # default <ckpt>/campaign.jsonl
    log_dir: Optional[str] = None  # default <ckpt>/logs
    #: attempt i (1-based) runs with GAMESMAN_FAULTS = chaos[i-1] ("" =
    #: clean); later attempts run clean. A world arms rank 0 only.
    chaos: List[str] = dataclasses.field(default_factory=list)
    #: shards per rank of a world (parallel/launch.py's local_shards).
    local_devices: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts is None:
            self.max_attempts = env_int("GAMESMAN_CAMPAIGN_MAX_ATTEMPTS", 8)
        if self.no_progress_limit is None:
            self.no_progress_limit = env_int(
                "GAMESMAN_CAMPAIGN_NO_PROGRESS", 3)
        if self.backoff_base_secs is None:
            self.backoff_base_secs = env_float(
                "GAMESMAN_CAMPAIGN_BACKOFF_BASE_SECS", 1.0)
        if self.backoff_max_secs is None:
            self.backoff_max_secs = env_float(
                "GAMESMAN_CAMPAIGN_BACKOFF_MAX_SECS", 60.0)
        if self.attempt_timeout_secs is None:
            self.attempt_timeout_secs = env_float(
                "GAMESMAN_CAMPAIGN_ATTEMPT_SECS", 0.0)
        if self.disk_soft_mb is None:
            self.disk_soft_mb = env_float("GAMESMAN_CKPT_DISK_SOFT_MB", 0.0)
        if self.disk_floor_mb is None:
            self.disk_floor_mb = env_float("GAMESMAN_CKPT_DISK_FLOOR_MB",
                                           0.0)
        if self.oom_escalate is None:
            self.oom_escalate = env_bool("GAMESMAN_CAMPAIGN_OOM_ESCALATE",
                                         True)
        if self.max_shards is None:
            self.max_shards = env_int("GAMESMAN_CAMPAIGN_MAX_SHARDS", 64)
        if self.cache_floor_mb is None:
            self.cache_floor_mb = env_int(
                "GAMESMAN_CAMPAIGN_CACHE_FLOOR_MB", 16)
        if self.elastic_ranks is None:
            self.elastic_ranks = env_bool("GAMESMAN_CAMPAIGN_ELASTIC_RANKS",
                                          False)
        if self.ledger_path is None:
            self.ledger_path = str(
                pathlib.Path(self.checkpoint_dir) / "campaign.jsonl")
        if self.log_dir is None:
            self.log_dir = str(pathlib.Path(self.checkpoint_dir) / "logs")


class CampaignAborted(RuntimeError):
    """The campaign gave up (breaker / disk floor); ``code`` is the exit
    code, and the diagnosis bundle is already on disk."""

    def __init__(self, reason: str, code: int):
        super().__init__(reason)
        self.code = code


class Campaign:
    """Drives one solve to completion across attempts; ``run()`` returns
    the campaign's exit code (see the module docstring)."""

    def __init__(self, config: CampaignConfig, echo=None):
        self.cfg = config
        self.ledger = _Ledger(config.ledger_path)
        self.echo = echo or (lambda msg: print(msg, file=sys.stderr,
                                               flush=True))
        pathlib.Path(config.checkpoint_dir).mkdir(parents=True,
                                                  exist_ok=True)
        pathlib.Path(config.log_dir).mkdir(parents=True, exist_ok=True)
        #: written by the signal handler (lock-free: a plain flag plus
        #: os.kill of the recorded child pids).
        self._preempted = False
        self._child_pids: List[int] = []
        #: the live attempt geometry the policy changes between attempts;
        #: every change is on the ledger before an attempt runs with it.
        self._processes = config.processes
        self._local_devices = config.local_devices
        self._shards = self._parse_shards(config.solver_args)
        self._shards0 = self._shards
        self._cache_mb: Optional[int] = None  # None = inherit env
        self._geometry_dirty = False
        #: /status state: plain attribute stores, read by HTTP threads.
        self._attempt = 0
        self._last_cause: Optional[str] = None
        self._no_progress = 0
        self._backoff_deadline: Optional[float] = None
        self._status_server = None
        #: where the child's ephemeral status server publishes its
        #: address; the campaign proxies it through its own stable port.
        self._solve_addr_file = pathlib.Path(config.log_dir) / "status_addr"

    # ----------------------------------------------------- geometry args

    @staticmethod
    def _parse_shards(args) -> Optional[int]:
        """The solve CLI's ``--devices N`` in the solver args, or None."""
        for i, a in enumerate(args):
            if a == "--devices" and i + 1 < len(args):
                try:
                    return int(args[i + 1])
                except ValueError:
                    return None
            if a.startswith("--devices="):
                try:
                    return int(a.split("=", 1)[1])
                except ValueError:
                    return None
        return None

    @staticmethod
    def _rewrite_devices(args: List[str], shards: int) -> List[str]:
        out = list(args)
        for i, a in enumerate(out):
            if a == "--devices" and i + 1 < len(out):
                out[i + 1] = str(shards)
                return out
            if a.startswith("--devices="):
                out[i] = f"--devices={shards}"
                return out
        return out

    def _effective_cache_mb(self) -> int:
        """The store cache budget the next attempt runs with: the
        policy's override, else store/blockstore's env default."""
        if self._cache_mb is not None:
            return self._cache_mb
        return env_int("GAMESMAN_STORE_CACHE_MB", 256)

    # ------------------------------------------------------------ signals

    def request_preempt(self) -> None:
        # Lock-free: the handler runs on the main thread between any two
        # bytecodes, so it takes no lock. Forward the grace signal to
        # every live attempt process; they drain and exit 75.
        self._preempted = True
        for pid in list(self._child_pids):
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass

    def install_signal_handlers(self):
        """SIGTERM/SIGINT preempt the campaign (and, forwarded, the
        attempt). Returns a restore callable; a no-op off the main
        thread."""
        previous = {}

        def _on_signal(signum, frame):
            self.request_preempt()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, _on_signal)
            except ValueError:
                pass

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        return restore

    # ----------------------------------------------------------- attempts

    def _attempt_env(self, attempt: int) -> dict:
        env = dict(os.environ)
        env.pop("GAMESMAN_FAULTS", None)
        for k in list(env):
            if k.startswith("GAMESMAN_FAULTS_RANK_"):
                env.pop(k)
        spec = ""
        if attempt <= len(self.cfg.chaos):
            spec = self.cfg.chaos[attempt - 1]
        if spec:
            if self._processes > 1:
                env["GAMESMAN_FAULTS_RANK_0"] = spec
            else:
                env["GAMESMAN_FAULTS"] = spec
        if self._cache_mb is not None:
            env["GAMESMAN_STORE_CACHE_MB"] = str(self._cache_mb)
        if self._processes == 1 and self.cfg.processes > 1:
            # Degraded from a world to one process: stale wiring in the
            # inherited env would dial a coordinator that is gone.
            for k in ("GAMESMAN_COORDINATOR", "GAMESMAN_NUM_PROCESSES",
                      "GAMESMAN_PROCESS_ID", "GAMESMAN_COORD_ADDR"):
                env.pop(k, None)
        if (self._geometry_dirty and self._processes == 1
                and self._shards):
            # An escalated one-process attempt must hold the new shard
            # count: GAMESMAN_FAKE_DEVICES lets that many shards share
            # the visible cards (parallel/mesh.py).
            env["GAMESMAN_FAKE_DEVICES"] = str(self._shards)
        # Every attempt checkpoints its flight recorder at level
        # boundaries into the log dir, so a SIGKILLed attempt still
        # leaves flightrec_<rank>.json; an operator's dir wins.
        env.setdefault("GAMESMAN_FLIGHTREC_DIR", str(self.cfg.log_dir))
        if self._status_server is not None:
            # The campaign owns the operator's port; the child binds an
            # ephemeral one and publishes it for the proxy.
            env["GAMESMAN_STATUS_PORT"] = "0"
            env["GAMESMAN_STATUS_ADDR_FILE"] = str(self._solve_addr_file)
        return env

    def _solver_args(self) -> List[str]:
        args = list(self.cfg.solver_args)
        if self._shards is not None and self._shards != self._shards0:
            args = self._rewrite_devices(args, self._shards)
        return args + ["--checkpoint-dir", str(self.cfg.checkpoint_dir)]

    def _status_payload(self) -> dict:
        """The campaign's /status body: attempt, backoff and breaker
        state, the checkpoint's progress, and the live attempt's own
        /status proxied under ``solve`` (one port across restarts). Runs
        on HTTP handler threads: reads only plain attributes."""
        now = time.monotonic()
        deadline = self._backoff_deadline
        payload = {
            "kind": "campaign",
            "attempt": self._attempt,
            "max_attempts": self.cfg.max_attempts,
            "last_cause": self._last_cause,
            "no_progress": self._no_progress,
            "no_progress_limit": self.cfg.no_progress_limit,
            "breaker": (
                "open" if self._no_progress >= self.cfg.no_progress_limit
                else "closed"
            ),
            "backoff_secs_remaining": (
                round(max(0.0, deadline - now), 3)
                if deadline is not None and deadline > now else None
            ),
            "preempted": self._preempted,
            "processes": self._processes,
            "shards": self._shards,
            "cache_mb": self._cache_mb,
            "progress": checkpoint_progress(self.cfg.checkpoint_dir),
        }
        try:
            addr = self._solve_addr_file.read_text().strip()
        except OSError:
            addr = None
        if addr:
            # Longer than the child's own scrape of its peers: rank 0 may
            # spend (W-1) x GAMESMAN_STATUS_SCRAPE_TIMEOUT on its fleet
            # view, and the proxy must not time out first.
            per_peer = env_float("GAMESMAN_STATUS_SCRAPE_TIMEOUT", 2.0)
            budget = max(5.0, per_peer * (self._processes + 1))
            payload["solve"] = obs_status.fetch_status(addr, timeout=budget)
        return payload

    def _run_attempt(self, attempt: int) -> dict:
        """Launch one attempt and wait it out; -> {"rcs": {rank: rc},
        "log_tails": {name: str}, "wall_secs": float}. A ``None`` rc
        means the attempt timeout killed a straggler."""
        t0 = time.monotonic()
        try:
            self._solve_addr_file.unlink()  # never proxy a dead child
        except OSError:
            pass
        timeout = self.cfg.attempt_timeout_secs or None
        if self._processes > 1:
            out = self._run_attempt_world(attempt, timeout)
        else:
            out = self._run_attempt_single(attempt, timeout)
        out["wall_secs"] = time.monotonic() - t0
        return out

    def _run_attempt_single(self, attempt: int, timeout) -> dict:
        log_dir = pathlib.Path(self.cfg.log_dir)
        out_path = log_dir / f"attempt_{attempt:03d}.out"
        err_path = log_dir / f"attempt_{attempt:03d}.err"
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "gamesmanmpi_tpu_torch",
                 *self._solver_args()],
                cwd=str(_REPO), env=self._attempt_env(attempt),
                stdout=out_f, stderr=err_f,
            )
            self._child_pids.append(proc.pid)
            try:
                try:
                    rc: Optional[int] = proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    rc = None
            finally:
                self._child_pids.remove(proc.pid)
                if proc.poll() is None:
                    # Timeout, or an unwinding exception: the attempt
                    # must not outlive its supervisor.
                    proc.kill()
                    proc.wait()
        return {
            "rcs": {0: rc},
            "log_tails": {"attempt": _tail(err_path) + _tail(out_path)},
        }

    def _run_attempt_world(self, attempt: int, timeout) -> dict:
        from gamesmanmpi_tpu_torch.parallel.launch import (
            DEFAULT_LOCAL_SHARDS,
            start_world,
        )

        world = start_world(
            self._solver_args(),
            processes=self._processes,
            log_dir=str(pathlib.Path(self.cfg.log_dir)
                        / f"attempt_{attempt:03d}"),
            env=self._attempt_env(attempt),
            local_shards=int(self._local_devices or DEFAULT_LOCAL_SHARDS),
        )
        self._child_pids.extend(world.pids())
        results = None
        try:
            # None waits forever, as the single-process path: the
            # attempt timeout is off by default.
            results = world.wait(timeout)
        finally:
            for pid in world.pids():
                if pid in self._child_pids:
                    self._child_pids.remove(pid)
            if results is None:
                # An unwinding exception: no rank outlives the campaign.
                world.send_signal(signal.SIGKILL)
        return {
            "rcs": {r.rank: r.returncode for r in results},
            "log_tails": {
                f"rank{r.rank}": r.stderr[-LOG_TAIL_BYTES:]
                + r.stdout[-LOG_TAIL_BYTES:]
                for r in results
            },
        }

    # ------------------------------------------------------ classification

    @staticmethod
    def classify(rcs: Dict[int, Optional[int]], log_tails: dict) -> str:
        """One word per death, for the ledger and the breaker."""
        if all(rc == 0 for rc in rcs.values()):
            return "complete"
        tails = " ".join(log_tails.values())
        if any(m in tails for m in ENOSPC_MARKERS):
            return "enospc"
        if any(m in tails for m in OOM_MARKERS):
            return "oom"
        codes = set(rcs.values())
        # Injected deaths first: in a world with rank 0 killed, the peers'
        # 124s are the coordinated abort's shadow; grace (75) likewise
        # beats 124.
        if KILL_EXIT_CODE in codes:
            return "killed"
        if TORN_EXIT_CODE in codes:
            return "torn_kill"
        if GRACE_EXIT_CODE in codes:
            return "preempted"
        if WATCHDOG_EXIT_CODE in codes:
            return "deadline_abort"
        if None in codes:
            return "timeout"
        if any(rc is not None and rc < 0 for rc in codes):
            return "signal"
        return "crash"

    # ------------------------------------------------- adaptive geometry

    def _maybe_revert_shards(self, cause: str, tails: str,
                             attempt: int) -> None:
        """An escalated attempt that died at mesh construction ("requested
        N shards but only M devices") asked for more than this host has:
        step the shard escalation back down (never below the original
        request) and keep the shrunken cache."""
        if cause != "crash" or not self._shards or not self._shards0:
            return
        if self._shards <= self._shards0:
            return
        if MESH_INFEASIBLE_MARKER not in tails:
            return
        prev = self._shards
        self._shards = max(self._shards0, self._shards // 2)
        self.ledger.log({
            "phase": "campaign_reshard",
            "attempt": attempt,
            "cause": "infeasible",
            "from_shards": prev,
            "to_shards": self._shards,
            "from_cache_mb": self._effective_cache_mb(),
            "to_cache_mb": self._effective_cache_mb(),
            "processes": self._processes,
        })
        default_registry().counter(
            "gamesman_campaign_reshards_total",
            "attempt-geometry escalations (shards/cache) between "
            "campaign attempts",
        ).inc()
        default_registry().counter(
            "gamesman_campaign_degrade_total",
            "graceful campaign degradations by kind",
            kind="infeasible",
        ).inc()
        self.echo(
            f"[campaign] escalated geometry is infeasible on this "
            f"host: reverting shards {prev}->{self._shards}"
        )

    def _apply_policy(self, cause: str, attempt: int) -> None:
        """Degradation between attempts: oom -> shards double (under
        ``max_shards``) and the store cache halves (to
        ``cache_floor_mb``); a lost rank (opt-in ``elastic_ranks``) ->
        the world at W-1 ranks. Each change is a ledger record and a
        ``gamesman_campaign_*`` counter before the next attempt."""
        if cause == "oom" and self.cfg.oom_escalate:
            from_shards = self._shards
            from_cache = self._effective_cache_mb()
            changed = False
            if self._shards and self._shards * 2 <= self.cfg.max_shards:
                self._shards *= 2
                if self._processes > 1:
                    # ceil(S / W) shards per rank.
                    self._local_devices = max(
                        int(self._local_devices or 1),
                        -(-self._shards // self._processes),
                    )
                changed = True
            new_cache = max(self.cfg.cache_floor_mb, from_cache // 2)
            if new_cache < from_cache:
                self._cache_mb = new_cache
                changed = True
            if not changed:
                return  # at the ceiling and the floor: a plain retry
            self._geometry_dirty = True
            self.ledger.log({
                "phase": "campaign_reshard",
                "attempt": attempt,
                "cause": cause,
                "from_shards": from_shards,
                "to_shards": self._shards,
                "from_cache_mb": from_cache,
                "to_cache_mb": self._effective_cache_mb(),
                "processes": self._processes,
            })
            default_registry().counter(
                "gamesman_campaign_reshards_total",
                "attempt-geometry escalations (shards/cache) between "
                "campaign attempts",
            ).inc()
            default_registry().counter(
                "gamesman_campaign_degrade_total",
                "graceful campaign degradations by kind",
                kind="oom",
            ).inc()
            self.echo(
                f"[campaign] oom: escalating geometry for the next "
                f"attempt (shards {from_shards}->{self._shards}, "
                f"store cache {from_cache}->"
                f"{self._effective_cache_mb()} MB)"
            )
        elif (cause in LOST_RANK_CAUSES and self.cfg.elastic_ranks
                and self._processes > 1):
            from_processes = self._processes
            self._processes -= 1
            if self._shards:
                self._local_devices = max(
                    int(self._local_devices or 1),
                    -(-self._shards // self._processes),
                )
            self._geometry_dirty = True
            self.ledger.log({
                "phase": "campaign_degrade",
                "attempt": attempt,
                "kind": "lost_rank",
                "cause": cause,
                "from_processes": from_processes,
                "to_processes": self._processes,
                "shards": self._shards,
            })
            default_registry().counter(
                "gamesman_campaign_degrade_total",
                "graceful campaign degradations by kind",
                kind="lost_rank",
            ).inc()
            self.echo(
                f"[campaign] lost rank ({cause}): retrying at "
                f"{self._processes} rank(s)"
            )

    # ------------------------------------------------------------- disk

    def _free_mb(self) -> float:
        return shutil.disk_usage(self.cfg.checkpoint_dir).free / (1 << 20)

    def _gc(self, reason: str) -> dict:
        """Retention GC on the quiescent tree (no attempt is live). The
        checkpointer (which imports torch, never CUDA) loads here, so a
        campaign that never collects never imports it."""
        free_before = self._free_mb()
        from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

        ck = LevelCheckpointer(self.cfg.checkpoint_dir)
        quarantined = ck.quarantine_inventory()
        freed = ck.gc_superseded()
        self.ledger.log({
            "phase": "campaign_gc",
            "reason": reason,
            "freed_files": freed["files"],
            "freed_bytes": freed["bytes"],
            "kinds": freed["kinds"],
            "quarantined": quarantined,
            "free_mb_before": round(free_before, 1),
            "free_mb_after": round(self._free_mb(), 1),
        })
        self.echo(
            f"[campaign] gc ({reason}): freed {freed['files']} files / "
            f"{freed['bytes']} bytes"
        )
        return freed

    def _check_disk(self, had_enospc: bool) -> None:
        """ENOSPC death, soft threshold or hard floor -> retention GC
        first; still under the floor after it -> CampaignAborted."""
        free = self._free_mb()
        soft, floor = self.cfg.disk_soft_mb, self.cfg.disk_floor_mb
        if had_enospc or (soft > 0 and free < soft) \
                or (floor > 0 and free < floor):
            reason = ("enospc" if had_enospc
                      else "soft_threshold" if soft > 0 and free < soft
                      else "hard_floor")
            self._gc(reason)
            free = self._free_mb()
        if floor > 0 and free < floor:
            raise CampaignAborted(
                f"free disk {free:.1f} MiB under the hard floor "
                f"{floor:.1f} MiB after retention GC",
                DISK_FLOOR_EXIT_CODE,
            )

    # ---------------------------------------------------------- diagnosis

    def _write_diagnosis(self, reason: str, attempt: int,
                         last: Optional[dict]) -> str:
        """The abort bundle: progress, geometry, quarantine, and the last
        attempt's per-rank log tails and exit codes."""
        bundle = {
            "reason": reason,
            "attempts": attempt,
            "checkpoint_dir": str(self.cfg.checkpoint_dir),
            "progress": checkpoint_progress(self.cfg.checkpoint_dir),
            "geometry": {
                "attempt_shards": self._shards,
                "attempt_processes": self._processes,
                "cache_mb": self._cache_mb,
            },
            "quarantine": [
                {"file": p.name, "bytes": p.stat().st_size}
                for p in sorted(
                    pathlib.Path(self.cfg.checkpoint_dir).glob("*.corrupt"))
            ],
            "log_tails": (last or {}).get("log_tails", {}),
            "rcs": {str(k): v for k, v in (last or {}).get(
                "rcs", {}).items()},
        }
        path = pathlib.Path(self.cfg.ledger_path).with_name(
            "campaign_diagnosis.json")
        path.write_text(json.dumps(bundle, indent=1, default=str))
        return str(path)

    # ---------------------------------------------------------------- run

    def _backoff(self, consecutive_failures: int) -> float:
        return min(
            self.cfg.backoff_max_secs,
            self.cfg.backoff_base_secs * (2 ** max(
                0, consecutive_failures - 1)),
        )

    def _sleep_backoff(self, secs: float) -> None:
        deadline = time.monotonic() + secs
        self._backoff_deadline = deadline  # /status shows the countdown
        try:
            while not self._preempted and time.monotonic() < deadline:
                time.sleep(min(0.2, max(0.0, deadline - time.monotonic())))
        finally:
            self._backoff_deadline = None

    def run(self) -> int:
        # GAMESMAN_STATUS_PORT: the campaign holds the operator's port
        # across every attempt and proxies the live child through it.
        self._status_server = obs_status.maybe_status_server(
            self._status_payload)
        try:
            return self._run()
        finally:
            if self._status_server is not None:
                self._status_server.stop()
                self._status_server = None

    def _run(self) -> int:
        cfg = self.cfg
        t0 = time.monotonic()
        self.ledger.log({
            "phase": "campaign_start",
            "solver_args": self._solver_args(),
            "processes": cfg.processes,
            "max_attempts": cfg.max_attempts,
            "no_progress_limit": cfg.no_progress_limit,
            "chaos": cfg.chaos,
        })
        # One counter serves the breaker and the backoff curve: a failure
        # that made progress resets both.
        no_progress = 0
        last = None
        attempt = 0
        try:
            while True:
                if self._preempted:
                    self.ledger.log({"phase": "campaign_preempted",
                                     "attempts": attempt})
                    self.echo("[campaign] preempted; rerun to continue")
                    return GRACE_EXIT_CODE
                self._check_disk(had_enospc=False)
                attempt += 1
                self._attempt = attempt
                before = checkpoint_progress(cfg.checkpoint_dir)
                self.echo(
                    f"[campaign] attempt {attempt}/{cfg.max_attempts} "
                    f"(resume level {before['deepest_solved']}, "
                    f"forward {before['forward_levels']})"
                )
                last = self._run_attempt(attempt)
                cause = self.classify(last["rcs"], last["log_tails"])
                self._last_cause = cause
                flightrec.record(
                    "campaign_attempt", attempt=attempt, cause=cause,
                    rcs=json.dumps(
                        {str(k): v for k, v in last["rcs"].items()}),
                )
                if cause != "complete":
                    # The campaign's own ring lands next to the attempt's
                    # per-rank dumps.
                    flightrec.dump(cause, directory=cfg.log_dir,
                                   rank="campaign")
                after = checkpoint_progress(cfg.checkpoint_dir)
                progressed = progress_score(after) > progress_score(before)
                self.ledger.log({
                    "phase": "campaign_attempt",
                    "attempt": attempt,
                    "rcs": {str(k): v for k, v in last["rcs"].items()},
                    "cause": cause,
                    "wall_secs": round(last["wall_secs"], 3),
                    "resume_level": before["deepest_solved"],
                    "progressed": progressed,
                    "solved_before": len(before["solved_levels"]),
                    "solved_after": len(after["solved_levels"]),
                    "forward_after": after["forward_levels"],
                    # What this attempt ran with against what the tree
                    # was sealed at: sealed_shards != shards is a reshard
                    # adoption.
                    "shards": self._shards,
                    "processes": self._processes,
                    "cache_mb": self._cache_mb,
                    "sealed_shards": before.get("shards"),
                })
                if cause == "complete":
                    self.ledger.log({
                        "phase": "campaign_done",
                        "attempts": attempt,
                        "wall_secs": round(time.monotonic() - t0, 3),
                    })
                    self.echo(f"[campaign] solved after {attempt} "
                              "attempt(s)")
                    return 0
                self.echo(
                    f"[campaign] attempt {attempt} died: {cause} "
                    f"rcs={last['rcs']} progressed={progressed}"
                )
                if self._preempted:
                    # Our own forwarded SIGTERM: the attempt drained. A
                    # preemption, not a failure for the breaker.
                    self.ledger.log({"phase": "campaign_preempted",
                                     "attempts": attempt})
                    self.echo("[campaign] preempted; rerun to continue")
                    return GRACE_EXIT_CODE
                if cause == "enospc":
                    self._check_disk(had_enospc=True)
                self._maybe_revert_shards(
                    cause, " ".join(last["log_tails"].values()), attempt)
                self._apply_policy(cause, attempt)
                if progressed:
                    no_progress = 0
                else:
                    no_progress += 1
                self._no_progress = no_progress
                if no_progress >= cfg.no_progress_limit:
                    raise CampaignAborted(
                        f"{no_progress} consecutive attempts died "
                        f"(last cause: {cause}) without sealing "
                        "anything new",
                        NO_PROGRESS_EXIT_CODE,
                    )
                if attempt >= cfg.max_attempts and not progressed:
                    # The budget bounds flapping, not work: an attempt
                    # that sealed something new never ends the campaign.
                    raise CampaignAborted(
                        f"attempt budget exhausted "
                        f"({cfg.max_attempts}; last cause: {cause})",
                        NO_PROGRESS_EXIT_CODE,
                    )
                backoff = self._backoff(max(no_progress, 1))
                self.ledger.log({"phase": "campaign_backoff",
                                 "secs": round(backoff, 3)})
                self._sleep_backoff(backoff)
        except CampaignAborted as e:
            bundle = self._write_diagnosis(str(e), attempt, last)
            self.ledger.log({
                "phase": "campaign_abort",
                "reason": str(e),
                "code": e.code,
                "attempts": attempt,
                "diagnosis": bundle,
                "wall_secs": round(time.monotonic() - t0, 3),
            })
            self.echo(f"[campaign] ABORT: {e} (diagnosis: {bundle})")
            return e.code


def _tail(path, nbytes: int = LOG_TAIL_BYTES) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - nbytes))
            return fh.read().decode(errors="replace")
    except OSError:
        return ""


# ------------------------------------------------------- the command line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gamesmanmpi_tpu_torch.resilience.campaign",
        description="Drive one solve of the port to completion across "
        "failures: auto-resume, preemption grace, disk-budget GC, "
        "append-only ledger. Everything after -- goes to the solve CLI "
        "verbatim (e.g. -- --device cpu --devices 2).",
    )
    p.add_argument("game", help="game spec, e.g. connect4:w=5,h=5 "
                   "(passed to the solve CLI)")
    p.add_argument("--checkpoint-dir", required=True,
                   help="the campaign's one source of truth: attempts "
                   "resume from it, the ledger lives next to it")
    p.add_argument("--processes", type=int, default=1,
                   help="1 = one solve process; N>1 = a parallel/launch.py "
                   "torch.distributed world per attempt")
    p.add_argument("--max-attempts", type=int, default=None,
                   help="attempt budget: past it, the next attempt that "
                   "seals nothing new aborts (env "
                   "GAMESMAN_CAMPAIGN_MAX_ATTEMPTS, default 8)")
    p.add_argument("--no-progress", type=int, default=None, metavar="K",
                   help="breaker: abort after K consecutive attempts that "
                   "seal nothing new (env GAMESMAN_CAMPAIGN_NO_PROGRESS, "
                   "default 3)")
    p.add_argument("--backoff-base-secs", type=float, default=None,
                   help="first inter-attempt backoff, doubling per "
                   "consecutive failure (env "
                   "GAMESMAN_CAMPAIGN_BACKOFF_BASE_SECS, default 1)")
    p.add_argument("--backoff-max-secs", type=float, default=None,
                   help="backoff ceiling (env "
                   "GAMESMAN_CAMPAIGN_BACKOFF_MAX_SECS, default 60)")
    p.add_argument("--attempt-timeout", type=float, default=None,
                   metavar="S",
                   help="kill an attempt running longer than S seconds "
                   "(env GAMESMAN_CAMPAIGN_ATTEMPT_SECS; 0 = none)")
    p.add_argument("--disk-soft-mb", type=float, default=None,
                   help="run retention GC when free space drops below "
                   "this (env GAMESMAN_CKPT_DISK_SOFT_MB; 0 = off)")
    p.add_argument("--disk-floor-mb", type=float, default=None,
                   help="abort cleanly (exit 4, prefix intact) when free "
                   "space is below this after GC (env "
                   "GAMESMAN_CKPT_DISK_FLOOR_MB; 0 = off)")
    p.add_argument("--ledger", default=None, metavar="FILE",
                   help="campaign ledger path (default "
                   "<checkpoint-dir>/campaign.jsonl)")
    p.add_argument("--log-dir", default=None,
                   help="per-attempt solve logs (default "
                   "<checkpoint-dir>/logs)")
    p.add_argument("--elastic-ranks", action="store_true", default=None,
                   help="retry a lost-rank death (killed/signal/"
                   "deadline-abort/timeout) at W-1 ranks, floor 1 (env "
                   "GAMESMAN_CAMPAIGN_ELASTIC_RANKS, default off)")
    p.add_argument("--no-oom-escalate", action="store_true",
                   help="disable the oom policy (an oom death otherwise "
                   "doubles --devices under the shard cap and halves "
                   "GAMESMAN_STORE_CACHE_MB for the next attempt; env "
                   "GAMESMAN_CAMPAIGN_OOM_ESCALATE, default on)")
    p.add_argument("--max-shards", type=int, default=None,
                   help="ceiling for oom shard escalation (env "
                   "GAMESMAN_CAMPAIGN_MAX_SHARDS, default 64)")
    p.add_argument("--cache-floor-mb", type=int, default=None,
                   help="floor for oom store-cache shrinking (env "
                   "GAMESMAN_CAMPAIGN_CACHE_FLOOR_MB, default 16)")
    p.add_argument("--chaos", action="append", default=None,
                   metavar="SPEC",
                   help="GAMESMAN_FAULTS spec armed for attempt i (repeat "
                   "per attempt; later attempts run clean; a world arms "
                   "rank 0). For chaos drills, not production")
    p.add_argument("--local-devices", type=int, default=None,
                   help="multi-process: shards per rank (parallel/"
                   "launch.py's --local-shards, default 2)")
    p.add_argument("--status-port", type=int, default=None, metavar="P",
                   help="serve GET /status on this port for the whole "
                   "campaign, the live attempt's own status proxied "
                   "under 'solve' (env GAMESMAN_STATUS_PORT; 0 = "
                   "ephemeral; unset = off)")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Split on the first bare "--" here: argparse.REMAINDER after a
    # positional would swallow the campaign's own flags too.
    extra: list = []
    if "--" in argv:
        split = argv.index("--")
        argv, extra = argv[:split], argv[split + 1:]
    args = build_parser().parse_args(argv)
    if args.status_port is not None:
        # The env twin's CLI spelling; Campaign.run reads the env.
        os.environ["GAMESMAN_STATUS_PORT"] = str(args.status_port)
    for banned in ("--checkpoint-dir",):
        if banned in extra:
            print(f"error: {banned} is the campaign's to manage — set it "
                  "with the campaign flag", file=sys.stderr)
            return USAGE_EXIT_CODE
    if args.processes < 1:
        print("error: --processes must be >= 1", file=sys.stderr)
        return USAGE_EXIT_CODE
    cfg = CampaignConfig(
        solver_args=[args.game, *extra],
        checkpoint_dir=args.checkpoint_dir,
        processes=args.processes,
        max_attempts=args.max_attempts,
        no_progress_limit=args.no_progress,
        backoff_base_secs=args.backoff_base_secs,
        backoff_max_secs=args.backoff_max_secs,
        attempt_timeout_secs=args.attempt_timeout,
        disk_soft_mb=args.disk_soft_mb,
        disk_floor_mb=args.disk_floor_mb,
        oom_escalate=False if args.no_oom_escalate else None,
        max_shards=args.max_shards,
        cache_floor_mb=args.cache_floor_mb,
        elastic_ranks=args.elastic_ranks,
        ledger_path=args.ledger,
        log_dir=args.log_dir,
        chaos=list(args.chaos or []),
        local_devices=args.local_devices,
    )
    campaign = Campaign(cfg)
    restore = campaign.install_signal_handlers()
    try:
        return campaign.run()
    finally:
        restore()


if __name__ == "__main__":
    sys.exit(main())
