"""Serving-fleet supervisor: N query-serving workers, one socket (port
of gamesmanmpi_tpu/serve/supervisor.py).

One Python process cannot serve millions of users: a single GIL and a
single crash domain sit between the solved DBs and the traffic. This
module is the process-tree answer: a supervisor that

* binds the listening socket ONCE (``LISTEN_BACKLOG`` deep) and opens
  every fleet DB's ``DbReader`` in the parent, then
* spawns N workers that share the socket's accept queue — by ``fork``
  while the parent has never initialized CUDA (the CLI path: the mmap'd
  DB pages, the page cache, and the imported interpreter all come for
  free), by re-exec (``python -m gamesmanmpi_tpu_torch.serve.worker``
  with inherited fds) when it has, since a CUDA context does not survive
  fork, and
* owns their lifecycle: liveness via a heartbeat pipe per worker
  (crash = pipe EOF, hang = beat deadline), bounded exponential-backoff
  restart with a restart-storm breaker, warm-start gating (a worker
  joins the ready set only after ``db.check.verify_for_serving`` and a
  real self-probe — see serve/worker.py), and rolling restart / rolling
  fleet-manifest reload that drains ONE worker at a time so in-flight
  requests are never dropped.

The supervisor never serves queries itself and never touches the CUDA
driver: its readers are opened with no device (``device=None``), the
device name travels in each worker's config, and every worker resolves
it after the fork. A forked worker runs torch's CPU ops on one thread:
the fleet's parallelism is its processes, and an OpenMP pool inherited
from a parent that already ran parallel torch work hangs the child at
its first parallel op. Its control surface is a tiny HTTP endpoint (``/healthz``
aggregating per-worker state, ``/metrics``, ``POST /reload``) on a
separate control port.

Thread model: one scheduler thread (``run``) owns the state machine;
the control server's handler threads and signal handlers only read
snapshots (``status()``) or set request flags — both under ``_lock`` —
and wake the scheduler through a self-pipe. Worker-death handling is
edge-triggered off the pipes, so the idle supervisor costs zero CPU.
"""

from __future__ import annotations

import collections
import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.serve.manifest import FleetEntry, load_fleet_manifest
from gamesmanmpi_tpu_torch.serve.server import LISTEN_BACKLOG, PROMETHEUS_CONTENT_TYPE
from gamesmanmpi_tpu_torch.utils.env import env_float, env_int

__all__ = ["ServeSupervisor", "FleetEntry", "load_fleet_manifest"]

#: Slot states. ``broken`` is the restart-storm breaker: the slot has
#: died so often inside the storm window that restarting it immediately
#: would only burn CPU on a crash loop — it waits out a cool-off, then
#: half-opens with one more spawn attempt.
STATES = ("starting", "ready", "draining", "restarting", "broken", "stopped")


class _ForkProc:
    """Child handle for the fork spawn path (waitpid-based)."""

    def __init__(self, pid: int):
        self.pid = pid
        self._rc = None

    def kill(self, sig) -> None:
        if self._rc is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def poll(self):
        if self._rc is None:
            try:
                pid, status = os.waitpid(self.pid, os.WNOHANG)
            except ChildProcessError:
                return None
            if pid == self.pid:
                self._rc = os.waitstatus_to_exitcode(status)
        return self._rc


class _ExecProc:
    """Child handle for the re-exec spawn path (Popen-based)."""

    def __init__(self, proc):
        self._proc = proc
        self.pid = proc.pid

    def kill(self, sig) -> None:
        try:
            self._proc.send_signal(sig)
        except ProcessLookupError:
            pass

    def poll(self):
        return self._proc.poll()


class _Slot:
    """One worker slot's record. Mutated only under the supervisor's
    ``_lock`` (the scheduler thread does the mutating; the control
    thread reads copies via ``status()``)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.gen = -1  # config generation the running worker was built from
        self.proc = None
        self.fd = None  # heartbeat pipe read end
        self.buf = b""
        self.state = "restarting"  # pre-first-spawn: due immediately
        self.pid = None
        self.health = "unknown"  # worker-reported /healthz status
        self.heard = False  # any pipe bytes from the CURRENT process yet
        self.half_open = False  # this spawn is a breaker's single probe
        self.last_msg = 0.0  # monotonic time of the last pipe message
        self.ready_info: dict = {}
        self.restarts = 0
        self.recent: list = []  # restart times inside the storm window
        self.backoff_n = 0
        self.next_spawn_at = 0.0  # monotonic; None = no spawn scheduled
        self.drain_deadline = None
        self.last_error = None
        self.slo: dict = {}  # latest burn-rate snapshot off the beat


class ServeSupervisor:
    """Fleet supervisor; construct, then ``run()`` (or ``start()`` for a
    background scheduler in tests/benches)."""

    def __init__(self, entries, *, workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 control_port: int | None = 0,
                 manifest_path=None,
                 server_config: dict | None = None,
                 jsonl=None,
                 heartbeat_secs: float | None = None,
                 heartbeat_timeout: float | None = None,
                 restart_base: float | None = None,
                 restart_max: float | None = None,
                 storm_restarts: int | None = None,
                 storm_secs: float | None = None,
                 drain_grace: float = 10.0,
                 spawn=None, logger=None, registry=None,
                 device: str = "cuda"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.entries: list[FleetEntry] = list(entries)
        if not self.entries:
            raise ValueError("a fleet needs at least one DB entry")
        self.workers = int(workers)
        #: Where every worker's reader canonicalizes and expands; the
        #: name is resolved in the worker, after the fork.
        self.device = str(device)
        self.manifest_path = manifest_path
        self.server_config = dict(server_config or {})
        self.jsonl = jsonl
        self.logger = logger
        self.registry = registry or default_registry()
        self.drain_grace = float(drain_grace)
        self.heartbeat_secs = (
            env_float("GAMESMAN_SERVE_HEARTBEAT_SECS", 1.0)
            if heartbeat_secs is None else float(heartbeat_secs)
        )
        if heartbeat_timeout is None:
            heartbeat_timeout = env_float(
                "GAMESMAN_SERVE_HEARTBEAT_TIMEOUT",
                max(5.0, 5.0 * self.heartbeat_secs),
            )
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.restart_base = (
            env_float("GAMESMAN_SERVE_RESTART_BASE_SECS", 0.5)
            if restart_base is None else float(restart_base)
        )
        self.restart_max = (
            env_float("GAMESMAN_SERVE_RESTART_MAX_SECS", 30.0)
            if restart_max is None else float(restart_max)
        )
        self.storm_restarts = max(2, (
            env_int("GAMESMAN_SERVE_STORM_RESTARTS", 5)
            if storm_restarts is None else int(storm_restarts)
        ))
        self.storm_secs = (
            env_float("GAMESMAN_SERVE_STORM_SECS", 60.0)
            if storm_secs is None else float(storm_secs)
        )
        # Before the worker's FIRST pipe byte the silence deadline has
        # not started: a cold exec spawn pays interpreter + torch import
        # before it can say "hello", which must not read as a hang.
        self.spawn_grace = max(
            self.heartbeat_timeout,
            env_float("GAMESMAN_SERVE_SPAWN_GRACE_SECS", 60.0),
        )
        # The fleet's one listening socket: bound and listening BEFORE
        # any worker exists, so the accept queue outlives every one of
        # them — during a rolling restart arriving connections simply
        # wait in the backlog for the next accept.
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(LISTEN_BACKLOG)
        self.host, self.port = self._sock.getsockname()[:2]
        # Parent-side readers: opened BEFORE any spawn — this validates
        # every DB's identity once, establishes the mmaps whose
        # file-backed pages all workers share through the page cache,
        # and is what "fork after DbReader open" buys on the fork path.
        # They have no device, so the parent never probes (a probe on
        # the card would initialize CUDA and forbid fork).
        self.readers = self._open_readers(self.entries)
        # Cross-worker decoded-block cache (store/shm.py):
        # the supervisor owns segment lifecycle — created here, name
        # handed to every worker cfg, swapped on a manifest reload
        # (stale epochs already read as misses; the swap just drops the
        # dead weight), unlinked at shutdown. None when disabled
        # (GAMESMAN_SHM_CACHE_MB=0) or no fleet DB has blocked levels
        # (v1 DBs mmap — there is nothing decoded to share).
        self._shm_seq = 0
        self._shm_backup = None  # pre-roll segment; guarded-by: _lock
        self._shm = self._create_shm()
        self._spawn = spawn or self._default_spawn
        self._spawn_mode = "fork" if self._use_fork() else "exec"
        self._sel = selectors.DefaultSelector()
        self._by_fd: dict = {}  # fd -> slot (scheduler thread only)
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._slots = [_Slot(i) for i in range(self.workers)]
        self._gen = 0
        # Signal-safe request flags: WRITTEN lock-free from signal
        # handlers / any thread (atomic attribute store), read by the
        # scheduler. Everything else below is lock-guarded.
        self._stop_requested = False
        self._reload_requested = False
        self._stopping = False  # guarded-by: _lock
        self._last_reload_error = None  # guarded-by: _lock
        self._roll_queue = None  # guarded-by: _lock
        self._roll_backup = None  # pre-roll (entries, readers); guarded-by: _lock
        self._rolling_back = False  # guarded-by: _lock
        self._reloads_done = 0  # guarded-by: _lock
        # Last registry sync report (POST /registry-sync from the pull
        # client, registry/pull.py): what epoch set the replica last
        # tried to land and whether the roll happened. None until a
        # sync ever reported.
        self._registry_sync = None  # guarded-by: _lock
        # Fleet-wide trace ring: workers tail-sample per-request traces
        # (obs/qtrace.py) and ship newly kept ones on heartbeat beats —
        # the only per-worker channel, since all workers share one
        # accept queue and cannot be HTTP-addressed individually. The
        # control port serves the aggregate at GET /traces.
        self._fleet_traces: collections.deque = collections.deque(
            maxlen=max(1, env_int("GAMESMAN_TRACE_FLEET_RING", 2048))
        )  # guarded-by: _lock
        self._thread = None
        self._control = None
        self._control_thread = None
        self.control_port = None
        if control_port is not None:
            self._control = _ControlServer((host, int(control_port)), self)
            self.control_port = self._control.server_address[1]

    # ------------------------------------------------------------- plumbing

    @staticmethod
    def _open_readers(entries):
        from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader

        readers: dict = {}
        entry = None
        try:
            for entry in entries:
                readers[entry.name] = DbReader(entry.db, device=None)
        except OSError as exc:
            _close_readers(readers)
            # An unreadable DB is a DB problem, not a bind problem: let
            # callers' DbFormatError handling attribute it correctly.
            raise DbFormatError(
                f"cannot open DB {entry.db}: {exc}"
            ) from exc
        except Exception:
            _close_readers(readers)
            raise
        return readers

    def _create_shm(self):
        """Create the fleet's shared decoded-block segment, sized from
        the manifests: one slot holds the largest decoded (keys, cells)
        block pair any routed DB can produce, and the
        ``GAMESMAN_SHM_CACHE_MB`` budget caps the whole segment. A
        creation failure (exhausted /dev/shm, tiny budget) degrades to
        per-worker private caches — never a refusal to serve."""
        budget_mb = env_int("GAMESMAN_SHM_CACHE_MB", 256)
        if budget_mb <= 0:
            return None
        from gamesmanmpi_tpu_torch.db.format import level_is_blocked

        slot_bytes = 0
        for reader in self.readers.values():
            for rec in reader.manifest["levels"].values():
                if not level_is_blocked(rec):
                    continue
                nbytes = sum(
                    int(idx["block_positions"])
                    * np.dtype(idx["dtype"]).itemsize
                    for idx in (rec["keys_blocks"], rec["cells_blocks"])
                )
                slot_bytes = max(slot_bytes, nbytes)
        if slot_bytes == 0:
            return None
        from gamesmanmpi_tpu_torch.store import ShmBlockCache

        self._shm_seq += 1
        name = f"gmshm-{os.getpid()}-{self._shm_seq}"
        try:
            shm = ShmBlockCache.create(
                name, slot_bytes=slot_bytes,
                budget_bytes=budget_mb << 20, registry=self.registry,
            )
        except (ValueError, OSError) as e:
            self._log({"phase": "serve_shm_disabled",
                       "error": f"{type(e).__name__}: {e}"[:300]})
            return None
        self._log({"phase": "serve_shm_created", "segment": name,
                   "nslots": shm.nslots, "slot_bytes": shm.slot_bytes})
        return shm

    @staticmethod
    def _unlink_shm(shm) -> None:
        if shm is not None:
            try:
                shm.unlink()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass

    @staticmethod
    def _use_fork() -> bool:
        """Fork only while this process has never initialized CUDA: a
        CUDA context does not survive fork, and a worker that inherits
        one fails at its first CUDA call. After CUDA init, workers
        re-exec instead."""
        if not hasattr(os, "fork"):
            return False
        torch = sys.modules.get("torch")
        return torch is None or not torch.cuda.is_initialized()

    def _log(self, record: dict) -> None:
        if self.logger is not None:
            self.logger.log(record)

    def _worker_cfg(self, slot) -> dict:
        cfg = {
            "worker_id": slot.idx,
            "entries": [[e.name, e.db] for e in self.entries],
            "heartbeat_secs": self.heartbeat_secs,
            "device": self.device,
            **self.server_config,
        }
        if self.jsonl:
            cfg["jsonl"] = _worker_path(self.jsonl, slot.idx)
        if self._shm is not None:
            cfg["shm_segment"] = self._shm.name
        return cfg

    def _default_spawn(self, slot_idx: int, cfg: dict):
        """Spawn a worker process; returns (proc handle, pipe read fd)."""
        r, w = os.pipe()
        if self._spawn_mode == "fork":
            # Grab every fd the child must NOT keep before forking.
            other_fds = [s.fd for s in self._slots
                         if s.fd is not None] + [r, self._wake_r,
                                                 self._wake_w]
            control_fd = (self._control.fileno()
                          if self._control is not None else None)
            pid = os.fork()
            if pid == 0:
                from gamesmanmpi_tpu_torch.serve.worker import EXIT_CRASH, run_worker

                code = EXIT_CRASH
                try:
                    # An inherited OpenMP pool is dead in the child: one
                    # thread, before any torch op can wait on it.
                    torch = sys.modules.get("torch")
                    if torch is not None:
                        torch.set_num_threads(1)
                    for fd in other_fds:
                        try:
                            os.close(fd)
                        except OSError:
                            pass
                    if control_fd is not None:
                        try:
                            os.close(control_fd)
                        except OSError:
                            pass
                    code = run_worker(cfg, self._sock, w)
                except BaseException as e:  # noqa: BLE001 - report + die
                    sys.stderr.write(f"[worker {slot_idx}] crashed in "
                                     f"spawn: {e!r}\n")
                finally:
                    # Never run the supervisor's atexit/stack in a child.
                    os._exit(code)
            os.close(w)
            return _ForkProc(pid), r
        sock_fd = self._sock.fileno()
        child_cfg = dict(cfg, listen_fd=sock_fd, pipe_fd=w)
        proc = subprocess.Popen(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch.serve.worker",
             json.dumps(child_cfg)],
            pass_fds=(sock_fd, w),
        )
        os.close(w)
        return _ExecProc(proc), r

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    # ---------------------------------------------------------- public API

    def request_stop(self) -> None:
        # NO lock here: CPython runs signal handlers on the scheduler's
        # own main thread (the CLI path), so taking the non-reentrant
        # lock from a handler that interrupted a `with _lock:` block
        # would deadlock the supervisor. A plain attribute store and a
        # pipe write are both safe from a handler.
        self._stop_requested = True
        self._wake()

    def request_reload(self) -> None:
        """Ask the scheduler for a rolling reload (re-read the fleet
        manifest when one was given, then drain-and-replace one worker
        at a time). Safe from any thread / signal handler (lock-free —
        see request_stop)."""
        self._reload_requested = True
        self._wake()

    def note_registry_sync(self, info: dict) -> None:
        """Record a registry pull client's sync report (shown in
        /status as ``registry_sync``) — observability only; the roll
        itself arrives via the normal request_reload path."""
        keep = {
            k: info.get(k)
            for k in ("status", "epochs", "failed", "wall_time")
        }
        with self._lock:
            self._registry_sync = keep

    # wire: producer
    def status(self) -> dict:
        """Fleet-level health snapshot (the control /healthz payload)."""
        now = time.monotonic()
        with self._lock:
            workers = {}
            ready = 0
            for s in self._slots:
                if s.state == "ready":
                    ready += 1
                workers[str(s.idx)] = {
                    "state": s.state,
                    "pid": s.pid,
                    "health": s.health,
                    "restarts": s.restarts,
                    "breaker": "open" if s.state == "broken" else "ok",
                    "gen": s.gen,
                    "last_beat_age": round(now - s.last_msg, 3)
                    if s.last_msg else None,
                    "last_error": s.last_error,
                    "verified": s.ready_info.get("verified"),
                    "warmup_secs": s.ready_info.get("warmup_secs"),
                    "slo": s.slo or None,
                }
            degraded = any(
                s.state == "ready" and s.health not in ("ok", "unknown")
                for s in self._slots
            )
            if self._stopping:
                status = "draining"
            elif ready == self.workers and not degraded:
                status = "ok"
            elif ready > 0:
                status = "degraded"
            else:
                status = "down"
            return {
                "status": status,
                "workers": workers,
                "workers_total": self.workers,
                "ready": ready,
                "port": self.port,
                "control_port": self.control_port,
                "games": sorted(e.name or "default" for e in self.entries),
                "gen": self._gen,
                "reload_in_progress": self._roll_queue is not None,
                "reloads_done": self._reloads_done,
                "last_reload_error": self._last_reload_error,
                "spawn_mode": self._spawn_mode,
                "slo_fast_burn": any(
                    s.slo.get("fast_burn") for s in self._slots
                ),
                "registry_sync": self._registry_sync,
            }

    def traces(self) -> dict:
        """Fleet-wide sampled-trace snapshot (the control /traces
        payload): every tail-kept query trace workers shipped on their
        beats, oldest first, bounded by GAMESMAN_TRACE_FLEET_RING."""
        with self._lock:
            recs = list(self._fleet_traces)
        return {"kind": "qtrace_fleet", "count": len(recs), "traces": recs}

    def start(self):
        """Run the scheduler in a background thread (tests, benches)."""
        self._thread = threading.Thread(
            target=self.run, name="gamesman-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self.request_stop()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def run(self) -> int:
        """The scheduler loop: spawn, supervise, roll, drain, exit 0."""
        if self._control is not None:
            self._control_thread = threading.Thread(
                target=self._control.serve_forever,
                name="gamesman-supervisor-control", daemon=True,
            )
            self._control_thread.start()
        try:
            while True:
                with self._lock:
                    if self._stop_requested:
                        break
                self._poll(0.25)
        finally:
            self._shutdown()
        return 0

    # ------------------------------------------------------- scheduler loop

    def _poll(self, max_wait: float) -> None:
        now = time.monotonic()
        self._spawn_due(now)
        self._handle_reload_request()
        self._advance_roll(now)
        deadline = self._earliest_deadline(now)
        wait = max(0.0, min(max_wait, deadline - now))
        self._dispatch_events(self._sel.select(wait))
        # A slow handler above (a _reap can block the scheduler for up
        # to ~2 s on a wedged teardown) leaves sibling beats unread in
        # their pipe buffers; judging silence on last_msg now would
        # SIGKILL healthy workers. Drain whatever is already readable
        # first (bounded passes — each consumes all that was ready).
        for _ in range(4):
            events = self._sel.select(0)
            if not events:
                break
            self._dispatch_events(events)
        self._check_liveness(time.monotonic())

    def _dispatch_events(self, events) -> None:
        for key, _ in events:
            if key.fd == self._wake_r:
                try:
                    os.read(self._wake_r, 4096)
                except OSError:
                    pass
                continue
            self._drain_pipe(key.fd)

    def _silence_allowance(self, slot) -> float:
        """Seconds of pipe silence this slot is allowed right now: the
        spawn grace until its FIRST byte (interpreter + torch import on a
        cold exec spawn), the beat deadline after."""
        return self.heartbeat_timeout if slot.heard else self.spawn_grace

    def _earliest_deadline(self, now: float) -> float:
        horizon = now + 60.0
        with self._lock:
            for s in self._slots:
                if s.next_spawn_at is not None and s.state in (
                        "restarting", "broken"):
                    horizon = min(horizon, s.next_spawn_at)
                if s.state in ("starting", "ready") and s.last_msg:
                    horizon = min(
                        horizon, s.last_msg + self._silence_allowance(s)
                    )
                if s.drain_deadline is not None:
                    horizon = min(horizon, s.drain_deadline)
        return horizon

    def _spawn_due(self, now: float) -> None:
        with self._lock:
            if self._stopping:
                return
            due = [
                s for s in self._slots
                if s.state in ("restarting", "broken")
                and s.next_spawn_at is not None and s.next_spawn_at <= now
            ]
        for slot in due:
            self._spawn_slot(slot, now)

    def _spawn_slot(self, slot, now: float) -> None:
        cfg = None
        with self._lock:
            was_broken = slot.state == "broken"
            slot.gen = self._gen
            cfg = self._worker_cfg(slot)
        try:
            proc, fd = self._spawn(slot.idx, cfg)
        except Exception as e:  # noqa: BLE001 - a failed spawn is a death
            with self._lock:
                slot.last_error = f"spawn failed: {e!r}"
            self._schedule_restart(slot, now, f"spawn failed: {e!r}")
            return
        os.set_blocking(fd, False)
        self._sel.register(fd, selectors.EVENT_READ, slot)
        self._by_fd[fd] = slot
        with self._lock:
            slot.proc = proc
            slot.fd = fd
            slot.buf = b""
            slot.state = "starting"
            slot.pid = proc.pid
            slot.health = "unknown"
            slot.heard = False
            slot.half_open = was_broken
            slot.last_msg = now
            slot.ready_info = {}
            slot.next_spawn_at = None
            slot.drain_deadline = None
        if was_broken:
            self.registry.gauge(
                "gamesman_serve_storm_breaker_open",
                "1 while a slot's restart-storm breaker is open",
                worker=str(slot.idx),
            ).set(0)
        self._log({"phase": "serve_worker_spawn", "worker": slot.idx,
                   "pid": proc.pid})

    def _drain_pipe(self, fd: int) -> None:
        slot = self._by_fd.get(fd)
        if slot is None:
            return
        eof = False
        chunks = []
        while True:
            try:
                data = os.read(fd, 65536)
            except BlockingIOError:
                break
            except OSError:
                eof = True
                break
            if not data:
                eof = True
                break
            chunks.append(data)
        now = time.monotonic()
        if chunks:
            with self._lock:
                slot.buf += b"".join(chunks)
                slot.heard = True
                slot.last_msg = now
                lines, _, slot.buf = slot.buf.rpartition(b"\n")
            for line in lines.splitlines():
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                self._on_msg(slot, msg, now)
        if eof:
            self._on_pipe_eof(slot, now)

    # wire: consumer
    def _on_msg(self, slot, msg: dict, now: float) -> None:
        kind = msg.get("type")
        if kind == "hello":
            with self._lock:
                slot.pid = msg.get("pid", slot.pid)
        elif kind == "ready":
            with self._lock:
                slot.state = "ready"
                slot.health = "ok"
                slot.ready_info = msg
                slot.backoff_n = 0
                slot.half_open = False  # the breaker's probe succeeded
                slot.last_error = None
            self.registry.gauge(
                "gamesman_serve_worker_up",
                "1 while this worker slot is in the ready set",
                worker=str(slot.idx),
            ).set(1)
            self._log({"phase": "serve_worker_ready", "worker": slot.idx,
                       "pid": slot.pid,
                       "warmup_secs": msg.get("warmup_secs")})
        elif kind == "beat":
            sampled = msg.get("traces") or ()
            with self._lock:
                slot.health = msg.get("status", "ok")
                slo = msg.get("slo")
                if isinstance(slo, dict):
                    slot.slo = slo
                for rec in sampled:
                    if isinstance(rec, dict):
                        rec.setdefault("worker", slot.idx)
                        self._fleet_traces.append(rec)
            self.registry.counter(
                "gamesman_serve_heartbeats_total",
                "worker heartbeats received by the supervisor",
                worker=str(slot.idx),
            ).inc()
            if sampled:
                self.registry.counter(
                    "gamesman_serve_traces_ingested_total",
                    "sampled query traces received on worker beats",
                    worker=str(slot.idx),
                ).inc(len(sampled))
        elif kind == "failed":
            with self._lock:
                slot.last_error = msg.get("error")
        elif kind == "draining":
            with self._lock:
                if slot.state != "draining":
                    slot.state = "draining"
                if slot.drain_deadline is None:
                    # An EXTERNAL SIGTERM (operator/process manager):
                    # the supervisor didn't start this drain, but it
                    # still owns the deadline — a teardown that wedges
                    # after announcing "draining" must not linger.
                    slot.drain_deadline = now + self.drain_grace

    def _on_pipe_eof(self, slot, now: float) -> None:
        if slot.fd is not None:
            try:
                self._sel.unregister(slot.fd)
            except (KeyError, ValueError):
                pass
            self._by_fd.pop(slot.fd, None)
            try:
                os.close(slot.fd)
            except OSError:
                pass
        rc = self._reap(slot)
        with self._lock:
            was = slot.state
            stopping = self._stopping
            slot.fd = None
            slot.proc = None
            slot.drain_deadline = None
        self.registry.gauge(
            "gamesman_serve_worker_up",
            "1 while this worker slot is in the ready set",
            worker=str(slot.idx),
        ).set(0)
        if stopping:
            with self._lock:
                slot.state = "stopped"
            return
        if was == "draining" and rc == 0:
            # A clean drained exit: the supervisor's own rolling
            # restart/reload, or an EXTERNAL SIGTERM (an operator or a
            # process manager poking one worker). Either way the slot
            # is replaced NOW, no backoff — the supervisor owns the
            # fleet size; only a whole-fleet stop parks slots.
            self._log({"phase": "serve_worker_drained",
                       "worker": slot.idx})
            self._spawn_slot(slot, now)
            return
        why = f"exit rc={rc}"
        with self._lock:
            if slot.last_error:
                why = f"{why} ({slot.last_error})"
        self._schedule_restart(slot, now, why)

    def _reap(self, slot):
        """Collect the dead worker's exit code; a process that outlives
        its own closed pipe (a wedged teardown) is SIGKILLed NOW — the
        scheduler thread must not wait it out, or sibling heartbeats sit
        unread long enough to read as stalls."""
        proc = slot.proc
        if proc is None:
            return None
        deadline = time.monotonic() + 0.1
        while time.monotonic() < deadline:
            rc = proc.poll()
            if rc is not None:
                return rc
            time.sleep(0.005)
        proc.kill(signal.SIGKILL)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            rc = proc.poll()
            if rc is not None:
                return rc
            time.sleep(0.01)
        return None

    def _schedule_restart(self, slot, now: float, why: str) -> None:
        with self._lock:
            slot.restarts += 1
            slot.recent = [
                t for t in slot.recent if t > now - self.storm_secs
            ] + [now]
            # A dead half-open probe re-opens the breaker DIRECTLY: the
            # prior deaths aged out of the window during the hold-down,
            # and "half-opens with ONE spawn" means one — not a fresh
            # storm budget of crash-loops per window.
            storm = slot.half_open \
                or len(slot.recent) >= self.storm_restarts
            if storm:
                # Restart-storm breaker: crash-looping this fast means
                # the problem is not transient (a rotted DB fails every
                # warm-start verify identically) — hold the slot down
                # for a full storm window, then half-open with ONE try.
                slot.state = "broken"
                delay = self.storm_secs
                slot.backoff_n = 0
            else:
                slot.state = "restarting"
                delay = min(
                    self.restart_base * (2 ** slot.backoff_n),
                    self.restart_max,
                )
                slot.backoff_n += 1
            slot.next_spawn_at = now + delay
            slot.last_error = why
        self.registry.counter(
            "gamesman_serve_worker_restarts_total",
            "worker deaths that scheduled a supervisor restart",
            worker=str(slot.idx),
        ).inc()
        if storm:
            self.registry.gauge(
                "gamesman_serve_storm_breaker_open",
                "1 while a slot's restart-storm breaker is open",
                worker=str(slot.idx),
            ).set(1)
        self._log({
            "phase": "serve_worker_death", "worker": slot.idx,
            "why": why, "restart_in_secs": round(delay, 3),
            "breaker": "open" if storm else "ok",
        })

    def _check_liveness(self, now: float) -> None:
        hung = []
        with self._lock:
            for s in self._slots:
                allowance = self._silence_allowance(s)
                if s.state in ("starting", "ready") and s.last_msg and \
                        now - s.last_msg > allowance:
                    s.last_error = (
                        f"heartbeat stall ({now - s.last_msg:.1f}s "
                        f"> {allowance:g}s)"
                    )
                    hung.append(s)
                elif s.drain_deadline is not None and \
                        now > s.drain_deadline:
                    s.last_error = "drain deadline exceeded"
                    hung.append(s)
        for s in hung:
            # A hung worker cannot drain; SIGKILL turns it into an
            # ordinary death (pipe EOF -> backoff restart).
            self._log({"phase": "serve_worker_hang", "worker": s.idx,
                       "why": s.last_error})
            if s.proc is not None:
                s.proc.kill(signal.SIGKILL)

    # -------------------------------------------------- rolling restart/reload

    def _handle_reload_request(self) -> None:
        with self._lock:
            requested = self._reload_requested
            rolling = self._roll_queue is not None
            stopping = self._stopping
            # Consume the flag only when acting on it: a reload asked
            # for DURING a roll stays pending and starts the moment the
            # current roll finishes — never silently dropped.
            if requested and not rolling:
                self._reload_requested = False
        if not requested or rolling or stopping:
            return
        prev = (self.entries, self.readers)
        try:
            faults.fire("serve.reload")
            if self.manifest_path is not None:
                entries = load_fleet_manifest(self.manifest_path)
                # Open the NEW readers before touching fleet state: a
                # manifest pointing at a missing/corrupt DB must fail
                # the reload here, with every worker still serving the
                # old fleet untouched.
                readers = self._open_readers(entries)
                self.entries = entries
                self.readers = readers
                # New fleet config -> new shared segment (sized for the
                # new DBs); the old one keeps serving the old-gen
                # workers until the roll finishes ("done" unlinks it).
                # Correctness never depends on this swap — a reloaded
                # DB's epoch turns every old slot into a miss.
                with self._lock:
                    self._shm_backup, self._shm = self._shm, None
                self._shm = self._create_shm()
        except Exception as e:  # noqa: BLE001 - a failed reload must not
            # take the fleet down: report it and keep serving as-is.
            with self._lock:
                self._last_reload_error = f"{type(e).__name__}: {e}"
            self._log({"phase": "serve_reload_failed",
                       "error": str(e)[:300]})
            return
        with self._lock:
            self._gen += 1
            self._roll_queue = [s.idx for s in self._slots]
            self._roll_backup = prev  # for a mid-roll abort
            self._rolling_back = False
            self._last_reload_error = None
            gen = self._gen
        self._log({"phase": "serve_reload_started", "gen": gen})

    def _advance_roll(self, now: float) -> None:
        action = None  # "done" | ("drain", slot, proc) | ("abort", slot)
        with self._lock:
            if self._roll_queue is None:
                return
            if not self._roll_queue:
                self._roll_queue = None
                self._reloads_done += 1
                action = "done"
            else:
                slot = self._slots[self._roll_queue[0]]
                if slot.state == "broken" and slot.gen == self._gen:
                    # The replacement cannot pass warm start on the new
                    # config (a structurally-valid manifest whose DB is
                    # rotted passes the parent's checks but fails the
                    # worker's verify gate). Waiting would wedge the
                    # roll forever at N-1 capacity with every future
                    # reload blocked behind it.
                    action = ("abort", slot)
                elif slot.state == "ready" and slot.gen == self._gen:
                    # Replacement is serving: move on next poll.
                    self._roll_queue.pop(0)
                elif slot.state == "ready":
                    # Old-generation worker: drain it (ONE at a time —
                    # every other worker keeps accepting, so in-flight
                    # requests are never dropped by the roll).
                    slot.state = "draining"
                    slot.drain_deadline = now + self.drain_grace
                    action = ("drain", slot, slot.proc)
                # else starting/draining/restarting: wait for the slot
        if action == "done":
            with self._lock:
                self._rolling_back = False
                backup, self._roll_backup = self._roll_backup, None
                shm_old, self._shm_backup = self._shm_backup, None
            if shm_old is not None and shm_old is not self._shm:
                # Every worker is on the new generation now — nothing
                # can still be attached to the pre-roll segment.
                self._unlink_shm(shm_old)
            if backup is not None and backup[1] is not self.readers:
                # A manifest roll replaced the fleet config: the
                # pre-roll readers are dead weight now — close them
                # instead of leaving multi-GB mmaps to the GC's
                # schedule. (A plain rolling RESTART keeps the same
                # reader dict; the identity check protects it.)
                _close_readers(backup[1])
            self.registry.counter(
                "gamesman_serve_reloads_total",
                "rolling reload/restart cycles completed",
            ).inc()
            self._log({"phase": "serve_reload_done"})
        elif action is not None and action[0] == "abort":
            self._abort_roll(action[1], now)
        elif action is not None and action[0] == "drain":
            _, slot, proc = action
            if proc is not None:
                proc.kill(signal.SIGTERM)
            self._log({"phase": "serve_worker_drain_begin",
                       "worker": slot.idx})

    def _abort_roll(self, slot, now: float) -> None:
        """A roll whose replacement worker cannot warm-start is aborted,
        not waited out: revert to the pre-roll config and roll the fleet
        BACK, so a rotted new DB costs one slot's restart churn instead
        of wedging the fleet at N-1 with every future reload blocked."""
        dropped = None
        with self._lock:
            if self._rolling_back:
                # The rollback itself hit a broken replacement: the old
                # config is rotting too. Stop rolling; the breaker's
                # cool-off keeps probing the slot on its own.
                self._roll_queue = None
                self._rolling_back = False
                self._last_reload_error = (
                    f"reload rollback also failed on worker {slot.idx}; "
                    "roll stopped"
                )
            else:
                if self._roll_backup is not None:
                    if self._roll_backup[1] is not self.readers:
                        dropped = self.readers  # the failed new config's
                    self.entries, self.readers = self._roll_backup
                if self._shm_backup is not None:
                    # Rolling back to the old config: the old segment
                    # (still warm with the old epoch's blocks) becomes
                    # current again; the failed config's segment dies.
                    dropped_shm = self._shm
                    self._shm, self._shm_backup = self._shm_backup, None
                    if dropped_shm is not None \
                            and dropped_shm is not self._shm:
                        self._unlink_shm(dropped_shm)
                self._gen += 1
                self._roll_queue = [s.idx for s in self._slots]
                self._rolling_back = True
                self._last_reload_error = (
                    f"reload aborted: worker {slot.idx} failed warm "
                    "start on the new config; rolling back"
                )
                # The crash-loop evidence belongs to the FAILED config;
                # probe the reverted one immediately, not after the
                # breaker's full cool-off.
                slot.next_spawn_at = now
            err = self._last_reload_error
        if dropped is not None:
            _close_readers(dropped)
        self._log({"phase": "serve_reload_aborted", "error": err})

    # -------------------------------------------------------------- shutdown

    def _shutdown(self) -> None:
        with self._lock:
            self._stopping = True
            live = [s for s in self._slots if s.proc is not None]
            for s in live:
                if s.state not in ("draining",):
                    s.state = "draining"
        for s in live:
            s.proc.kill(signal.SIGTERM)
        deadline = time.monotonic() + self.drain_grace
        while time.monotonic() < deadline:
            with self._lock:
                if all(s.proc is None for s in self._slots):
                    break
            for key, _ in self._sel.select(0.1):
                if key.fd != self._wake_r:
                    self._drain_pipe(key.fd)
                else:
                    try:
                        os.read(self._wake_r, 4096)
                    except OSError:
                        pass
        with self._lock:
            stragglers = [s for s in self._slots if s.proc is not None]
        for s in stragglers:
            s.proc.kill(signal.SIGKILL)
            self._reap(s)
            with self._lock:
                s.proc = None
                s.state = "stopped"
        if self._control is not None:
            self._control.shutdown()
            self._control.server_close()
        try:
            self._sel.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        self._sock.close()
        _close_readers(self.readers)
        with self._lock:
            backup, self._roll_backup = self._roll_backup, None
            shm, self._shm = self._shm, None
            shm_backup, self._shm_backup = self._shm_backup, None
        self._unlink_shm(shm)
        if shm_backup is not None and shm_backup is not shm:
            self._unlink_shm(shm_backup)  # stop() arrived mid-roll
        if backup is not None and backup[1] is not self.readers:
            _close_readers(backup[1])  # stop() arrived mid-roll
        self._log({"phase": "serve_supervisor_stopped"})


def _close_readers(readers: dict) -> None:
    """Best-effort close of a reader dict (teardown / replaced config)."""
    for reader in readers.values():
        try:
            reader.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass


def _worker_path(path: str, worker: int) -> str:
    """``serve.jsonl`` -> ``serve.worker0.jsonl``: the per-worker JSONL
    naming twin of the CLI's per-rank ``_rank_path``."""
    root, ext = os.path.splitext(path)
    return f"{root}.worker{worker}{ext}"


class _ControlHandler(BaseHTTPRequestHandler):
    server_version = "gamesman-supervisor/1"
    protocol_version = "HTTP/1.1"
    timeout = 30

    def log_message(self, fmt, *args):
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _send_json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def do_GET(self):  # noqa: N802 - http.server API
        sup = self.server.supervisor
        if self.path == "/healthz":
            self._send_json(200, sup.status())
        elif self.path == "/status":
            # Status parity with the solve stack's GAMESMAN_STATUS_PORT
            # endpoint (docs/OBSERVABILITY.md "Live status"): one URL
            # shape whether the process is a solver, a campaign, or
            # this serving fleet's supervisor.
            self._send_json(200, {"kind": "serve_fleet", **sup.status()})
        elif self.path == "/metrics":
            self._send(
                200, sup.registry.render_prometheus().encode(),
                PROMETHEUS_CONTENT_TYPE,
            )
        elif self.path == "/traces":
            self._send_json(200, sup.traces())
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self):  # noqa: N802 - http.server API
        sup = self.server.supervisor
        # Only /registry-sync reads a (bounded) body; every other POST
        # ignores it — so always drop the connection, and stray bytes
        # can't desync a keep-alive socket.
        self.close_connection = True
        if self.path == "/reload":
            sup.request_reload()
            self._send_json(202, {"ok": True, "status": "reload requested"})
        elif self.path == "/registry-sync":
            try:
                n = int(self.headers.get("Content-Length") or 0)
                if not 0 < n <= 1 << 20:
                    raise ValueError(f"bad Content-Length {n}")
                info = json.loads(self.rfile.read(n))
                if not isinstance(info, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, OSError) as e:
                self._send_json(400, {"error": f"bad sync report: {e}"})
                return
            sup.note_registry_sync(info)
            self._send_json(200, {"ok": True})
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})


class _ControlServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, supervisor):
        super().__init__(addr, _ControlHandler)
        self.supervisor = supervisor
