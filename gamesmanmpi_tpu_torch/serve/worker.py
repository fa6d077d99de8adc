"""Serving-fleet worker: one supervised process answering queries (port
of gamesmanmpi_tpu/serve/worker.py).

The body a `serve/supervisor.py` slot runs — forked from the supervisor
when the parent has never initialized CUDA (the CLI path: mmap page
cache and the imported interpreter come for free), or re-exec'd as
``python -m gamesmanmpi_tpu_torch.serve.worker <config-json>`` when fork
would inherit a live CUDA context (the supervisor picks the spawn mode,
see ``ServeSupervisor._use_fork``).

Each worker opens its readers on the config's ``device`` (the card by
default) after it starts. A worker that cannot reach that device fails
its warm start (exit 3): it never answers from another device.

Lifecycle (every transition reported on the heartbeat pipe as one JSON
line, which is the supervisor's only view of the worker):

1. ``hello`` — process is up; per-worker chaos re-armed from
   ``GAMESMAN_FAULTS_WORKER_<id>`` (the serving twin of the launcher's
   ``GAMESMAN_FAULTS_RANK_<i>``), then the ``serve.worker_spawn``
   fault point fires.
2. warm start — every routed DB passes the
   ``db.check.verify_for_serving`` gate (full check_db: checksums,
   sortedness, decided-ness; ``GAMESMAN_SERVE_VERIFY=0`` skips), then a
   ``QueryServer`` opens over the inherited listening socket and
   answers a self-probe (one real lookup per game — brings up the
   device and runs the query path once, off the serving path). Warm
   start BEATS (``status: "starting"``) the whole way: re-hashing a
   multi-GB DB can take minutes and must not trip the supervisor's
   silence deadline; a wedged warm start is caught by the worker's own
   ``GAMESMAN_SERVE_WARMSTART_SECS`` deadline instead.
3. ``ready`` — the worker joins the ready set; only now does the
   supervisor count it toward fleet health.
4. ``beat`` every ``GAMESMAN_SERVE_HEARTBEAT_SECS`` carrying the
   worker's own health status; a stopped pipe (crash) or stalled beat
   (hang — the ``serve.heartbeat`` fault point injects one) is what the
   supervisor's liveness deadline catches.
5. SIGTERM -> ``draining``: stop accepting, flush in-flight batches,
   ``bye``, exit 0. Any other death is a crash the supervisor restarts
   with backoff.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time

from gamesmanmpi_tpu_torch.utils.env import env_float, env_opt

#: Worker exit codes the supervisor distinguishes: a warm-start refusal
#: (bad DB, failed self-probe) is a *config/storage* problem that will
#: recur on restart, so the supervisor's storm breaker sees it quickly.
EXIT_WARMSTART_FAILED = 3
EXIT_CRASH = 70


class _Pipe:
    """Line-oriented JSON writer over the supervisor's heartbeat pipe.

    A broken pipe means the supervisor is gone — the worker records it
    and the caller drains: an unsupervised fleet worker must not linger
    as an orphan accept()ing on a socket nobody owns.
    """

    def __init__(self, fd: int):
        self.fd = fd
        self.broken = False

    def send(self, **msg) -> bool:
        if self.broken:
            return False
        try:
            os.write(self.fd, (json.dumps(msg) + "\n").encode())
            return True
        except (BrokenPipeError, OSError):
            self.broken = True
            return False


def _build_server(cfg: dict, listen_sock, registry):
    from gamesmanmpi_tpu_torch.db import DbReader
    from gamesmanmpi_tpu_torch.serve.server import QueryServer

    # The supervisor-owned cross-worker decoded-block segment: attach
    # by name (works identically for fork and exec spawns — nothing fd
    # shaped to inherit). Attach failure degrades to the private cache:
    # a missing/raced segment must never refuse a warm start.
    shm = None
    if cfg.get("shm_segment"):
        from gamesmanmpi_tpu_torch.store import ShmBlockCache

        try:
            shm = ShmBlockCache.attach(cfg["shm_segment"],
                                       registry=registry)
        except (FileNotFoundError, ValueError, OSError) as e:
            sys.stderr.write(
                f"[worker {cfg['worker_id']}] shm attach failed "
                f"({type(e).__name__}: {e}); using private cache only\n"
            )
    readers = {
        name: DbReader(db, registry=registry, shm=shm,
                       device=cfg.get("device", "cuda"))
        for name, db in cfg["entries"]
    }
    return QueryServer(
        readers=readers,
        listen_sock=listen_sock,
        worker_id=int(cfg["worker_id"]),
        window=float(cfg.get("window", 0.002)),
        cache_size=int(cfg.get("cache_size", 65536)),
        max_queue=int(cfg.get("max_queue", 1024)),
        request_timeout=cfg.get("request_timeout"),
        logger=_build_logger(cfg),
        registry=registry,
    )


def _build_logger(cfg: dict):
    """Worker-stamped JSONL stream (``serve.worker0.jsonl`` — the
    supervisor already qualified the path): tools/obs_report.py merges
    the per-worker streams the way it merges per-rank solve streams."""
    if not cfg.get("jsonl"):
        return None
    from gamesmanmpi_tpu_torch.utils.metrics import JsonlLogger, TagLogger

    return TagLogger(JsonlLogger(cfg["jsonl"]), worker=int(cfg["worker_id"]))


def _start_orphan_watch(wid: int) -> None:
    """Exit hard if this worker is ever reparented (supervisor died).

    The beat loop notices a dead supervisor through EPIPE on its next
    write — but WARM START writes nothing, so a worker wedged there
    (fork-from-a-threaded-parent is inherently racy: an inherited lock
    can deadlock the first kernel compile) would outlive a SIGKILLed
    supervisor forever, accept()ing on a socket nobody owns. Observed
    exactly once under the heartbeat chaos test before this watch.
    os._exit, not sys.exit: the wedge we are escaping could just as
    well hang a clean teardown.
    """
    ppid0 = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != ppid0:
                sys.stderr.write(
                    f"[worker {wid}] supervisor died (reparented); "
                    "exiting\n"
                )
                os._exit(EXIT_CRASH)

    threading.Thread(
        target=watch, name="gamesman-orphan-watch", daemon=True
    ).start()


# wire: producer
def run_worker(cfg: dict, listen_sock, pipe_fd: int) -> int:
    """The worker body; returns the process exit code, never raises.
    Every ``pipe.send(...)`` keyword and beat-dict key here crosses the
    supervisor pipe as JSON, hence the producer annotation."""
    from gamesmanmpi_tpu_torch.obs import MetricsRegistry
    from gamesmanmpi_tpu_torch.resilience import faults

    wid = int(cfg["worker_id"])
    pipe = _Pipe(pipe_fd)
    drain = threading.Event()
    _start_orphan_watch(wid)

    def _on_term(signum, frame):
        drain.set()

    # Fork inherits the supervisor's handlers (which would re-enter the
    # SUPERVISOR's drain logic in this process) — install the worker's
    # own before anything can deliver a signal.
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    # Per-worker chaos: a fleet-wide GAMESMAN_FAULTS arms every worker
    # identically, which is almost never what a worker-death scenario
    # wants — GAMESMAN_FAULTS_WORKER_<id> re-arms just this slot (every
    # respawn of the slot re-arms, so a spawn-death directive makes a
    # deterministic crash-looper for the storm-breaker tests).
    spec = env_opt(f"GAMESMAN_FAULTS_WORKER_{wid}")
    if spec is not None:
        faults.configure(spec)

    pipe.send(type="hello", pid=os.getpid())
    t_spawn = time.monotonic()
    beat_secs = max(0.05, float(cfg.get("heartbeat_secs", 1.0)))

    # Warm start must BEAT, not go silent: verifying a multi-GB DB can
    # legitimately take minutes, and the supervisor's liveness deadline
    # must not confuse that with a hang. Silence stays the hang signal;
    # a wedged warm start that still beats (a deadlocked compile thread
    # leaves the GIL free) is caught by the worker's own deadline.
    warm_deadline = env_float("GAMESMAN_SERVE_WARMSTART_SECS", 300.0)
    ready_evt = threading.Event()

    def _warm_beat():
        while not ready_evt.wait(beat_secs):
            if time.monotonic() - t_spawn > warm_deadline:
                pipe.send(type="failed",
                          error=f"warm start exceeded {warm_deadline:g}s")
                os._exit(EXIT_WARMSTART_FAILED)
            if not pipe.send(type="beat", status="starting"):
                os._exit(EXIT_CRASH)  # supervisor gone mid-warm-start

    threading.Thread(
        target=_warm_beat, name="gamesman-warm-beat", daemon=True
    ).start()
    server = None
    try:
        faults.fire("serve.worker_spawn", worker=wid)
        # A fresh registry (not the inherited process singleton): this
        # worker's /metrics must carry ITS serving series only, each
        # labeled worker=<id> — the per-rank labeling convention of
        # docs/OBSERVABILITY.md applied to the fleet.
        registry = MetricsRegistry()
        registry.set_constant_labels(worker=str(wid))
        from gamesmanmpi_tpu_torch.db.check import verify_for_serving

        verified = {}
        for name, db in cfg["entries"]:
            verified[name or "default"] = verify_for_serving(db)
        server = _build_server(cfg, listen_sock, registry)
        server.start()
        server.self_probe()
        warmup = time.monotonic() - t_spawn
        registry.gauge(
            "gamesman_serve_warmup_seconds",
            "spawn-to-ready wall seconds of this worker "
            "(verify gate + open + self-probe + kernel compiles)",
        ).set(warmup)
        pipe.send(
            type="ready", pid=os.getpid(), verified=verified,
            warmup_secs=round(warmup, 3),
            games=sorted(n or "default" for n, _ in cfg["entries"]),
        )
    except Exception as e:  # noqa: BLE001 - report, then die visibly
        pipe.send(type="failed", error=f"{type(e).__name__}: {e}"[:500])
        if server is not None:
            try:
                server.stop()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        return EXIT_WARMSTART_FAILED
    finally:
        ready_evt.set()  # warm-start beats end; the ready loop's begin

    code = 0
    try:
        while not drain.wait(beat_secs):
            # The heartbeat IS the liveness signal: an injected delay
            # here (serve.heartbeat:delay=...) stalls the beats and the
            # supervisor's deadline turns the silent hang into a
            # SIGKILL + restart — exactly what a wedged worker gets.
            faults.fire("serve.heartbeat", worker=wid)
            beat = {
                "type": "beat",
                "status": server.healthz()["status"],
                "inflight": server.inflight,
                # The burn-rate snapshot rides every beat so the control
                # port's /status can show WHY a worker is degraded (which
                # route/objective is past fast-burn), not just that it is.
                "slo": server.slo.snapshot(),
            }
            # Newly tail-sampled traces ride the beat (bounded batch):
            # the workers share one accept queue, so the supervisor
            # cannot HTTP-address THIS worker's /traces — the heartbeat
            # pipe is the only per-worker channel, and it aggregates the
            # fleet ring the control port serves.
            sampled = server.trace_ring.drain_outbox(8)
            if sampled:
                beat["traces"] = sampled
            if not pipe.send(**beat):
                drain.set()  # supervisor gone: drain and exit
    except Exception as e:  # noqa: BLE001 - a faulted beat is a crash
        pipe.send(type="failed", error=f"{type(e).__name__}: {e}"[:500])
        code = EXIT_CRASH
    pipe.send(type="draining")
    try:
        server.stop()
    except Exception:  # noqa: BLE001 - teardown best-effort
        code = code or EXIT_CRASH
    pipe.send(type="bye", code=code)
    return code


def main(argv=None) -> int:
    """Exec-spawn entry: ``python -m gamesmanmpi_tpu_torch.serve.worker
    '<config json>'`` with the listening socket and pipe inherited as
    the fd numbers named in the config."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m gamesmanmpi_tpu_torch.serve.worker CONFIG_JSON",
              file=sys.stderr)
        return 2
    cfg = json.loads(argv[0])
    listen_sock = socket.socket(fileno=int(cfg["listen_fd"]))
    return run_worker(cfg, listen_sock, int(cfg["pipe_fd"]))


if __name__ == "__main__":
    sys.exit(main())
