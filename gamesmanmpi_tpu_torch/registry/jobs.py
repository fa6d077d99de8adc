"""Solve-on-demand: a durable job queue and its runner (port of
gamesmanmpi_tpu/registry/jobs.py; either package replays the other's
ledger to the same state).

A query for a game nobody has published yet becomes a published DB
without a human in the loop. The queue is an fsync'd append-only JSONL
ledger: every state transition is one durable line and state is the
ledger's replay, so a runner SIGKILLed anywhere (mid-claim,
mid-campaign, mid-publish) loses nothing; the next runner replays,
reclaims the dead claim (pid gone or lease expired) and resumes.

Ledger ops::

    {"op": "enqueue",  "job": <id>, "spec": ..., "db_name": ...}
    {"op": "claim",    "job": <id>, "pid": ..., "lease_until": ...}
    {"op": "release",  "job": <id>, "error": ...}     back to pending
    {"op": "complete", "job": <id>, "epoch": ...}
    {"op": "fail",     "job": <id>, "error": ...}     terminal

Jobs are deduped by ``spec_hash`` (the id is the hash of ``(db_name,
spec)``). Admission refuses new work when the queue is already
``GAMESMAN_JOBS_MAX_DEPTH`` deep or free disk under the ledger is below
``GAMESMAN_JOBS_DISK_FLOOR_MB``.

The runner (``run_pending``) drives each claimed job through the port's
own children: the campaign (``python -m
gamesmanmpi_tpu_torch.resilience.campaign``) to a checkpoint tree, then
``python -m gamesmanmpi_tpu_torch export-db --from-checkpoint`` (with
``--book-plies``, db/book.py seals the opening book on the exported DB),
then ``publish_db``. Every child runs on ``device`` (default the card).
A failed step releases the job (retried up to
``GAMESMAN_JOBS_MAX_ATTEMPTS`` claims, then failed terminally). The
runner itself imports no torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.utils.env import env_float, env_int

#: Repo root (…/gamesmanmpi_tpu_torch/registry/jobs.py -> repo): the
#: runner's children run the package from it.
_REPO = pathlib.Path(__file__).resolve().parents[2]


class QueueRefused(RuntimeError):
    """Admission control said no (queue depth / disk floor)."""


def spec_hash(spec: str, db_name: str | None = None) -> str:
    """The dedup/config key: two queries for the same (name, spec) are
    one job, whatever order they arrive in."""
    blob = f"{db_name or ''}\n{spec.strip()}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _pid_alive(pid) -> bool:
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


class JobQueue:
    """Durable solve-on-demand queue over one append-only ledger.

    Single-writer-per-call, multi-process safe for the intended shape
    (one registry server enqueueing, one runner claiming): every
    mutation is an fsync'd append and state is ledger replay, so a
    crash between any two lines is recoverable by construction.
    """

    def __init__(self, path, registry=None):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.registry = registry or default_registry()

    # ------------------------------------------------------------ ledger

    def _append(self, record: dict) -> None:
        line = json.dumps({"wall_time": time.time(), **record},
                          default=str)
        with open(self.path, "a") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    # wire: producer
    def _replay(self) -> dict:
        """Ledger -> {job_id: job dict}. A torn tail line (death
        mid-append) is skipped, exactly like the campaign ledger.
        Job records cross the wire verbatim (``POST /solve`` responses,
        ``/jobs`` snapshots), hence the producer annotation."""
        jobs: dict = {}
        if not self.path.exists():
            return jobs
        with open(self.path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail — appends never tear earlier lines
                jid = rec.get("job")
                if not jid:
                    continue
                op = rec.get("op")
                if op == "enqueue":
                    jobs[jid] = {
                        "id": jid,
                        "spec": rec.get("spec"),
                        "db_name": rec.get("db_name"),
                        "state": "pending",
                        "attempts": 0,
                        "enqueue_time": rec.get("wall_time"),
                        "error": None,
                    }
                    continue
                job = jobs.get(jid)
                if job is None:
                    continue  # op for an unknown job: ignore, stay durable
                if op == "claim":
                    job["state"] = "running"
                    job["attempts"] += 1
                    job["pid"] = rec.get("pid")
                    job["lease_until"] = rec.get("lease_until")
                elif op == "release":
                    job["state"] = "pending"
                    job["error"] = rec.get("error")
                elif op == "complete":
                    job["state"] = "done"
                    job["epoch"] = rec.get("epoch")
                    job["db"] = rec.get("db")
                elif op == "fail":
                    job["state"] = "failed"
                    job["error"] = rec.get("error")
        return jobs

    # ----------------------------------------------------------- queries

    @staticmethod
    def _reclaimable(job: dict) -> bool:
        """A running job whose runner is provably gone: pid dead or
        lease expired — the classify half of classify-and-resume."""
        if job["state"] != "running":
            return False
        if not _pid_alive(job.get("pid")):
            return True
        lease = job.get("lease_until")
        return lease is not None and time.time() > float(lease)

    def jobs(self) -> dict:
        return self._replay()

    def depth(self, jobs: dict | None = None) -> int:
        jobs = self._replay() if jobs is None else jobs
        return sum(1 for j in jobs.values()
                   if j["state"] in ("pending", "running"))

    def snapshot(self) -> dict:
        jobs = self._replay()
        depth = self.depth(jobs)
        self.registry.gauge(
            "gamesman_jobs_queue_depth",
            "solve-on-demand jobs pending or running",
        ).set(depth)
        by_state: dict = {}
        for j in jobs.values():
            by_state[j["state"]] = by_state.get(j["state"], 0) + 1
        return {
            "kind": "job_queue", "depth": depth, "by_state": by_state,
            "jobs": sorted(jobs.values(), key=lambda j: j["enqueue_time"]),
        }

    # --------------------------------------------------------- mutations

    def enqueue(self, spec: str, name: str | None = None) -> dict:
        """Queue a solve (deduped, admission-controlled) -> job dict
        with a ``state`` field; raises :class:`QueueRefused` when
        admission says no and ``ValueError`` on an empty spec."""
        if not spec or not spec.strip():
            raise ValueError("empty game spec")
        jid = spec_hash(spec, name)
        jobs = self._replay()
        existing = jobs.get(jid)
        if existing is not None and existing["state"] != "failed":
            self.registry.counter(
                "gamesman_jobs_deduped_total",
                "enqueues answered by an existing job (spec_hash dedup)",
            ).inc()
            return existing
        depth = self.depth(jobs)
        max_depth = env_int("GAMESMAN_JOBS_MAX_DEPTH", 16)
        if depth >= max_depth:
            self._refused("queue depth")
            raise QueueRefused(
                f"job queue at max depth ({depth} >= {max_depth}); "
                "retry later"
            )
        floor_mb = env_float("GAMESMAN_JOBS_DISK_FLOOR_MB", 0.0)
        if floor_mb > 0:
            free_mb = shutil.disk_usage(self.path.parent).free / 1e6
            if free_mb < floor_mb:
                self._refused("disk floor")
                raise QueueRefused(
                    f"free disk {free_mb:.0f} MB under the "
                    f"{floor_mb:g} MB job floor; not queueing new solves"
                )
        self._append({"op": "enqueue", "job": jid, "spec": spec.strip(),
                      "db_name": name})
        self.registry.counter(
            "gamesman_jobs_enqueued_total", "solve-on-demand jobs queued",
        ).inc()
        self.registry.gauge(
            "gamesman_jobs_queue_depth",
            "solve-on-demand jobs pending or running",
        ).set(depth + 1)
        return self._replay()[jid]

    def _refused(self, reason: str) -> None:
        self.registry.counter(
            "gamesman_jobs_refused_total",
            "enqueues refused by admission control", reason=reason,
        ).inc()

    def claim(self, pid: int | None = None) -> dict | None:
        """Claim the oldest runnable job (pending, or a dead/expired
        claim being reclaimed) -> job dict, or None when the queue has
        nothing runnable. Jobs past ``GAMESMAN_JOBS_MAX_ATTEMPTS``
        claims are failed terminally instead of claimed again."""
        pid = os.getpid() if pid is None else int(pid)
        max_attempts = env_int("GAMESMAN_JOBS_MAX_ATTEMPTS", 3)
        lease_secs = env_float("GAMESMAN_JOBS_LEASE_SECS", 900.0)
        jobs = self._replay()
        for job in sorted(jobs.values(), key=lambda j: j["enqueue_time"]):
            resumed = self._reclaimable(job)
            if job["state"] != "pending" and not resumed:
                continue
            if job["attempts"] >= max_attempts:
                self._append({
                    "op": "fail", "job": job["id"],
                    "error": f"attempts exhausted "
                             f"({job['attempts']} >= {max_attempts})",
                })
                self.registry.counter(
                    "gamesman_jobs_failed_total",
                    "jobs failed terminally",
                ).inc()
                continue
            self._append({
                "op": "claim", "job": job["id"], "pid": pid,
                "lease_until": time.time() + lease_secs,
            })
            self.registry.counter(
                "gamesman_jobs_claimed_total", "job claims by runners",
            ).inc()
            if resumed:
                self.registry.counter(
                    "gamesman_jobs_resumed_total",
                    "dead/expired claims reclaimed by a later runner",
                ).inc()
            # The chaos seam: the claim is durable, the work has not
            # started. A kill here leaves a running job with a dead
            # pid — exactly what _reclaimable resumes.
            faults.fire("jobs.claim", job=job["id"], pid=pid)
            return self._replay()[job["id"]]
        return None

    def release(self, job_id: str, error: str | None = None) -> None:
        self._append({"op": "release", "job": job_id,
                      "error": (error or "")[:500] or None})

    def complete(self, job_id: str, **info) -> None:
        self._append({"op": "complete", "job": job_id, **info})
        self.registry.counter(
            "gamesman_jobs_completed_total",
            "jobs driven to a published DB",
        ).inc()

    def fail(self, job_id: str, error: str) -> None:
        self._append({"op": "fail", "job": job_id, "error": error[:500]})
        self.registry.counter(
            "gamesman_jobs_failed_total", "jobs failed terminally",
        ).inc()


# ------------------------------------------------------------- the runner


def _run_step(cmd: list, log, what: str, env: dict | None = None) -> None:
    """One pipeline step as a subprocess; raises RuntimeError with the
    captured output tail on a non-zero exit."""
    if log is not None:
        log({"phase": "job_step", "what": what, "cmd": cmd[:6]})
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **env) if env else None, cwd=str(_REPO),
    )
    if proc.returncode != 0:
        tail = (proc.stdout or "")[-2000:]
        raise RuntimeError(
            f"{what} exited {proc.returncode}: …{tail}"
        )


def run_job(queue: JobQueue, job: dict, registry_root, work_dir, *,
            book_plies: int = 0, solver_args: list | None = None,
            device: str = "cuda", log=None) -> dict:
    """Drive one claimed job through campaign -> export (and book) ->
    publish. Returns {"job", "ok", ...}; a failed step releases the job
    for a later claim (capped by ``claim``). ``solver_args`` are
    campaign flags (and, after ``--``, solve flags); ``device`` goes to
    every child."""
    from gamesmanmpi_tpu_torch.registry.server import publish_db

    # Absolute paths: the children run with cwd=_REPO, so a relative
    # checkpoint dir would land inside the repository.
    work = pathlib.Path(work_dir).resolve() / f"job-{job['id']}"
    ckpt, db = work / "ckpt", work / "db"
    work.mkdir(parents=True, exist_ok=True)
    name = job.get("db_name") or job["spec"].split(":")[0]
    campaign_args = list(solver_args or [])
    if "--" not in campaign_args:
        campaign_args.append("--")
    campaign_args += ["--device", device]
    book = ["--book-plies", str(book_plies)] if book_plies > 0 else []
    try:
        _run_step(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch.resilience.campaign",
             job["spec"], "--checkpoint-dir", str(ckpt), *campaign_args],
            log, "run_campaign",
        )
        _run_step(
            [sys.executable, "-m", "gamesmanmpi_tpu_torch", "export-db",
             job["spec"], "--out", str(db), "--from-checkpoint",
             str(ckpt), "--overwrite", "--device", device, *book],
            log, "export-db",
        )
        record = publish_db(registry_root, name, db,
                            registry=queue.registry)
    except (RuntimeError, OSError, ValueError) as e:
        queue.release(job["id"], error=str(e))
        return {"job": job["id"], "ok": False, "error": str(e)}
    queue.complete(job["id"], epoch=record["epoch"], db=name)
    return {"job": job["id"], "ok": True, "db": name,
            "epoch": record["epoch"]}


def run_pending(queue: JobQueue, registry_root, work_dir, *,
                book_plies: int = 0, solver_args: list | None = None,
                device: str = "cuda", once: bool = False,
                log=None) -> list:
    """Claim-and-run until the queue has nothing runnable (or one job
    with ``once``). Returns the per-job result records."""
    results = []
    while True:
        job = queue.claim()
        if job is None:
            break
        results.append(
            run_job(queue, job, registry_root, work_dir,
                    book_plies=book_plies, solver_args=solver_args,
                    device=device, log=log)
        )
        if once:
            break
    return results
