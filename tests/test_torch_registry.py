"""The DB registry on the torch port, against the JAX package (the
reference's tests/test_registry.py, on the port).

* Publish: the same DB published by either package gives an equal
  catalog entry (all but ``published_time``) and the same
  ``catalog_seal``; a republish is a no-op.
* Pull across packages: the port's client installs from the reference's
  ``RegistryServer`` and the reference's client from the port's, each
  verified, the rerun a no-op; a tampered catalog, rotted staged bytes
  and an epoch that fails admission are refused, refetched and
  quarantined.
* The fault points, in child processes: ``registry.fetch`` torn,
  ``registry.install`` and ``registry.publish`` killed, each rerun
  completing; ``sync_fleet`` lands the fleet manifest and reports to the
  supervisor's ``/reload`` and ``/registry-sync``.
* Jobs: a ledger written by either package replays to the same state in
  the other; dedup, admission by depth and disk floor, dead-claim
  reclaim and the attempts cap; ``POST /solve`` with its 429.
* ``registry run-jobs --once --device cpu`` on tictactoe, first killed at
  ``jobs.claim``: the rerun reclaims the job, drives the campaign,
  export-db and publish, and the epoch equals sha256 of the manifest the
  reference's ``export-db --from-checkpoint`` writes from the same tree.

Exact throughout: digests, dicts and bytes.
"""

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.db import export_result as jax_export_result
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.registry import jobs as ref_jobs
from gamesmanmpi_tpu.registry import pull as ref_pull
from gamesmanmpi_tpu.registry import server as ref_server
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.db.check import check_db
from gamesmanmpi_tpu_torch.db.format import MANIFEST_NAME, file_sha256
from gamesmanmpi_tpu_torch.db.writer import export_result
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.registry import (
    JobQueue,
    PullError,
    QueueRefused,
    RegistryServer,
    catalog_seal,
    load_catalog,
    publish_db,
    pull_db,
    sync_fleet,
)
from gamesmanmpi_tpu_torch.registry.pull import ensure_db, fetch_catalog
from gamesmanmpi_tpu_torch.solve.engine import Solver

from helpers import REPO

torch.set_num_threads(1)

SPEC = "subtract:total=10,moves=1-2"
PULL = [sys.executable, "-m", "gamesmanmpi_tpu_torch.registry.pull"]
CLI = [sys.executable, "-m", "gamesmanmpi_tpu_torch"]


def child_env(**extra):
    env = dict(os.environ)
    env.pop("GAMESMAN_FAULTS", None)
    env["GAMESMAN_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["GAMESMAN_CAMPAIGN_BACKOFF_BASE_SECS"] = "0.05"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _digests(d):
    return {p.name: file_sha256(p) for p in sorted(d.iterdir())
            if p.is_file()}


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The subtract DB exported by the port and by the reference (the
    same bytes: either package's writer)."""
    root = tmp_path_factory.mktemp("regdbs")
    port_db, ref_db = root / "port" / "sub", root / "ref" / "sub"
    export_result(Solver(get_game(SPEC), device="cpu").solve(), port_db, SPEC)
    jax_export_result(JaxSolver(jax_get_game(SPEC)).solve(), ref_db, SPEC)
    assert _digests(port_db) == _digests(ref_db)
    return port_db, ref_db


@pytest.fixture()
def port_registry(tmp_path):
    srv = RegistryServer(tmp_path / "port_registry").start()
    yield srv
    srv.stop()


@pytest.fixture()
def ref_registry(tmp_path):
    srv = ref_server.RegistryServer(tmp_path / "ref_registry")
    srv.start()
    yield srv
    srv.stop()


# ---------------------------------------------------- publish / catalog


def test_publish_gives_the_references_catalog_entry(tmp_path, dbs):
    port_db, ref_db = dbs
    port_rec = publish_db(tmp_path / "a", "sub", port_db)
    ref_rec = ref_server.publish_db(tmp_path / "b", "sub", ref_db)
    assert port_rec["epoch"] == file_sha256(port_db / MANIFEST_NAME)
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k != "published_time"}
    assert strip(port_rec) == strip(ref_rec)
    port_cat, ref_cat = load_catalog(tmp_path / "a"), load_catalog(
        tmp_path / "b")
    assert port_cat["seal"] == catalog_seal(port_cat["dbs"])
    # One published_time, then the seals (either package's) agree.
    ref_cat["dbs"]["sub"]["published_time"] = \
        port_cat["dbs"]["sub"]["published_time"]
    assert catalog_seal(ref_cat["dbs"]) == catalog_seal(port_cat["dbs"])
    assert ref_server.catalog_seal(port_cat["dbs"]) == port_cat["seal"]
    assert check_db(tmp_path / "a" / port_rec["path"]) == []
    assert publish_db(tmp_path / "a", "sub", port_db) == port_rec
    assert load_catalog(tmp_path / "a") == port_cat
    with pytest.raises(ValueError, match="url-safe"):
        publish_db(tmp_path / "a", "no/slash", port_db)


def test_cli_publish_prints_the_record(tmp_path, dbs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["registry", "publish", str(dbs[0]), "--root",
                       str(tmp_path / "r")])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert out["epoch"] == file_sha256(dbs[0] / MANIFEST_NAME)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jax_cli.main(["registry", "publish", str(dbs[1]), "--root",
                             str(tmp_path / "ref")]) == 0
    assert json.loads(buf.getvalue()) == out
    assert cli.main(["registry", "publish", str(tmp_path / "nope"),
                     "--root", str(tmp_path / "r")]) == 2


# ------------------------------------------------------------------ pull


def test_port_client_installs_from_the_references_registry(
        ref_registry, tmp_path, dbs):
    ref_server.publish_db(ref_registry.root, "sub", dbs[1])
    dest = tmp_path / "replica"
    rec = pull_db(ref_registry.url, "sub", dest)
    assert rec["installed"] and rec["epoch"] == file_sha256(
        dbs[1] / MANIFEST_NAME)
    assert _digests(pathlib_of(rec["db"])) == _digests(dbs[1])
    assert check_db(rec["db"]) == []
    again = pull_db(ref_registry.url, "sub", dest)
    assert not again["installed"] and again["db"] == rec["db"]
    assert set(fetch_catalog(ref_registry.url)["dbs"]) == {"sub"}


def test_reference_client_installs_from_the_ports_registry(
        port_registry, tmp_path, dbs):
    publish_db(port_registry.root, "sub", dbs[0])
    dest = tmp_path / "replica"
    rec = ref_pull.pull_db(port_registry.url, "sub", dest)
    assert rec["installed"]
    assert _digests(pathlib_of(rec["db"])) == _digests(dbs[0])
    assert not ref_pull.pull_db(port_registry.url, "sub", dest)["installed"]
    assert set(ref_pull.fetch_catalog(port_registry.url)["dbs"]) == {"sub"}
    # Both servers answer the same routes with the same codes.
    status, man = _get(f"{port_registry.url}/db/sub/manifest")
    assert status == 200 and man["name"] == "sub"
    for path in ("/db/nope/manifest", "/db/sub/blob/nope", "/nope"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port_registry.url + path)
        assert e.value.code == 404
    status, health = _get(f"{port_registry.url}/healthz")
    assert health == {"status": "ok", "kind": "registry", "dbs": ["sub"],
                      "jobs": None}
    req = urllib.request.Request(
        f"{port_registry.url}/db/sub/blob/{MANIFEST_NAME}",
        headers={"Range": "bytes=5-9"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 206
        assert resp.read() == (dbs[0] / MANIFEST_NAME).read_bytes()[5:10]


def pathlib_of(path):
    import pathlib

    return pathlib.Path(path)


def test_tampered_catalog_is_refused(port_registry, dbs):
    publish_db(port_registry.root, "sub", dbs[0])
    cat_path = port_registry.root / "catalog.json"
    doc = json.loads(cat_path.read_text())
    doc["dbs"]["sub"]["epoch"] = "0" * 64
    cat_path.write_text(json.dumps(doc))
    with pytest.raises(PullError, match="seal"):
        fetch_catalog(port_registry.url)
    with pytest.raises(ref_pull.PullError, match="seal"):
        ref_pull.fetch_catalog(port_registry.url)


def test_pull_refetches_rotted_staging_bytes(port_registry, tmp_path, dbs):
    publish_db(port_registry.root, "sub", dbs[0])
    epoch12 = file_sha256(dbs[0] / MANIFEST_NAME)[:12]
    dest = tmp_path / "replica"
    stage = dest / ".registry_tmp" / f"sub@{epoch12}"
    stage.mkdir(parents=True)
    real = (dbs[0] / "level_0000.keys.npy").read_bytes()
    (stage / "level_0000.keys.npy").write_bytes(b"\xff" * len(real))
    rec = pull_db(port_registry.url, "sub", dest)
    assert rec["installed"] and rec["refetched_files"] == 1
    assert check_db(rec["db"]) == []
    assert not list(pathlib_of(rec["db"]).glob("*.corrupt"))


def test_pull_quarantines_epoch_that_fails_admission(
        port_registry, tmp_path, dbs):
    rotted = tmp_path / "rotted"
    shutil.copytree(dbs[0], rotted)
    cells_file = rotted / "level_0003.cells.npy"
    np.save(cells_file.with_suffix(""), np.zeros_like(np.load(cells_file)))
    man = json.loads((rotted / MANIFEST_NAME).read_text())
    man["levels"]["3"]["cells_sha256"] = file_sha256(cells_file)
    (rotted / MANIFEST_NAME).write_text(json.dumps(man))
    publish_db(port_registry.root, "sub", rotted)
    dest = tmp_path / "replica"
    with pytest.raises(PullError, match="quarantin"):
        pull_db(port_registry.url, "sub", dest)
    installs = [d for d in dest.iterdir() if not d.name.startswith(".")]
    assert installs and all(d.name.endswith(".corrupt") for d in installs)


def _pull_child(url, dest, faults=None):
    env = child_env(**({"GAMESMAN_FAULTS": faults} if faults else {}))
    return subprocess.run(PULL + [url, "sub", "--dest", str(dest), "--json"],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=str(REPO))


def test_torn_fetch_and_killed_install_resume(port_registry, tmp_path, dbs):
    """A pull torn at ``registry.fetch`` exits 86 and the rerun resumes
    the torn file; one killed at ``registry.install`` exits 77 with
    nothing installed, and the rerun finds every staged byte verified."""
    publish_db(port_registry.root, "sub", dbs[0])
    dest = tmp_path / "torn"
    out = _pull_child(port_registry.url, dest, "registry.fetch:torn:2")
    assert out.returncode == 86, out.stderr
    out = _pull_child(port_registry.url, dest)
    assert out.returncode == 0, out.stderr
    (rec,) = json.loads(out.stdout)["pulled"]
    # The torn file is a clean prefix: the rerun resumes it by a ranged
    # read (the first file staged whole is not fetched again).
    assert rec["installed"] and rec["resumed_files"] == 1
    assert rec["refetched_files"] == 0
    assert _digests(pathlib_of(rec["db"])) == _digests(dbs[0])
    dest = tmp_path / "install"
    out = _pull_child(port_registry.url, dest, "registry.install:kill")
    assert out.returncode == 77, out.stderr
    assert [d.name for d in dest.iterdir()] == [".registry_tmp"]
    out = _pull_child(port_registry.url, dest)
    (rec,) = json.loads(out.stdout)["pulled"]
    nfiles = len(_digests(dbs[0]))
    assert rec["installed"] and rec["resumed_files"] == nfiles


def test_killed_publish_keeps_the_old_catalog(tmp_path, dbs):
    root = tmp_path / "reg"
    argv = CLI + ["registry", "publish", str(dbs[0]), "--root", str(root),
                  "--name", "sub"]
    out = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         cwd=str(REPO),
                         env=child_env(GAMESMAN_FAULTS="registry.publish:kill"))
    assert out.returncode == 77, out.stderr
    assert load_catalog(root)["dbs"] == {}
    epoch = file_sha256(dbs[0] / MANIFEST_NAME)
    assert (root / "dbs" / "sub" / epoch[:12]).is_dir()  # the orphan
    out = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         cwd=str(REPO), env=child_env())
    assert out.returncode == 0, out.stderr
    assert load_catalog(root)["dbs"]["sub"]["epoch"] == epoch


class _Control(BaseHTTPRequestHandler):
    """A stand-in for the serve supervisor's control port."""

    posts: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802 - http.server API
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.posts.append((self.path, body))
        data = json.dumps({"ok": True}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_sync_fleet_lands_the_manifest_and_reports(port_registry, tmp_path,
                                                   dbs):
    publish_db(port_registry.root, "sub", dbs[0])
    control = ThreadingHTTPServer(("127.0.0.1", 0), _Control)
    threading.Thread(target=control.serve_forever, daemon=True).start()
    _Control.posts = []
    try:
        url = f"http://127.0.0.1:{control.server_address[1]}"
        fleet = tmp_path / "fleet.json"
        result = sync_fleet(port_registry.url, ["sub", "nope"], fleet,
                            tmp_path / "dbs", control_url=url)
    finally:
        control.shutdown()
        control.server_close()
    assert result["status"] == "rolled" and result["rolled"]
    assert [f["name"] for f in result["failed"]] == ["nope"]
    doc = json.loads(fleet.read_text())
    assert doc["games"] == [{"name": "sub", "db": result["pulled"][0]["db"]}]
    paths = [p for p, _ in _Control.posts]
    assert paths == ["/reload", "/registry-sync"]
    report = _Control.posts[1][1]
    assert report["status"] == "rolled" and report["failed"] == ["nope"]
    assert report["epochs"] == {
        "sub": file_sha256(dbs[0] / MANIFEST_NAME)[:12]}


# ------------------------------------------------------------------- jobs


def _drive(queue_cls, path, dead_pid):
    """One scripted history of a job ledger."""
    q = queue_cls(path)
    a = q.enqueue("subtract:total=6,moves=1-2", name="sub6")
    q.enqueue("subtract:total=6,moves=1-2", name="sub6")  # dedup
    b = q.enqueue("subtract:total=7,moves=1-2")
    q.enqueue("subtract:total=8,moves=1-2", name="sub8")
    q.claim(pid=dead_pid)
    q.release(a["id"], error="step blew up")
    q.claim(pid=dead_pid)
    q.complete(a["id"], epoch="e" * 64, db="sub6")
    q.claim(pid=dead_pid)
    q.fail(b["id"], "no")


def _state(jobs):
    return {k: {f: v for f, v in j.items()
                if f not in ("enqueue_time", "lease_until")}
            for k, j in jobs.items()}


def test_job_ledger_replays_the_same_in_either_package(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    _drive(ref_jobs.JobQueue, tmp_path / "ref.jsonl", dead.pid)
    _drive(JobQueue, tmp_path / "port.jsonl", dead.pid)
    for path in (tmp_path / "ref.jsonl", tmp_path / "port.jsonl"):
        port_view = JobQueue(path).jobs()
        assert port_view == ref_jobs.JobQueue(path).jobs()
        assert JobQueue(path).snapshot()["by_state"] == ref_jobs.JobQueue(
            path).snapshot()["by_state"]
    assert _state(JobQueue(tmp_path / "port.jsonl").jobs()) == _state(
        JobQueue(tmp_path / "ref.jsonl").jobs())
    assert ref_jobs.spec_hash(SPEC, "x") == __import__(
        "gamesmanmpi_tpu_torch.registry.jobs", fromlist=["spec_hash"]
    ).spec_hash(SPEC, "x")


def test_job_queue_dedup_admission_reclaim_and_cap(tmp_path, monkeypatch):
    q = JobQueue(tmp_path / "jobs.jsonl")
    job = q.enqueue("subtract:total=6,moves=1-2", name="sub6")
    assert job["state"] == "pending"
    assert q.enqueue("subtract:total=6,moves=1-2",
                     name="sub6")["id"] == job["id"]
    assert JobQueue(tmp_path / "jobs.jsonl").depth() == 1  # replay
    monkeypatch.setenv("GAMESMAN_JOBS_MAX_DEPTH", "1")
    with pytest.raises(QueueRefused):
        q.enqueue("subtract:total=7,moves=1-2", name="sub7")
    monkeypatch.setenv("GAMESMAN_JOBS_MAX_DEPTH", "64")
    monkeypatch.setenv("GAMESMAN_JOBS_DISK_FLOOR_MB", "1e9")
    with pytest.raises(QueueRefused, match="disk"):
        q.enqueue("subtract:total=8,moves=1-2", name="sub8")
    monkeypatch.delenv("GAMESMAN_JOBS_DISK_FLOOR_MB")
    monkeypatch.setenv("GAMESMAN_JOBS_MAX_ATTEMPTS", "2")
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    assert q.claim(pid=dead.pid)["attempts"] == 1
    assert q.claim(pid=dead.pid)["attempts"] == 2  # reclaimed
    assert q.claim(pid=dead.pid) is None
    assert q.jobs()[job["id"]]["state"] == "failed"
    with pytest.raises(ValueError):
        q.enqueue("  ")
    # A torn last line (a death mid-append) is skipped by the replay.
    before = q.jobs()
    with open(tmp_path / "jobs.jsonl", "a") as fh:
        fh.write('{"op": "enqueue", "job": "torn')
    assert q.jobs() == before


def test_solve_endpoint_queues_dedups_and_sheds(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_JOBS_MAX_DEPTH", "1")
    root = tmp_path / "reg"
    srv = RegistryServer(root, queue=JobQueue(root / "jobs.jsonl")).start()
    try:
        out = ensure_db(srv.url, "sub6", spec="subtract:total=6,moves=1-2")
        assert out["status"] == "pending" and out["id"]
        again = ensure_db(srv.url, "sub6", spec="subtract:total=6,moves=1-2")
        assert again["id"] == out["id"]
        status, jobs = _get(f"{srv.url}/jobs")
        assert status == 200 and jobs["depth"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{srv.url}/solve",
                  {"name": "sub7", "spec": "subtract:total=7,moves=1-2"})
        assert e.value.code == 429
        assert float(e.value.headers.get("Retry-After")) > 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{srv.url}/solve", {"name": "x", "spec": ""})
        assert e.value.code == 400
        status, health = _get(f"{srv.url}/healthz")
        assert health["jobs"]["depth"] == 1
    finally:
        srv.stop()


def test_registry_serve_cli_banner_and_sigterm(tmp_path):
    proc = subprocess.Popen(
        CLI + ["registry", "serve", "--root", str(tmp_path / "r"), "--jobs",
               "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=child_env(), cwd=str(REPO))
    try:
        banner = proc.stdout.readline()
        assert "with solve-on-demand queue" in banner, proc.stderr.read()
        url = banner.split(" on ")[1].split()[0]
        status, health = _get(f"{url}/healthz")
        assert health["kind"] == "registry" and health["jobs"]["depth"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    out = subprocess.run(CLI + ["registry", "serve", "--root",
                                str(tmp_path / "r")],
                         capture_output=True, text=True, timeout=60,
                         env=child_env(), cwd=str(REPO))
    if not torch.cuda.is_available():
        assert out.returncode == 2 and "--device cpu" in out.stderr


def test_registry_commands_load_no_torch(tmp_path, dbs):
    """The registry's processes only publish, serve and start children:
    they never load torch (its resident set would tax the job runner)."""
    code = ("import sys\n"
            "from gamesmanmpi_tpu_torch.cli import main\n"
            f"assert main(['registry', 'publish', {str(dbs[0])!r}, "
            f"'--root', {str(tmp_path / 'r')!r}]) == 0\n"
            f"assert main(['registry', 'run-jobs', '--root', "
            f"{str(tmp_path / 'r')!r}, '--device', 'cpu']) == 0\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=child_env(),
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert '"ran": 0' in out.stdout


def test_run_jobs_publishes_the_reference_exports_epoch(tmp_path):
    root = tmp_path / "reg"
    job = JobQueue(root / "jobs.jsonl").enqueue("tictactoe", name="ttt")
    run = CLI + ["registry", "run-jobs", "--root", str(root), "--once",
                 "--device", "cpu"]
    out = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         env=child_env(GAMESMAN_FAULTS="jobs.claim:kill"),
                         cwd=str(REPO))
    assert out.returncode == 77, out.stderr[-2000:]
    claimed = JobQueue(root / "jobs.jsonl").jobs()[job["id"]]
    assert claimed["state"] == "running" and claimed["attempts"] == 1
    t0 = time.monotonic()
    out = subprocess.run(run, capture_output=True, text=True, timeout=300,
                         env=child_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    secs = time.monotonic() - t0
    (result,) = json.loads(out.stdout)["results"]
    assert result["ok"] and result["db"] == "ttt"
    done = JobQueue(root / "jobs.jsonl").jobs()[job["id"]]
    assert done["state"] == "done" and done["attempts"] == 2
    assert done["epoch"] == result["epoch"]
    steps = [json.loads(line)["what"] for line in out.stderr.splitlines()
             if line.startswith("{")]
    assert steps == ["run_campaign", "export-db"]
    # The reference's export of the same checkpoint tree: the same epoch.
    work = root / "work" / f"job-{job['id']}"
    ref_db = tmp_path / "ref_db"
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jax_cli.main(["export-db", "tictactoe", "--out", str(ref_db),
                             "--from-checkpoint", str(work / "ckpt")]) == 0
    assert file_sha256(ref_db / MANIFEST_NAME) == result["epoch"]
    rec = load_catalog(root)["dbs"]["ttt"]
    assert {f["name"]: f["sha256"] for f in rec["files"]} == _digests(ref_db)
    assert secs < 200
