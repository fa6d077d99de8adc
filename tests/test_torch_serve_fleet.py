"""Torch port's supervised serving fleet (serve/supervisor, serve/worker,
the CLI's ``serve --workers``) on the CPU.

The shapes of the reference's ``tests/test_serve_fleet.py``, on the
port, with ``--device cpu`` and DBs the port exported:

* a forked two-worker CLI fleet answers the nim 3-4-5 oracle exactly,
  survives a SIGKILLed worker under ``tools/load_gen.py`` load (dropped
  at most the requests in flight, no errors, no mismatches), restarts
  it, and rolls a reload with no failed request;
* an in-process fleet forked from a parent that already ran parallel
  torch work (the OpenMP pool a fork child cannot use) comes up and
  restarts a SIGKILLed worker;
* exec mode serves and recovers; the supervisor takes it once CUDA is
  initialized in the parent, and never touches the CUDA driver itself;
* a worker that cannot reach its device fails its warm start (exit 3)
  and never serves;
* no worker outlives a SIGKILLed supervisor.

Every subprocess, wait and join has a hard time limit of its own.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from gamesmanmpi_tpu.core.values import value_name
from gamesmanmpi_tpu.solve.oracle import oracle_solve
from gamesmanmpi_tpu_torch.db import export_result
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.serve import ServeSupervisor, single_db_entries
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.utils.device import resolve_device

from helpers import REF_GAMES, REPO, load_module

_CLI = [sys.executable, "-m", "gamesmanmpi_tpu_torch"]


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _wait_for(pred, timeout=60.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def sub_db(tmp_path_factory):
    spec = "subtract:total=10,moves=1-2"
    d = tmp_path_factory.mktemp("torch_fleet") / "sub"
    export_result(Solver(get_game(spec), device="cpu").solve(), d, spec)
    return d


@pytest.fixture(scope="module")
def nim_db(tmp_path_factory):
    spec = "nim:heaps=3-4-5"
    d = tmp_path_factory.mktemp("torch_fleet_nim") / "nim"
    export_result(Solver(get_game(spec), device="cpu").solve(), d, spec,
                  compress=True)
    _, _, oracle = oracle_solve(load_module(REF_GAMES / "nim_345.py"))
    return d, oracle


def _cli_fleet(db, env_extra=None, workers=2, extra=()):
    env = dict(os.environ)
    env["GAMESMAN_SERVE_RESTART_BASE_SECS"] = "0.1"
    env.pop("GAMESMAN_FAULTS", None)
    env.update(env_extra or {})
    proc = subprocess.Popen(
        _CLI + ["serve", str(db), "--port", "0", "--workers", str(workers),
                "--control-port", "0", "--device", "cpu", *extra],
        stdout=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    # A child that never prints its banner is killed, not waited on.
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        banner = proc.stdout.readline()
    finally:
        watchdog.cancel()
    assert "serving fleet" in banner, banner
    port, cport = (int(p) for p in re.findall(r"127\.0\.0\.1:(\d+)",
                                              banner))
    return proc, f"http://127.0.0.1:{port}", f"http://127.0.0.1:{cport}"


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def _hammer(base, position, done, failures):
    while not done.is_set():
        try:
            status, body = _post(base + "/query",
                                 {"positions": [hex(position)]}, timeout=10)
            if status != 200 or not body["results"][0]["found"]:
                failures.append(body)
        except Exception as e:  # noqa: BLE001 - collected
            failures.append(e)


def test_cli_fleet_forks_survives_a_kill_and_rolls_a_reload(nim_db,
                                                            tmp_path):
    nim_dir, oracle = nim_db
    proc, base, control = _cli_fleet(
        nim_dir, extra=("--jsonl", str(tmp_path / "serve.jsonl")))
    try:
        st = _wait_for(
            lambda: (s := _get(control + "/healthz")[1])["status"] == "ok"
            and s, timeout=120, what="fleet ready")
        assert st["spawn_mode"] == "fork"
        assert all(w["verified"] == {"default": True}
                   for w in st["workers"].values())
        positions = sorted(oracle)
        for i in range(0, len(positions), 64):
            chunk = [hex(p) for p in positions[i:i + 64]]
            status, body = _post(base + "/query", {"positions": chunk})
            assert status == 200
            for q, rec in zip(chunk, body["results"]):
                v, r = oracle[int(q, 0)]
                assert (rec["found"], rec["value"], rec["remoteness"]) \
                    == (True, value_name(v), r), q

        pos_file = tmp_path / "positions.txt"
        pos_file.write_text("\n".join(hex(p) for p in positions))
        out_json = tmp_path / "load.json"
        conc = 4
        load = subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "load_gen.py"), base,
             "--positions-file", str(pos_file), "--duration", "5",
             "--concurrency", str(conc), "--dist", "zipf:1.1",
             "--max-dropped", str(conc), "--json", str(out_json)],
            stdout=subprocess.PIPE, text=True, cwd=str(REPO))
        try:
            time.sleep(1.5)
            st = _get(control + "/healthz")[1]
            victim = next(w for w in st["workers"].values()
                          if w["state"] == "ready")
            os.kill(victim["pid"], signal.SIGKILL)
            assert load.wait(timeout=120) == 0, load.stdout.read()
        finally:
            _stop(load)
        record = json.loads(out_json.read_text())
        assert record["ok"] > 0
        assert record["errors"] == 0 and record["mismatches"] == 0
        assert record["dropped"] <= conc
        st = _wait_for(
            lambda: (s := _get(control + "/healthz")[1])["status"] == "ok"
            and all(w["state"] == "ready" for w in s["workers"].values())
            and s, timeout=60, what="killed worker restarted")
        assert sum(w["restarts"] for w in st["workers"].values()) == 1

        failures, done = [], threading.Event()
        t = threading.Thread(target=_hammer,
                             args=(base, positions[0], done, failures))
        t.start()
        try:
            urllib.request.urlopen(urllib.request.Request(
                control + "/reload", method="POST", data=b""), timeout=10)
            _wait_for(lambda: (s := _get(control + "/healthz")[1])
                      ["reloads_done"] >= 1 and s["status"] == "ok",
                      timeout=120, what="rolling reload done")
        finally:
            done.set()
            t.join(timeout=30)
        assert not failures, failures[:3]
        with urllib.request.urlopen(control + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "gamesman_serve_worker_restarts_total" in text
        assert "gamesman_serve_reloads_total" in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        records = [json.loads(ln) for ln in
                   (tmp_path / "serve.worker0.jsonl").read_text()
                   .splitlines()]
        assert any(r.get("phase") == "serve_batch" and r["worker"] == 0
                   for r in records)
    finally:
        _stop(proc)


def test_fleet_forks_from_a_parent_that_ran_parallel_torch(sub_db):
    """The pytest process already ran multi-threaded torch work; forked
    workers must not hang on the dead OpenMP pool they inherit."""
    x = torch.randn(1 << 21)
    assert x.sort()[0][0] <= x[0]  # wakes the intra-op pool
    sup = ServeSupervisor(single_db_entries(sub_db), workers=2,
                          control_port=None, restart_base=0.1,
                          heartbeat_secs=0.2, device="cpu").start()
    try:
        assert sup.status()["spawn_mode"] == "fork"
        st = _wait_for(lambda: (s := sup.status())["status"] == "ok" and s,
                       timeout=60, what="fleet ready")
        base = f"http://127.0.0.1:{sup.port}"
        status, body = _post(base + "/query", {"positions": list(range(11))})
        assert status == 200 and all(r["found"] for r in body["results"])
        victim = st["workers"]["1"]["pid"]
        os.kill(victim, signal.SIGKILL)
        _wait_for(lambda: (s := sup.status())["workers"]["1"]["restarts"]
                  == 1 and s["workers"]["1"]["state"] == "ready"
                  and s["workers"]["1"]["pid"] != victim,
                  timeout=60, what="worker restarted")
        assert _post(base + "/query", {"positions": [10]})[1][
            "results"][0]["value"] == "WIN"
    finally:
        sup.stop()
    assert all(w["state"] == "stopped"
               for w in sup.status()["workers"].values())


def test_exec_mode_serves_and_recovers(sub_db, monkeypatch):
    monkeypatch.setattr(ServeSupervisor, "_use_fork",
                        staticmethod(lambda: False))
    sup = ServeSupervisor(single_db_entries(sub_db), workers=1,
                          control_port=None, restart_base=0.1,
                          heartbeat_secs=0.2, heartbeat_timeout=30.0,
                          device="cpu").start()
    try:
        assert sup.status()["spawn_mode"] == "exec"
        st = _wait_for(lambda: (s := sup.status())["status"] == "ok" and s,
                       timeout=120, what="exec worker ready")
        assert st["workers"]["0"]["verified"] == {"default": True}
        base = f"http://127.0.0.1:{sup.port}"
        assert _post(base + "/query", {"positions": [10]})[1][
            "results"][0]["found"]
        os.kill(st["workers"]["0"]["pid"], signal.SIGKILL)
        _wait_for(lambda: (s := sup.status())["workers"]["0"]["restarts"]
                  >= 1 and s["status"] == "ok",
                  timeout=120, what="exec worker restarted")
        assert _post(base + "/query", {"positions": [10]})[0] == 200
    finally:
        sup.stop()


def test_supervisor_never_touches_the_cuda_driver(sub_db, monkeypatch):
    """The fleet parent checks for the card through NVML
    (device_count) and opens its readers without a device; the CUDA
    runtime check (is_available, which initializes the driver) is never
    called. Once CUDA is initialized, the spawn mode is exec."""
    def poisoned():
        raise AssertionError("the supervisor initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", poisoned)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_device("cuda", fork_safe=True).type == "cuda"
    sup = ServeSupervisor(single_db_entries(sub_db), workers=2,
                          control_port=None, device="cuda")
    try:
        assert all(r.device is None for r in sup.readers.values())
        assert sup._worker_cfg(sup._slots[0])["device"] == "cuda"
        assert sup._spawn_mode == "fork"
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        assert ServeSupervisor._use_fork() is False
    finally:
        sup._shutdown()


def test_worker_without_its_device_fails_warm_start(sub_db):
    """No silent fallback: a worker told to serve on the card, on a
    machine without one, exits 3 at warm start and never joins the
    ready set."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would warm-start")
    sup = ServeSupervisor(single_db_entries(sub_db), workers=1,
                          control_port=None, restart_base=0.1,
                          restart_max=0.2, storm_restarts=2,
                          heartbeat_secs=0.2, device="cuda").start()
    try:
        st = _wait_for(
            lambda: (s := sup.status())["workers"]["0"]["restarts"] >= 1
            and s, timeout=60, what="failed warm start")
        w = st["workers"]["0"]
        assert "rc=3" in w["last_error"]
        assert "DeviceUnavailable" in w["last_error"]
        assert st["ready"] == 0 and st["status"] != "ok"
    finally:
        sup.stop()


def test_workers_never_outlive_a_sigkilled_supervisor(sub_db):
    proc, _, control = _cli_fleet(sub_db, env_extra={
        "GAMESMAN_FAULTS_WORKER_0": "serve.worker_spawn:delay=60",
        "GAMESMAN_SERVE_HEARTBEAT_SECS": "0.2"})
    try:
        st = _wait_for(
            lambda: (s := _get(control + "/healthz")[1])
            ["workers"]["0"]["state"] == "starting"
            and s["workers"]["0"]["pid"]
            and s["workers"]["1"]["state"] == "ready" and s,
            timeout=60, what="worker 0 wedged in warm start")
        pids = [st["workers"]["0"]["pid"], st["workers"]["1"]["pid"]]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)

        def _all_gone():
            for pid in pids:
                try:
                    os.kill(pid, 0)
                    return False
                except ProcessLookupError:
                    pass
            return True

        _wait_for(_all_gone, timeout=15, interval=0.25,
                  what="workers exiting after supervisor SIGKILL")
    finally:
        _stop(proc)
