"""The torch port's sharded engine across a real world of processes.

Two-process gloo worlds on the CPU, started through
``gamesmanmpi_tpu_torch.parallel.launch`` (the port's ``mpirun -np 2``):
the ranks' tables are identical to each other and to one process; a
transient on one rank is a retry on both, with equal counts; a rank that
dies mid-backward (an injected exit, or a real SIGKILL) ends the world
with the coordinated abort, exit 124, within the barrier deadline — no
hang. Integers throughout: no tolerance.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.parallel.launch import REPO, launch, start_world

C3 = "connect4:w=3,h=3,connect=3"
ARGS = ["solve", C3, "--device", "cpu", "--devices", "4"]


def _arrays(path):
    with np.load(path) as z:
        return {f: (z[f].dtype, z[f].tobytes()) for f in z.files}


def _ok(ranks):
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.returncode, r.stderr[-2000:])


def _retry_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("[coordination]") and " retries " in ln]


@pytest.fixture(scope="module")
def single_table(tmp_path_factory):
    path = tmp_path_factory.mktemp("one") / "T.npz"
    assert cli.main(ARGS + ["--table-out", str(path)]) == 0
    return _arrays(path)


def test_launch_cli_world_matches_one_process(single_table, tmp_path):
    """The acceptance command: `python -m gamesmanmpi_tpu_torch.parallel.
    launch --processes 2 -- solve ... --devices 4 --table-out T` gives two
    rank tables identical to each other and to the one-process table."""
    proc = subprocess.run(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch.parallel.launch",
         "--processes", "2", "--log-dir", str(tmp_path), "--",
         *ARGS, "--table-out", str(tmp_path / "T.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for rank in (0, 1):
        assert f"--- rank {rank}: rc=0 ---" in proc.stdout
    assert proc.stdout.count("positions: 694") == 2
    assert proc.stdout.count("devices: 4") == 2
    assert not (tmp_path / "T.npz").exists()
    r0, r1 = (_arrays(tmp_path / f"T.rank{i}.npz") for i in (0, 1))
    assert r0 == r1 == single_table


def test_generic_path_world_nim(tmp_path):
    args = ["solve", "nim:heaps=2-3-4", "--device", "cpu", "--devices", "4",
            "--table-out", str(tmp_path / "N.npz")]
    ranks = launch(args, processes=2, log_dir=str(tmp_path), timeout=240)
    _ok(ranks)
    for r in ranks:
        assert "value: WIN" in r.stdout and "positions: 60" in r.stdout
    assert cli.main(args[:-1] + [str(tmp_path / "one.npz")]) == 0
    assert (_arrays(tmp_path / "N.rank0.npz")
            == _arrays(tmp_path / "N.rank1.npz")
            == _arrays(tmp_path / "one.npz"))


def test_transient_on_one_rank_is_a_retry_on_both(single_table, tmp_path):
    ranks = launch(
        ARGS + ["--table-out", str(tmp_path / "T.npz")], processes=2,
        log_dir=str(tmp_path), timeout=240,
        env={"GAMESMAN_FAULTS_RANK_1": "sharded.forward:transient:2",
             "GAMESMAN_RETRY_BASE_SECS": "0"})
    _ok(ranks)
    assert "injecting transient" not in ranks[0].stderr
    assert "injecting transient at sharded.forward" in ranks[1].stderr
    counts = [len(_retry_lines(r.stderr)) for r in ranks]
    assert counts == [1, 1]
    assert (_arrays(tmp_path / "T.rank0.npz")
            == _arrays(tmp_path / "T.rank1.npz") == single_table)


@pytest.mark.parametrize("how", ["fault-exit", "sigkill"])
def test_killed_rank_ends_the_world_without_a_hang(how, tmp_path):
    """Rank 1 dies at its third backward step (an injected exit 77, or a
    real SIGKILL while a delay holds it there): rank 0 waits in that
    step's consensus round, which times out at GAMESMAN_BARRIER_SECS,
    and exits 124."""
    barrier = 4.0
    fault = ("sharded.backward:kill:3" if how == "fault-exit"
             else "sharded.backward:delay=60:3")
    t0 = time.monotonic()
    world = start_world(
        ARGS, processes=2, log_dir=str(tmp_path),
        env={"GAMESMAN_FAULTS_RANK_1": fault,
             "GAMESMAN_BARRIER_SECS": str(barrier),
             "GAMESMAN_COLLECTIVE_TIMEOUT": "30"})
    if how == "sigkill":
        deadline = time.monotonic() + 120
        while "injecting delay at sharded.backward" not in world.stderr_of(1):
            assert time.monotonic() < deadline, world.stderr_of(1)
            time.sleep(0.05)
        os.kill(world.pids()[1], signal.SIGKILL)
        t_kill = time.monotonic()
    ranks = world.wait(120)
    assert ranks[1].returncode == (77 if how == "fault-exit"
                                   else -signal.SIGKILL)
    assert ranks[0].returncode == 124, ranks[0].stderr[-2000:]
    assert "coordinated abort" in ranks[0].stderr
    assert "positions:" not in ranks[0].stdout
    if how == "sigkill":
        assert time.monotonic() - t_kill < barrier + 20
    assert time.monotonic() - t0 < 120
