"""Checkpoint/resume of the torch port's sharded engine against the JAX
package.

* Kill-and-resume parity at each sharded fault point, in process (an
  injected fatal fault) and in a CLI child (a kill, exit 77, and a torn
  seal, exit 86): the resumed tables equal the uninterrupted solve's.
* Cross-resume: the port resumes a directory the reference's
  ``ShardedSolver`` sealed on the CPU, and the reference resumes the
  port's, edges included.
* A 2-process gloo world, checkpointed, with rank 1 killed: rank 0 exits
  124, and the directory resumes in a world and in one process.
* World grace: SIGUSR1 on one rank stops both ranks at the same boundary
  with exit 75, and the rerun's tables are identical.
* ``export-db --from-checkpoint`` of a sharded directory writes the same
  files (sha256) as the classic export, in either package.

Integer tables throughout, compared exactly.
"""

import hashlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.parallel import ShardedSolver as JaxShardedSolver
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu.utils.checkpoint import LevelCheckpointer as JaxCkpt
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.core.values import value_name
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.parallel import ShardedSolver
from gamesmanmpi_tpu_torch.parallel.launch import REPO, launch, start_world
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch pool as wide as the machine in each of them oversubscribes the
# cores (a 2 s meshed dense solve took 80-105 s under six workers).
torch.set_num_threads(1)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}  # the same for child processes

C3 = "connect4:w=3,h=3,connect=3"
NIM = "nim:heaps=3-4-5"
WORLD = ["solve", C3, "--device", "cpu", "--devices", "4"]

_CLEAN = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def clean(spec):
    """The JAX package's uninterrupted solve of `spec`."""
    if spec not in _CLEAN:
        _CLEAN[spec] = JaxSolver(jax_get_game(spec)).solve()
    return _CLEAN[spec]


def assert_same_tables(got, want):
    """A port or JAX result against a JAX one, states as uint64."""
    assert (got.value, got.remoteness, got.num_positions) == (
        want.value, want.remoteness, want.num_positions)
    assert sorted(got.levels) == sorted(want.levels)
    for k, t in want.levels.items():
        u = got.levels[k]
        np.testing.assert_array_equal(
            np.asarray(u.states).astype(np.uint64),
            np.asarray(t.states).astype(np.uint64), err_msg=k)
        np.testing.assert_array_equal(u.values, np.asarray(t.values),
                                      err_msg=k)
        np.testing.assert_array_equal(u.remoteness,
                                      np.asarray(t.remoteness), err_msg=k)


def _arrays(path):
    with np.load(path) as z:
        return {f: (z[f].dtype, z[f].tobytes()) for f in z.files}


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def _quiet(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def single_table(tmp_path_factory):
    path = tmp_path_factory.mktemp("one") / "T.npz"
    assert _quiet(cli.main, WORLD + ["--table-out", str(path)])[0] == 0
    return _arrays(path)


def _port(spec, S, d):
    return ShardedSolver(get_game(spec), num_shards=S, device="cpu",
                         checkpointer=LevelCheckpointer(d))


def _jax(spec, S, d):
    return JaxShardedSolver(jax_get_game(spec), num_shards=S,
                            checkpointer=JaxCkpt(d))


# ------------------------------------------------ kill and resume parity


@pytest.mark.parametrize("spec,point", [
    (C3, "sharded.forward:fatal:2"),
    (C3, "sharded.backward:fatal:3"),
    (C3, "ckpt.save_level:fatal:2"),
    (C3, "store.writebehind:fatal:3"),
    (NIM, "sharded.forward:fatal:4"),
    (NIM, "sharded.backward:fatal:3"),
])
def test_kill_and_resume_parity(spec, point, tmp_path):
    """A fatal fault at each sharded point, then a rerun on the same
    directory: the tables equal the uninterrupted solve's, and a level
    sealed before the fault is loaded, not resolved again."""
    d = tmp_path / "ck"
    faults.configure(point)
    with pytest.raises(faults.FatalFault):
        _port(spec, 4, d).solve()
    faults.clear()
    sealed = LevelCheckpointer(d).completed_levels()
    resumed = _port(spec, 4, d).solve()
    assert resumed.stats["resharded_from"] is None
    assert resumed.stats["ckpt_bytes_raw"] > 0
    if "backward" in point:
        assert sealed  # levels sealed before the fault were loaded
        levels = resumed.stats["levels"]
        assert resumed.stats["backward_edges_levels"] <= levels - len(sealed)
    assert_same_tables(resumed, clean(spec))


def _child(args, env=None):
    full = dict(os.environ)
    full.pop("GAMESMAN_FAULTS", None)
    full.update(ONE_THREAD, **(env or {}))
    return subprocess.run([sys.executable, "-m", "gamesmanmpi_tpu_torch",
                           *args], cwd=REPO, env=full, capture_output=True,
                          text=True, timeout=240)


@pytest.mark.parametrize("fault,code", [
    ("sharded.backward:kill:3", faults.KILL_EXIT_CODE),
    ("ckpt.save_level:torn:2", faults.TORN_EXIT_CODE),
])
def test_cli_kill_and_torn_seal_resume(fault, code, single_table, tmp_path):
    """A killed child (exit 77) and a torn level-shard seal (exit 86):
    the rerun resumes (the torn shard set is quarantined and recomputed)
    to the one-device table."""
    d, out = tmp_path / "ck", tmp_path / "T.npz"
    args = WORLD + ["--checkpoint-dir", str(d), "--table-out", str(out)]
    killed = _child(args, {"GAMESMAN_FAULTS": fault})
    assert killed.returncode == code, killed.stderr[-2000:]
    assert not out.exists()
    resumed = _child(args)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert _arrays(out) == single_table
    if "torn" in fault:
        assert list(d.glob("level_*.shard_*.npz.corrupt"))


# ------------------------------------------------------------ cross-resume


@pytest.mark.parametrize("point", ["sharded.forward:fatal:3",
                                   "sharded.backward:fatal:3"])
def test_port_resumes_reference_directory(point, tmp_path):
    d = tmp_path / "ck"
    ref_faults.configure(point)
    with pytest.raises(ref_faults.FatalFault):
        _jax(C3, 2, d).solve()
    ref_faults.clear()
    resumed = _port(C3, 2, d).solve()
    # The reference's edge files serve the port's edges backward.
    assert resumed.stats["backward_edges_levels"] > 0
    assert resumed.stats["edges_geometry_fallback_levels"] == 0
    assert_same_tables(resumed, clean(C3))


@pytest.mark.parametrize("point", ["sharded.forward:fatal:3",
                                   "sharded.backward:fatal:3"])
def test_reference_resumes_port_directory(point, tmp_path):
    d = tmp_path / "ck"
    faults.configure(point)
    with pytest.raises(faults.FatalFault):
        _port(C3, 2, d).solve()
    faults.clear()
    resumed = _jax(C3, 2, d).solve()
    assert resumed.stats["backward_edges_levels"] > 0
    assert_same_tables(resumed, clean(C3))


# ------------------------------------------------------------------ worlds


def test_world_kill_resumes_in_world_and_in_one_process(single_table,
                                                         tmp_path):
    """Rank 1 dies mid-backward in a checkpointed 2-process world: rank 0
    ends with the coordinated abort (exit 124) and the sealed prefix
    resumes, in a world and in one process, to the one-process table."""
    d = tmp_path / "ck"
    args = WORLD + ["--checkpoint-dir", str(d)]
    ranks = launch(args, processes=2, log_dir=str(tmp_path / "k"),
                   timeout=240,
                   env={"GAMESMAN_BARRIER_SECS": "4",
                        "GAMESMAN_COLLECTIVE_TIMEOUT": "30", **ONE_THREAD},
                   per_rank_env={1: {"GAMESMAN_FAULTS":
                                     "sharded.backward:kill:3"}})
    assert ranks[1].returncode == faults.KILL_EXIT_CODE
    assert ranks[0].returncode == 124, ranks[0].stderr[-2000:]
    ck = LevelCheckpointer(d)
    assert ck.sealed_geometry()["num_processes"] == 2
    assert len(ck.completed_levels()) == 2
    shutil.copytree(d, tmp_path / "one")
    out = tmp_path / "T.npz"
    ranks = launch(args + ["--table-out", str(out)], processes=2,
                   log_dir=str(tmp_path / "w"), timeout=240, env=ONE_THREAD)
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    assert (_arrays(tmp_path / "T.rank0.npz")
            == _arrays(tmp_path / "T.rank1.npz") == single_table)
    assert LevelCheckpointer(d).run_info()["epoch"] == 2
    rc, _ = _quiet(cli.main, WORLD + ["--checkpoint-dir",
                                      str(tmp_path / "one"), "--table-out",
                                      str(tmp_path / "O.npz")])
    assert rc == 0
    assert _arrays(tmp_path / "O.npz") == single_table


def test_world_grace_signal_stops_both_ranks_with_75(single_table,
                                                     tmp_path):
    """SIGUSR1 on rank 1 only: at the next level boundary the consensus
    round stops both ranks (exit 75, "preempted:"), and the world's rerun
    resumes to the one-process table."""
    d = tmp_path / "ck"
    args = WORLD + ["--checkpoint-dir", str(d)]
    delay = {"GAMESMAN_FAULTS": "sharded.backward:delay=0.3:always"}
    world = start_world(args, processes=2, log_dir=str(tmp_path / "g"),
                        env={"GAMESMAN_BARRIER_SECS": "20", **ONE_THREAD},
                        per_rank_env={0: delay, 1: delay})
    deadline = time.monotonic() + 120
    while "injecting delay at sharded.backward" not in world.stderr_of(1):
        assert time.monotonic() < deadline, world.stderr_of(1)
        time.sleep(0.05)
    os.kill(world.pids()[1], signal.SIGUSR1)
    ranks = world.wait(120)
    for r in ranks:
        assert r.returncode == 75, (r.rank, r.stderr[-2000:])
        assert "preempted:" in r.stderr
    assert "peer rank preempted" in ranks[0].stderr
    assert "positions:" not in ranks[0].stdout
    out = tmp_path / "T.npz"
    ranks = launch(args + ["--table-out", str(out)], processes=2,
                   log_dir=str(tmp_path / "r"), timeout=240, env=ONE_THREAD)
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    assert _arrays(tmp_path / "T.rank0.npz") == single_table


# ------------------------------------------------------ export and queries


def test_sharded_export_matches_classic_export(tmp_path):
    """export-db --from-checkpoint of a sharded directory (the shards
    merged per level by load_level) gives the classic export's files,
    from either package's CLI."""
    d = tmp_path / "ck"
    _port(C3, 4, d).solve()
    assert LevelCheckpointer(d).level_shard_count(0) == 4
    args = ["export-db", C3, "--from-checkpoint", str(d), "--out"]
    assert _quiet(cli.main, args + [str(tmp_path / "p"), "--device",
                                    "cpu"])[0] == 0
    assert _quiet(jax_cli.main, args + [str(tmp_path / "j")])[0] == 0
    assert _quiet(cli.main, ["export-db", C3, "--out",
                             str(tmp_path / "c"), "--device", "cpu"])[0] == 0
    want = _digests(tmp_path / "c")
    assert _digests(tmp_path / "p") == _digests(tmp_path / "j") == want
    manifest = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert manifest["num_positions"] == clean(C3).num_positions


def test_no_tables_queries_answer_from_shard_files(tmp_path, capsys):
    """--no-tables keeps only the root; --query answers from the ONE shard
    file its owner hash names."""
    d = str(tmp_path / "ck")
    ref = clean(C3)
    level = sorted(ref.levels)[4]
    states = [int(s) for s in ref.levels[level].states[:3]]
    argv = WORLD + ["--checkpoint-dir", d, "--no-tables"]
    for s in states:
        argv += ["--query", hex(s)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    for i, s in enumerate(states):
        t = ref.levels[level]
        want = (f"query {hex(s)}: value={value_name(int(t.values[i]))} "
                f"remoteness={int(t.remoteness[i])}")
        assert want in out
