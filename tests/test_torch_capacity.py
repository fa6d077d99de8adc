"""The torch port's capacity machinery against the JAX package.

* Sharded window streaming (``GAMESMAN_WINDOW_BLOCK``): at 2 and 4
  shards, under the edges and the lookup backward, on the fast and the
  generic path, levels wider than the block stream back through the
  device (``window_stream_blocks`` > 0) and the tables equal the
  resident solve's and the JAX package's sharded solve's; the same in a
  2-process ``torch.distributed`` world.
* The edges' disk tier: past the device store and the store cache's
  budget, checkpointed edges keep no resident copy
  (``edges_bytes_disk`` > 0) and reload through the store; a kill and a
  resume still give identical tables.
* The dense counts file: a second solve reads it instead of sweeping,
  ``0`` turns it off, a stale entry forces a sweep, and each package
  reads the file the other wrote.

Integers throughout: no tolerance.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.parallel import ShardedSolver as JaxShardedSolver
from gamesmanmpi_tpu.parallel import sharded as ref_sharded
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu.solve import dense as ref_dense
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.parallel import ShardedSolver, sharded
from gamesmanmpi_tpu_torch.parallel.launch import REPO, launch
from gamesmanmpi_tpu_torch.solve import dense
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
from gamesmanmpi_tpu_torch.solve.engine import Solver

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

C43 = "connect4:w=4,h=3"  # widest level 2,424: > 256 per shard at 4
NIM = "nim:heaps=4-5-6-7-8"  # generic path, widest level 1,272

_REF = {}


def reference(spec):
    """(JAX ShardedSolver over 4 shards, port resident sharded solve) of
    `spec`, once per test process."""
    if spec not in _REF:
        jax = (JaxShardedSolver(jax_get_game(spec), num_shards=4).solve()
               if spec == C43 else JaxSolver(jax_get_game(spec)).solve())
        _REF[spec] = (jax, ShardedSolver(get_game(spec), num_shards=4,
                                         device="cpu").solve())
    return _REF[spec]


def assert_same_tables(got, ref):
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.levels) == sorted(ref.levels)
    for k, want in ref.levels.items():
        t = got.levels[k]
        np.testing.assert_array_equal(
            t.states, np.asarray(want.states).astype(np.int64), err_msg=k)
        np.testing.assert_array_equal(t.values, np.asarray(want.values))
        np.testing.assert_array_equal(t.remoteness,
                                      np.asarray(want.remoteness))


# ------------------------------------------------------ window streaming


@pytest.mark.parametrize("value", ["0", "-1", "1", "255", "256", "257",
                                   "300", str(1 << 22), "junk"])
def test_window_block_parses_like_reference(value, monkeypatch):
    monkeypatch.setenv("GAMESMAN_WINDOW_BLOCK", value)
    with pytest.warns() if value == "junk" else contextlib.nullcontext():
        got = sharded._window_block()
    with pytest.warns() if value == "junk" else contextlib.nullcontext():
        want = ref_sharded._window_block()
    assert got == want


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mode", ["edges", "lookup"])
@pytest.mark.parametrize("spec", [C43, NIM])
def test_window_streaming_matches_resident_and_reference(spec, mode, S,
                                                         monkeypatch):
    jax, resident = reference(spec)
    monkeypatch.setenv("GAMESMAN_BACKWARD", mode)
    monkeypatch.setenv("GAMESMAN_WINDOW_BLOCK", "256")
    got = ShardedSolver(get_game(spec), num_shards=S, device="cpu",
                        paranoid=True).solve()
    st = got.stats
    assert st["window_stream_blocks"] > 0
    assert st["misses"] == 0
    fast = get_game(spec).uniform_level_jump
    assert st["backward_edges_levels"] == (
        st["levels"] - 1 if fast and mode == "edges" else 0)
    assert resident.stats["window_stream_blocks"] == 0
    assert_same_tables(got, resident)
    assert_same_tables(got, jax)


def test_window_streams_every_level_once_one_spills(monkeypatch):
    """A lookup resolve whose window holds a spilled level streams the
    resident ones too (the reference's rule): nim's window spans
    max_level_jump levels."""
    resident = reference(NIM)[1]
    monkeypatch.setenv("GAMESMAN_WINDOW_BLOCK", "512")
    solver = ShardedSolver(get_game(NIM), num_shards=2, device="cpu")
    spilled = []
    real = solver._resolve_lookup

    def spy(states, window, spilled_levels=None):
        if spilled_levels is not None:
            spilled.append(len(spilled_levels))
            assert window is None
        return real(states, window, spilled_levels)

    solver._resolve_lookup = spy
    got = solver.solve()
    assert spilled and max(spilled) > 1
    assert_same_tables(got, resident)


def test_window_streaming_in_a_world(tmp_path):
    """A 2-process gloo world with --window-block 256: both ranks' tables
    equal the one-process streamed and resident tables."""
    args = ["solve", C43, "--device", "cpu", "--devices", "4",
            "--window-block", "256", "--jsonl", str(tmp_path / "r.jsonl"),
            "--table-out", str(tmp_path / "W.npz")]
    ranks = launch(args, processes=2, log_dir=str(tmp_path), timeout=240,
                   env={"OMP_NUM_THREADS": "1"})
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    one = ["solve", C43, "--device", "cpu", "--devices", "4",
           "--table-out", str(tmp_path / "one.npz")]
    assert cli.main(one) == 0
    arrays = [_arrays(tmp_path / f"W.rank{i}.npz") for i in (0, 1)]
    assert arrays[0] == arrays[1] == _arrays(tmp_path / "one.npz")
    for i in (0, 1):
        done = json.loads((tmp_path / f"r.rank{i}.jsonl").read_text()
                          .splitlines()[-1])
        assert done["phase"] == "done" and done["window_stream_blocks"] > 0


def _arrays(path):
    with np.load(path) as z:
        return {f: (str(z[f].dtype), z[f].tobytes()) for f in z.files}


# ------------------------------------------------------- edges' disk tier


def _cli(args, env):
    return subprocess.run(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch", "solve", *args],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", **env),
        capture_output=True, text=True, timeout=240)


def test_edges_disk_tier_kill_and_resume(tmp_path):
    """--device-store-mb 0 spills every edge level; past the 1 MiB store
    cache the checkpointed ones keep no copy (edges_bytes_disk > 0) and
    the backward reloads them. A kill in the backward and a resume give
    the classic engine's and the JAX package's tables."""
    spec = "connect4:w=4,h=4"
    ck = tmp_path / "ck"
    args = [spec, "--device", "cpu", "--devices", "4",
            "--device-store-mb", "0", "--checkpoint-dir", str(ck)]
    env = {"GAMESMAN_STORE_CACHE_MB": "1", "GAMESMAN_CKPT_COMPRESS": "0"}
    full = tmp_path / "full"
    proc = _cli([*args[:-1], str(full), "--jsonl", str(tmp_path / "a.jsonl"),
                 "--table-out", str(tmp_path / "a.npz")], env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    done = json.loads((tmp_path / "a.jsonl").read_text().splitlines()[-1])
    assert done["edges_bytes_disk"] > 0
    assert done["edges_bytes_disk"] < done["edges_bytes_spilled"]
    assert done["backward_edges_levels"] == done["levels"] - 1
    killed = _cli(args, dict(env, GAMESMAN_FAULTS="sharded.backward:kill:3"))
    assert killed.returncode == 77, killed.stderr[-2000:]
    resumed = _cli([*args, "--jsonl", str(tmp_path / "b.jsonl"),
                    "--table-out", str(tmp_path / "b.npz")], env)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert _arrays(tmp_path / "a.npz") == _arrays(tmp_path / "b.npz")
    classic = tmp_path / "c.npz"
    assert cli.main(["solve", spec, "--device", "cpu", "--engine", "classic",
                     "--table-out", str(classic)]) == 0
    assert _arrays(classic) == _arrays(tmp_path / "a.npz")
    assert_same_tables(Solver(get_game(spec), device="cpu").solve(),
                       JaxSolver(jax_get_game(spec)).solve())


def test_edges_disk_tier_in_a_world(tmp_path):
    """A 2-process gloo world on the disk tier: every rank weighs the
    level's bytes over all shards, so both ranks take the one-process
    run's verdicts (the same spilled and disk bytes) and the same
    collectives, and their tables equal the one-process run's."""
    spec = "connect4:w=4,h=4"
    env = {"GAMESMAN_STORE_CACHE_MB": "1", "GAMESMAN_CKPT_COMPRESS": "0"}
    base = ["solve", spec, "--device", "cpu", "--devices", "4",
            "--device-store-mb", "0"]
    one = _cli([*base[1:], "--checkpoint-dir", str(tmp_path / "one"),
                "--jsonl", str(tmp_path / "one.jsonl"),
                "--table-out", str(tmp_path / "one.npz")], env)
    assert one.returncode == 0, one.stderr[-2000:]
    ranks = launch([*base, "--checkpoint-dir", str(tmp_path / "w"),
                    "--jsonl", str(tmp_path / "w.jsonl"),
                    "--table-out", str(tmp_path / "W.npz")],
                   processes=2, log_dir=str(tmp_path), timeout=240,
                   env=dict(env, OMP_NUM_THREADS="1"))
    for r in ranks:
        assert r.returncode == 0, (r.rank, r.stderr[-2000:])
    want = _arrays(tmp_path / "one.npz")
    for i in (0, 1):
        assert _arrays(tmp_path / f"W.rank{i}.npz") == want
    done = [_done(tmp_path / "one.jsonl")] + [
        _done(tmp_path / f"w.rank{i}.jsonl") for i in (0, 1)]
    assert done[0]["edges_bytes_disk"] > 0
    for d in done[1:]:
        assert d["backward_edges_levels"] == done[0]["backward_edges_levels"]
        for key in ("edges_bytes_spilled", "edges_bytes_disk"):
            assert d[key] == done[0][key], key


def _done(path):
    return [r for r in map(json.loads, path.read_text().splitlines())
            if r.get("phase") == "done"][-1]


def test_no_disk_tier_without_a_checkpoint(monkeypatch):
    resident = reference(C43)[1]
    monkeypatch.setenv("GAMESMAN_DEVICE_STORE_MB", "0")
    monkeypatch.setenv("GAMESMAN_STORE_CACHE_MB", "1")
    got = ShardedSolver(get_game(C43), num_shards=4, device="cpu").solve()
    assert got.stats["edges_bytes_spilled"] > 0
    assert got.stats["edges_bytes_disk"] == 0
    assert_same_tables(got, resident)


# ------------------------------------------------------ dense counts file

C34 = "connect4:w=3,h=4,connect=3"


@pytest.fixture
def counts_file(tmp_path, monkeypatch):
    path = tmp_path / "counts.json"
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", str(path))
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    monkeypatch.setattr(ref_dense, "_REACH_COUNTS", {})
    return path


def _dense(spec=C34):
    return DenseSolver(get_game(spec), device="cpu")


def test_second_solve_reads_the_counts_file(counts_file, monkeypatch):
    first = _dense().solve()
    assert first.stats["reach_counts_source"] == "sweep"
    data = json.loads(counts_file.read_text())
    assert data["3x4x3"]["version"] == 2 and data["3x4x3"]["board"] == "3x4x3"
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    solver = _dense()
    monkeypatch.setattr(solver, "_sweep_levels", _no_sweep)
    second = solver.solve()
    assert second.stats["reach_counts_source"] == "file"
    assert second.num_positions == first.num_positions
    assert (second.stats["reachable_per_level"]
            == first.stats["reachable_per_level"])
    assert _dense().solve().stats["reach_counts_source"] == "process"


def _no_sweep(*a, **k):
    raise AssertionError("the reach sweep ran")


def test_counts_file_zero_disables(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    monkeypatch.chdir(tmp_path)
    assert dense._counts_file() is None
    r = _dense().solve()
    assert r.stats["reach_counts_source"] == "sweep"
    assert dense._load_cached_counts((3, 4, 3)) is None


@pytest.mark.parametrize("edit", ["version", "board", "level0", "negative",
                                  "torn"])
def test_stale_counts_force_a_sweep(edit, counts_file, monkeypatch):
    _dense().solve()
    data = json.loads(counts_file.read_text())
    rec = data["3x4x3"]
    if edit == "version":
        rec["version"] = 1
    elif edit == "board":
        rec["board"] = "4x4x4"
    elif edit == "level0":
        rec["counts"]["0"] = 2
    elif edit == "negative":
        rec["counts"]["5"] = -1
    text = json.dumps(data) if edit != "torn" else counts_file.read_text()[
        :20]
    counts_file.write_text(text)
    assert dense._load_cached_counts((3, 4, 3)) is None
    assert ref_dense._load_cached_counts((3, 4, 3)) is None
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    again = _dense().solve()
    assert again.stats["reach_counts_source"] == "sweep"
    # The sweep rewrote the entry, stamped.
    assert dense._load_cached_counts((3, 4, 3)) == {
        int(k): v for k, v in again.stats["reachable_per_level"].items()}


def test_each_package_reads_the_others_counts_file(counts_file,
                                                   monkeypatch):
    """The port writes 3x4x3, the JAX package reads it; the JAX package
    writes 3x3x3 (merging, under its lock), the port reads both."""
    port = _dense().solve()
    want = {int(k): v for k, v in port.stats["reachable_per_level"].items()}
    assert ref_dense._load_cached_counts((3, 4, 3)) == want
    jax_counts = ref_dense.DenseSolver(
        jax_get_game("connect4:w=3,h=3,connect=3")).reachable_counts()
    assert json.loads(counts_file.read_text()).keys() == {"3x4x3", "3x3x3"}
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    solver = _dense("connect4:w=3,h=3,connect=3")
    monkeypatch.setattr(solver, "_sweep_levels", _no_sweep)
    got = solver.solve()
    assert got.stats["reach_counts_source"] == "file"
    assert {int(k): v for k, v in got.stats[
        "reachable_per_level"].items()} == dict(jax_counts)
    assert dense._load_cached_counts((3, 4, 3)) == want
