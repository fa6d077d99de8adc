"""Elastic resume of the torch port's sharded checkpoints against the JAX
package (the counterpart of tests/test_reshard.py).

* The row re-partitioner: ``repartition_rows`` and
  ``reshard_shard_stream`` give the reference's arrays on the same seeded
  inputs.
* In-process resume: killed mid-backward at S=2 and resumed at S' in
  {1, 4}, the tree reshards on load (``resharded_from``), its sealed
  edges fall back to the lookup backward, and the tables equal the
  uninterrupted solve's; a forward prefix sealed at mixed shard counts
  resumes too.
* ``GAMESMAN_RESHARD=0`` raises, naming both geometries.
* ``sealed_geometry`` and ``resume_digest`` equal the reference's for the
  same directory.

Integer tables throughout, compared exactly.
"""

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.utils import checkpoint as ref_ckpt
from gamesmanmpi_tpu_torch.core.hashing import owner_shard_np
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.parallel import ShardedSolver
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.solve.engine import Solver, SolverError
from gamesmanmpi_tpu_torch.utils.checkpoint import (
    LevelCheckpointer,
    repartition_rows,
    reshard_shard_stream,
)

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch pool as wide as the machine in each of them oversubscribes the
# cores (a 2 s meshed dense solve took 80-105 s under six workers).
torch.set_num_threads(1)

C3 = "connect4:w=3,h=3,connect=3"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def c3_clean():
    return Solver(get_game(C3), device="cpu").solve()


def assert_same_tables(got, want):
    assert (got.value, got.remoteness, got.num_positions) == (
        want.value, want.remoteness, want.num_positions)
    assert sorted(got.levels) == sorted(want.levels)
    for k, t in want.levels.items():
        u = got.levels[k]
        np.testing.assert_array_equal(u.states, t.states, err_msg=k)
        np.testing.assert_array_equal(u.values, t.values, err_msg=k)
        np.testing.assert_array_equal(u.remoteness, t.remoteness,
                                      err_msg=k)


def _keys(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.unique(rng.randint(0, 2 ** 62, n).astype(np.uint64))


def _kill(spec, S, point, d):
    faults.configure(point)
    with pytest.raises(faults.FatalFault):
        ShardedSolver(get_game(spec), num_shards=S, device="cpu",
                      checkpointer=LevelCheckpointer(d)).solve()
    faults.clear()


def _resume(spec, S, d):
    return ShardedSolver(get_game(spec), num_shards=S, device="cpu",
                         checkpointer=LevelCheckpointer(d)).solve()


# ------------------------------------------------------ the re-partitioner


@pytest.mark.parametrize("new_s", [1, 2, 3, 4, 8, 16])
def test_repartition_rows_matches_reference(new_s):
    states = _keys(999)
    payload = (states % np.uint64(251)).astype(np.int32)
    got = repartition_rows(states, new_s, payload)
    want = ref_ckpt.repartition_rows(states, new_s, payload)
    assert len(got) == len(want) == new_s
    for t, ((st, pl), (rst, rpl)) in enumerate(zip(got, want)):
        assert (owner_shard_np(st, new_s) == t).all()
        np.testing.assert_array_equal(st, rst)
        np.testing.assert_array_equal(pl, rpl)
        assert st.dtype == states.dtype
    # The int64 carrier buckets like the reference's uint64.
    carrier = repartition_rows(states.astype(np.int64), new_s)
    for (st,), (rst, _) in zip(carrier, want):
        np.testing.assert_array_equal(st, rst.astype(np.int64))


@pytest.mark.parametrize("old_s", [1, 2, 3, 8])
@pytest.mark.parametrize("new_s", [1, 2, 4, 16])
def test_reshard_stream_matches_reference(old_s, new_s):
    states = _keys(1234, seed=old_s * 31 + new_s)
    payload = (states * np.uint64(3)).astype(np.uint64)
    old = repartition_rows(states, old_s, payload)
    got = reshard_shard_stream(lambda s: old[s], old_s, new_s)
    want = ref_ckpt.reshard_shard_stream(lambda s: old[s], old_s, new_s)
    direct = repartition_rows(states, new_s, payload)
    assert len(got) == new_s
    for t in range(new_s):
        for i in range(2):
            np.testing.assert_array_equal(got[t][i], want[t][i])
            np.testing.assert_array_equal(got[t][i], direct[t][i])
        assert (np.diff(got[t][0].astype(np.uint64)) > 0).all() \
            or got[t][0].shape[0] <= 1


def test_reshard_stream_bare_arrays():
    """Frontier files hold one member: load_shard may return a bare
    array."""
    states = _keys(500)
    old = [p[0] for p in repartition_rows(states, 4)]
    got = reshard_shard_stream(lambda s: old[s], 4, 2)
    want = ref_ckpt.reshard_shard_stream(lambda s: old[s], 4, 2)
    for t in range(2):
        np.testing.assert_array_equal(got[t][0], want[t][0])


# --------------------------------------------------------- in-process resume


@pytest.mark.parametrize("new_s", [1, 4])
def test_backward_reshard_resume_parity(tmp_path, c3_clean, new_s):
    """Killed mid-backward at S=2 (snapshot, some solved levels and the
    edges sealed at 2), resumed at S': the frontier and the solved levels
    reshard on load, the unsolved levels' foreign edges take the lookup
    backward, and the tables equal the uninterrupted solve's."""
    d = tmp_path / "ck"
    _kill(C3, 2, "sharded.backward:fatal:3", d)
    resumed = _resume(C3, new_s, d)
    assert resumed.stats["resharded_from"] == 2
    assert resumed.stats["edges_geometry_fallback_levels"] >= 1
    assert resumed.stats["backward_edges_levels"] == 0
    assert_same_tables(resumed, c3_clean)


def test_forward_prefix_reshard_resume_parity(tmp_path, c3_clean):
    """Killed mid-forward at S=2, then again mid-forward at S=4: the
    prefix is sealed at mixed counts {2, 4}, and a resume at S=8 adopts
    it level by level."""
    d = tmp_path / "ck"
    _kill(C3, 2, "sharded.forward:fatal:3", d)
    _kill(C3, 4, "sharded.forward:fatal:5", d)
    manifest = LevelCheckpointer(d).load_manifest()
    counts = {int(v) for v in manifest["forward_level_shards"].values()}
    assert counts == {2, 4}
    resumed = _resume(C3, 8, d)
    assert resumed.stats["resharded_from"] is not None
    assert_same_tables(resumed, c3_clean)
    # The snapshot superseded the forward level files.
    manifest = LevelCheckpointer(d).load_manifest()
    assert "forward_level_shards" not in manifest
    assert manifest["frontier_shards"] == 8
    assert not list(d.glob("frontier_*.shard_*.npz"))


def test_reshard_disabled_raises_named_geometry(tmp_path, c3_clean,
                                                monkeypatch):
    d = tmp_path / "ck"
    _kill(C3, 2, "sharded.backward:fatal:2", d)
    monkeypatch.setenv("GAMESMAN_RESHARD", "0")
    with pytest.raises(SolverError) as ei:
        _resume(C3, 4, d)
    msg = str(ei.value)
    assert "sealed at" in msg
    assert "shards=[2]" in msg and "shards=4" in msg
    assert "epoch=" in msg and "GAMESMAN_RESHARD" in msg
    # The same geometry resumes under the strict mode, and the default
    # reshards.
    monkeypatch.setenv("GAMESMAN_RESHARD", "off")
    assert _resume(C3, 2, d).stats["resharded_from"] is None
    monkeypatch.delenv("GAMESMAN_RESHARD")
    d2 = tmp_path / "ck2"
    _kill(C3, 2, "sharded.backward:fatal:2", d2)
    resumed = _resume(C3, 4, d2)
    assert resumed.stats["resharded_from"] == 2
    assert_same_tables(resumed, c3_clean)


def test_sealed_geometry_and_digest_match_reference(tmp_path, monkeypatch):
    """The port's geometry view and resume digest of a directory equal the
    reference's (the digest is what a world's ranks barrier on, so a
    mixed-package world would agree), geometry-normalized under reshard
    and strict without it."""
    d = tmp_path / "ck"
    ck = LevelCheckpointer(d)
    assert ck.sealed_geometry()["shard_counts"] == []
    assert ck.check_resume_geometry(4)["status"] == "fresh"
    _kill(C3, 2, "sharded.backward:fatal:2", d)
    ck, ref = LevelCheckpointer(d), ref_ckpt.LevelCheckpointer(d)
    geom = ck.sealed_geometry()
    assert geom == ref.sealed_geometry()
    assert geom["num_shards"] == 2 and geom["shard_counts"] == [2]
    assert geom["num_processes"] == 1 and geom["epoch"] == 1
    assert ck.run_info() == ref.run_info()
    for S in (2, 4):
        assert (ck.check_resume_geometry(S)
                == ref.check_resume_geometry(S))
    assert ck.check_resume_geometry(2)["status"] == "match"
    assert ck.check_resume_geometry(4)["status"] == "reshard"
    assert ck.resume_digest(2) == ck.resume_digest(4) == ref.resume_digest(4)
    monkeypatch.setenv("GAMESMAN_RESHARD", "0")
    assert ck.resume_digest(2) != ck.resume_digest(4)
    for S in (2, 4):
        assert ck.resume_digest(S) == ref.resume_digest(S)
