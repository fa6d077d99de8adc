"""Torch port's checkpoint/resume against the JAX package.

A checkpoint directory is interchangeable between the packages: the same
manifest keys, file names, npz members and dtypes. A directory the JAX
solvers sealed, cut back to a prefix of its levels, resumes in the port,
and one the port sealed loads in the reference's LevelCheckpointer with
identical arrays and resumes there; either way the finished tables equal
an uninterrupted JAX solve's. Also the reference's own checkpoint tests
(tests/test_utils.py, tests/test_dense.py) on the port. The port runs on
the CPU; integers throughout, so tolerance zero.
"""

import io
import json
import shutil
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu.solve.dense import DenseSolver as JaxDenseSolver
from gamesmanmpi_tpu.utils.checkpoint import LevelCheckpointer as JaxCkpt
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.core.bitops import to_reference
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.solve import dense as dense_mod
from gamesmanmpi_tpu_torch.solve import engine
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
from gamesmanmpi_tpu_torch.solve.engine import Solver, SolverError
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

#: fast path uint32, generic path uint64, fast path Connect-4.
SPECS = ["tictactoe", "nim:heaps=8-1-1-1-1-1-1-1",
         "connect4:w=3,h=4,connect=3"]
DENSE = "connect4:w=3,h=4,connect=3"

_SEALED = {}


def jax_sealed(spec, tmp_path_factory):
    """(directory, result) of one checkpointed JAX solve, once per
    process: the reference's directory and its uninterrupted tables."""
    if spec not in _SEALED:
        d = tmp_path_factory.mktemp("jax_ck")
        if spec == "dense":
            r = JaxDenseSolver(jax_get_game(DENSE),
                               checkpointer=JaxCkpt(str(d))).solve()
        else:
            r = JaxSolver(jax_get_game(spec),
                          checkpointer=JaxCkpt(str(d))).solve()
        _SEALED[spec] = (d, r)
    return _SEALED[spec]


def assert_tables_equal(got, ref):
    """The port's SolveResult against a JAX one: every level's states (in
    the reference dtype), values and remoteness."""
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.levels) == sorted(ref.levels)
    for k, want in ref.levels.items():
        t = got.levels[k]
        states = to_reference(t.states, got.game)
        assert states.dtype == want.states.dtype, k
        np.testing.assert_array_equal(states, want.states, err_msg=k)
        np.testing.assert_array_equal(t.values, want.values, err_msg=k)
        np.testing.assert_array_equal(t.remoteness, want.remoteness,
                                      err_msg=k)


def cut(directory, *, levels=None, forward=None):
    """Cut a sealed directory back to what an interrupted run leaves:
    `levels` keeps the deepest that many solved levels, `forward` the
    first that many forward levels (unmarking the complete forward and
    the generic path's snapshot)."""
    path = directory / "manifest.json"
    m = json.loads(path.read_text())
    if levels is not None:
        m["levels"] = sorted(m.get("levels", []))[::-1][:levels]
    if forward is not None:
        m["forward_levels"] = sorted(m.get("forward_levels", []))[:forward]
        m.pop("frontiers_complete", None)
        m.pop("frontiers", None)
    path.write_text(json.dumps(m))
    return m


def copy_dir(src, dst):
    shutil.copytree(src, dst)
    return dst


# ------------------------------------------------------ the directory format


@pytest.mark.parametrize("spec", SPECS)
def test_port_directory_matches_reference_file_for_file(spec, tmp_path,
                                                        tmp_path_factory):
    """Same manifest keys and files; every npz member equal, dtype
    included, loaded through both packages' checkpointers."""
    ref_dir, _ = jax_sealed(spec, tmp_path_factory)
    g = get_game(spec)
    Solver(g, device="cpu",
           checkpointer=LevelCheckpointer(tmp_path / "p")).solve()
    mine = json.loads((tmp_path / "p" / "manifest.json").read_text())
    theirs = json.loads((ref_dir / "manifest.json").read_text())
    assert sorted(mine) == sorted(theirs)
    for key in ("game", "levels", "forward_levels", "frontiers_complete",
                "frontiers"):
        assert mine.get(key) == theirs.get(key), key
    assert sorted(mine["crc"]) == sorted(theirs["crc"])
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir())
    for name in mine["crc"]:
        with np.load(tmp_path / "p" / name) as a, np.load(ref_dir / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    # The reference's loaders read the port's files to the same arrays.
    jp, jr = JaxCkpt(str(tmp_path / "p")), JaxCkpt(str(ref_dir))
    for k in jr.completed_levels():
        a, b = jp.load_level(k), jr.load_level(k)
        for field in ("states", "values", "remoteness"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, (k, field)
            np.testing.assert_array_equal(x, y, err_msg=f"{k} {field}")
    if g.uniform_level_jump:
        a, b = jp.load_forward_levels(), jr.load_forward_levels()
    else:
        a, b = jp.load_frontiers(), jr.load_frontiers()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == g.state_dtype
        np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------- cross-resume, JAX -> port


@pytest.mark.parametrize("where", ["backward", "forward", "complete"])
@pytest.mark.parametrize("spec", SPECS)
def test_jax_sealed_prefix_resumes_in_port(spec, where, tmp_path,
                                           tmp_path_factory, monkeypatch):
    ref_dir, ref = jax_sealed(spec, tmp_path_factory)
    d = copy_dir(ref_dir, tmp_path / "ck")
    n = len(ref.levels)
    if where == "backward":
        cut(d, levels=n // 2)
    elif where == "forward":
        cut(d, levels=0, forward=n // 2)
    solver = Solver(get_game(spec), device="cpu",
                    checkpointer=LevelCheckpointer(d))
    if where == "complete":
        # Everything is sealed: nothing may be expanded or resolved.
        for name in ("expand_provenance", "expand_unique",
                     "expand_with_levels", "resolve_level",
                     "resolve_provenance"):
            monkeypatch.setattr(engine, name, _poisoned)
    assert_tables_equal(solver.solve(), ref)


def _poisoned(*a, **k):
    raise AssertionError("resume recomputed a sealed level")


def test_jax_sealed_dense_prefix_resumes_in_port(tmp_path, tmp_path_factory,
                                                 monkeypatch):
    ref_dir, ref = jax_sealed("dense", tmp_path_factory)
    d = copy_dir(ref_dir, tmp_path / "ck")
    m = json.loads((d / "manifest.json").read_text())
    nc = max(m["dense_levels"])
    m["dense_levels"] = list(range(nc - 4, nc + 1))  # the top five
    (d / "manifest.json").write_text(json.dumps(m))
    solver = DenseSolver(get_game(DENSE), device="cpu",
                         checkpointer=LevelCheckpointer(d))
    orig = solver._backward_level

    def guarded(L, child_flat):
        assert L < nc - 4, f"resume recomputed sealed level {L}"
        return orig(L, child_flat)

    monkeypatch.setattr(solver, "_backward_level", guarded)
    got = solver.solve()
    assert got.stats["levels_resumed"] == 5
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    for L in ref.cells:
        np.testing.assert_array_equal(got.cells[L], np.asarray(ref.cells[L]))
    # Every level is on disk again, in the reference's dtype and length.
    jc = JaxCkpt(str(d))
    assert jc.dense_levels() == list(range(nc + 1))
    for L in range(nc + 1):
        cells = jc.load_dense_level(L)
        assert cells.dtype == np.uint8 and cells.ndim == 1
        np.testing.assert_array_equal(cells,
                                      np.asarray(ref.cells[L]).reshape(-1))


# ----------------------------------------------------- cross-resume, port -> JAX


@pytest.mark.parametrize("spec", SPECS)
def test_port_sealed_prefix_resumes_in_jax(spec, tmp_path, tmp_path_factory):
    _, ref = jax_sealed(spec, tmp_path_factory)
    d = tmp_path / "ck"
    Solver(get_game(spec), device="cpu",
           checkpointer=LevelCheckpointer(d)).solve()
    cut(d, levels=len(ref.levels) // 2)
    got = JaxSolver(jax_get_game(spec), checkpointer=JaxCkpt(str(d))).solve()
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    for k, want in ref.levels.items():
        for field in ("states", "values", "remoteness"):
            x, y = getattr(got.levels[k], field), getattr(want, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f"{k} {field}")


def test_port_sealed_dense_prefix_resumes_in_jax(tmp_path, tmp_path_factory):
    _, ref = jax_sealed("dense", tmp_path_factory)
    d = tmp_path / "ck"
    full = DenseSolver(get_game(DENSE), device="cpu",
                       checkpointer=LevelCheckpointer(d)).solve()
    jc = JaxCkpt(str(d))
    for L, cells in full.cells.items():
        got = jc.load_dense_level(L)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, cells.reshape(-1))
    m = json.loads((d / "manifest.json").read_text())
    assert m["game"] == ref.game.name + ":dense"
    nc = max(m["dense_levels"])
    m["dense_levels"] = list(range(nc - 6, nc + 1))
    (d / "manifest.json").write_text(json.dumps(m))
    got = JaxDenseSolver(jax_get_game(DENSE),
                         checkpointer=JaxCkpt(str(d))).solve()
    assert (got.value, got.remoteness) == (ref.value, ref.remoteness)
    for L in ref.cells:
        np.testing.assert_array_equal(np.asarray(got.cells[L]),
                                      np.asarray(ref.cells[L]))


# -------------------------------------------- the reference's checkpoint tests


def test_checkpoint_roundtrip(tmp_path):
    ck = LevelCheckpointer(str(tmp_path / "ckpt"))
    result = Solver(get_game("tictactoe"), device="cpu",
                    checkpointer=ck).solve()
    assert ck.completed_levels() == sorted(result.levels)
    for level, table in result.levels.items():
        loaded = ck.load_level(level)
        assert loaded.states.dtype == np.int64  # back on the port's carrier
        np.testing.assert_array_equal(loaded.states, table.states)
        np.testing.assert_array_equal(loaded.values, table.values)
        np.testing.assert_array_equal(loaded.remoteness, table.remoteness)
    s = result.stats
    assert s["ckpt_bytes_raw"] > 0 and s["ckpt_bytes_stored"] > 0
    assert s["io_wait_secs"] >= 0


@pytest.mark.parametrize("spec", ["tictactoe", "nim:heaps=3-4-5"])
def test_checkpoint_resume_skips_recompute(spec, tmp_path, monkeypatch):
    d = str(tmp_path / "resume")
    first = Solver(get_game(spec), device="cpu",
                   checkpointer=LevelCheckpointer(d)).solve()
    for name in ("expand_provenance", "expand_unique", "expand_with_levels",
                 "resolve_level", "resolve_provenance"):
        monkeypatch.setattr(engine, name, _poisoned)
    resumed = Solver(get_game(spec), device="cpu",
                     checkpointer=LevelCheckpointer(d)).solve()
    assert (resumed.value, resumed.remoteness, resumed.num_positions) == (
        first.value, first.remoteness, first.num_positions)
    assert resumed.stats["ckpt_bytes_raw"] == 0  # nothing re-sealed


def test_no_tables_still_seals_every_level(tmp_path):
    d = tmp_path / "ck"
    r = Solver(get_game("tictactoe"), device="cpu", store_tables=False,
               checkpointer=LevelCheckpointer(d)).solve()
    assert list(r.levels) == [0]
    assert LevelCheckpointer(d).completed_levels() == list(range(10))


def test_manifest_writes_are_atomic(tmp_path):
    """Readers racing the writer always parse the manifest (old or new,
    never torn), and no tmp file is left behind."""
    ck = LevelCheckpointer(str(tmp_path / "atomic"))
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                ck.load_manifest()
            except Exception as e:  # noqa: BLE001 - a torn read
                errors.append(e)
                return

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(300):
            ck._write_manifest({"levels": list(range(i))})
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors
    assert len(ck.load_manifest()["levels"]) == 299
    assert not list((tmp_path / "atomic").glob("*.tmp"))


def test_forward_checkpoint_resume_mid_forward(tmp_path):
    """A run killed mid-discovery resumes expansion from its deepest
    sealed frontier level and matches the uninterrupted solve."""
    d = str(tmp_path / "fwd_resume")
    full = Solver(get_game("tictactoe"), device="cpu").solve()

    class _Die(Exception):
        pass

    ck = LevelCheckpointer(d)
    orig = LevelCheckpointer.save_frontier_level

    def dying(level, states):
        orig(ck, level, states)
        if level >= 3:
            raise _Die()

    ck.save_frontier_level = dying
    with pytest.raises(_Die):
        Solver(get_game("tictactoe"), device="cpu", checkpointer=ck).solve()
    assert LevelCheckpointer(d).load_manifest()["forward_levels"] == \
        [0, 1, 2, 3]
    resumed_ck = LevelCheckpointer(d)
    saved = []

    def recording(level, states):
        saved.append(level)
        orig(resumed_ck, level, states)

    resumed_ck.save_frontier_level = recording
    resumed = Solver(get_game("tictactoe"), device="cpu",
                     checkpointer=resumed_ck).solve()
    assert saved == list(range(4, 10))  # only the undiscovered levels
    assert resumed.stats["provenance_levels"] == 6  # levels 3..8 expanded
    for k, t in full.levels.items():
        np.testing.assert_array_equal(resumed.levels[k].states, t.states)
        np.testing.assert_array_equal(resumed.levels[k].values, t.values)
        np.testing.assert_array_equal(resumed.levels[k].remoteness,
                                      t.remoteness)


def test_stale_and_foreign_directories_are_refused(tmp_path):
    d = tmp_path / "ck"
    Solver(get_game("tictactoe"), device="cpu",
           checkpointer=LevelCheckpointer(d)).solve()
    with pytest.raises(ValueError, match="belongs to game"):
        Solver(get_game("tictactoe:sym=1"), device="cpu",
               checkpointer=LevelCheckpointer(d)).solve()
    with pytest.raises(ValueError, match="belongs to game"):
        DenseSolver(get_game(DENSE), device="cpu",
                    checkpointer=LevelCheckpointer(d)).solve()
    # A sealed level whose states differ from the discovered frontier.
    ck = LevelCheckpointer(d)
    ck.bind_game("tictactoe_3x3x3", np.uint32)
    t = ck.load_level(4)
    ck.save_level(4, t._replace(states=t.states[:-1], values=t.values[:-1],
                                remoteness=t.remoteness[:-1]))
    with pytest.raises(SolverError, match="stale checkpoint"):
        Solver(get_game("tictactoe"), device="cpu",
               checkpointer=LevelCheckpointer(d)).solve()
    # A directory the sharded engine sealed is no longer refused: like
    # the reference, the one-device engine reads its shard sets, and a
    # sharded level whose files are missing is quarantined and recomputed.
    full = Solver(get_game("tictactoe"), device="cpu").solve()
    for name, solver in (("port", None), ("jax", "jax")):
        d2 = tmp_path / f"sharded_{name}"
        Solver(get_game("tictactoe"), device="cpu",
               checkpointer=LevelCheckpointer(d2)).solve()
        m = json.loads((d2 / "manifest.json").read_text())
        m["levels"] = [k for k in m["levels"] if k != 3]
        m["sharded_levels"] = {"3": 4}
        (d2 / "manifest.json").write_text(json.dumps(m))
        (d2 / "level_0003.npz").unlink()
        if solver is None:
            got = Solver(get_game("tictactoe"), device="cpu",
                         checkpointer=LevelCheckpointer(d2)).solve()
            for k, t in full.levels.items():
                np.testing.assert_array_equal(got.levels[k].values,
                                              t.values)
        else:
            JaxSolver(jax_get_game("tictactoe"),
                      checkpointer=JaxCkpt(d2)).solve()
        m = json.loads((d2 / "manifest.json").read_text())
        assert m.get("sharded_levels") == {} and 3 in m["levels"], name


def test_state_files_never_hold_the_sentinel(tmp_path):
    ck = LevelCheckpointer(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="bind_game"):
        ck.save_frontier_level(0, np.array([1], np.int64))
    ck.bind_game("x", np.uint32)
    with pytest.raises(ValueError, match="sentinel"):
        ck.save_frontier_level(0, np.array([1, (1 << 63) - 1], np.int64))


# ------------------------------------------------------------------- dense


def test_dense_checkpoint_resume(tmp_path, monkeypatch):
    """A run that sealed levels K..nc rechains from K's cells without
    recomputing them; a fully sealed rerun computes nothing; a different
    game and a stale cell count are refused."""
    g = get_game(DENSE)
    full = DenseSolver(g, device="cpu").solve()
    nc = full._tables.ncells
    d = tmp_path / "dense_ck"
    ck = LevelCheckpointer(d)
    ck.bind_game(g.name + ":dense")
    for L in range(nc - 3, nc + 1):
        ck.save_dense_level(L, full.cells[L])
    for store_tables in (True, False):
        solver = DenseSolver(g, device="cpu", store_tables=store_tables,
                             checkpointer=LevelCheckpointer(d))
        orig = solver._backward_level

        def guarded(L, child_flat, orig=orig):
            assert L <= nc - 4, f"resume recomputed sealed level {L}"
            return orig(L, child_flat)

        monkeypatch.setattr(solver, "_backward_level", guarded)
        resumed = solver.solve()
        assert (resumed.value, resumed.remoteness, resumed.num_positions) \
            == (full.value, full.remoteness, full.num_positions)
        assert resumed.stats["levels_resumed"] == 4
        assert resumed.stats["encodable_positions"] == \
            full.stats["encodable_positions"]
        if store_tables:
            for L in full.cells:
                np.testing.assert_array_equal(resumed.cells[L],
                                              full.cells[L])
        # The first pass sealed the rest: reset to the top four for the
        # no-tables pass, which may read level K's file only.
        m = json.loads((d / "manifest.json").read_text())
        m["dense_levels"] = list(range(nc - 3, nc + 1))
        (d / "manifest.json").write_text(json.dumps(m))
    # Everything on disk: a fully resumed solve computes nothing.
    DenseSolver(g, device="cpu", checkpointer=LevelCheckpointer(d)).solve()
    final = DenseSolver(g, device="cpu", checkpointer=LevelCheckpointer(d))
    monkeypatch.setattr(final, "_backward_level", _poisoned)
    r = final.solve()
    assert (r.value, r.remoteness) == (full.value, full.remoteness)
    assert r.stats["levels_resumed"] == nc + 1
    with pytest.raises(ValueError, match="belongs to game"):
        DenseSolver(get_game("connect4:w=3,h=3,connect=3"), device="cpu",
                    checkpointer=LevelCheckpointer(d)).solve()
    ck.save_dense_level(nc, full.cells[nc].reshape(-1)[:-1])
    with pytest.raises(ValueError, match="stale checkpoint"):
        DenseSolver(g, device="cpu", checkpointer=LevelCheckpointer(d)).solve()
    with pytest.raises(ValueError, match="not both"):
        DenseSolver(g, device="cpu", checkpointer=LevelCheckpointer(d)).solve(
            resume_cells=dense_mod.cells_from_reference(full.cells, "cpu"))


# --------------------------------------------------------------------- CLI


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _query_lines(lines):
    return [ln for ln in lines if ln.startswith("query ")]


def _sample_queries(spec, n=60, seed=0):
    """Reachable states of every level plus some unreachable ones."""
    r = Solver(get_game(spec), device="cpu").solve()
    rng = np.random.default_rng(seed)
    qs = [int(s) for t in r.levels.values()
          for s in rng.choice(t.states, size=min(4, t.states.shape[0]),
                              replace=False)]
    return [hex(q) for q in qs[:n]] + ["0x3FFFFFF", "zz"]


@pytest.mark.parametrize("spec,engine_flag", [
    ("tictactoe", "classic"), ("tictactoe:sym=1", "classic"),
    ("nim:heaps=3-4-5", "classic"), (DENSE, "dense"),
])
def test_cli_no_tables_queries_answer_from_the_checkpoint(spec, engine_flag,
                                                          tmp_path):
    """--no-tables keeps only the root on the host; --checkpoint-dir
    answers every other query from the directory, exactly as the full
    tables and the reference CLI answer."""
    qargs = [a for q in _sample_queries(spec) for a in ("--query", q)]
    rc, full = _run(cli.main, ["solve", spec, "--device", "cpu", "--engine",
                               engine_flag, *qargs])
    assert rc == 0
    ck = str(tmp_path / "ck")
    rc, got = _run(cli.main, ["solve", spec, "--device", "cpu", "--engine",
                              engine_flag, "--no-tables",
                              "--checkpoint-dir", ck, *qargs])
    assert rc == 0
    assert _query_lines(got) == _query_lines(full)
    assert sum("remoteness=" in ln for ln in _query_lines(got)) >= 10
    # A rerun on the sealed directory (resumed, nothing computed) too.
    rc, again = _run(cli.main, ["solve", spec, "--device", "cpu", "--engine",
                                engine_flag, "--no-tables",
                                "--checkpoint-dir", ck, *qargs])
    assert rc == 0 and _query_lines(again) == _query_lines(full)
    rc, ref = _run(jax_cli.main, ["solve", spec, "--engine", engine_flag,
                                  *qargs])
    assert rc == 0 and _query_lines(ref) == _query_lines(full)


def test_cli_checkpoint_routing(tmp_path, monkeypatch, capsys):
    """The reference's routing on the card: auto + --checkpoint-dir runs
    the classic engine, an explicit dense takes the checkpoint, and dense
    with --table-out/--paranoid is still exit 2."""
    chosen = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def __call__(self, game, **kw):
            chosen.append((self.name, kw.get("checkpointer") is not None))
            raise _Stop()

    class _Stop(Exception):
        pass

    import gamesmanmpi_tpu_torch.utils.device as device_mod

    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(engine, "Solver", Fake("classic"))
    monkeypatch.setattr(dense_mod, "DenseSolver", Fake("dense"))
    spec = "connect4:w=3,h=3,connect=3"
    ck = str(tmp_path / "ck")
    for argv, want in (
        ([], ("dense", False)),
        (["--checkpoint-dir", ck], ("classic", True)),
        (["--engine", "dense", "--checkpoint-dir", ck], ("dense", True)),
        (["--engine", "classic", "--checkpoint-dir", ck], ("classic", True)),
    ):
        with pytest.raises(_Stop):
            cli.main(["solve", spec, *argv])
        assert chosen.pop() == want, argv
    for extra in (["--table-out", "x.npz"], ["--paranoid"]):
        assert cli.main(["solve", spec, "--engine", "dense",
                         "--checkpoint-dir", ck, *extra]) == 2
        assert "--engine dense needs" in capsys.readouterr().err
