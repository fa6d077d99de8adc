"""The torch port's hybrid dense/BFS engine against the JAX package (the
counterpart of tests/test_hybrid.py).

On 3x3 connect-3 at cutovers K in {0, 3, default, 8}: the dense region's
cells equal the reference ``HybridSolver``'s byte for byte (garbage cells
included: the boundary join leaves the same UNDECIDED misses), the BFS
region's tables equal its tables, and every reachable position's lookup
equals the classic engine's. Then sym=1 (the seam canonicalizes both
ways), devices=2 (meshed dense region, sharded BFS), the streamed
boundary (GAMESMAN_HYBRID_RESIDENT_MB=0), validation, the garbage-cell
refusal and the CLI, each against the reference. Integers throughout: no
tolerance.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.solve.hybrid import HybridSolver as JaxHybridSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.solve.hybrid import HybridSolver, default_cutover

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch pool as wide as the machine in each of them oversubscribes the
# cores (a 2 s meshed dense solve took 80-105 s under six workers).
torch.set_num_threads(1)

C3 = "connect4:w=3,h=3,connect=3"
CUTOVERS = (0, 3, default_cutover(9), 8)

_SOLVES = {}


def classic(spec):
    if spec not in _SOLVES:
        _SOLVES[spec] = Solver(get_game(spec), device="cpu").solve()
    return _SOLVES[spec]


def reference(spec, K, **kw):
    key = (spec, K, tuple(sorted(kw.items())))
    if key not in _SOLVES:
        _SOLVES[key] = JaxHybridSolver(jax_get_game(spec), cutover=K,
                                       **kw).solve()
    return _SOLVES[key]


def assert_answers_reachable(hy, plain, ref_root):
    """Root as `ref_root`, and every position of the full (sym=0) classic
    tables answered as there."""
    assert (hy.value, hy.remoteness) == (ref_root.value,
                                         ref_root.remoteness)
    for level, table in plain.levels.items():
        for i in range(table.states.shape[0]):
            s = int(table.states[i])
            assert hy.lookup(s) == (int(table.values[i]),
                                    int(table.remoteness[i])), (level,
                                                                hex(s))


def assert_same_as_reference(hy, ref):
    assert (hy.value, hy.remoteness, hy.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(hy.cells) == sorted(ref.cells)
    for L, cells in ref.cells.items():
        np.testing.assert_array_equal(hy.cells[L], np.asarray(cells),
                                      err_msg=L)
    assert sorted(hy.levels) == sorted(ref.levels)
    for L, t in ref.levels.items():
        u = hy.levels[L]
        np.testing.assert_array_equal(u.states.astype(np.uint64),
                                      np.asarray(t.states, np.uint64))
        np.testing.assert_array_equal(u.values, np.asarray(t.values))
        np.testing.assert_array_equal(u.remoteness,
                                      np.asarray(t.remoteness))
    for key in ("positions_dense_region", "positions_bfs_region",
                "frontier_at_boundary", "reachable_at_boundary",
                "cutover"):
        assert hy.stats[key] == ref.stats[key], key


@pytest.mark.parametrize("K", CUTOVERS)
def test_hybrid_full_parity_3x3c3(K):
    hy = HybridSolver(get_game(C3), cutover=K, device="cpu").solve()
    assert_same_as_reference(hy, reference(C3, K))
    assert hy.num_positions == classic(C3).num_positions
    assert_answers_reachable(hy, classic(C3), classic(C3))
    assert hy.stats["engine"] == "hybrid" and hy.stats["cutover"] == K


@pytest.mark.parametrize("K", CUTOVERS)
def test_hybrid_sym_parity_3x3c3(K):
    """sym=1: the BFS region holds mirror representatives, the dense region
    the full space; both members of every mirror class answer."""
    spec = C3 + ",sym=1"
    hy = HybridSolver(get_game(spec), cutover=K, device="cpu").solve()
    assert_same_as_reference(hy, reference(spec, K))
    plain = classic(C3)
    assert hy.stats["positions_dense_region"] == sum(
        plain.levels[L].states.shape[0] for L in plain.levels if L <= K)
    assert_answers_reachable(hy, plain, classic(spec))


@pytest.mark.parametrize("spec", [C3, C3 + ",sym=1"])
def test_hybrid_devices_2_parity(spec):
    """devices=2: the dense region's steps split their lanes over two
    shards, the BFS region runs the sharded engine; the result is the
    one-device hybrid's and the reference's."""
    hy = HybridSolver(get_game(spec), cutover=4, device="cpu",
                      devices=2).solve()
    assert hy.stats["devices"] == 2
    one = HybridSolver(get_game(spec), cutover=4, device="cpu").solve()
    for L, cells in one.cells.items():
        np.testing.assert_array_equal(hy.cells[L], cells)
    assert hy.stats["gather_nmiss"] == one.stats["gather_nmiss"]
    assert_same_as_reference(hy, reference(spec, 4))
    assert_answers_reachable(hy, classic(C3), classic(spec))


def test_hybrid_streamed_boundary_parity(monkeypatch):
    """GAMESMAN_HYBRID_RESIDENT_MB=0 streams the level-B table through the
    join in GAMESMAN_HYBRID_WBLOCK-state blocks, with the resident join's
    cells."""
    spec = "connect4:w=4,h=3"
    resident = HybridSolver(get_game(spec), cutover=6, device="cpu").solve()
    monkeypatch.setenv("GAMESMAN_HYBRID_RESIDENT_MB", "0")
    monkeypatch.setenv("GAMESMAN_HYBRID_WBLOCK", "256")
    solver = HybridSolver(get_game(spec), cutover=6, device="cpu")
    hy = solver.solve()
    assert solver.boundary_stream_blocks > 1
    assert hy.stats["boundary_stream_blocks"] == solver.boundary_stream_blocks
    for L, cells in resident.cells.items():
        np.testing.assert_array_equal(hy.cells[L], cells)
    ref = reference(spec, 6)
    for L, cells in ref.cells.items():
        np.testing.assert_array_equal(hy.cells[L], np.asarray(cells))
    assert (hy.value, hy.remoteness, hy.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)


def test_hybrid_validates_args(monkeypatch):
    g = get_game(C3)
    for K in (9, -1):
        with pytest.raises(ValueError, match="cutover"):
            HybridSolver(g, cutover=K, device="cpu")
    with pytest.raises(TypeError):
        HybridSolver(get_game("tictactoe"), device="cpu")
    with pytest.raises(ValueError, match="devices"):
        HybridSolver(g, cutover=4, device="cpu", devices=0)
    monkeypatch.setenv("GAMESMAN_HYBRID_CUTOVER", "4")
    assert HybridSolver(g, device="cpu").cutover == 4
    monkeypatch.setenv("GAMESMAN_HYBRID_CUTOVER", "24k")
    with pytest.raises(ValueError, match="not an integer"):
        HybridSolver(g, device="cpu")
    monkeypatch.delenv("GAMESMAN_HYBRID_CUTOVER")
    assert HybridSolver(g, device="cpu").cutover == default_cutover(9)
    for knob in ("GAMESMAN_HYBRID_RESIDENT_MB", "GAMESMAN_HYBRID_WBLOCK"):
        monkeypatch.setenv(knob, "2g")
        with pytest.raises(ValueError, match="not an integer"):
            HybridSolver(g, cutover=4, device="cpu")
        monkeypatch.delenv(knob)


def test_hybrid_no_tables_and_garbage_lookup_refused():
    g = get_game(C3)
    hy = HybridSolver(g, store_tables=False, cutover=5, device="cpu").solve()
    ref = classic(C3)
    assert (hy.value, hy.remoteness, hy.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    with pytest.raises(KeyError):
        hy.lookup(int(g.initial_state()))
    # Level 6, heights (3, 2, 1): the player to move owns all of column 0,
    # a line of their own: a placeholder cell, never a position. The
    # reference refuses it the same way.
    hy = HybridSolver(g, cutover=6, device="cpu").solve()
    h1 = 4
    garbage = (1 << 3) | (1 << (h1 + 2)) | (1 << (2 * h1 + 1)) | 0b111
    with pytest.raises(KeyError, match="line"):
        hy.lookup(garbage)
    with pytest.raises(KeyError, match="line"):
        reference(C3, 6).lookup(garbage)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith(("elapsed", "throughput"))]


@pytest.mark.parametrize("spec,extra", [
    (C3, []), (C3 + ",sym=1", []), (C3, ["--devices", "2"])])
def test_cli_engine_hybrid_matches_jax_cli(spec, extra):
    """The same block as the JAX CLI's (453 positions at sym=1: the full
    dense levels 0..5 plus representatives 6..9)."""
    argv = [spec, "--engine", "hybrid", "--hybrid-cutover", "5", *extra]
    rc, got = _run(cli.main, ["solve", *argv, "--device", "cpu"])
    rc_j, want = _run(jax_cli.main, argv)
    assert rc == rc_j == 0
    assert got == want
    assert any(ln == ("positions: 453" if "sym" in spec
                      else "positions: 694") for ln in got)


@pytest.mark.parametrize("argv,needle", [
    (["tictactoe", "--engine", "hybrid"], "Connect-4-family"),
    ([C3, "--engine", "hybrid", "--hybrid-cutover", "99"], "cutover"),
    ([C3, "--engine", "hybrid", "--checkpoint-dir", "CK"], "--checkpoint"),
    ([C3, "--engine", "hybrid", "--paranoid"], "--paranoid"),
    ([C3, "--engine", "hybrid", "--table-out", "T.npz"], "--table-out"),
    (["examples/ref_games/chomp_33.py", "--engine", "hybrid"],
     "compat game modules"),
    (["examples/ref_games/chomp_33.py", "--engine", "dense"],
     "compat game modules"),
    ([C3, "--engine", "hybrid", "--coordinator", "127.0.0.1:1",
      "--num-processes", "2", "--process-id", "0"], "single-controller"),
    ([C3, "--engine", "dense", "--devices", "2", "--coordinator",
      "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"],
     "single-controller"),
])
def test_cli_hybrid_refusals_exit_2(argv, needle, tmp_path, capsys):
    argv = [str(tmp_path / a) if a in ("CK", "T.npz") else a for a in argv]
    assert cli.main(["solve", *argv, "--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert needle in captured.err
    assert "positions:" not in captured.out
    assert not list(tmp_path.iterdir())


def test_cli_hybrid_env_cutover_typo_exits_2(monkeypatch, capsys):
    monkeypatch.setenv("GAMESMAN_HYBRID_CUTOVER", "24k")
    assert cli.main(["solve", C3, "--engine", "hybrid", "--device",
                     "cpu"]) == 2
    assert "not an integer" in capsys.readouterr().err
