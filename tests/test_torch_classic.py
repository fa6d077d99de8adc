"""Torch port's classic (level-BFS) engine against the JAX Solver.

For every listed game, with and without sym, the root and every level's
(states, values, remoteness), converted to the reference dtypes, equal
gamesmanmpi_tpu.solve.Solver's, through both backward routes: the
gather-only provenance resolve and the lookup join
(GAMESMAN_PROVENANCE=0). The CLI's report lines and its --table-out npz
(keys, dtypes, arrays) equal the JAX CLI's. The port runs on the CPU
here; integers throughout, so tolerance zero.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.core.bitops import to_reference
from gamesmanmpi_tpu_torch.games import Subtract, get_game
from gamesmanmpi_tpu_torch.solve import engine
from gamesmanmpi_tpu_torch.solve.engine import Solver, SolverError

SPECS = [
    "tictactoe", "tictactoe:sym=1", "nim:heaps=3-4-5",
    "subtract:total=10,moves=1-2", "subtract:total=10,moves=1-2,misere=1",
    "chomp:w=3,h=3", "chomp:w=3,h=3,sym=1",
    "connect4:w=3,h=3,connect=3", "connect4:w=3,h=3,connect=3,sym=1",
    "connect4:w=3,h=4,connect=3",
]

_JAX = {}


def jax_solve(spec):
    """The reference classic solve of `spec`, once per test process."""
    if spec not in _JAX:
        _JAX[spec] = JaxSolver(jax_get_game(spec)).solve()
    return _JAX[spec]


def assert_same_solve(got, ref):
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.levels) == sorted(ref.levels)
    for k, want in ref.levels.items():
        t = got.levels[k]
        assert t.states.dtype == np.int64, k  # the port's carrier
        t = t._replace(states=to_reference(t.states, got.game))
        assert t.states.dtype == want.states.dtype, k
        assert t.values.dtype == want.values.dtype == np.uint8, k
        assert t.remoteness.dtype == want.remoteness.dtype, k
        np.testing.assert_array_equal(t.states, want.states, err_msg=k)
        np.testing.assert_array_equal(t.values, want.values, err_msg=k)
        np.testing.assert_array_equal(t.remoteness, want.remoteness,
                                      err_msg=k)
    assert got.stats["misses"] == 0


@pytest.mark.parametrize("route", ["provenance", "join"])
@pytest.mark.parametrize("spec", SPECS)
def test_tables_match_reference(spec, route, monkeypatch):
    monkeypatch.setenv("GAMESMAN_PROVENANCE",
                       "1" if route == "provenance" else "0")
    solver = Solver(get_game(spec), device="cpu")
    got = solver.solve()
    assert_same_solve(got, jax_solve(spec))
    fast = get_game(spec).uniform_level_jump
    assert got.stats["path"] == ("fast" if fast else "generic")
    assert got.stats["use_provenance"] == (fast and route == "provenance")
    if fast and route == "provenance":
        assert got.stats["provenance_levels"] == got.stats["levels"] - 1


@pytest.mark.slow
@pytest.mark.parametrize("spec", ["connect4:w=4,h=4", "connect4:w=4,h=4,sym=1"])
def test_connect4_4x4_tables_match_reference(spec):
    assert_same_solve(Solver(get_game(spec), device="cpu").solve(),
                      jax_solve(spec))


@pytest.mark.parametrize("spec", ["tictactoe:sym=1", "nim:heaps=3-4-5"])
def test_small_blocks_and_spilled_levels_give_the_same_tables(spec,
                                                              monkeypatch):
    """A 7-row backward block and a zero device-store budget (every level
    on the host, no provenance) change the schedule, not the tables."""
    monkeypatch.setenv("GAMESMAN_BACKWARD_BLOCK", "7")
    monkeypatch.setenv("GAMESMAN_DEVICE_STORE_MB", "0")
    solver = Solver(get_game(spec), device="cpu")
    assert (solver.backward_block, solver.device_store_bytes) == (7, 0)
    got = solver.solve()
    assert got.stats["provenance_levels"] == 0
    assert_same_solve(got, jax_solve(spec))


def test_backward_block_zero_means_unbounded(monkeypatch):
    monkeypatch.setenv("GAMESMAN_BACKWARD_BLOCK", "0")
    assert Solver(get_game("tictactoe"), device="cpu").backward_block >= 1 << 62


def test_lookup_canonicalizes_queries():
    full = Solver(get_game("tictactoe"), device="cpu").solve()
    sym = Solver(get_game("tictactoe:sym=1"), device="cpu").solve()
    for t in full.levels.values():
        for i in range(0, t.states.shape[0], 7):
            s = int(t.states[i])
            want = (int(t.values[i]), int(t.remoteness[i]))
            assert full.lookup(s) == want
            assert sym.lookup(s) == want
    with pytest.raises(KeyError):
        full.lookup(0x3FFFF)  # both planes full: not reachable
    with pytest.raises(OverflowError):
        full.lookup(1 << 40)  # does not fit the game's uint32
    c4 = Solver(get_game("connect4:w=3,h=3,connect=3"), device="cpu").solve()
    # tictactoe fits uint32; 7x9 connect-4 would need uint64: a 64-bit
    # state with the top bit set is unreachable, not an error.
    big = engine.canonical_scalar
    with pytest.raises(KeyError):
        big(get_game("connect4:w=7,h=8"), (1 << 64) - 1)
    assert c4.lookup(c4.game.initial_state()) == (c4.value, c4.remoteness)


def test_store_tables_false_keeps_only_the_root():
    got = Solver(get_game("nim:heaps=3-4-5"), device="cpu",
                 store_tables=False).solve()
    assert list(got.levels) == [0]
    assert got.num_positions == 120
    got = Solver(get_game("tictactoe"), device="cpu",
                 store_tables=False).solve()
    assert list(got.levels) == [0] and got.num_positions == 5478


class _ShortWindow(Subtract):
    """A broken game: it under-declares its level jump, so the backward
    window misses the children two levels down."""

    def __init__(self):
        super().__init__(10, (1, 2))
        self.max_level_jump = 1


class _ShortLevels(Subtract):
    """A broken game: it under-declares its number of levels."""

    def __init__(self):
        super().__init__(10, (1, 2))
        self.num_levels = 5


def test_misses_are_counted_and_raise_under_paranoid():
    got = Solver(_ShortWindow(), device="cpu").solve()
    assert got.stats["misses"] > 0
    with pytest.raises(SolverError, match="consistency failures"):
        Solver(_ShortWindow(), device="cpu", paranoid=True).solve()
    with pytest.raises(SolverError, match="num_levels"):
        Solver(_ShortLevels(), device="cpu").solve()


def test_stats_keys():
    s = Solver(get_game("tictactoe"), device="cpu").solve().stats
    for key in ("secs_forward", "secs_backward", "positions_per_sec",
                "peak_mem_bytes", "misses", "levels", "positions"):
        assert key in s
    assert s["peak_mem_bytes"] is None  # a card metric; this ran on the CPU
    assert s["secs_forward"] >= 0 and s["secs_backward"] >= 0
    assert s["positions_per_sec"] > 0 and s["engine"] == "classic"


# ------------------------------------------------------------------ the CLI


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _report_lines(lines):
    keep = ("game:", "devices:", "positions:", "value:", "remoteness:",
            "query ")
    return [ln for ln in lines if ln.startswith(keep)]


CLI_CASES = [
    ("tictactoe", ["0", "0x1", "0x3FFFF", "0x1FFFFFFFF", "zz"]),
    ("tictactoe:sym=1", ["0x4", "0x10", "0x100"]),
    ("nim:heaps=3-4-5", ["0", "0x543", "0x545", "-1"]),
    ("subtract:total=10,moves=1-2,misere=1", ["10", "9", "3", "11"]),
    ("chomp:w=3,h=3,sym=1", ["0xFF", "0x1", "0x7"]),
    ("connect4:w=3,h=3,connect=3,sym=1", ["0x111", "0x112", "0x114", "0"]),
]


@pytest.mark.parametrize("spec,queries", CLI_CASES)
def test_cli_report_and_table_out_match_reference(spec, queries, tmp_path):
    qargs = [a for q in queries for a in ("--query", q)]
    ref_path, got_path = tmp_path / "ref.npz", tmp_path / "got"
    rc_j, ref = _run(jax_cli.main, ["solve", spec, "--engine", "classic",
                                    "--table-out", str(ref_path), *qargs])
    rc_t, got = _run(cli.main, ["solve", spec, "--device", "cpu",
                                "--table-out", str(got_path), *qargs])
    assert rc_j == rc_t == 0
    assert _report_lines(got) == _report_lines(ref)
    assert len(_report_lines(got)) == 5 + len(queries)
    assert got[7] == f"table written: {got_path}"
    with np.load(ref_path) as a, np.load(str(got_path) + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_cli_engine_routing(capsys):
    # auto on the CPU is classic, as in the reference; dense on request.
    rc, result = cli.solve_main(["solve", "connect4:w=3,h=3,connect=3",
                                 "--device", "cpu"])
    assert rc == 0 and result.stats["engine"] == "classic"
    rc, result = cli.solve_main(["solve", "connect4:w=3,h=3,connect=3",
                                 "--device", "cpu", "--engine", "dense"])
    assert rc == 0 and result.stats["engine"] == "dense"
    for extra in (["--table-out", "x.npz"], ["--paranoid"]):
        assert cli.main(["solve", "connect4:w=3,h=3,connect=3", "--engine",
                         "dense", "--device", "cpu", *extra]) == 2
        assert "--engine dense needs" in capsys.readouterr().err
    assert cli.main(["solve", "nim", "--engine", "dense", "--device",
                     "cpu"]) == 2
    rc, result = cli.solve_main(["solve", "nim", "--device", "cpu",
                                 "--paranoid", "--no-tables"])
    assert rc == 0 and list(result.levels) == [0]
