"""Torch port's oracle and compat path against the JAX package.

The memoized-negamax oracle gives the reference's table for every module
in examples/ref_games/; `solve module.py` prints the reference CLI's
lines (the oracle for a module without `level_of`, the classic engine
through TensorizedModule for one with it); and chomp_33.py, lifted onto
the batched protocol, solves on the port's classic engine to the
reference's solve_module_jitted tables. Integers throughout: exact.
"""

import glob
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.compat import load_game_module as ref_load
from gamesmanmpi_tpu.compat import solve_module as ref_solve_module
from gamesmanmpi_tpu.compat import solve_module_jitted
from gamesmanmpi_tpu.solve import oracle as ref_oracle
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.compat import (
    TensorizedModule,
    load_game_module,
    shim,
    solve_module,
    solve_module_tensorized,
)
from gamesmanmpi_tpu_torch.core.bitops import to_reference
from gamesmanmpi_tpu_torch.solve import oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(glob.glob(os.path.join(REPO, "examples", "ref_games",
                                        "*.py")))
CHOMP = os.path.join(REPO, "examples", "ref_games", "chomp_33.py")


def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith(("elapsed:", "throughput:"))]


@pytest.mark.parametrize("path", MODULES, ids=os.path.basename)
def test_oracle_tables_equal_reference(path):
    got = solve_module(load_game_module(path))
    want = ref_solve_module(ref_load(path))
    assert got[:2] == want[:2]
    assert got[2] == want[2]


def test_oracle_helpers_match_reference():
    for v in ("WIN", "lose", "Draw", "UNDECIDED", None, 1, 2, 3, 0):
        assert oracle.normalize_value(v) == ref_oracle.normalize_value(v)
    for bad in ("MAYBE", 7):
        with pytest.raises(ValueError):
            oracle.normalize_value(bad)
    cases = [[], [(1, 3)], [(2, 4), (2, 1), (3, 9)], [(3, 2), (1, 7)],
             [(1, 0), (1, 5)]]
    for children in cases:
        assert oracle.combine_host(children) == ref_oracle.combine_host(
            children)


@pytest.mark.parametrize("name,extra", [
    ("ten_to_zero.py", ["--query", "10", "--query", "3", "--query", "99",
                        "--query", "zz"]),
    ("nim_345.py", []),
    ("mnk_333_misere.py", []),
    ("chomp_33.py", ["--query", "63", "--query", "1", "--query", "0x2"]),
])
def test_cli_module_solve_prints_reference_lines(name, extra, tmp_path):
    path = os.path.join(REPO, "examples", "ref_games", name)
    rc_t, got = run_cli(cli.main, ["solve", path, "--device", "cpu",
                                   "--table-out", str(tmp_path / "t.npz"),
                                   *extra])
    rc_j, want = run_cli(jax_cli.main, ["solve", path, "--table-out",
                                        str(tmp_path / "j.npz"), *extra])
    assert rc_t == rc_j == 0
    assert got == [ln.replace("j.npz", "t.npz") for ln in want]
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_tensorized_chomp_matches_reference_engine():
    """chomp_33.py declares level_of: lifted onto the batched protocol it
    runs on the port's classic engine, to the reference's tables."""
    got = solve_module_tensorized(load_game_module(CHOMP), device="cpu")
    want = solve_module_jitted(ref_load(CHOMP))
    assert got.game.name == want.game.name == "compat_chomp_33"
    assert (got.value, got.remoteness, got.num_positions) == (
        want.value, want.remoteness, want.num_positions)
    assert sorted(got.levels) == sorted(want.levels)
    for k, t in want.levels.items():
        mine = got.levels[k]
        states = to_reference(mine.states, got.game)
        assert states.dtype == t.states.dtype == np.uint64
        np.testing.assert_array_equal(states, t.states)
        np.testing.assert_array_equal(mine.values, t.values)
        np.testing.assert_array_equal(mine.remoteness, t.remoteness)
    # And the oracle agrees on every position.
    _, _, table = solve_module(load_game_module(CHOMP))
    for t in got.levels.values():
        for s, v, r in zip(t.states.tolist(), t.values, t.remoteness):
            assert table[s] == (int(v), int(r))


def _branchy_module():
    """Branching explodes past the probe sample: 0->1->...->6, then six
    moves from 6; primitive at >= 7 (the reference's test module)."""
    import types

    m = types.ModuleType("branchy")
    m.initial_position = 0
    m.gen_moves = lambda pos: [1] if pos < 6 else list(range(1, 7))
    m.do_move = lambda pos, mv: pos + mv
    m.primitive = lambda pos: "LOSE" if pos >= 7 else "UNDECIDED"
    m.level_of = lambda pos: pos
    m.max_level_jump = 6
    m.num_levels = 14
    return m


def test_max_moves_probe_grows_and_retries(monkeypatch):
    """An undersized max_moves probe overflows mid-solve; the solve
    doubles it and reruns to the reference's answer."""
    module = _branchy_module()
    monkeypatch.setattr(shim, "_PROBE_LIMIT", 4)
    assert TensorizedModule(module).max_moves == 1
    r = solve_module_tensorized(module, device="cpu")
    want = solve_module_jitted(_branchy_module())
    assert (r.value, r.remoteness, r.num_positions) == (
        want.value, want.remoteness, want.num_positions) == (1, 7, 13)
    assert r.game.max_moves >= 6
    with pytest.raises(ValueError, match="GAMESMAN_MAX_MOVES_OVERFLOW"):
        solve_module_tensorized(module, device="cpu", max_retries=0)


def test_cli_module_refusals(tmp_path, capsys):
    assert cli.main(["solve", CHOMP, "--engine", "dense", "--device",
                     "cpu"]) == 2
    assert "not compat game modules" in capsys.readouterr().err
    bad = tmp_path / "bad_game.py"
    bad.write_text("initial_position = 0\n")
    assert cli.main(["solve", str(bad), "--device", "cpu"]) == 2
    assert "invalid game module" in capsys.readouterr().err
    ten = os.path.join(REPO, "examples", "ref_games", "ten_to_zero.py")
    assert cli.main(["solve", ten, "--paranoid", "--device", "cpu"]) == 0
    assert "--paranoid needs the tensorized" in capsys.readouterr().err
    with pytest.raises(ValueError, match="level function"):
        TensorizedModule(load_game_module(ten))


def test_tensorized_module_without_card_exits_2(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["solve", CHOMP]) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
