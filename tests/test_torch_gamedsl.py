"""Torch port's game compiler (gamedsl/) against the JAX package's.

The same specs — every committed file under examples/specs/, the
symmetry variants of the reference's byte-parity cases, and 63-bit drop
boards — go through both packages' compile_spec. On seeded random-walk
positions the compiled games agree state for state (children, move
masks, primitives, levels, canonical forms); solved tables equal the
JAX package's (sha256 after the port's int64 carrier is converted to
the reference's dtype) and the hand-written games'; spec hashes and
validation findings are the reference's; GameSpec databases are the
reference's file for file and each package reads the other's; and the
CLI takes GAME or --spec as the reference does. Integers throughout, so
no tolerance.
"""

import hashlib
import io
import json
import pathlib
from contextlib import redirect_stderr, redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.db import DbReader as RefReader
from gamesmanmpi_tpu.gamedsl import GameSpec as RefSpec
from gamesmanmpi_tpu.gamedsl import SpecError as RefSpecError
from gamesmanmpi_tpu.gamedsl import load_spec as ref_load_spec
from gamesmanmpi_tpu.gamedsl import spec_problems as ref_spec_problems
from gamesmanmpi_tpu.gamedsl.compiler import compile_spec as ref_compile
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.compat import load_game_module
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL, to_reference
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.db import DbReader
from gamesmanmpi_tpu_torch.gamedsl import (
    GameSpec,
    SpecError,
    lint_file,
    load_spec,
    spec_problems,
)
from gamesmanmpi_tpu_torch.gamedsl.compiler import compile_spec
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.solve.oracle import oracle_solve

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SPECS = REPO / "examples" / "specs"
SPEC_FILES = sorted(p.name for p in SPECS.glob("*.json"))


def _doc(name, w, h, family, k, symmetry=None, **win):
    doc = {"gamedsl": 1, "name": name, "board": {"width": w, "height": h},
           "moves": {"family": family},
           "win": {"kind": "k_in_line", "k": k, **win}}
    if symmetry:
        doc["symmetry"] = symmetry
    return doc


#: the reference's PARITY_CASES sym variants (tests/test_gamedsl.py)
TTT_SYM = _doc("tictactoe_3x3x3_sym", 3, 3, "place", 3,
               ["mirror_h", "transpose"])
C4_43_SYM = _doc("connect4_4x3_sym", 4, 3, "drop", 4, ["mirror_h"])
#: boards whose packed state uses all 63 bits of the carrier
DROP_7X8 = _doc("drop_7x8", 7, 8, "drop", 4)
DROP_9X6_SYM = _doc("drop_9x6_sym", 9, 6, "drop", 5, ["mirror_h"])

ELEMENTWISE = ([("file", f) for f in SPEC_FILES]
               + [("doc", d) for d in (TTT_SYM, C4_43_SYM, DROP_7X8,
                                       DROP_9X6_SYM)])


def _ids(cases):
    return [c[1] if c[0] == "file" else c[1]["name"] for c in cases]


def _pair(case):
    """(reference compiled game, port compiled game) of one case."""
    kind, src = case
    if kind == "file":
        return (ref_compile(ref_load_spec(str(SPECS / src))),
                compile_spec(load_spec(str(SPECS / src))))
    return (ref_compile(RefSpec.from_dict(src)),
            compile_spec(GameSpec.from_dict(src)))


def walk_states(game, seed=0, walks=40):
    """Distinct positions of seeded random games from the initial state,
    played with the port's expand: [n] int64."""
    rng = np.random.default_rng(seed)
    seen = {int(game.initial_state())}
    for _ in range(walks):
        s = torch.tensor([game.initial_state()], dtype=torch.int64)
        while int(game.primitive(s)[0]) == UNDECIDED:
            kids, mask = game.expand(s)
            legal = np.flatnonzero(mask[0].numpy())
            if legal.size == 0:
                break
            s = kids[0, rng.choice(legal)].reshape(1)
            seen.add(int(s[0]))
    return np.array(sorted(seen), dtype=np.int64)


@pytest.mark.parametrize("case", ELEMENTWISE, ids=_ids(ELEMENTWISE))
def test_compiled_games_agree_elementwise(case):
    """expand (children and masks), primitive, level_of and canonicalize
    equal the reference's on every walked position. A sentinel lane
    rides in the batch to show a padding lane disturbs no neighbour;
    its own outputs are not compared (the carriers' sentinels are
    different words, and the engine masks sentinel lanes)."""
    ref, port = _pair(case)
    assert ref.state_dtype == port.state_dtype
    assert ref.spec_hash == port.spec_hash
    assert (ref.name, ref.num_levels, ref.max_moves, ref.state_bits,
            ref.sym) == (port.name, port.num_levels, port.max_moves,
                         port.state_bits, port.sym)
    assert ref.cache_key == port.cache_key
    states = walk_states(port)
    n = states.shape[0]
    assert n > 50
    dt = ref.state_dtype
    ref_in = jnp.asarray(np.append(states.astype(dt),
                                   np.array([np.iinfo(dt).max], dtype=dt)))
    t = torch.from_numpy(np.append(states, SENTINEL))
    rch, rmask = ref.expand(ref_in)
    pch, pmask = port.expand(t)
    # A masked child may carry out of the packed width (a full column's
    # guard): compare the bit patterns the reference's dtype keeps.
    np.testing.assert_array_equal(np.asarray(rch)[:n],
                                  pch.numpy()[:n].astype(dt))
    np.testing.assert_array_equal(np.asarray(rmask)[:n], pmask.numpy()[:n])
    np.testing.assert_array_equal(np.asarray(ref.primitive(ref_in))[:n],
                                  port.primitive(t).numpy()[:n])
    np.testing.assert_array_equal(
        np.asarray(ref.level_of(ref_in))[:n].astype(np.int64),
        port.level_of(t).numpy()[:n].astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(ref.canonicalize(ref_in))[:n],
        to_reference(port.canonicalize(t)[:n], port))
    assert port.describe(int(states[-1])) == ref.describe(int(states[-1]))


def test_sentinel_is_not_a_reachable_state():
    """The all-ones 63-bit word is the port's sentinel: a 63-bit drop
    board's word would be every column full of the mover's stones,
    which no walk reaches (and place boards use at most 62 bits)."""
    for doc in (DROP_7X8, DROP_9X6_SYM):
        game = compile_spec(GameSpec.from_dict(doc))
        assert game.state_bits == 63
        assert int(walk_states(game, seed=1).max()) < SENTINEL
    assert all(load_spec(str(SPECS / f)).state_bits <= 62
               for f in SPEC_FILES)


def test_drop_strides_are_derived_not_hardcoded():
    """The reference's check: the full compass on a 5x4 board gives
    connect4's {1, h, h+1, h+2}; directions e and n alone give (1, 5)."""
    full = compile_spec(_doc("d", 5, 4, "drop", 4))
    assert full._dirs == (1, 4, 5, 6)
    ortho = compile_spec(_doc("d", 5, 4, "drop", 4, directions=["e", "n"]))
    assert ortho._dirs == (1, 5)


@pytest.mark.parametrize("name", SPEC_FILES)
def test_spec_hash_and_findings_match_the_reference(name):
    path = str(SPECS / name)
    assert load_spec(path).spec_hash == ref_load_spec(path).spec_hash
    assert load_spec(path).to_doc() == ref_load_spec(path).to_doc()
    assert lint_file(path) == []


BAD_SPECS = [
    _doc("big", 7, 9, "drop", 4),                       # GS101
    _doc("far", 3, 3, "place", 5),                      # GS103
    _doc("exact_drop", 4, 4, "drop", 3, exact=True),    # GS108
    _doc("sym", 4, 3, "place", 3, ["transpose"]),       # GS105
    _doc("closure", 3, 3, "place", 3, ["mirror_h"],
         directions=["e", "ne"]),                       # GS106
    _doc("drop_sym", 4, 4, "drop", 4, ["rot90"]),       # GS105
]


@pytest.mark.parametrize("doc", BAD_SPECS, ids=[d["name"] for d in BAD_SPECS])
def test_error_specs_refused_with_the_whole_list(doc):
    """Findings equal the reference's; compile_spec refuses with every
    error in one message, word for word the reference's."""
    assert spec_problems(GameSpec.from_dict(doc)) == ref_spec_problems(
        RefSpec.from_dict(doc))
    with pytest.raises(SpecError) as got:
        compile_spec(doc)
    with pytest.raises(RefSpecError) as want:
        ref_compile(RefSpec.from_dict(doc))
    assert str(got.value) == str(want.value)
    assert "not compilable" in str(got.value)


def test_malformed_documents_raise_the_references_errors():
    for doc in ({"gamedsl": 2}, {"gamedsl": 1, "name": "x"},
                dict(_doc("x", 3, 3, "place", 3), extra=1),
                _doc("x", 3, 3, "hop", 3)):
        with pytest.raises(SpecError) as got:
            GameSpec.from_dict(doc)
        with pytest.raises(RefSpecError) as want:
            RefSpec.from_dict(doc)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------- solved tables

_JAX = {}


def table_sha256(result, to_ref=False):
    h = hashlib.sha256()
    for level in sorted(result.levels):
        t = result.levels[level]
        states = (to_reference(t.states, result.game) if to_ref
                  else np.asarray(t.states))
        h.update(states.tobytes())
        h.update(np.asarray(t.values).tobytes())
        h.update(np.asarray(t.remoteness).tobytes())
    return h.hexdigest()


SOLVE_CASES = [("file", "tictactoe_3x3.json"), ("doc", C4_43_SYM),
               ("file", "gomoku_4x3x3.json"),
               ("file", "mnk_3x3x3_misere.json")]


@pytest.mark.parametrize("case", SOLVE_CASES, ids=_ids(SOLVE_CASES))
def test_solved_tables_equal_the_references(case):
    ref_game, game = _pair(case)
    key = _ids([case])[0]
    if key not in _JAX:
        _JAX[key] = JaxSolver(ref_game).solve()
    want = _JAX[key]
    got = Solver(game, device="cpu").solve()
    assert (got.value, got.remoteness, got.num_positions) == (
        want.value, want.remoteness, want.num_positions)
    assert table_sha256(got, to_ref=True) == table_sha256(want)


@pytest.mark.parametrize("hand,spec", [
    ("connect4:w=4,h=4", "connect4_4x4.json"),
    ("tictactoe:sym=1", TTT_SYM),
])
def test_compiled_tables_equal_the_hand_written_games(hand, spec):
    game = (get_game(str(SPECS / spec)) if isinstance(spec, str)
            else compile_spec(spec))
    got = Solver(game, device="cpu").solve()
    want = Solver(get_game(hand), device="cpu").solve()
    assert table_sha256(got) == table_sha256(want)
    assert (got.value, got.remoteness) == (want.value, want.remoteness)


@pytest.mark.parametrize("spec,module", [
    ("gomoku_4x3x3.json", "gomoku_4x3x3.py"),
    ("mnk_3x3x3_misere.json", "mnk_333_misere.py"),
])
def test_description_only_games_match_their_scalar_twins(spec, module):
    """The games that exist only as descriptions answer as the port's
    host oracle over the reference-style scalar modules."""
    got = Solver(get_game(str(SPECS / spec)), device="cpu").solve()
    value, remoteness, table = oracle_solve(
        load_game_module(str(REPO / "examples" / "ref_games" / module)))
    assert (got.value, got.remoteness) == (value, remoteness)
    for level in got.levels.values():
        for s, v, r in zip(level.states[:500], level.values[:500],
                           level.remoteness[:500]):
            assert table[int(s)] == (int(v), int(r))


# ------------------------------------------------------------- databases


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def digests(d):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pathlib.Path(d).iterdir())}


@pytest.mark.parametrize("compress", [False, True], ids=["v1", "v2"])
def test_export_db_spec_is_the_references_file_for_file(compress,
                                                        tmp_path):
    """`export-db --spec` in both packages gives the same files; each
    package's reader rebuilds the game from the other's embedded spec
    and answers every walked position alike."""
    spec = str(SPECS / "mnk_3x3x3_misere.json")
    extra = ["--compress"] if compress else []
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    rc, out, _ = _run(cli.main, ["export-db", "--spec", spec, "--out",
                                 str(port_dir), "--device", "cpu", *extra])
    assert rc == 0 and "positions:" in out
    rc, _, _ = _run(jax_cli.main, ["export-db", "--spec", spec, "--out",
                                   str(ref_dir), *extra])
    assert rc == 0
    assert digests(port_dir) == digests(ref_dir)
    manifest = json.loads((port_dir / "manifest.json").read_text())
    assert manifest["spec_sha256"] == load_spec(spec).spec_hash
    states = to_reference(walk_states(get_game(spec)), get_game(spec))
    with DbReader(ref_dir, device="cpu") as mine, RefReader(port_dir) as ref:
        assert mine.game.spec_hash == ref.game.spec_hash
        got = mine.lookup(states)
        want = ref.lookup(states)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gamespec_db_reads_from_its_embedded_spec(tmp_path):
    """The reader rebuilds the game from the manifest's game_spec, not
    from the (now missing) file, and `query` answers from it."""
    spec = tmp_path / "ttt.json"
    spec.write_text((SPECS / "tictactoe_3x3.json").read_text())
    d = tmp_path / "db"
    assert _run(cli.main, ["export-db", str(spec), "--out", str(d),
                           "--device", "cpu"])[0] == 0
    spec.unlink()
    with DbReader(d, device="cpu") as r:
        assert r.game.name == "tictactoe_3x3x3"
    rc, out, _ = _run(cli.main, ["query", str(d), "0", "--device", "cpu"])
    assert rc == 0
    assert "query 0: value=TIE remoteness=9" in out


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("argv,needle", [
    (["solve", "tictactoe", "--spec", "x.json"], "not both"),
    (["solve"], "a game is required"),
    (["export-db", "tictactoe", "--spec", "x.json", "--out", "o"],
     "not both"),
    (["export-db", "--out", "o"], "a game is required"),
    (["solve", "--spec", "no/such/spec.json", "--device", "cpu"],
     "cannot read game spec file"),
])
def test_game_and_spec_are_exclusive(argv, needle):
    rc, out, err = _run(cli.main, argv)
    assert rc == 2 and needle in err and "positions:" not in out


@pytest.mark.parametrize("engine", ["dense", "hybrid"])
def test_dense_and_hybrid_refuse_compiled_games(engine):
    """A compiled drop game is not of the Connect-4 class: refused with
    the reference's exit code and message."""
    spec = str(SPECS / "connect4_4x4.json")
    rc, out, err = _run(cli.main, ["solve", "--spec", spec, "--engine",
                                   engine, "--device", "cpu"])
    ref_rc, _, ref_err = _run(jax_cli.main, ["--spec", spec, "--engine",
                                             engine])
    assert rc == ref_rc == 2
    assert err == ref_err
    assert "positions:" not in out


def test_cli_solves_a_spec_as_the_reference_cli(tmp_path):
    """`solve --spec` reports the reference's lines and writes the
    reference's --table-out arrays."""
    spec = str(SPECS / "mnk_3x3x3_misere.json")
    mine, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    rc, out, _ = _run(cli.main, ["solve", "--spec", spec, "--device", "cpu",
                                 "--table-out", str(mine)])
    ref_rc, ref_out, _ = _run(jax_cli.main, ["--spec", spec, "--table-out",
                                             str(ref)])
    assert rc == ref_rc == 0
    keep = ("game:", "positions:", "value:", "remoteness:")
    assert ([ln for ln in out.splitlines() if ln.startswith(keep)]
            == [ln for ln in ref_out.splitlines() if ln.startswith(keep)])
    with np.load(mine) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key])
