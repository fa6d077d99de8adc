"""Torch port's solved-position DB (db/) against the JAX package.

For every board below, the port's streamed export (its classic Solver
feeding a DbWriter through level_sink) and the JAX package's export of
its own solve are the same files, byte for byte, in format v1 and v2,
opening book and manifest included; each package's reader answers the
other's DB identically on every raw reachable position (every symmetry
member) and on seeded random states; a checkpoint directory either
package sealed converts in the other; the checkers (check_db, db_equal,
db_stats) give the same verdicts, corruption included; and the CLI's
export-db/query lines are the reference's. Inputs are made by numpy from
seeds; everything is integers, so tolerance zero.
"""

import hashlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.db import DbReader as RefReader
from gamesmanmpi_tpu.db import export_checkpoint as ref_export_checkpoint
from gamesmanmpi_tpu.db import export_result as ref_export_result
from gamesmanmpi_tpu.db import book as ref_book
from gamesmanmpi_tpu.db import check as ref_check
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu.utils.checkpoint import LevelCheckpointer as JaxCkpt
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.values import MAX_REMOTENESS, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.db import (
    DbFormatError,
    DbReader,
    DbWriter,
    check_db,
    export_checkpoint,
    export_result,
)
from gamesmanmpi_tpu_torch.db import book, check
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
from gamesmanmpi_tpu_torch.solve.engine import LevelTable, Solver
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer
from gamesmanmpi_tpu_torch.utils.device import DeviceUnavailable

REPO = pathlib.Path(__file__).resolve().parent.parent

#: ttt ±sym (fast path), nim and subtract (generic path), chomp sym=1,
#: Connect-4 3x4 connect-3 (fast path), and a uint64 board.
SPECS = ["tictactoe", "tictactoe:sym=1", "nim:heaps=3-4-5",
         "subtract:total=10,moves=1-2", "chomp:w=3,h=3,sym=1",
         "connect4:w=3,h=4,connect=3", "nim:heaps=8-1-1-1-1-1-1-1"]
BOOK_PLIES = 3

_JAX = {}
_DBS = {}


def jax_result(spec):
    """The JAX package's solve of `spec`, once per process."""
    if spec not in _JAX:
        _JAX[spec] = JaxSolver(jax_get_game(spec)).solve()
    return _JAX[spec]


def ref_db(spec, compress, factory):
    """The JAX package's DB of `spec` (its export_result, then its book)."""
    key = ("ref", spec, compress)
    if key not in _DBS:
        d = factory.mktemp("ref_db") / "db"
        ref_export_result(jax_result(spec), d, spec, compress=compress)
        ref_book.build_book(d, BOOK_PLIES)
        _DBS[key] = d
    return _DBS[key]


def port_export(spec, d, compress=False):
    """The port's streamed export: Solver(store_tables=False) feeding a
    DbWriter through level_sink, as `export-db` does. -> manifest."""
    game = get_game(spec)
    writer = DbWriter(d, game, spec, compress=compress)
    Solver(game, device="cpu", store_tables=False,
           level_sink=writer.add_level_table).solve()
    return writer.finalize()


def port_db(spec, compress, factory):
    key = ("port", spec, compress)
    if key not in _DBS:
        d = factory.mktemp("port_db") / "db"
        port_export(spec, d, compress)
        book.build_book(d, BOOK_PLIES, device="cpu")
        _DBS[key] = d
    return _DBS[key]


def digests(d):
    """{file name: sha256} of every file of a DB directory."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pathlib.Path(d).iterdir())}


def raw_reachable(spec):
    """Every raw reachable position (no canonicalization: every member of
    every reachable symmetry class), in the reference dtype, sorted."""
    game = get_game(spec)
    frontier = torch.tensor([game.initial_state()], dtype=torch.int64)
    seen = frontier
    while frontier.numel():
        kids, mask = game.expand(frontier)
        mask &= (game.primitive(frontier) == UNDECIDED).unsqueeze(-1)
        frontier = torch.unique(kids[mask])
        frontier = frontier[~torch.isin(frontier, seen)]
        seen = torch.cat([seen, frontier])
    return np.sort(seen.numpy()).astype(game.state_dtype)


def queries(spec, seed=0):
    """Raw reachable positions plus seeded random states of the game's
    state space (most of them unreachable); on a uint64 board also
    states above 2^63 and the all-ones word."""
    game = get_game(spec)
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << game.state_bits, size=2000,
                        dtype=np.uint64).astype(game.state_dtype)
    extra = []
    if game.state_dtype == np.uint64:
        extra = np.array([1 << 63, (1 << 64) - 2, (1 << 64) - 1,
                          SENTINEL], dtype=np.uint64)
    return np.concatenate([raw_reachable(spec), rand,
                           np.asarray(extra, dtype=game.state_dtype)])


def run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith("elapsed:")]


# ------------------------------------------------------ byte identity


@pytest.mark.parametrize("compress", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("spec", SPECS)
def test_export_is_byte_identical(spec, compress, tmp_path_factory):
    """Every file of the port's DB, manifest.json and book.gmb included,
    has the reference's sha256."""
    got = digests(port_db(spec, compress, tmp_path_factory))
    want = digests(ref_db(spec, compress, tmp_path_factory))
    assert "manifest.json" in got and "book.gmb" in got
    assert any(n.endswith(".gmb" if compress else ".npy") for n in got)
    assert got == want


def test_v2_export_of_many_blocks_is_byte_identical(tmp_path, monkeypatch):
    """Small blocks (GAMESMAN_DB_BLOCK=64): every level of many blocks
    encodes on the thread pool, to the reference's bytes."""
    spec = "connect4:w=3,h=4,connect=3"
    monkeypatch.setenv("GAMESMAN_DB_BLOCK", "64")
    port_export(spec, tmp_path / "t", compress=True)
    ref_export_result(jax_result(spec), tmp_path / "j", spec, compress=True)
    m = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert max(len(r["keys_blocks"]["lengths"])
               for r in m["levels"].values()) >= 8
    assert digests(tmp_path / "t") == digests(tmp_path / "j")


# ------------------------------------------------------- readers


@pytest.mark.parametrize("spec", SPECS)
def test_readers_answer_each_others_dbs(spec, tmp_path_factory):
    """The port's reader on the reference's DB and the reference's reader
    on the port's give the same lookup and lookup_best, dtypes included,
    on every raw reachable position and on random states; the answers
    are the JAX solve's."""
    q = queries(spec)
    n_raw = raw_reachable(spec).shape[0]
    ref = jax_result(spec)
    for compress in (False, True):
        with DbReader(ref_db(spec, compress, tmp_path_factory),
                      device="cpu") as mine, \
                RefReader(port_db(spec, compress, tmp_path_factory)) as theirs:
            got = mine.lookup_best(q)
            want = theirs.lookup_best(q)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for a, b in zip(mine.lookup(q), want[:3]):
                np.testing.assert_array_equal(a, b)
            assert got[2][:n_raw].all()  # every raw reachable state found
            assert mine.book is not None and len(mine.book) > 1
    # Each stored (canonical) state answers as the JAX solve's table.
    with DbReader(port_db(spec, False, tmp_path_factory),
                  device="cpu") as mine:
        for t in ref.levels.values():
            v, r, f = mine.lookup(t.states)
            assert f.all()
            np.testing.assert_array_equal(v, t.values)
            np.testing.assert_array_equal(r, t.remoteness)


def test_best_move_is_a_raw_child_realizing_the_value(tmp_path_factory):
    """sym=1: each best move is a legal child of the queried raw position
    (not of its class representative) whose value is the combine's
    pick; primitives and misses get the reference's sentinel."""
    spec = "tictactoe:sym=1"
    game = get_game(spec)
    q = raw_reachable(spec)
    with DbReader(port_db(spec, False, tmp_path_factory),
                  device="cpu") as r:
        values, rem, found, best = r.lookup_best(q)
        kids, mask = game.expand(torch.from_numpy(q.astype(np.int64)))
        prim = game.primitive(torch.from_numpy(q.astype(np.int64))).numpy()
        has = best != game.sentinel
        assert found.all() and not has[prim != UNDECIDED].any()
        assert has[prim == UNDECIDED].all()
        kids = np.where(mask.numpy(), kids.numpy(), -1)
        assert (kids[has] == best[has, None].astype(np.int64)).any(1).all()
        bv, br, bf = r.lookup(best[has])
        want = {1: 2, 2: 1, 3: 3}  # WIN -> a LOSE child, LOSE -> WIN, TIE
        assert bf.all()
        assert (bv == np.vectorize(want.get)(values[has])).all()
        assert (br == rem[has] - 1).all()
    _, _, f, b = DbReader(port_db(spec, False, tmp_path_factory),
                          device="cpu").lookup_best(
        np.array([0x3FFFF], dtype=game.state_dtype))
    assert not f[0] and b[0] == game.sentinel and b.dtype == np.uint32


def test_book_matches_reader_and_verifies_both_ways(tmp_path_factory):
    spec = "connect4:w=3,h=4,connect=3"
    for compress in (False, True):
        mine = port_db(spec, compress, tmp_path_factory)
        theirs = ref_db(spec, compress, tmp_path_factory)
        assert book.verify_book(theirs, device="cpu") == []
        assert ref_book.verify_book(mine) == []
        ob = book.OpeningBook.load(mine)
        with DbReader(mine, device="cpu") as r:
            for a, b in zip(ob.lookup(ob.positions), r.lookup_best(
                    ob.positions)):
                np.testing.assert_array_equal(a, b)
            miss = ob.lookup(np.array([1, 2], dtype=ob.positions.dtype))
            assert not miss[2].any() and (miss[3] == r.game.sentinel).all()


# ------------------------------------------------------ checkpoints


@pytest.mark.parametrize("spec", ["tictactoe", "nim:heaps=8-1-1-1-1-1-1-1"])
def test_export_checkpoint_across_packages(spec, tmp_path):
    """A directory the JAX package sealed converts in the port, and one
    the port sealed converts in the JAX package, to the same files as a
    streamed export and as export_result, v1 and v2."""
    jd, td = tmp_path / "jax_ck", tmp_path / "torch_ck"
    JaxSolver(jax_get_game(spec), checkpointer=JaxCkpt(str(jd))).solve()
    Solver(get_game(spec), device="cpu",
           checkpointer=LevelCheckpointer(td)).solve()
    for compress in (False, True):
        tag = "v2" if compress else "v1"
        fresh = tmp_path / f"fresh_{tag}"
        port_export(spec, fresh, compress)
        mine = tmp_path / f"port_from_jax_{tag}"
        export_checkpoint(LevelCheckpointer(jd), get_game(spec), spec, mine,
                          compress=compress)
        theirs = tmp_path / f"jax_from_port_{tag}"
        ref_export_checkpoint(JaxCkpt(str(td)), jax_get_game(spec), spec,
                              theirs, compress=compress)
        whole = tmp_path / f"result_{tag}"  # an in-memory SolveResult
        export_result(Solver(get_game(spec), device="cpu").solve(), whole,
                      spec, compress=compress)
        assert digests(mine) == digests(theirs) == digests(fresh) \
            == digests(whole)


def test_dense_directory_refused_as_the_reference_refuses(tmp_path,
                                                          capsys):
    """A dense checkpoint directory (the reference's format, sealed by the
    port's dense engine) is refused by both packages with one message,
    and by the CLI with exit 2."""
    spec = "connect4:w=3,h=4,connect=3"
    d = tmp_path / "dense_ck"
    DenseSolver(get_game(spec), device="cpu",
                checkpointer=LevelCheckpointer(d)).solve()
    with pytest.raises(Exception) as want:
        ref_export_checkpoint(JaxCkpt(str(d)), jax_get_game(spec), spec,
                              tmp_path / "ref_out")
    with pytest.raises(DbFormatError) as got:
        export_checkpoint(LevelCheckpointer(d), get_game(spec), spec,
                          tmp_path / "out")
    assert str(got.value) == str(want.value)
    assert "encodable-superset" in str(got.value)
    assert cli.main(["export-db", spec, "--from-checkpoint", str(d),
                     "--out", str(tmp_path / "cli_out"), "--device",
                     "cpu"]) == 2
    assert "encodable-superset" in capsys.readouterr().err
    assert not (tmp_path / "out" / "manifest.json").exists()


# ------------------------------------------------------- checkers


def test_checkers_agree_both_ways(tmp_path_factory):
    spec = "connect4:w=3,h=4,connect=3"
    p1, p2 = (port_db(spec, c, tmp_path_factory) for c in (False, True))
    r1, r2 = (ref_db(spec, c, tmp_path_factory) for c in (False, True))
    assert check.db_equal(p1, r2) == [] == ref_check.db_equal(r1, p2)
    assert check.db_equal(p2, r1) == [] == ref_check.db_equal(p2, r1)
    assert check.db_equal_fast(p1, r1) == ref_check.db_equal_fast(p1, r1)
    assert check.db_equal_fast(p1, p2) == ref_check.db_equal_fast(p1, p2)
    for d in (p1, p2, r1, r2):
        assert check_db(d) == [] == ref_check.check_db(d)
        assert check.db_stats(d) == ref_check.db_stats(d)
        assert check.verify_for_serving(d) is True


@pytest.mark.parametrize("compress", [False, True], ids=["v1", "v2"])
def test_checkers_catch_the_same_corruption(compress, tmp_path,
                                            tmp_path_factory):
    """The reference's corruption cases (tests/test_db.py): a flipped
    cells byte fails the checksum, unsorted keys with a refreshed
    checksum fail the order check — with the same problem strings from
    both checkers, and db_equal flags the difference."""
    good = port_db("tictactoe", compress, tmp_path_factory)
    bad = tmp_path / "bad"
    shutil.copytree(good, bad)
    manifest = json.loads((bad / "manifest.json").read_text())
    victim = bad / manifest["levels"]["5"]["cells"]
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(raw)
    got = check_db(bad)
    assert got and "checksum" in got[0]
    assert got == ref_check.check_db(bad)
    assert check.db_equal(good, bad) == ref_check.db_equal(good, bad) != []
    if compress:
        return
    from gamesmanmpi_tpu_torch.db.format import file_sha256, write_manifest

    bad2 = tmp_path / "bad2"
    shutil.copytree(good, bad2)
    manifest = json.loads((bad2 / "manifest.json").read_text())
    rec = manifest["levels"]["1"]
    keys = np.load(bad2 / rec["keys"])
    np.save(bad2 / rec["keys"], keys[::-1].copy())
    rec["keys_sha256"] = file_sha256(bad2 / rec["keys"])
    write_manifest(bad2, manifest)
    got = check_db(bad2)
    assert any("ascending" in p for p in got)
    assert got == ref_check.check_db(bad2)


# ------------------------------------------------------- the writer


def test_writer_enforces_probe_invariants(tmp_path):
    """The reference's refusals (tests/test_db.py), plus the carrier's
    INT64_MAX sentinel arriving through the engine adapter."""
    game = get_game("tictactoe")
    w = DbWriter(tmp_path / "db", game, "tictactoe")
    one = (np.ones(1, np.uint8), np.zeros(1, np.int32))
    with pytest.raises(DbFormatError, match="ascending"):
        w.add_level(1, np.array([2, 1], dtype=game.state_dtype),
                    np.ones(2, np.uint8), np.zeros(2, np.int32))
    with pytest.raises(DbFormatError, match="dtype"):
        w.add_level(1, np.array([1], dtype=np.uint64), *one)
    with pytest.raises(DbFormatError, match="dtype"):
        w.add_level(1, np.array([1], dtype=np.int64), *one)
    with pytest.raises(DbFormatError, match="sentinel"):
        w.add_level(1, np.array([0xFFFF_FFFF], dtype=np.uint32), *one)
    for g, spec in ((game, "tictactoe"),
                    (get_game("nim:heaps=8-1-1-1-1-1-1-1"), "nim")):
        w2 = DbWriter(tmp_path / f"db_{spec}", g, spec)
        with pytest.raises(DbFormatError, match="sentinel"):
            w2.add_level_table(3, LevelTable(
                np.array([5, SENTINEL], dtype=np.int64),
                np.ones(2, np.uint8), np.zeros(2, np.int32)))
    with pytest.raises(DbFormatError, match="remoteness"):
        w.add_level(1, np.array([1], dtype=game.state_dtype),
                    np.ones(1, np.uint8),
                    np.array([MAX_REMOTENESS + 1], dtype=np.int64))
    with pytest.raises(DbFormatError, match="empty"):
        w.finalize()
    w.add_level(0, np.array([0], dtype=game.state_dtype), *one)
    with pytest.raises(DbFormatError, match="twice"):
        w.add_level(0, np.array([0], dtype=game.state_dtype), *one)
    w.finalize()
    with pytest.raises(DbFormatError, match="already finalized"):
        w.add_level(2, np.array([3], dtype=game.state_dtype), *one)
    with pytest.raises(DbFormatError, match="finalized"):
        DbWriter(tmp_path / "db", game, "tictactoe")


def test_overwrite_stages_and_swaps(tmp_path):
    """--overwrite stages into a sibling directory: the old DB serves
    until the new one finalizes; an aborted re-export leaves the old DB
    and no staging directory."""
    game = get_game("tictactoe")
    d = tmp_path / "db"
    w = DbWriter(d, game, "tictactoe")
    w.add_level(0, np.array([0], dtype=game.state_dtype),
                np.full(1, WIN, np.uint8), np.zeros(1, np.int32))
    w.finalize()
    w3 = DbWriter(d, game, "tictactoe", overwrite=True)
    assert w3.dir == tmp_path / "db.staging"
    assert (d / "manifest.json").exists()  # the old DB still serves
    w3.add_level(0, np.array([0], dtype=game.state_dtype),
                 np.full(1, 3, np.uint8), np.zeros(1, np.int32))
    w3.finalize()
    assert not list(tmp_path.glob("db.staging*"))
    with DbReader(d, device="cpu") as r:
        values, _, found = r.lookup(np.array([0], dtype=np.uint32))
    assert found[0] and int(values[0]) == 3  # the new cells serve
    w4 = DbWriter(d, game, "tictactoe", overwrite=True)
    w4.add_level(0, np.array([0], dtype=game.state_dtype),
                 np.full(1, WIN, np.uint8), np.zeros(1, np.int32))
    w4.abort()
    assert not list(tmp_path.glob("db.staging*"))
    with DbReader(d, device="cpu") as r:
        assert int(r.lookup(np.array([0], dtype=np.uint32))[0][0]) == 3
    # The CLI: a second export into --out refuses, --overwrite replaces.
    out = str(tmp_path / "cli")
    argv = ["export-db", "subtract:total=10,moves=1-2", "--out", out,
            "--device", "cpu"]
    assert cli.main(argv) == 0
    assert cli.main(argv) == 2
    assert cli.main(argv + ["--overwrite", "--compress"]) == 0
    assert json.loads((tmp_path / "cli" / "manifest.json").read_text())[
        "version"] == 2


def test_level_sink_streams_every_level(tmp_path):
    """level_sink gets every level's table with store_tables=False, on
    the fast and the generic path, and from a checkpoint resume; the
    result keeps only the root level."""
    for spec in ("tictactoe", "nim:heaps=3-4-5"):
        full = Solver(get_game(spec), device="cpu").solve()
        got = {}
        r = Solver(get_game(spec), device="cpu", store_tables=False,
                   level_sink=lambda k, t: got.__setitem__(k, t)).solve()
        assert list(r.levels) == [min(full.levels)]
        assert sorted(got) == sorted(full.levels)
        for k, t in full.levels.items():
            for a, b in zip(got[k], t):
                np.testing.assert_array_equal(a, b)
        d = tmp_path / spec.replace(":", "_")
        Solver(get_game(spec), device="cpu",
               checkpointer=LevelCheckpointer(d)).solve()
        again = {}
        Solver(get_game(spec), device="cpu", store_tables=False,
               checkpointer=LevelCheckpointer(d),
               level_sink=lambda k, t: again.__setitem__(k, t)).solve()
        assert sorted(again) == sorted(full.levels)


# ------------------------------------------------------------- CLI


@pytest.mark.parametrize("spec,extra,positions", [
    ("subtract:total=10,moves=1-2", [], ["10", "9", "0x1", "0", "11",
                                         "zz", "4096"]),
    ("tictactoe:sym=1", ["--compress", "--book-plies", "2"],
     ["0", "0x1", "0x4", "0x10", "0x3ffff", "-1", "0x1" + "0" * 40]),
    ("nim:heaps=8-1-1-1-1-1-1-1", ["--compress"],
     ["0", "0x11111118", "0x11111111", "0xffffffff"]),
])
def test_cli_lines_match_reference(spec, extra, positions, tmp_path):
    """export-db and query print the reference CLI's lines, all but
    elapsed; the two DBs are the same files."""
    rc_t, got = run_cli(cli.main, ["export-db", spec, "--out",
                                   str(tmp_path / "t"), "--device", "cpu",
                                   *extra])
    rc_j, want = run_cli(jax_cli.main, ["export-db", spec, "--out",
                                        str(tmp_path / "j"), *extra])
    assert rc_t == rc_j == 0
    assert got[1:] == want[1:] and got[0].startswith("database written:")
    assert digests(tmp_path / "t") == digests(tmp_path / "j")
    rc_t, got = run_cli(cli.main, ["query", str(tmp_path / "j"),
                                   *positions, "--device", "cpu"])
    rc_j, want = run_cli(jax_cli.main, ["query", str(tmp_path / "t"),
                                        *positions])
    assert rc_t == rc_j == 0
    assert got == want and len(got) == len(positions)


def test_cli_query_and_export_refuse_bad_inputs(tmp_path, capsys):
    assert cli.main(["query", str(tmp_path / "none"), "0", "--device",
                     "cpu"]) == 2
    assert "not a solved-position database" in capsys.readouterr().err
    assert cli.main(["export-db", "nosuchgame", "--out",
                     str(tmp_path / "x"), "--device", "cpu"]) == 2
    assert cli.main(["export-db", "examples/specs/no_such_spec.json",
                     "--out", str(tmp_path / "x"), "--device", "cpu"]) == 2
    assert "cannot read game spec file" in capsys.readouterr().err
    assert cli.main(["export-db", "tictactoe", "--from-checkpoint",
                     str(tmp_path / "missing"), "--out", str(tmp_path / "x"),
                     "--device", "cpu"]) == 2
    assert "no such checkpoint directory" in capsys.readouterr().err
    assert not (tmp_path / "missing").exists()


def test_gamespec_db_refused(tmp_path, tmp_path_factory, capsys):
    """A manifest with game_spec is a compiled-game DB: the reader
    rebuilds its game from the embedded spec (the port's game compiler)
    and `query` answers from it; an embedded spec that does not compile
    is refused, and the CLI exits 2."""
    from gamesmanmpi_tpu_torch.gamedsl import load_spec

    spec = load_spec(str(REPO / "examples" / "specs" / "tictactoe_3x3.json"))
    d = tmp_path / "spec_db"
    shutil.copytree(port_db("tictactoe", False, tmp_path_factory), d)
    m = json.loads((d / "manifest.json").read_text())
    m["game_spec"] = spec.to_doc()
    m["spec_sha256"] = spec.spec_hash
    (d / "manifest.json").write_text(json.dumps(m))
    with DbReader(d, device="cpu") as r:
        assert r.game.spec_hash == spec.spec_hash
        assert r.game.name == m["game"]
    rc, lines = run_cli(cli.main, ["query", str(d), "0", "--device", "cpu"])
    assert rc == 0
    assert lines == ["query 0: value=TIE remoteness=9 best=0x1"]
    m["game_spec"] = {"name": "tictactoe_3x3"}
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(DbFormatError, match="not compilable"):
        DbReader(d, device="cpu")
    assert cli.main(["query", str(d), "0", "--device", "cpu"]) == 2
    assert "not compilable" in capsys.readouterr().err


def test_db_entry_points_default_to_the_card(monkeypatch, tmp_path,
                                             tmp_path_factory, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = port_db("tictactoe", False, tmp_path_factory)
    with pytest.raises(DeviceUnavailable):
        DbReader(d)
    assert cli.main(["query", str(d), "0"]) == 2
    assert cli.main(["export-db", "tictactoe", "--out",
                     str(tmp_path / "x")]) == 2
    err = capsys.readouterr().err
    assert err.count("torch.cuda.is_available() is false") == 2
    assert not (tmp_path / "x").exists()


def test_format_and_check_import_no_torch():
    code = ("import sys\n"
            "import gamesmanmpi_tpu_torch.db\n"
            "from gamesmanmpi_tpu_torch.db import check_db, parse_position\n"
            "import gamesmanmpi_tpu_torch.db.check\n"
            "import gamesmanmpi_tpu_torch.db.format\n"
            "import gamesmanmpi_tpu_torch.solve.oracle\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'gamesmanmpi_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
