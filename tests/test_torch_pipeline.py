"""The torch port's backward pipeline, capacity flags, records and tools
against the JAX package.

* ``GAMESMAN_PIPELINE=pingpong``: the classic backward's tables,
  checkpoint files and DB files are byte for byte those of ``level`` and
  of the JAX package's pingpong solve; ``overlap_secs`` is reported; a
  preemption at a boundary still seals the deferred level, and a retried
  level seals once.
* The four capacity flags win over their env twins, restore them after
  the solve, and the host path of a compat module warns about them in
  the reference's words.
* The three repaired faults: a torn seal writes the reference's
  ``ckpt_degraded`` record, the hybrid writes ``hybrid_sweep``,
  ``hybrid_bfs`` and ``done`` with the reference's keys, and
  ``BlockCache(registry=)`` registers the ``gamesman_db_cache_*`` family.
* The ``tools/`` twins print what the reference's tools print and exit
  with their codes on the same DB or spec.

Integers and bytes throughout: no tolerance.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.ops import fused as ref_fused
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.compress.cache import BlockCache
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.obs.registry import MetricsRegistry
from gamesmanmpi_tpu_torch.ops.fused import pipeline_mode
from gamesmanmpi_tpu_torch.resilience import faults, preempt
from gamesmanmpi_tpu_torch.solve import engine
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
C34 = "connect4:w=3,h=4,connect=3"
SPECS = ["tictactoe", C34, "nim:heaps=3-4-5"]

_JAX = {}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    ref_faults.clear()
    preempt.reset()
    yield
    faults.clear()
    ref_faults.clear()
    preempt.reset()


def jax_pingpong(spec, monkeypatch):
    """The JAX package's solve of `spec` under GAMESMAN_PIPELINE=pingpong,
    once per test process."""
    if spec not in _JAX:
        with monkeypatch.context() as m:
            m.setenv("GAMESMAN_PIPELINE", "pingpong")
            _JAX[spec] = JaxSolver(jax_get_game(spec)).solve()
        assert _JAX[spec].stats["pipeline"] == "pingpong"
    return _JAX[spec]


def assert_same_tables(got, ref):
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.levels) == sorted(ref.levels)
    for k, want in ref.levels.items():
        t = got.levels[k]
        np.testing.assert_array_equal(
            t.states, np.asarray(want.states).astype(np.int64), err_msg=k)
        assert t.values.dtype == np.uint8 and t.remoteness.dtype == np.int32
        np.testing.assert_array_equal(t.values, np.asarray(want.values))
        np.testing.assert_array_equal(t.remoteness,
                                      np.asarray(want.remoteness))


def file_digests(d, skip=("manifest.json",)):
    """{name: sha256} of a directory's files (the manifest carries run
    times, so checkpoint comparisons skip it)."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(pathlib.Path(d).iterdir())
            if p.is_file() and p.name not in skip
            and not p.name.startswith("flightrec")}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# ------------------------------------------------------------ pingpong


@pytest.mark.parametrize("value", [None, "level", "pingpong", "fused", ""])
def test_pipeline_mode_parses_like_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("GAMESMAN_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("GAMESMAN_PIPELINE", value)
    try:
        want = ref_fused.pipeline_mode()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pipeline_mode()
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            Solver(get_game("tictactoe"), device="cpu")
        return
    assert pipeline_mode() == want


@pytest.mark.parametrize("spec", SPECS)
def test_pingpong_tables_and_checkpoints_match_level_and_reference(
        spec, tmp_path, monkeypatch):
    """Both modes: the same tables as the JAX package's pingpong solve,
    and every sealed level and frontier file byte for byte the same."""
    results = {}
    for mode in ("level", "pingpong"):
        monkeypatch.setenv("GAMESMAN_PIPELINE", mode)
        ck = LevelCheckpointer(str(tmp_path / mode))
        results[mode] = Solver(get_game(spec), device="cpu",
                               checkpointer=ck).solve()
        assert results[mode].stats["pipeline"] == mode
    ref = jax_pingpong(spec, monkeypatch)
    for mode, r in results.items():
        assert_same_tables(r, ref)
        assert r.stats["misses"] == 0
    assert results["level"].stats["overlap_secs"] == 0.0
    assert results["pingpong"].stats["overlap_secs"] >= 0.0
    assert (results["level"].stats["bytes_host"]
            == results["pingpong"].stats["bytes_host"])
    level_files = file_digests(tmp_path / "level")
    assert any(n.startswith("level_") for n in level_files)
    assert level_files == file_digests(tmp_path / "pingpong")


def test_pingpong_no_tables_keeps_the_root(monkeypatch):
    monkeypatch.setenv("GAMESMAN_PIPELINE", "pingpong")
    got = Solver(get_game(C34), device="cpu", store_tables=False).solve()
    ref = jax_pingpong(C34, monkeypatch)
    assert (got.value, got.remoteness) == (ref.value, ref.remoteness)
    assert list(got.levels) == [0]


def test_pingpong_db_export_files_match_level(tmp_path, monkeypatch):
    """The level sink runs one level late under pingpong: the exported
    DB's files (manifest included) are the level order's byte for
    byte."""
    digests = {}
    for mode in ("level", "pingpong"):
        monkeypatch.setenv("GAMESMAN_PIPELINE", mode)
        out = tmp_path / mode
        rc, _, err = _run(cli.main, ["export-db", C34, "--out", str(out),
                                     "--device", "cpu"])
        assert rc == 0, err
        digests[mode] = file_digests(out, skip=())
    assert digests["level"] == digests["pingpong"]
    assert "manifest.json" in digests["level"]


def test_pingpong_preemption_seals_the_deferred_level(tmp_path,
                                                      monkeypatch):
    """A preemption at level L's boundary runs level L+1's deferred tail
    first: L+1 is sealed, and the resume reaches the same tables."""
    monkeypatch.setenv("GAMESMAN_PIPELINE", "pingpong")
    real = engine.preempt.check

    def check(phase, level=None, logger=None):
        if phase == "backward" and level == 6:
            raise preempt.PreemptionRequested("test preemption")
        return real(phase, level=level, logger=logger)

    ck = LevelCheckpointer(str(tmp_path / "ck"))
    with monkeypatch.context() as m:
        m.setattr(engine.preempt, "check", check)
        with pytest.raises(preempt.PreemptionRequested):
            Solver(get_game(C34), device="cpu", checkpointer=ck).solve()
    sealed = sorted(LevelCheckpointer(str(tmp_path / "ck"))
                    .completed_levels())
    assert sealed == list(range(7, 13))
    resumed = Solver(get_game(C34), device="cpu",
                     checkpointer=LevelCheckpointer(str(tmp_path / "ck"))
                     ).solve()
    assert_same_tables(resumed, jax_pingpong(C34, monkeypatch))


def test_pingpong_retried_level_seals_once(tmp_path, monkeypatch):
    """A transient at a backward level is retried inside the resolve;
    the deferred tail of every level runs once."""
    monkeypatch.setenv("GAMESMAN_PIPELINE", "pingpong")
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    faults.configure("engine.backward:transient:3")
    ck = LevelCheckpointer(str(tmp_path / "ck"))
    saved = []
    real = ck.save_level

    def save_level(level, table):
        saved.append(level)
        return real(level, table)

    ck.save_level = save_level
    r = Solver(get_game(C34), device="cpu", checkpointer=ck).solve()
    assert r.stats["retries"] == 1
    assert sorted(saved) == list(range(13))
    assert_same_tables(r, jax_pingpong(C34, monkeypatch))


# ------------------------------------------------------ capacity flags


@pytest.mark.parametrize("flag,value,env,env_value,attr,want", [
    ("--backward-block", "64", "GAMESMAN_BACKWARD_BLOCK", "0",
     "backward_block", 64),
    ("--device-store-mb", "0", "GAMESMAN_DEVICE_STORE_MB", "8192",
     "device_store_bytes", 0),
])
def test_classic_capacity_flags_win_over_env(flag, value, env, env_value,
                                             attr, want, monkeypatch):
    monkeypatch.setenv(env, env_value)
    seen = {}
    real = Solver.solve

    def spy(self):
        seen[attr] = getattr(self, attr)
        return real(self)

    monkeypatch.setattr(Solver, "solve", spy)
    rc, _, err = _run(cli.main, ["solve", C34, "--engine", "classic",
                                 "--device", "cpu", flag, value])
    assert rc == 0, err
    assert seen[attr] == want
    assert os.environ[env] == env_value  # restored after the solve


@pytest.mark.parametrize("flag,value,env,env_value,check", [
    ("--window-block", "256", "GAMESMAN_WINDOW_BLOCK", "0",
     lambda s: s["window_stream_blocks"] > 0),
    ("--backward", "lookup", "GAMESMAN_BACKWARD", "edges",
     lambda s: s["backward"] == "lookup" and s["backward_edges_levels"] == 0),
    ("--backward", "edges", "GAMESMAN_BACKWARD", "lookup",
     lambda s: s["backward"] == "edges" and s["backward_edges_levels"] > 0),
    ("--device-store-mb", "0", "GAMESMAN_DEVICE_STORE_MB", "8192",
     lambda s: s["edges_bytes_spilled"] > 0),
])
def test_sharded_capacity_flags_win_over_env(flag, value, env, env_value,
                                             check, tmp_path, monkeypatch):
    monkeypatch.setenv(env, env_value)
    jsonl = tmp_path / "r.jsonl"
    rc, _, err = _run(cli.main, ["solve", "connect4:w=4,h=3", "--device",
                                 "cpu", "--devices", "2", flag, value,
                                 "--jsonl", str(jsonl)])
    assert rc == 0, err
    done = json.loads(jsonl.read_text().splitlines()[-1])
    assert done["phase"] == "done" and check(done), done
    assert os.environ[env] == env_value


def test_campaign_attempts_carry_the_capacity_flags(tmp_path):
    """A campaign's attempt command line passes the capacity flags on
    unchanged, also after an oom escalation rewrites --devices, as the
    reference's does."""
    from gamesmanmpi_tpu.resilience import campaign as ref_campaign
    from gamesmanmpi_tpu_torch.resilience import campaign

    flags = ["--window-block", "256", "--backward", "lookup",
             "--backward-block", "64", "--device-store-mb", "1"]
    args = {}
    for mod, tag in ((campaign, "port"), (ref_campaign, "ref")):
        cfg = mod.CampaignConfig(
            solver_args=["connect4:w=4,h=3", "--devices", "2", *flags],
            checkpoint_dir=str(tmp_path / tag))
        c = mod.Campaign(cfg, echo=lambda m: None)
        c._shards = 4  # what an oom escalation does
        args[tag] = c._solver_args()[:-1]
    assert args["port"] == args["ref"] == [
        "connect4:w=4,h=3", "--devices", "4", *flags, "--checkpoint-dir"]


def test_host_path_warns_in_the_reference_words(monkeypatch):
    """A compat module without level_of is solved on the host: each
    capacity flag (and --devices, --paranoid, --checkpoint-dir) it
    ignores gets the reference's warning line, word for word."""
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    argv = ["examples/ref_games/ten_to_zero.py", "--devices", "2",
            "--paranoid", "--backward-block", "64", "--window-block", "256",
            "--device-store-mb", "1"]
    monkeypatch.chdir(REPO)
    rc_j, out_j, err_j = _run(jax_cli.main, argv)
    rc, out, err = _run(cli.main, ["solve", *argv, "--device", "cpu"])
    assert rc == rc_j == 0
    warnings = [ln for ln in err.splitlines() if ln.startswith("warning:")]
    assert warnings == [ln for ln in err_j.splitlines()
                        if ln.startswith("warning:")]
    assert len(warnings) == 5
    assert [ln for ln in out.splitlines() if ln.startswith("value")] == [
        ln for ln in out_j.splitlines() if ln.startswith("value")]


# ------------------------------------------------------ repaired faults


def _degraded(path):
    return [(r["phase"], r["level"]) for r in map(
        json.loads, pathlib.Path(path).read_text().splitlines())
        if r["phase"] == "ckpt_degraded"]


def test_torn_seal_writes_ckpt_degraded_like_reference(tmp_path,
                                                       monkeypatch):
    """One sealed directory, one level file torn in two copies of it:
    each package's resume quarantines the level, recomputes it and
    writes the same ckpt_degraded record to --jsonl."""
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    base = tmp_path / "base"
    rc, _, err = _run(cli.main, ["solve", C34, "--engine", "classic",
                                 "--device", "cpu", "--checkpoint-dir",
                                 str(base)])
    assert rc == 0, err
    records = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        d = tmp_path / name
        shutil.copytree(base, d)
        victim = d / "level_0005.npz"
        victim.write_bytes(victim.read_bytes()[:40])
        jsonl = tmp_path / f"{name}.jsonl"
        argv = [C34, "--engine", "classic", "--checkpoint-dir", str(d),
                "--jsonl", str(jsonl), *extra]
        rc, out, err = _run(main, ["solve", *argv] if main is cli.main
                            else argv)
        assert rc == 0, err
        assert "value: TIE" in out or "value:" in out
        records[name] = _degraded(jsonl)
        assert list(d.glob("level_0005.npz.corrupt"))
    assert records["port"] == records["jax"] == [("ckpt_degraded", 5)]


def _phases(path):
    recs = [json.loads(ln) for ln in pathlib.Path(path).read_text()
            .splitlines()]
    return [r for r in recs if r["phase"] != "heartbeat"]


def test_hybrid_records_match_reference(tmp_path, monkeypatch):
    """--engine hybrid --jsonl: hybrid_sweep, hybrid_bfs and done, in the
    reference's order, the first two with exactly its keys, done with
    every key of the reference's but the analytic byte counts the port
    leaves out."""
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    argv = ["connect4:w=4,h=4", "--engine", "hybrid", "--hybrid-cutover",
            "10"]
    rc, out, err = _run(cli.main, ["solve", *argv, "--device", "cpu",
                                   "--jsonl", str(tmp_path / "p.jsonl")])
    assert rc == 0, err
    rc_j, out_j, _ = _run(jax_cli.main, [*argv, "--jsonl",
                                         str(tmp_path / "j.jsonl")])
    assert rc_j == 0
    got, want = _phases(tmp_path / "p.jsonl"), _phases(tmp_path / "j.jsonl")
    assert [r["phase"] for r in got] == [r["phase"] for r in want] == [
        "hybrid_sweep", "hybrid_bfs", "done"]
    for g, w in zip(got[:2], want[:2]):
        assert set(g) == set(w)
        for key in set(w) - {"secs", "t"}:
            assert g[key] == w[key], key
    analytic = {"bytes_sorted", "bytes_gathered"}
    assert set(want[2]) - analytic <= set(got[2])
    for key in ("positions", "cutover", "positions_dense_region",
                "positions_bfs_region", "frontier_at_boundary",
                "reachable_at_boundary", "engine"):
        assert got[2][key] == want[2][key], key
    assert got[2]["positions"] == 161029


def test_block_cache_registers_db_cache_metrics():
    reg = MetricsRegistry()
    cache = BlockCache(100, registry=reg, labels={"db": "t"})
    cache.put("a", b"x" * 60, 60)
    cache.put("b", b"y" * 60, 60)  # evicts "a"
    assert cache.get("a") is None and cache.get("b") is not None
    snap = reg.snapshot()
    for name in ("gamesman_db_cache_evictions_total",
                 "gamesman_db_cache_bytes", "gamesman_db_cache_hits_total",
                 "gamesman_db_cache_misses_total"):
        assert name in snap, name
        assert snap[name]["values"][0]["labels"] == {"db": "t"}
    assert snap["gamesman_db_cache_evictions_total"]["values"][0][
        "value"] == 1
    assert snap["gamesman_db_cache_bytes"]["values"][0]["value"] == 60
    # instruments= keeps its owner's family, and wins over registry=.
    own = MetricsRegistry()
    inst = tuple(own.counter(f"x_{i}", "x") for i in range(3)) + (
        own.gauge("x_bytes", "x"),)
    BlockCache(10, registry=reg, instruments=inst).put("k", b"", 20)
    assert own.snapshot()["x_bytes"]["values"][0]["value"] == 20


# ---------------------------------------------------------- the twins


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def ttt_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("twin") / "ttt.db"
    rc, _, err = _run(cli.main, ["export-db", "tictactoe", "--out", str(d),
                                 "--device", "cpu", "--compress",
                                 "--book-plies", "2"])
    assert rc == 0, err
    return d


def _both(tool, twin, argv, twin_extra=()):
    got = _run(twin, [*argv, *twin_extra])
    want = _run(_tool(tool), list(argv))
    return got, want


def test_check_db_twin_matches_tool(ttt_db, tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    from gamesmanmpi_tpu_torch.db import check

    (rc, out, _), (rc_j, out_j, _) = _both(
        "check_db", check.main, [str(ttt_db)], ("--device", "cpu"))
    assert rc == rc_j == 0 and out == out_j
    assert "book: deep re-probe OK" in out
    bad = tmp_path / "bad.db"
    shutil.copytree(ttt_db, bad)
    victim = sorted(p for p in bad.iterdir() if p.name.startswith("level")
                    and p.stat().st_size > 64)[0]
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    (rc, out, err), (rc_j, out_j, err_j) = _both(
        "check_db", check.main, [str(bad), "--quiet"], ("--device", "cpu"))
    assert rc == rc_j == 1 and out == out_j
    assert err.splitlines()[-1] == err_j.splitlines()[-1]
    with pytest.raises(SystemExit) as e:
        check.main([])
    assert e.value.code == 2


def test_build_book_twin_matches_tool(ttt_db, tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    from gamesmanmpi_tpu_torch.db import book

    a, b = tmp_path / "a.db", tmp_path / "b.db"
    shutil.copytree(ttt_db, a)
    shutil.copytree(ttt_db, b)
    rc, out, _ = _run(book.main, [str(a), "--plies", "3", "--verify",
                                  "--device", "cpu"])
    rc_j, out_j, _ = _run(_tool("build_book"), [str(b), "--plies", "3",
                                                "--verify"])
    assert rc == rc_j == 0 and out == out_j
    assert file_digests(a, skip=()) == file_digests(b, skip=())
    monkeypatch.delenv("GAMESMAN_BOOK_PLIES", raising=False)
    rc, _, err = _run(book.main, [str(a), "--device", "cpu"])
    rc_j, _, err_j = _run(_tool("build_book"), [str(b)])
    assert rc == rc_j == 2 and err == err_j


def test_spec_lint_twin_matches_tool(tmp_path):
    from gamesmanmpi_tpu_torch.gamedsl import spec

    (rc, out, _), (rc_j, out_j, _) = _both("spec_lint", spec.main, [])
    assert rc == rc_j == 0 and out == out_j and ": OK" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"gamedsl": 1, "name": "bad", "board": {
        "width": 3, "height": 3}, "moves": {"family": "place"},
        "win": {"kind": "k_in_line", "k": 9}}))
    missing = str(tmp_path / "missing.json")
    for argv in ([str(bad)], [str(bad), "--errors-only"], [missing]):
        (rc, out, err), (rc_j, out_j, err_j) = _both("spec_lint", spec.main,
                                                      argv)
        assert (rc, out, err) == (rc_j, out_j, err_j)
        assert rc == 1


def test_ckpt_to_db_twin_matches_tool(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_PLATFORM", "cpu")
    from gamesmanmpi_tpu_torch.db import ckpt_to_db

    ck = tmp_path / "ck"
    rc, _, err = _run(cli.main, ["solve", C34, "--engine", "classic",
                                 "--device", "cpu", "--checkpoint-dir",
                                 str(ck)])
    assert rc == 0, err
    rc, _, err = _run(ckpt_to_db.main, [str(ck), str(tmp_path / "p.db"),
                                        "--game", C34, "--device", "cpu"])
    rc_j, _, err_j = _run(_tool("ckpt_to_db"), [str(ck), str(tmp_path /
                                                              "j.db"),
                                                "--game", C34])
    assert rc == rc_j == 0, (err, err_j)
    assert (file_digests(tmp_path / "p.db", skip=())
            == file_digests(tmp_path / "j.db", skip=()))
    # A game that does not match the checkpoint's binding: both refuse.
    rc, _, _ = _run(ckpt_to_db.main, [str(ck), str(tmp_path / "x.db"),
                                      "--game", "tictactoe", "--device",
                                      "cpu"])
    rc_j, _, _ = _run(_tool("ckpt_to_db"), [str(ck), str(tmp_path / "y.db"),
                                            "--game", "tictactoe"])
    assert rc == rc_j != 0
