"""Torch port's fault injection, preemption grace and checkpoint
integrity (the reference's tests/test_resilience.py, on the port).

* The GAMESMAN_FAULTS grammar and every injected kind; a point the port
  does not fire yet refuses to arm.
* Level-step retry: a transient at a forward or backward step is
  absorbed, the tables equal the undisturbed solve's, and the retry
  count equals the JAX package's on the same schedule; a fatal fault
  fails fast, and torch's out-of-memory error is never retried.
* A crc mismatch quarantines the level (or frontier) and the resume
  recomputes it; GAMESMAN_CKPT_VERIFY=0 skips the check.
* Preemption: SIGUSR1 mid-backward raises PreemptionRequested at the
  next level boundary, and the CLI exits 75; the resume reaches the
  uninterrupted tables.
* Chaos in a subprocess of the CLI on the CPU: an injected kill exits 77
  and a torn seal 86; each resumes to the uninterrupted tables.
* The DB's points: a kill or a torn payload at ``store.writebehind``
  leaves an export without a manifest, which the reader refuses;
  ``db.probe`` and ``serve.block_decode`` fire on the reader's probe.

The port runs on the CPU; integers throughout, so tolerance zero.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.resilience import retry as ref_retry
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.obs import default_registry
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.resilience import faults, preempt
from gamesmanmpi_tpu_torch.resilience import retry
from gamesmanmpi_tpu_torch.resilience.faults import FatalFault, TransientFault
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.store import BlockStore, file_crc32
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The in-process game: 3x4 connect-3, 2,715 positions over 13 levels,
#: the fast path.
C34 = "connect4:w=3,h=4,connect=3"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    ref_faults.clear()
    preempt.reset()
    yield
    faults.clear()
    ref_faults.clear()
    preempt.reset()


@pytest.fixture(scope="module")
def clean():
    """Uninterrupted solves: the parity baselines."""
    return {spec: Solver(get_game(spec), device="cpu").solve()
            for spec in (C34, "nim:heaps=3-4-5")}


def assert_same_tables(got, want):
    assert (got.value, got.remoteness, got.num_positions) == (
        want.value, want.remoteness, want.num_positions)
    assert sorted(got.levels) == sorted(want.levels)
    for k, t in want.levels.items():
        np.testing.assert_array_equal(got.levels[k].states, t.states)
        np.testing.assert_array_equal(got.levels[k].values, t.values)
        np.testing.assert_array_equal(got.levels[k].remoteness, t.remoteness)


def resume(spec, d):
    return Solver(get_game(spec), device="cpu",
                  checkpointer=LevelCheckpointer(d)).solve()


# ------------------------------------------------------------ the grammar


def test_fault_spec_parsing_and_schedule():
    faults.configure("engine.forward:transient:2")
    faults.fire("engine.forward")  # visit 1: nothing
    with pytest.raises(TransientFault):
        faults.fire("engine.forward")  # visit 2: fires
    faults.fire("engine.forward")  # visit 3: one-shot schedule

    faults.configure("ckpt.load_level:fatal:always")
    for _ in range(3):
        with pytest.raises(FatalFault):
            faults.fire("ckpt.load_level")

    def sequence():
        faults.configure("engine.backward:transient:p0.5@7")
        fired = []
        for _ in range(20):
            try:
                faults.fire("engine.backward")
                fired.append(False)
            except TransientFault:
                fired.append(True)
        return fired

    a, b = sequence(), sequence()
    assert a == b and any(a) and not all(a)
    for bad in ("no.such.point:kill", "engine.forward:frobnicate",
                "engine.forward", "engine.forward:kill:0"):
        with pytest.raises(ValueError):
            faults.configure(bad)
    faults.clear()
    faults.fire("engine.forward")  # disarmed: free and silent


def test_known_points_are_the_references():
    assert sorted(faults.KNOWN_POINTS) == sorted(ref_faults.KNOWN_POINTS)
    assert set(faults.PORTED_POINTS) == {
        "engine.forward", "engine.dedup", "engine.backward",
        "ckpt.save_level", "ckpt.load_level", "ckpt.save_frontier",
        "store.writebehind", "db.probe", "serve.block_decode",
        "serve.flush", "serve.worker_spawn", "serve.heartbeat",
        "serve.reload", "sharded.forward", "sharded.backward",
        "sharded.collective", "coord.barrier", "coord.handshake",
        "registry.fetch", "registry.publish", "registry.install",
        "jobs.claim"}
    assert faults.KILL_EXIT_CODE == ref_faults.KILL_EXIT_CODE == 77
    assert faults.TORN_EXIT_CODE == ref_faults.TORN_EXIT_CODE == 86
    assert preempt.GRACE_EXIT_CODE == 75


@pytest.mark.parametrize("point", [
    "jobs.claim", "registry.fetch", "registry.install", "registry.publish"])
def test_unported_point_refuses_to_arm(point, monkeypatch):
    """The last points the port lacked (the registry's) arm now that
    registry/ fires them; a name the reference does not know is still
    refused, from the API and from the environment."""
    armed = faults.configure(f"{point}:kill:2")
    assert [d.point for d in armed[point]] == [point]
    faults.fire(point)  # visit 1: not due, the process lives
    faults.clear()
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.configure(f"{point}x:kill")
    monkeypatch.setenv("GAMESMAN_FAULTS", f"{point}x:kill")
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.configure_from_env()


@pytest.mark.parametrize("point", [
    "sharded.forward", "sharded.backward", "sharded.collective",
    "coord.barrier", "coord.handshake"])
def test_sharded_points_arm(point):
    """The sharded engine's and the coordination client's points arm now
    that the port fires them (parallel/sharded.py,
    resilience/coordination.py)."""
    armed = faults.configure(f"{point}:transient:2")
    assert [d.point for d in armed[point]] == [point]
    faults.fire(point)  # visit 1: not due
    with pytest.raises(TransientFault):
        faults.fire(point)
    faults.clear()


def test_cli_refuses_a_bad_fault_spec(monkeypatch, capsys):
    monkeypatch.setenv("GAMESMAN_FAULTS", "registry.fetched:kill")
    assert cli.main(["solve", "tictactoe", "--device", "cpu"]) == 2
    assert "unknown fault point" in capsys.readouterr().err


@pytest.mark.parametrize("kind,exc", [
    ("transient", TransientFault), ("fatal", FatalFault),
    ("enospc", OSError), ("oom", MemoryError)])
def test_raising_kinds(kind, exc):
    faults.configure(f"ckpt.save_level:{kind}")
    with pytest.raises(exc) as info:
        faults.fire("ckpt.save_level", path="/nonexistent/x.npz", level=3)
    if kind == "enospc":
        assert info.value.errno == 28
    if kind == "oom":
        assert "RESOURCE_EXHAUSTED" in str(info.value)


def test_delay_kind_sleeps():
    faults.configure("engine.dedup:delay=0.05:always")
    t0 = time.perf_counter()
    faults.fire("engine.dedup")
    faults.fire("engine.dedup")
    assert time.perf_counter() - t0 >= 0.1


def test_env_arms_at_the_first_visit(monkeypatch):
    faults._LOADED = False
    monkeypatch.setenv("GAMESMAN_FAULTS", "engine.forward:fatal")
    with pytest.raises(FatalFault):
        faults.fire("engine.forward")


@pytest.mark.parametrize("point", ["engine.forward", "engine.dedup",
                                   "engine.backward", "ckpt.save_level",
                                   "ckpt.save_frontier", "ckpt.load_level"])
def test_every_ported_point_fires_on_a_checkpointed_solve(point, tmp_path):
    """Each point sits on the solve path: a fatal there aborts the solve
    with the sealed prefix intact, and the rerun reaches parity."""
    faults.configure(f"{point}:fatal:2")
    d = tmp_path / "ck"
    if point == "ckpt.load_level":  # only a resume loads levels
        Solver(get_game("tictactoe"), device="cpu",
               checkpointer=LevelCheckpointer(d)).solve()
        faults.configure(f"{point}:fatal:2")
    with pytest.raises(FatalFault):
        resume("tictactoe", d)
    faults.clear()
    r = resume("tictactoe", d)
    assert (r.value, r.remoteness, r.num_positions) == (3, 9, 5478)


# ------------------------------------------------------ level-step retry


def _retries_total():
    fam = default_registry().snapshot().get("gamesman_retries_total", {})
    return sum(row["value"] for row in fam.get("values", ()))


@pytest.mark.parametrize("spec", [C34, "nim:heaps=3-4-5"])
@pytest.mark.parametrize("fault", ["engine.forward:transient:2",
                                   "engine.backward:transient:p0.5@7"])
def test_transient_is_absorbed_with_the_references_retries(
        spec, fault, clean, monkeypatch):
    """The fast (C34) and generic (nim) paths absorb a one-shot forward
    transient and a seeded coin-flip backward one; with eight attempts
    per step neither package exhausts its retries, and both count the
    same number of them on the same schedule."""
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    monkeypatch.setenv("GAMESMAN_RETRY_ATTEMPTS", "8")
    ref_faults.configure(fault)
    want = JaxSolver(jax_get_game(spec)).solve().stats["retries"]
    faults.configure(fault)
    before = _retries_total()
    got = Solver(get_game(spec), device="cpu").solve()
    assert got.stats["retries"] == want >= 1
    assert _retries_total() - before == want
    assert_same_tables(got, clean[spec])


def test_exhausted_transients_fail_like_the_reference(monkeypatch):
    """With the default three attempts the coin-flip schedule exhausts a
    backward step in both packages: the last TransientFault surfaces."""
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    fault = "engine.backward:transient:p0.5@7"
    ref_faults.configure(fault)
    with pytest.raises(ref_faults.TransientFault):
        JaxSolver(jax_get_game(C34)).solve()
    faults.configure(fault)
    with pytest.raises(TransientFault):
        Solver(get_game(C34), device="cpu").solve()


def test_fatal_fails_fast_without_retry(monkeypatch):
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    faults.configure("engine.backward:fatal:2")
    solver = Solver(get_game(C34), device="cpu")
    with pytest.raises(FatalFault):
        solver.solve()
    assert solver.retries == 0
    assert faults._ARMED["engine.backward"][0].visits == 2  # no re-entry


def test_out_of_memory_is_never_transient():
    import torch

    def cases(mod):
        return [mod.TransientFault("x"), mod.FatalFault("x"),
                MemoryError("oom"),
                RuntimeError("UNAVAILABLE: socket closed"),
                RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                OSError("connection reset by peer"),
                ValueError("unavailable")]

    port = [retry.is_transient(c) for c in cases(faults)]
    ref = [ref_retry.is_transient(c) for c in cases(ref_faults)]
    assert port == ref == [True, False, False, True, False, True, False]
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB; the device is "
        "unavailable for the rest of this step")
    assert not retry.is_transient(oom)
    assert retry.TRANSIENT_MARKERS == ref_retry.TRANSIENT_MARKERS


def test_cli_absorbs_a_transient_like_the_jax_cli(monkeypatch, capsys):
    monkeypatch.setenv("GAMESMAN_FAULTS", "engine.forward:transient:2")
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    ref_faults.configure("engine.forward:transient:2")  # the env, armed
    outs = []
    for main, argv in ((jax_cli.main, ["solve", "tictactoe"]),
                       (cli.main, ["solve", "tictactoe", "--device", "cpu"])):
        assert main(argv) == 0
        out, err = capsys.readouterr()
        outs.append(([ln for ln in out.splitlines()
                      if ln.split(":")[0] in ("positions", "value",
                                              "remoteness")],
                     [ln for ln in err.splitlines()
                      if ln.startswith("[faults]")]))
    assert outs[1] == outs[0]
    assert outs[1][0] == ["positions: 5478", "value: TIE", "remoteness: 9"]
    assert len(outs[1][1]) == 1


# ------------------------------------------------------- crc integrity


def _flip_byte(path, offset_frac=0.5):
    size = os.path.getsize(path)
    off = max(0, int(size * offset_frac))
    with open(path, "r+b") as fh:
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("ckpt_mode", ["auto", "blocks"])
def test_crc_quarantines_corrupt_level_and_recomputes(tmp_path, clean,
                                                      monkeypatch, ckpt_mode):
    monkeypatch.setenv("GAMESMAN_CKPT_COMPRESS", ckpt_mode)
    ck = LevelCheckpointer(tmp_path / "ck")
    Solver(get_game(C34), device="cpu", checkpointer=ck).solve()
    sealed = ck.completed_levels()
    victim = sealed[len(sealed) // 2]
    victim_file = tmp_path / "ck" / f"level_{victim:04d}.npz"
    recorded = ck.load_manifest()["crc"][victim_file.name]
    _flip_byte(victim_file)
    assert file_crc32(victim_file) != recorded
    assert_same_tables(resume(C34, tmp_path / "ck"), clean[C34])
    assert (tmp_path / "ck" / (victim_file.name + ".corrupt")).exists()
    ck2 = LevelCheckpointer(tmp_path / "ck")
    assert victim in ck2.completed_levels()  # re-sealed, fresh crc
    assert ck2.load_manifest()["crc"][victim_file.name] == \
        file_crc32(victim_file)


def test_crc_quarantines_corrupt_frontier_and_reexpands(tmp_path, clean):
    ck = LevelCheckpointer(tmp_path / "ck")
    Solver(get_game(C34), device="cpu", checkpointer=ck).solve()
    _flip_byte(tmp_path / "ck" / "frontier_0004.npz")
    assert_same_tables(resume(C34, tmp_path / "ck"), clean[C34])
    assert (tmp_path / "ck" / "frontier_0004.npz.corrupt").exists()
    assert LevelCheckpointer(tmp_path / "ck").load_manifest()[
        "frontiers_complete"]


def test_corrupt_generic_snapshot_is_quarantined(tmp_path, clean):
    spec = "nim:heaps=3-4-5"
    Solver(get_game(spec), device="cpu",
           checkpointer=LevelCheckpointer(tmp_path / "ck")).solve()
    _flip_byte(tmp_path / "ck" / "frontiers.npz", 0.3)
    assert_same_tables(resume(spec, tmp_path / "ck"), clean[spec])
    assert (tmp_path / "ck" / "frontiers.npz.corrupt").exists()


def test_crc_verify_can_be_disabled(tmp_path, monkeypatch):
    ck = LevelCheckpointer(tmp_path / "ck")
    Solver(get_game(C34), device="cpu", checkpointer=ck).solve()
    m = ck.load_manifest()
    m["crc"] = {k: v ^ 1 for k, v in m["crc"].items()}  # every crc wrong
    ck._write_manifest(m)
    monkeypatch.setenv("GAMESMAN_CKPT_VERIFY", "0")
    for k in ck.completed_levels():
        ck.load_level(k)  # unchecked: loads
    # Verified again, through a fresh store (the shared one caches what it
    # loaded): the wrong crc quarantines the level.
    monkeypatch.setenv("GAMESMAN_CKPT_VERIFY", "1")
    fresh = LevelCheckpointer(tmp_path / "ck", store=BlockStore())
    with pytest.raises(ValueError, match="crc32"):
        fresh.load_level(0)
    assert 0 not in fresh.completed_levels()


# ------------------------------------------------------------- preemption


def _arm_preempt_on_fire(monkeypatch, point, visit):
    """Deliver SIGUSR1 to this process at the `visit`th fire of `point`:
    the handler runs before the next bytecode, so the flag is set before
    the next level boundary."""
    state = {"n": 0}
    real_fire = faults.fire

    def firing(p, **kw):
        if p == point:
            state["n"] += 1
            if state["n"] == visit:
                signal.raise_signal(signal.SIGUSR1)
        return real_fire(p, **kw)

    monkeypatch.setattr(faults, "fire", firing)


@pytest.mark.parametrize("spec,point", [
    (C34, "engine.backward"), (C34, "engine.forward"),
    ("nim:heaps=3-4-5", "engine.backward")])
def test_preempt_drains_at_boundary_and_resumes_parity(spec, point, tmp_path,
                                                       clean, monkeypatch):
    ck = LevelCheckpointer(tmp_path / "ck")
    restore = preempt.install_grace_handler()
    _arm_preempt_on_fire(monkeypatch, point, 3)
    try:
        with pytest.raises(preempt.PreemptionRequested, match="boundary"):
            Solver(get_game(spec), device="cpu", checkpointer=ck).solve()
    finally:
        restore()  # also resets the flag and disarms the deadline
    assert not preempt.requested()
    if point == "engine.backward":
        assert len(ck.completed_levels()) == 3  # the levels before the signal
    monkeypatch.undo()
    assert_same_tables(resume(spec, tmp_path / "ck"), clean[spec])


def test_cli_exits_75_on_grace_signal_and_resumes(tmp_path, clean,
                                                  monkeypatch, capsys):
    d = str(tmp_path / "ck")
    _arm_preempt_on_fire(monkeypatch, "engine.backward", 4)
    rc, result = cli.solve_main(["solve", C34, "--device", "cpu",
                                 "--checkpoint-dir", d])
    assert (rc, result) == (75, None)
    err = capsys.readouterr().err
    assert "preempted: grace signal" in err
    # The CLI restored the previous handlers and cleared the flag.
    assert signal.getsignal(signal.SIGUSR1) is not preempt._on_grace_signal
    assert not preempt.requested()
    assert len(LevelCheckpointer(d).completed_levels()) == 4
    monkeypatch.undo()
    rc, result = cli.solve_main(["solve", C34, "--device", "cpu",
                                 "--checkpoint-dir", d])
    assert rc == 0
    assert_same_tables(result, clean[C34])


def test_grace_handler_only_for_checkpointed_solves(monkeypatch):
    installed = []
    monkeypatch.setattr(preempt, "install_grace_handler",
                        lambda: installed.append(1) or (lambda: None))
    assert cli.main(["solve", "subtract:total=10,moves=1-2",
                     "--device", "cpu"]) == 0
    assert installed == []


# ------------------------------------------------- chaos in a subprocess


def _cli(args, fault, tmp_path):
    env = dict(os.environ, GAMESMAN_FAULTS=fault)
    return subprocess.run(
        [sys.executable, "-m", "gamesmanmpi_tpu_torch.cli", "solve", *args,
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)


@pytest.mark.parametrize("spec,fault,code", [
    (C34, "engine.backward:kill:3", 77),
    (C34, "engine.forward:kill:5", 77),
    (C34, "ckpt.save_level:torn:2", 86),
    (C34, "ckpt.save_frontier:torn:4", 86),
    ("nim:heaps=3-4-5", "engine.backward:kill:3", 77),
    ("nim:heaps=3-4-5", "ckpt.save_level:torn:2", 86),
])
def test_chaos_kill_and_torn_resume_to_identical_tables(spec, fault, code,
                                                        tmp_path, clean):
    d = tmp_path / "ck"
    proc = _cli([spec, "--checkpoint-dir", str(d)], fault, tmp_path)
    assert proc.returncode == code, proc.stderr
    assert "[faults] injecting" in proc.stderr
    assert "positions:" not in proc.stdout
    manifest = json.loads((d / "manifest.json").read_text())
    if fault.startswith("engine.backward"):
        assert len(manifest["levels"]) == 2  # sealed before the kill
    if "torn" in fault:
        assert "[faults] tore" in proc.stderr
    assert_same_tables(resume(spec, d), clean[spec])
    if "torn" in fault and "save_level" in fault:
        assert list(d.glob("level_*.npz.corrupt"))


# ------------------------------------------------------ the DB's points


@pytest.mark.parametrize("fault,code", [("store.writebehind:kill:2", 77),
                                        ("store.writebehind:torn:3", 86)])
def test_writebehind_death_leaves_an_unsealed_export(fault, code, tmp_path):
    """A death at store.writebehind (after a level's payload landed, in
    the write-behind worker) leaves a directory without manifest.json,
    which the reader refuses; a rerun with --overwrite is not needed,
    the directory simply exports again."""
    from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader

    d = tmp_path / "db"
    env = dict(os.environ, GAMESMAN_FAULTS=fault)
    argv = [sys.executable, "-m", "gamesmanmpi_tpu_torch.cli", "export-db",
            C34, "--out", str(d), "--device", "cpu"]
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == code, proc.stderr
    assert "[faults] injecting" in proc.stderr
    assert "database written" not in proc.stdout
    assert list(d.glob("level_*.keys.npy"))
    assert not (d / "manifest.json").exists()
    if "torn" in fault:
        assert "[faults] tore" in proc.stderr
    with pytest.raises(DbFormatError, match="never finalized"):
        DbReader(d, device="cpu")
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    with DbReader(d, device="cpu") as r:
        assert r.num_positions == 2715


def test_db_probe_and_block_decode_fire_on_the_reader(tmp_path):
    from gamesmanmpi_tpu_torch.db import DbFormatError, DbReader, DbWriter

    game = get_game(C34)
    for compress in (False, True):
        d = tmp_path / f"db{int(compress)}"
        w = DbWriter(d, game, C34, compress=compress)
        Solver(game, device="cpu", store_tables=False,
               level_sink=w.add_level_table).solve()
        w.finalize()
    init = np.array([game.initial_state()], dtype=game.state_dtype)
    faults.configure("db.probe:fatal:2")
    with DbReader(tmp_path / "db0", device="cpu") as r:
        assert r.lookup(init)[2][0]
        with pytest.raises(FatalFault):  # the second probe
            r.lookup(init)
    faults.configure("serve.block_decode:fatal")
    with DbReader(tmp_path / "db1", device="cpu") as r:
        with pytest.raises(FatalFault):
            r.lookup(init)
    # A decode that fails with an I/O error is a reader fault, never a
    # wrong answer: DbFormatError, as in the reference.
    faults.configure("serve.block_decode:enospc")
    with DbReader(tmp_path / "db1", device="cpu") as r:
        with pytest.raises(DbFormatError, match="unreadable"):
            r.lookup(init + 1)
    faults.clear()
    with DbReader(tmp_path / "db1", device="cpu") as r:
        assert r.lookup(init)[2][0] and r.cache_stats()["misses"] >= 1

