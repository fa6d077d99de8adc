"""Self-healing solve campaigns and the checkpointer's retention GC on the
torch port, against the JAX package (the reference's
tests/test_campaign.py, on the port).

* Units: ``classify`` on the reference's cause table and the oom texts
  (torch's CUDA allocator included), ``progress_score`` across the
  forward/backward seam, ``checkpoint_progress`` on a missing or torn
  manifest and on directories either package wrote (equal dicts), and
  the oom, lost-rank and infeasible-revert policies, whose ledger
  records, solver args and attempt env equal the reference campaign's.
* The campaign process imports no torch, nor does parallel/launch.py
  (parallel/__init__.py loads the engine lazily).
* Retention GC: on classic (tictactoe) and 2-shard (connect4 3x3)
  directories written by either package, with strays planted,
  ``artifact_kind``, ``disk_usage``, ``referenced_files`` and
  ``quarantine_inventory`` equal the reference's, ``gc_superseded`` frees
  the same files, and both packages resume the collected directory to
  the uninterrupted tables.
* The command line (``python -m gamesmanmpi_tpu_torch.resilience.campaign``):
  usage errors, the disk floor's exit 4 before any attempt, a kill
  campaign whose ledger equals tools/run_campaign.py's on the same
  schedule, SIGTERM -> 75 -> rerun, a dense campaign killed after a seal,
  a 2-process world with rank 0 killed (resumed as a world, or at one
  rank with --elastic-ranks), and an oom campaign that escalates a
  2-shard solve to 4 shards and resumes with a reshard.

Integers, dicts and bytes throughout: no tolerance.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.obs import MetricsRegistry as JaxRegistry
from gamesmanmpi_tpu.parallel import ShardedSolver as JaxShardedSolver
from gamesmanmpi_tpu.resilience import campaign as ref
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu.utils.checkpoint import LevelCheckpointer as JaxCkpt
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.obs import MetricsRegistry
from gamesmanmpi_tpu_torch.parallel import ShardedSolver
from gamesmanmpi_tpu_torch.resilience import campaign
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.resilience.campaign import (
    DISK_FLOOR_EXIT_CODE,
    Campaign,
    CampaignConfig,
    checkpoint_progress,
    progress_score,
)
from gamesmanmpi_tpu_torch.solve.engine import Solver
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

from helpers import REPO, full_table

torch.set_num_threads(1)

C3 = "connect4:w=3,h=3,connect=3"
CAMPAIGN = [sys.executable, "-m", "gamesmanmpi_tpu_torch.resilience.campaign"]
REF_CAMPAIGN = [sys.executable, os.path.join(REPO, "tools", "run_campaign.py")]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def child_env(**extra):
    env = dict(os.environ)
    env.pop("GAMESMAN_FAULTS", None)
    env["GAMESMAN_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    # The tests hold policy, not patience.
    env["GAMESMAN_CAMPAIGN_BACKOFF_BASE_SECS"] = "0.05"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_campaign(args, timeout=300, **env):
    return subprocess.run(CAMPAIGN + list(args), capture_output=True,
                          text=True, timeout=timeout, env=child_env(**env),
                          cwd=str(REPO))


def ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def phases(records):
    return [r["phase"] for r in records]


# ------------------------------------------------------------------ units


def test_exit_codes_and_markers_are_the_references():
    assert campaign.CAMPAIGN_EXIT_CODES == ref.CAMPAIGN_EXIT_CODES
    assert set(campaign.CAMPAIGN_EXIT_CODES) == {0, 2, 3, 4, 75}
    for name in ("ENOSPC_MARKERS", "OOM_MARKERS", "MESH_INFEASIBLE_MARKER",
                 "LOST_RANK_CAUSES", "LOG_TAIL_BYTES", "SOLVED_EXIT_CODE",
                 "USAGE_EXIT_CODE", "NO_PROGRESS_EXIT_CODE",
                 "DISK_FLOOR_EXIT_CODE"):
        assert getattr(campaign, name) == getattr(ref, name), name


@pytest.mark.parametrize("rcs,tails,cause", [
    ({0: 0, 1: 0}, {}, "complete"),
    ({0: 77, 1: 124}, {}, "killed"),
    ({0: 86}, {}, "torn_kill"),
    ({0: 75, 1: 124}, {}, "preempted"),
    ({0: 124, 1: 124}, {}, "deadline_abort"),
    ({0: 1}, {"a": "OSError: [Errno 28] No space left on device"}, "enospc"),
    ({0: None}, {}, "timeout"),
    ({0: -9}, {}, "signal"),
    ({0: 1}, {"a": "traceback"}, "crash"),
    ({0: 1}, {"a": "MemoryError: injected oom (RESOURCE_EXHAUSTED: out of "
              "memory)"}, "oom"),
    ({0: 1}, {"a": "out of memory: host RSS 900 MiB exceeds ... "
              "progress: {}"}, "oom"),
    ({0: 1}, {"a": "torch.OutOfMemoryError: CUDA out of memory. Tried to "
              "allocate 2.00 GiB (GPU 0; 79.11 GiB total capacity)"}, "oom"),
    ({0: 1}, {"a": "OSError: [Errno 12] Cannot allocate memory"}, "oom"),
    ({0: 1}, {"a": "ValueError: requested 8 shards but only 4 devices"},
     "crash"),
])
def test_classify_causes(rcs, tails, cause):
    assert Campaign.classify(rcs, tails) == cause
    assert ref.Campaign.classify(rcs, tails) == cause


def test_progress_score_monotone_across_consolidation():
    forward_mid = {"solved_levels": [], "forward_levels": 5,
                   "frontiers_complete": False, "dense_levels": 0}
    forward_more = dict(forward_mid, forward_levels=7)
    consolidated = {"solved_levels": [], "forward_levels": 0,
                    "frontiers_complete": True, "dense_levels": 0}
    backward_mid = dict(consolidated, solved_levels=[9, 8])
    quarantined = dict(backward_mid, solved_levels=[9])
    chain = [forward_mid, forward_more, consolidated, backward_mid]
    for a, b in zip(chain, chain[1:]):
        assert progress_score(b) > progress_score(a)
    assert progress_score(quarantined) < progress_score(backward_mid)
    for p in chain + [quarantined]:
        assert progress_score(p) == ref.progress_score(p)


def test_checkpoint_progress_tolerates_missing_and_torn_manifest(tmp_path):
    p = checkpoint_progress(tmp_path / "nope")
    assert p["solved_levels"] == [] and p["deepest_solved"] is None
    assert p == ref.checkpoint_progress(tmp_path / "nope")
    d = tmp_path / "torn"
    d.mkdir()
    (d / "manifest.json").write_text('{"levels": [1, 2')
    assert checkpoint_progress(d)["solved_levels"] == []
    assert checkpoint_progress(d) == ref.checkpoint_progress(d)


def _imports_no_torch(*modules):
    code = "".join(f"import {m}\n" for m in modules) + (
        "import sys\nassert 'torch' not in sys.modules, 'torch imported'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr


def test_campaign_import_loads_no_torch():
    """The campaign and the registry stay torch-free at import: a parent
    holding CUDA would tax every attempt."""
    _imports_no_torch("gamesmanmpi_tpu_torch.resilience.campaign",
                      "gamesmanmpi_tpu_torch.registry")


def test_parallel_launch_loads_no_torch():
    """parallel/__init__.py loads the engine lazily: the world launcher a
    campaign imports brings no torch, while the engine's names still
    resolve from the package."""
    _imports_no_torch("gamesmanmpi_tpu_torch.parallel.launch")
    from gamesmanmpi_tpu_torch import parallel
    from gamesmanmpi_tpu_torch.parallel.mesh import make_mesh

    assert parallel.ShardedSolver is ShardedSolver
    assert parallel.make_mesh is make_mesh
    with pytest.raises(AttributeError):
        parallel.no_such_name  # noqa: B018


def test_flat_grammar_solves_as_solve_does(capsys):
    """A campaign attempt runs `python -m gamesmanmpi_tpu_torch GAME ...`
    (the reference's solve_launcher.py grammar): the same report as
    `solve GAME`; `-h` stays the top-level help."""
    from gamesmanmpi_tpu_torch import cli

    def report(argv):
        assert cli.main(argv) == 0
        return [ln for ln in capsys.readouterr().out.splitlines()
                if not ln.startswith(("elapsed:", "throughput:"))]

    flat = report(["nim:heaps=3-4-5", "--device", "cpu"])
    assert flat == report(["solve", "nim:heaps=3-4-5", "--device", "cpu"])
    assert "value: WIN" in flat and "positions: 120" in flat
    with pytest.raises(SystemExit) as e:
        cli.main(["-h"])
    assert e.value.code == 0
    assert "registry" in capsys.readouterr().out


# ---------------------------------------------- policies against the JAX


def _pair(tmp_path, solver_args, **kw):
    """The port's and the reference's Campaign on the same config."""
    out = []
    for mod, tag in ((campaign, "port"), (ref, "ref")):
        cfg = mod.CampaignConfig(solver_args=list(solver_args),
                                 checkpoint_dir=str(tmp_path / tag / "ck"),
                                 **kw)
        out.append(mod.Campaign(cfg, echo=lambda m: None))
    return out


def _records(c):
    if not os.path.exists(c.cfg.ledger_path):
        return []
    return [{k: v for k, v in r.items() if k != "wall_time"}
            for r in ledger(c.cfg.ledger_path)]


def _assert_same_state(port, refc, attempt):
    for attr in ("_shards", "_shards0", "_cache_mb", "_processes",
                 "_local_devices", "_geometry_dirty"):
        assert getattr(port, attr) == getattr(refc, attr), attr
    strip = lambda a, c: a[:-1] if a[-1] == c.cfg.checkpoint_dir else a  # noqa: E731
    assert strip(port._solver_args(), port) == strip(refc._solver_args(),
                                                    refc)
    keys = ("GAMESMAN_FAKE_DEVICES", "GAMESMAN_STORE_CACHE_MB",
            "GAMESMAN_NUM_PROCESSES", "GAMESMAN_FAULTS",
            "GAMESMAN_FAULTS_RANK_0")
    pe, re_ = port._attempt_env(attempt), refc._attempt_env(attempt)
    assert {k: pe.get(k) for k in keys} == {k: re_.get(k) for k in keys}
    assert _records(port) == _records(refc)


def test_oom_policy_escalates_shards_and_shrinks_cache(tmp_path):
    port, refc = _pair(tmp_path, [C3, "--devices", "2"], max_shards=8,
                       cache_floor_mb=32)
    for attempt in (1, 2, 3):
        port._apply_policy("oom", attempt)
        refc._apply_policy("oom", attempt)
        _assert_same_state(port, refc, attempt + 1)
    assert port._shards == 8 and port._cache_mb == 32
    env = port._attempt_env(4)
    assert env["GAMESMAN_FAKE_DEVICES"] == "8"
    records = _records(port)
    assert [(r["from_shards"], r["to_shards"]) for r in records] == [
        (2, 4), (4, 8), (8, 8)]


def test_oom_policy_respects_opt_out_and_missing_devices(tmp_path):
    port, refc = _pair(tmp_path / "a", [C3, "--devices", "2"],
                       oom_escalate=False)
    port._apply_policy("oom", 1)
    refc._apply_policy("oom", 1)
    _assert_same_state(port, refc, 2)
    assert port._shards == 2 and port._cache_mb is None
    port, refc = _pair(tmp_path / "b", ["tictactoe"])
    port._apply_policy("oom", 1)
    refc._apply_policy("oom", 1)
    _assert_same_state(port, refc, 2)
    assert port._shards is None and port._cache_mb is not None


def test_lost_rank_policy_is_opt_in_and_steps_world_down(tmp_path):
    port, refc = _pair(tmp_path / "a", [C3, "--devices", "4"], processes=3,
                       local_devices=2, elastic_ranks=True)
    for attempt, cause in enumerate(("killed", "deadline_abort", "signal"),
                                    start=1):
        port._apply_policy(cause, attempt)
        refc._apply_policy(cause, attempt)
        _assert_same_state(port, refc, attempt + 1)
    assert port._processes == 1 and port._local_devices == 4
    assert "GAMESMAN_NUM_PROCESSES" not in port._attempt_env(4)
    port, refc = _pair(tmp_path / "b", [C3], processes=2)
    port._apply_policy("killed", 1)
    refc._apply_policy("killed", 1)
    _assert_same_state(port, refc, 2)
    assert port._processes == 2


def test_infeasible_escalation_reverts_shards(tmp_path):
    """An escalation past the devices this host holds dies at mesh
    construction with parallel/mesh.py's message (the reference's words),
    and steps back down to the original request, as in the reference."""
    tail = "ValueError: requested 8 shards but only 4 devices"
    port, refc = _pair(tmp_path, [C3, "--devices", "2"])
    for c in (port, refc):
        c._apply_policy("oom", 1)
        c._apply_policy("oom", 2)
    assert port._shards == 8
    for attempt in (3, 4, 5):
        port._maybe_revert_shards("crash", tail, attempt)
        refc._maybe_revert_shards("crash", tail, attempt)
        _assert_same_state(port, refc, attempt + 1)
    assert port._shards == 2 and port._cache_mb is not None
    for c in (port, refc):
        c._apply_policy("oom", 6)
        c._maybe_revert_shards("crash", "unrelated traceback", 7)
    _assert_same_state(port, refc, 8)
    reverts = [r for r in _records(port) if r.get("cause") == "infeasible"]
    assert [(r["from_shards"], r["to_shards"]) for r in reverts] == [
        (8, 4), (4, 2)]


# ------------------------------------------- retention GC against the JAX


def _write(pkg, spec, d):
    """A directory killed mid-backward by `pkg` ("port" or "ref"):
    classic for tictactoe, 2 shards for connect4 3x3."""
    sharded = spec == C3
    point = ("sharded" if sharded else "engine") + ".backward:fatal:3"
    if pkg == "port":
        faults.configure(point)
        ck = LevelCheckpointer(d)
        solver = (ShardedSolver(get_game(spec), num_shards=2, device="cpu",
                                checkpointer=ck) if sharded
                  else Solver(get_game(spec), device="cpu", checkpointer=ck))
        with pytest.raises(faults.FatalFault):
            solver.solve()
        faults.clear()
    else:
        ref_faults.configure(point)
        ck = JaxCkpt(d)
        solver = (JaxShardedSolver(jax_get_game(spec), num_shards=2,
                                   checkpointer=ck) if sharded
                  else JaxSolver(jax_get_game(spec), checkpointer=ck))
        with pytest.raises(ref_faults.FatalFault):
            solver.solve()
        ref_faults.clear()


def _plant(d):
    """Every superseded class the GC reclaims, plus a file it must keep."""
    (d / "level_0099.npz.corrupt").write_bytes(b"x" * 64)
    (d / "frontier_0042.shard_0000.npz").write_bytes(b"y" * 64)
    (d / f"level_0001.{os.getpid()}.tmp.npz").write_bytes(b"z")
    (d / "edges_0077.shard_0003.npz").write_bytes(b"e" * 32)
    (d / "notes.txt").write_text("operator notes")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{(writer, spec): directory}, each killed mid-backward, strays
    planted; plus the uninterrupted tables of both games."""
    root = tmp_path_factory.mktemp("gc")
    out = {}
    for pkg in ("port", "ref"):
        for spec in ("tictactoe", C3):
            d = root / f"{pkg}-{spec.split(':')[0]}"
            _write(pkg, spec, d)
            _plant(d)
            out[(pkg, spec)] = d
    clean = {spec: full_table(Solver(get_game(spec), device="cpu").solve())
             for spec in ("tictactoe", C3)}
    return out, clean


def _files(d):
    return {p.name: p.stat().st_size for p in d.iterdir() if p.is_file()}


def test_checkpoint_progress_equal_on_either_packages_tree(trees):
    dirs, _ = trees
    for spec in ("tictactoe", C3):
        port_dir, ref_dir = dirs[("port", spec)], dirs[("ref", spec)]
        for d in (port_dir, ref_dir):
            assert checkpoint_progress(d) == ref.checkpoint_progress(d)
        a, b = checkpoint_progress(port_dir), checkpoint_progress(ref_dir)
        assert a == b, spec
        assert a["solved_levels"] and a["frontiers_complete"]
        assert a["shards"] == (2 if spec == C3 else None)


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("spec", ["tictactoe", C3])
def test_gc_parity_and_resume(trees, tmp_path, writer, spec):
    dirs, clean = trees
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(dirs[(writer, spec)], a)
    shutil.copytree(dirs[(writer, spec)], b)
    pck, rck = LevelCheckpointer(a), JaxCkpt(b)
    for name in sorted(_files(a)):
        assert (LevelCheckpointer.artifact_kind(name)
                == JaxCkpt.artifact_kind(name)), name
    assert pck.referenced_files() == rck.referenced_files()
    assert pck.quarantine_inventory() == rck.quarantine_inventory()
    assert pck.quarantine_inventory() == [
        {"file": "level_0099.npz.corrupt", "bytes": 64}]
    preg, rreg = MetricsRegistry(), JaxRegistry()
    assert pck.disk_usage(registry=preg) == rck.disk_usage(registry=rreg)
    kinds = {row["labels"]["kind"]: row["value"]
             for row in preg.snapshot()["gamesman_ckpt_bytes"]["values"]}
    assert kinds["corrupt"] == 64.0 and kinds["tmp"] > 0
    freed_p = pck.gc_superseded(registry=MetricsRegistry())
    freed_r = rck.gc_superseded(registry=JaxRegistry())
    assert freed_p == freed_r
    assert _files(a) == _files(b)
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    assert "notes.txt" in _files(a)
    assert not list(a.glob("*.corrupt")) and not list(a.glob("*.tmp*"))
    assert set(freed_p["kinds"]) >= {"corrupt", "frontier", "tmp", "edges"}
    if spec == C3:  # the solved levels' edges were consumed
        manifest = json.loads((a / "manifest.json").read_text())
        solved = {int(k) for k in manifest["sharded_levels"]}
        assert not solved & {int(k) for k in manifest.get("edge_levels", {})}
    # Both packages resume the collected tree to the uninterrupted tables.
    if spec == C3:
        got = ShardedSolver(get_game(spec), num_shards=2, device="cpu",
                            checkpointer=LevelCheckpointer(a)).solve()
        want = JaxShardedSolver(jax_get_game(spec), num_shards=2,
                                checkpointer=JaxCkpt(b)).solve()
    else:
        got = Solver(get_game(spec), device="cpu",
                     checkpointer=LevelCheckpointer(a)).solve()
        want = JaxSolver(jax_get_game(spec), checkpointer=JaxCkpt(b)).solve()
    assert full_table(got) == clean[spec]
    assert full_table(want) == clean[spec]


def test_enospc_death_runs_gc_and_the_floor_after_it(trees, tmp_path):
    """An ENOSPC death GCs the tree (a campaign_gc record with what the
    checkpointer freed), and the hard floor is evaluated after the GC."""
    dirs, _ = trees
    ck = tmp_path / "ck"
    shutil.copytree(dirs[("ref", "tictactoe")], ck)
    c = Campaign(CampaignConfig(solver_args=["tictactoe"],
                                checkpoint_dir=str(ck)), echo=lambda m: None)
    c._check_disk(had_enospc=True)
    (gc,) = [r for r in ledger(c.cfg.ledger_path)
             if r["phase"] == "campaign_gc"]
    assert gc["reason"] == "enospc" and gc["freed_files"] == 4
    assert gc["quarantined"] == [{"file": "level_0099.npz.corrupt",
                                  "bytes": 64}]
    c.cfg.disk_floor_mb = 1e12
    with pytest.raises(campaign.CampaignAborted) as e:
        c._check_disk(had_enospc=False)
    assert e.value.code == DISK_FLOOR_EXIT_CODE


# ------------------------------------------------------ the command line


def test_campaign_help_and_usage_errors(tmp_path):
    out = subprocess.run(CAMPAIGN + ["--help"], capture_output=True,
                         text=True, timeout=60, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    for flag in ("--checkpoint-dir", "--chaos", "--status-port",
                 "--processes", "--local-devices"):
        assert flag in out.stdout
    assert run_campaign(["tictactoe"]).returncode == 2
    ck = str(tmp_path / "x")
    assert run_campaign(["tictactoe", "--checkpoint-dir", ck,
                         "--processes", "0"]).returncode == 2
    assert run_campaign(["tictactoe", "--checkpoint-dir", ck, "--",
                         "--checkpoint-dir", "/tmp/y"]).returncode == 2


def test_disk_floor_aborts_before_any_attempt(tmp_path):
    ck = tmp_path / "ck"
    out = run_campaign(["tictactoe", "--checkpoint-dir", str(ck),
                        "--disk-floor-mb", str(10 ** 9), "--", "--device",
                        "cpu"])
    assert out.returncode == DISK_FLOOR_EXIT_CODE, out.stderr[-2000:]
    records = ledger(ck / "campaign.jsonl")
    assert "campaign_attempt" not in phases(records)
    assert records[-1]["phase"] == "campaign_abort"
    assert records[-1]["code"] == DISK_FLOOR_EXIT_CODE
    bundle = json.loads((ck / "campaign_diagnosis.json").read_text())
    assert bundle["attempts"] == 0 and bundle["progress"]["solved_levels"] == []


def _attempt_rows(records):
    return [(r["phase"], r.get("attempt"), r.get("cause"),
             r.get("progressed"), r.get("solved_before"),
             r.get("solved_after")) for r in records
            if r["phase"] != "campaign_backoff"]


def test_kill_campaign_ledger_equals_the_references(tmp_path):
    """tictactoe with an injected kill in attempt 1's forward: both
    campaigns (run side by side) resume to completion, and the ledgers
    agree in phase, attempt, cause and progress."""
    port_ck, ref_ck = tmp_path / "port", tmp_path / "ref"
    chaos = ["--chaos", "engine.forward:kill:1"]
    procs = [
        subprocess.Popen(CAMPAIGN + ["tictactoe", "--checkpoint-dir",
                                     str(port_ck), *chaos, "--", "--device",
                                     "cpu"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=child_env(), cwd=str(REPO)),
        subprocess.Popen(REF_CAMPAIGN + ["tictactoe", "--checkpoint-dir",
                                         str(ref_ck), *chaos],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=child_env(), cwd=str(REPO)),
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    port, refl = ledger(port_ck / "campaign.jsonl"), ledger(
        ref_ck / "campaign.jsonl")
    assert _attempt_rows(port) == _attempt_rows(refl)
    assert [r["cause"] for r in port if r["phase"] == "campaign_attempt"] \
        == ["killed", "complete"]
    assert port[0]["solver_args"] == ["tictactoe", "--device", "cpu",
                                      "--checkpoint-dir", str(port_ck)]
    # The killed attempt left its flight-recorder boundary dump and the
    # campaign's own dump of the death in the log dir.
    logs = port_ck / "logs"
    assert (logs / "flightrec_campaign.json").exists()
    assert "TIE" in (logs / "attempt_002.out").read_text()


def test_sigterm_preempts_with_75_and_the_rerun_completes(tmp_path):
    ck = tmp_path / "ck"
    argv = CAMPAIGN + ["tictactoe", "--checkpoint-dir", str(ck), "--chaos",
                       "engine.backward:delay=0.4:always", "--", "--device",
                       "cpu"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=child_env(), cwd=str(REPO))
    try:
        deadline = time.monotonic() + 120
        while not checkpoint_progress(ck)["solved_levels"]:
            assert time.monotonic() < deadline, "no level sealed"
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, err[-3000:]
    records = ledger(ck / "campaign.jsonl")
    attempt = [r for r in records if r["phase"] == "campaign_attempt"][-1]
    assert attempt["cause"] == "preempted" and attempt["rcs"] == {"0": 75}
    assert records[-1]["phase"] == "campaign_preempted"
    sealed = checkpoint_progress(ck)["solved_levels"]
    out = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                         env=child_env(), cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    rerun = [r for r in ledger(ck / "campaign.jsonl")
             if r["phase"] == "campaign_attempt"][-1]
    assert rerun["cause"] == "complete"
    assert rerun["solved_before"] == len(sealed)
    assert checkpoint_progress(ck)["solved_levels"] == list(range(10))


def test_dense_campaign_killed_after_a_seal(tmp_path):
    """The port visits ckpt.save_level after each dense seal (the
    reference fires no point there), so a dense campaign's chaos kills
    attempt 1 after its 3rd sealed level; attempt 2 resumes those levels,
    reports its gather launches (0 on the CPU: the plain version), and
    every sealed level holds the uninterrupted solve's cells."""
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
    from gamesmanmpi_tpu_torch.store import read_npz_members

    ck, jsonl = tmp_path / "ck", tmp_path / "solve.jsonl"
    out = run_campaign([C3, "--checkpoint-dir", str(ck), "--chaos",
                        "ckpt.save_level:kill:3", "--", "--engine", "dense",
                        "--device", "cpu", "--jsonl", str(jsonl)])
    assert out.returncode == 0, out.stderr[-3000:]
    records = ledger(ck / "campaign.jsonl")
    assert [r["cause"] for r in records
            if r["phase"] == "campaign_attempt"] == ["killed", "complete"]
    done = [r for r in ledger(jsonl) if r["phase"] == "done"][-1]
    assert done["levels_resumed"] == 3 and done["gather_launches"] == 0
    clean = DenseSolver(get_game(C3), device="cpu").solve()
    for level, cells in clean.cells.items():
        (got,) = read_npz_members(ck / f"dense_{level:04d}.npz", ("cells",))
        assert got.tobytes() == cells.tobytes(), level


@pytest.mark.parametrize("elastic", [False, True], ids=["world", "elastic"])
def test_world_campaign_kill_resumes(tmp_path, elastic):
    """A 2-process world (parallel/launch.py) with rank 0 killed in the
    backward: the peer ends with the coordinated abort (124), the cause is
    the kill, and the next attempt completes, as a world again or, with
    --elastic-ranks, at one rank (the tree reshards on resume)."""
    ck = tmp_path / "ck"
    out = run_campaign([C3, "--checkpoint-dir", str(ck), "--processes", "2",
                        "--chaos", "sharded.backward:kill:2",
                        *(["--elastic-ranks"] if elastic else []), "--",
                        "--device", "cpu", "--devices", "2"],
                       GAMESMAN_BARRIER_SECS=10)
    assert out.returncode == 0, out.stderr[-3000:]
    records = ledger(ck / "campaign.jsonl")
    attempts = [r for r in records if r["phase"] == "campaign_attempt"]
    assert [(r["cause"], r["rcs"]) for r in attempts] == [
        ("killed", {"0": 77, "1": 124}),
        ("complete", {"0": 0} if elastic else {"0": 0, "1": 0})]
    degrade = [r for r in records if r["phase"] == "campaign_degrade"]
    if elastic:
        assert [(r["from_processes"], r["to_processes"]) for r in degrade] \
            == [(2, 1)]
        assert "TIE" in (ck / "logs" / "attempt_002.out").read_text()
    else:
        assert not degrade
        logs = list((ck / "logs" / "attempt_002").glob("rank0_*.out"))
        assert "TIE" in logs[0].read_text()
    assert checkpoint_progress(ck)["solved_levels"] == list(range(10))


def test_oom_campaign_escalates_two_shards_to_four(tmp_path):
    """Attempt 1 (2 shards) dies oom in the backward; the next runs at 4
    shards with GAMESMAN_FAKE_DEVICES=4 and the store cache halved,
    resumes the 2-shard tree by resharding, and solves."""
    ck = tmp_path / "ck"
    jsonl = tmp_path / "solve.jsonl"
    table = tmp_path / "T.npz"
    out = run_campaign([C3, "--checkpoint-dir", str(ck), "--chaos",
                        "sharded.backward:oom:2", "--", "--device", "cpu",
                        "--devices", "2", "--jsonl", str(jsonl),
                        "--table-out", str(table)],
                       GAMESMAN_FAKE_DEVICES=2, GAMESMAN_CKPT_COMPRESS=0)
    assert out.returncode == 0, out.stderr[-3000:]
    records = ledger(ck / "campaign.jsonl")
    (resh,) = [r for r in records if r["phase"] == "campaign_reshard"]
    assert (resh["cause"], resh["from_shards"], resh["to_shards"]) == (
        "oom", 2, 4)
    assert resh["to_cache_mb"] == resh["from_cache_mb"] // 2
    attempts = [r for r in records if r["phase"] == "campaign_attempt"]
    assert [r["cause"] for r in attempts] == ["oom", "complete"]
    assert attempts[1]["shards"] == 4 and attempts[1]["sealed_shards"] == 2
    reshard = [r for r in ledger(jsonl) if r.get("phase") == "reshard"]
    assert reshard and reshard[-1]["from_shards"] == [2]
    assert reshard[-1]["to_shards"] == 4
    import numpy as np

    clean = tmp_path / "clean.npz"
    from gamesmanmpi_tpu_torch.utils.checkpoint import save_result_npz

    save_result_npz(clean, ShardedSolver(get_game(C3), num_shards=2,
                                         device="cpu").solve())
    with np.load(table) as got, np.load(clean) as want:
        assert sorted(got.files) == sorted(want.files)
        for f in want.files:
            assert got[f].tobytes() == want[f].tobytes(), f
