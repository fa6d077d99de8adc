"""BENCHMARK.json against the contract's character rules, and every cell
resolving by name to its files, a throwaway one added as files included."""

import ast
import json
import os
import re
import subprocess
import sys

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_lines_use_allowed_characters():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert all(LINE.match(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("h100bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert LINE.match(m["layer"])
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_each_cell_reports_what_its_layer_metrics_move():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, and each per-layer metric moves an end-to-end
    metric that every cell it lists reports."""
    import run

    for w in spec()["workloads"]:
        r = run.resolve(ROOT, w["name"])
        e2e = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert r["per_layer"]
        assert all(m["moves"] in e2e for m in r["per_layer"]), w["name"]


def test_the_traced_rate_reads_all_the_window():
    """traced_pos_per_s.solve: positions times solves over the window's
    wall time, and nothing where the window solved nothing."""
    import run

    read = run.load_reader(BENCH / "metrics" / "traced_pos_per_s.solve.py")
    ctx = {"solves": 1500, "positions": 69763700, "window_s": 51.0}
    assert read(ctx) == 69763700 * 1500 / 51.0
    assert read(dict(ctx, solves=0)) is None


def test_the_result_line_reports_the_window_per_solve(tmp_path, monkeypatch):
    """solve_ms: the window's time over its solves, in ms, in a CPU run of
    the dense cell at 4x4: every solve of the closed loop counts, a slow
    one as much as the rest."""
    import argparse

    import torch

    import run
    from conftest import small_root

    torch.set_num_threads(2)
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    seen = {}
    drive = run.DRIVERS["solve_loop"]

    def keep(r, args, device):
        seen.update(drive(r, args, device))
        return seen

    monkeypatch.setitem(run.DRIVERS, "solve_loop", keep)
    cell = argparse.Namespace(workload="c4_5x5_dense.solve", seed=2 ** 33 + 1,
                              seconds=1.2, trace=0, rates=None)
    out = run.run_cell(cell, "cpu", root=small_root(tmp_path))
    assert out["correct"], out["checks"]
    ctx = seen["ctx"]
    assert len(ctx["walls"]) == ctx["solves"] >= 2
    assert sum(ctx["walls"]) <= ctx["window_s"]
    assert out["metrics"]["solve_ms"] == {
        "value": 1e3 * ctx["window_s"] / ctx["solves"], "unit": "ms"}
    assert set(out["metrics"]) == {"setup_s", "solve_ms",
                                   "solve_peak_mem_gib"}


def test_every_cell_resolves_to_its_files(tmp_path):
    """The listed cells, and the unlisted ones once entered."""
    import run
    from conftest import small_root, with_unlisted_cells

    root = with_unlisted_cells(small_root(tmp_path))
    names = json.loads((root / "BENCHMARK.json").read_text())["workloads"]
    assert len(names) == len(spec()["workloads"]) + 3
    for w in names:
        r = run.resolve(root, w["name"])
        assert r["config"]["name"] == w["config"]
        assert r["mix"]["kind"] in run.DRIVERS
        assert {"setup_s"} <= {m["name"] for m in r["end_to_end"]}
        assert r["per_layer"] and all(p.exists()
                                      for p in r["readers"].values())


def test_a_cell_added_as_files_runs_without_edits(tmp_path, monkeypatch):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file of its own, plus their entries in BENCHMARK.json, and no file
    that was there edited: the configuration sets a deployment option
    that is not the default (the classic engine's pingpong pipeline, by
    its environment variable) and keyword arguments, and a run of the
    cell on the CPU solves with them and reads the new metric."""
    import argparse

    import torch

    import run
    from conftest import small_root

    import devtrace

    class NoDeviceTrace:  # the CPU has no device activity to trace
        def __init__(self, scratch):
            pass

        start = stop = summary = lambda self: None

    torch.set_num_threads(2)
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    monkeypatch.delenv("GAMESMAN_PIPELINE", raising=False)
    monkeypatch.setattr(devtrace, "DeviceTrace", NoDeviceTrace)
    root = small_root(tmp_path)
    bench = root / "h100bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "c4_4x4_pingpong.json").write_text(json.dumps(
        {"name": "c4_4x4_pingpong", "game": "connect4:w=4,h=4",
         "solver": {"call": "gamesmanmpi_tpu_torch.solve.engine:Solver",
                    "kwargs": {"store_tables": True, "paranoid": True}},
         "env": {"GAMESMAN_PIPELINE": "pingpong"}}))
    (bench / "traffic" / "solve_pair.json").write_text(json.dumps(
        {"kind": "solve_loop", "warmup_solves": 1}))
    (bench / "workloads" / "c4_4x4_pingpong.pair.json").write_text(
        json.dumps({"name": "c4_4x4_pingpong.pair",
                    "config": "c4_4x4_pingpong", "traffic": "solve_pair",
                    "chips": 1, "why": "a throwaway"}))
    (bench / "metrics" / "pingpong_share.pair.py").write_text(
        "def read(ctx):\n"
        "    s = ctx['stats']\n"
        "    return 100.0 * sum(x['pipeline'] == 'pingpong' for x in s)"
        " / len(s)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "c4_4x4_pingpong", "source": "a test",
                         "file": "h100bench/configs/c4_4x4_pingpong.json",
                         "reduced": [], "why": "a throwaway"})
    b["workloads"].append({"name": "c4_4x4_pingpong.pair",
                           "config": "c4_4x4_pingpong",
                           "traffic": "solve_pair", "chips": 1,
                           "why": "a throwaway"})
    b["per_layer"].append({"name": "pingpong_share.pair", "unit": "%",
                           "better": "higher", "source": "program_span",
                           "layer": "classic level loop",
                           "moves": "solve_peak_mem_gib",
                           "workloads": ["c4_4x4_pingpong.pair"]})
    next(m for m in b["end_to_end"] if m["name"] == "solve_peak_mem_gib")[
        "workloads"].append("c4_4x4_pingpong.pair")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    r = run.resolve(root, "c4_4x4_pingpong.pair")
    assert r["mix"]["kind"] == "solve_loop"
    assert [m["name"] for m in r["per_layer"]] == ["pingpong_share.pair"]
    assert {m["name"] for m in r["end_to_end"]} == {"setup_s",
                                                    "solve_peak_mem_gib"}
    cell = argparse.Namespace(workload="c4_4x4_pingpong.pair", seed=2 ** 33,
                              seconds=0.5, trace=1, rates=None)
    out = run.run_cell(cell, "cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"pingpong_share.pair": {"value": 100.0,
                                                      "unit": "%"}}
    assert "GAMESMAN_PIPELINE" not in os.environ  # put back after the run
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed


def test_config_values_build_program_objects(tmp_path):
    """A config's {"call": ...} builds the program's own objects, with
    "{cache}" the cell's cache directory; other modules are refused."""
    import pytest

    import run
    from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

    spec = {"checkpointer": {
        "call": "gamesmanmpi_tpu_torch.utils.checkpoint:LevelCheckpointer",
        "args": ["{cache}/ckpt"]}, "n": [1, "x"]}
    built = run.build(spec, tmp_path)
    assert isinstance(built["checkpointer"], LevelCheckpointer)
    assert built["checkpointer"].dir == tmp_path / "ckpt"
    assert built["n"] == [1, "x"]
    for bad in ("os:getcwd", "gamesmanmpi_tpu.solve:Solver",
                "gamesmanmpi_tpu_torch.solve.engine"):
        with pytest.raises(run.CellError):
            run.program_attr(bad)


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    import run

    for name in ("gamesmanmpi_tpu_torch", "gamesmanmpi_tpu_torch.cli",
                 "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not {"gamesmanmpi_tpu", "jax"} & set(run.forbidden_modules())
    for name in ("gamesmanmpi_tpu", "gamesmanmpi_tpu.solve", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == ["gamesmanmpi_tpu", "jax"]


def test_no_harness_module_imports_jax_or_the_jax_package():
    """Every import in the benchmark's files, top-level names compared
    whole: gamesmanmpi_tpu_torch passes, gamesmanmpi_tpu would not."""
    import run

    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(run.FORBIDDEN), (path, tops)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference, work, "
            "loadgen, control; bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('gamesmanmpi_tpu_torch', 'gamesmanmpi_tpu',"
            " 'jax')); print(bad); sys.exit(1 if bad else 0)" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
