"""The torch port as a package: its CLI against the JAX CLI, its import
boundary, its device policy, its kernel build and chip_smoke.py's refusal
to run without a card."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.games import Connect4, get_game
from gamesmanmpi_tpu_torch.kernels import build
from gamesmanmpi_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: initial position, one drop in column 0, a garbage position (both
#: players have a column of three), no guard bits, not a number.
QUERIES = ["0x111", "0x112", "0x18F", "0", "zz"]


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _report_lines(lines):
    keep = ("game:", "devices:", "positions:", "value:", "remoteness:",
            "query ")
    return [ln for ln in lines if ln.startswith(keep)]


@pytest.mark.parametrize("engine", ["dense", "classic"])
@pytest.mark.parametrize("spec", ["connect4:w=3,h=3,connect=3",
                                  "connect4:w=3,h=4,connect=3"])
def test_report_matches_reference_cli(spec, engine):
    qargs = [a for q in QUERIES for a in ("--query", q)]
    rc_j, ref = _run(jax_cli.main, ["solve", spec, "--engine", engine,
                                    *qargs])
    rc_t, got = _run(cli.main, ["solve", spec, "--device", "cpu",
                                "--engine", engine, *qargs])
    assert rc_j == rc_t == 0
    assert _report_lines(got) == _report_lines(ref)
    assert len(_report_lines(got)) == 5 + len(QUERIES)
    assert [ln.split(":")[0] for ln in got[5:7]] == ["elapsed", "throughput"]


def test_import_and_cpu_solve_leave_jax_out():
    code = (
        "import sys\n"
        "import gamesmanmpi_tpu_torch\n"
        "from gamesmanmpi_tpu_torch.cli import main\n"
        "assert main(['solve', 'connect4:w=3,h=3,connect=3',"
        " '--device', 'cpu', '--engine', 'dense']) == 0\n"
        "assert main(['solve', 'nim:heaps=3-4-5', '--device', 'cpu']) == 0\n"
        "import gamesmanmpi_tpu_torch.bench.microbench2\n"
        "import gamesmanmpi_tpu_torch.compress, gamesmanmpi_tpu_torch.store\n"
        "import gamesmanmpi_tpu_torch.resilience.faults\n"
        "import gamesmanmpi_tpu_torch.resilience.preempt\n"
        "import gamesmanmpi_tpu_torch.core.hashing\n"
        "import gamesmanmpi_tpu_torch.core.probe\n"
        "import gamesmanmpi_tpu_torch.utils.checkpoint\n"
        "import tempfile\n"
        "d = tempfile.mkdtemp()\n"
        "assert main(['solve', 'tictactoe', '--device', 'cpu',"
        " '--checkpoint-dir', d, '--no-tables', '--query', '0x1']) == 0\n"
        "assert main(['solve', 'connect4:w=3,h=3,connect=3', '--device',"
        " 'cpu', '--engine', 'dense', '--checkpoint-dir', d + '/dense',"
        " '--no-tables', '--query', '0x111']) == 0\n"
        "assert main(['export-db', 'tictactoe', '--out', d + '/db',"
        " '--device', 'cpu', '--compress', '--book-plies', '2']) == 0\n"
        "assert main(['export-db', 'tictactoe', '--from-checkpoint', d,"
        " '--out', d + '/db1', '--device', 'cpu']) == 0\n"
        "assert main(['query', d + '/db', '0', '0x1', '--device', 'cpu'])"
        " == 0\n"
        "assert main(['solve', 'examples/ref_games/chomp_33.py',"
        " '--device', 'cpu']) == 0\n"
        "assert main(['solve', 'examples/ref_games/ten_to_zero.py',"
        " '--device', 'cpu']) == 0\n"
        "import gamesmanmpi_tpu_torch.db.check, gamesmanmpi_tpu_torch.db.book\n"
        "import gamesmanmpi_tpu_torch.compat, gamesmanmpi_tpu_torch.solve.oracle\n"
        "import gamesmanmpi_tpu_torch.serve, gamesmanmpi_tpu_torch.obs\n"
        "import gamesmanmpi_tpu_torch.serve.worker\n"
        "import gamesmanmpi_tpu_torch.resilience.retry\n"
        "import gamesmanmpi_tpu_torch.utils.metrics\n"
        "import gamesmanmpi_tpu_torch.parallel.launch\n"
        "import gamesmanmpi_tpu_torch.resilience.coordination\n"
        "assert main(['solve', 'nim:heaps=3-4-5', '--device', 'cpu',"
        " '--devices', '4']) == 0\n"
        "import gamesmanmpi_tpu_torch.solve.hybrid\n"
        "assert main(['solve', 'connect4:w=3,h=3,connect=3', '--device',"
        " 'cpu', '--engine', 'hybrid', '--devices', '2']) == 0\n"
        "assert main(['solve', 'connect4:w=3,h=3,connect=3', '--device',"
        " 'cpu', '--devices', '2', '--checkpoint-dir', d + '/sharded'])"
        " == 0\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'gamesmanmpi_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # dense, dense checkpointed, hybrid, sharded checkpointed
    assert proc.stdout.count("positions: 694") == 4
    assert proc.stdout.count("positions: 120") == 2  # classic, sharded
    assert "devices: 4" in proc.stdout
    assert "query 0x1: value=TIE remoteness=8" in proc.stdout
    assert "query 0x111: value=TIE remoteness=9" in proc.stdout
    assert "opening book: 82 entries to 2 plies" in proc.stdout
    assert "query 0x1: value=TIE remoteness=8 best=0x2001" in proc.stdout
    assert "game: compat_chomp_33" in proc.stdout
    assert "game: ten_to_zero (compat module)" in proc.stdout
    assert proc.stdout.strip().endswith("clean")


def test_default_device_is_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["solve", "connect4:w=3,h=3,connect=3"]) == 2
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is false" in captured.err
    assert "positions:" not in captured.out
    assert resolve_device("cpu").type == "cpu"


#: a GameSpec whose k fits no line on its board (finding GS103)
BAD_SPEC = {"gamedsl": 1, "name": "far", "board": {"width": 3, "height": 3},
            "moves": {"family": "place"}, "win": {"kind": "k_in_line",
                                                  "k": 5}}


@pytest.mark.parametrize("argv,needle", [
    (["solve", "BAD_SPEC", "--device", "cpu"], "not compilable"),
    (["solve", "nosuchgame"], "bad game spec"),
    (["solve", "connect4:w=3,h=3,sym=maybe"], "bad game spec"),
    (["solve", "chomp:w=4,h=3,sym=1", "--device", "cpu"], "square board"),
])
def test_unported_and_bad_specs_exit_2(argv, needle, capsys, tmp_path):
    """A GameSpec compiles since the game compiler was ported; one with
    error findings exits 2 naming them, as a bad built-in spec does."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(BAD_SPEC))
    argv = [str(bad) if a == "BAD_SPEC" else a for a in argv]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert needle in err
    if needle == "not compilable":
        assert "GS103" in err


@pytest.mark.parametrize("argv,answer", [
    (["solve", "nim", "--device", "cpu"], ("WIN", 11, 120)),
    (["solve", "tictactoe", "--device", "cpu"], ("TIE", 9, 5478)),
    (["solve", "connect4:w=3,h=3,connect=3", "--engine", "classic",
      "--device", "cpu"], ("TIE", 9, 694)),
    (["solve", "connect4:w=3,h=3,sym=1", "--device", "cpu"],
     ("TIE", 9, 452)),
])
def test_formerly_unported_games_solve(argv, answer, capsys):
    """The classic engine's slice: what exited 2 as "not yet ported"
    before now solves, with the reference's known answers."""
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    value, rem, positions = answer
    assert f"value: {value}" in out and f"remoteness: {rem}" in out
    assert f"positions: {positions}" in out


def test_get_game_grammar():
    g = get_game("c4:width=5,height=4,k=3")
    assert isinstance(g, Connect4)
    assert (g.width, g.height, g.connect, g.name) == (5, 4, 3,
                                                      "connect3_5x4")
    assert get_game("connect4").name == "connect4_7x6"
    assert get_game("connect4:w=4,h=4,sym=1").sym
    # A GameSpec file compiles (gamedsl): the description-only gomoku.
    gomoku = get_game("examples/specs/gomoku_4x3x3.json")
    assert (gomoku.name, gomoku.state_bits, gomoku.max_moves) == (
        "gomoku_4x3x3", 24, 12)
    with pytest.raises(ValueError):
        get_game("connect4:w=9,h=7")


def test_kernel_build_is_keyed_and_local(monkeypatch, tmp_path):
    path = build._library_path("window_gather")
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.relative_to(REPO).as_posix() == "build/torch_ext"
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert path.name.startswith("window_gather_") and path.suffix == ".so"
    # The name hashes the source and flags: a different flag set is a
    # different library, so an edited build never loads a stale one.
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._library_path("window_gather") != path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build._nvcc()
    with pytest.raises(RuntimeError, match="error code 2"):
        build.check("monotone_window_gather", 2)


def test_cached_build_reports_ptxas(monkeypatch, tmp_path):
    """A library already built (here: a fake file) is not rebuilt, and
    its ptxas report comes from the file the build left beside it."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "PTXAS_REPORT", {})
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc ran"))
    for name in build.SOURCES:
        lib = build._library_path(name)
        assert lib.parent == tmp_path
        lib.write_bytes(b"not a real library")
        report = build._report_path(lib)
        assert report.name == lib.name[:-len(".so")] + ".ptxas.txt"
        report.write_text(f"ptxas info    : Used 9 registers ({name})")
    libs = build.build_all()
    assert set(libs) == set(build.SOURCES) == {"window_gather", "double_u32",
                                               "dense_level"}
    for name in build.SOURCES:
        assert build.PTXAS_REPORT[name].endswith(f"registers ({name})")
    # No report file beside a library: nothing to report, no rebuild.
    build._report_path(build._library_path("double_u32")).unlink()
    monkeypatch.setattr(build, "PTXAS_REPORT", {})
    build.build_all()
    assert set(build.PTXAS_REPORT) == {"window_gather", "dense_level"}


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    # Alone in a directory, without the rest of the repository.
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
