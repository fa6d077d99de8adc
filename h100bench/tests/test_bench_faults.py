"""The harness's comparison against broken programs: a whole run of each
cell at 4x4 on the CPU (the look for a card skipped), with the timed path
broken underneath, has to come out not correct; and the control, the
reference at a lower precision in the program's place, has to be
rejected."""

import argparse
import os

import pytest
import torch

import control
import reference
import run
from conftest import classic_tables, small_root, with_unlisted_cells

LEVEL = 8  # a 4x4 level with positions of every value


def args(cell):
    return argparse.Namespace(workload=cell, seed=2 ** 31 + 5, seconds=1.0,
                              trace=0, rates=None)


def broken_level(kind):
    def fault(cells):
        out = cells.clone()
        flat = out.reshape(-1)
        if kind == "altered":
            flat[flat.numel() // 3] ^= 4
        elif kind == "unchanged":
            flat.zero_()
        else:  # half of the lanes left out
            flat[flat.numel() // 2:] = 0
        return out
    return fault


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")


def test_sound_runs_are_correct(tmp_path):
    root = with_unlisted_cells(small_root(tmp_path))
    for cell in ("c4_5x5_dense.solve", "c4_5x5_classic.solve",
                 "c4_5x5_db.query"):
        out = run.run_cell(args(cell), "cpu", root=root)
        assert out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["altered", "unchanged", "half"])
def test_dense_level_step_faults_are_caught(tmp_path, monkeypatch, kind):
    from gamesmanmpi_tpu_torch.solve.dense import DenseSolver

    plain = DenseSolver._backward_level
    fault = broken_level(kind)

    def step(self, L, child_flat):
        cells, nmiss = plain(self, L, child_flat)
        return (fault(cells) if L == LEVEL else cells), nmiss

    monkeypatch.setattr(DenseSolver, "_backward_level", step)
    out = run.run_cell(args("c4_5x5_dense.solve"), "cpu",
                       root=small_root(tmp_path))
    assert not out["correct"]
    assert out["checks"]["position_mismatches"]["value"] > 0


@pytest.mark.parametrize("kind", ["altered", "unchanged", "half"])
def test_classic_combine_faults_are_caught(tmp_path, monkeypatch, kind):
    import gamesmanmpi_tpu_torch.solve.engine as engine

    plain = engine.combine_children

    def combine(cv, cr, mask):
        values, rem = plain(cv, cr, mask)
        n = values.shape[0]
        if kind == "altered" and n:
            rem = rem.clone()
            rem[n // 3] += 1
        elif kind == "unchanged":
            values, rem = torch.zeros_like(values), torch.zeros_like(rem)
        elif kind == "half" and n > 1:
            values, rem = values.clone(), rem.clone()
            values[n // 2:] = 0
        return values, rem

    monkeypatch.setattr(engine, "combine_children", combine)
    out = run.run_cell(args("c4_5x5_classic.solve"), "cpu",
                       root=with_unlisted_cells(small_root(tmp_path)))
    assert not out["correct"]
    assert out["checks"]["position_mismatches"]["value"] > 0


@pytest.mark.parametrize("fault,check", [("answer", "answer_mismatches"),
                                         ("half", "failed_requests")])
def test_served_answer_faults_are_caught(tmp_path, monkeypatch, fault,
                                         check):
    import sys

    from conftest import BENCH

    monkeypatch.setattr(run, "SERVE", [
        sys.executable, str(BENCH / "tests" / "faulty_serve.py"), fault])
    out = run.run_cell(args("c4_5x5_db.query"), "cpu",
                       root=with_unlisted_cells(small_root(tmp_path)))
    assert not out["correct"]
    assert out["checks"][check]["value"] > 0


def test_control_is_rejected():
    """The control (control.py) at 4x4: remoteness in 4 bits, where the
    root's is 16; the query form at 3 bits, since at 4x4 almost no
    position but the root is 16 or more from the end."""
    b = reference.Board(4, 4)
    ref = b.solve()
    ctl = b.solve(remoteness_bits=control.control_bits(b))
    assert control.control_bits(b) == 4
    assert reference.check_solve(b, ref, ctl.cells, None, "cpu") > 0
    assert reference.check_solve(b, ref, None, classic_tables(b, ctl),
                                 "cpu") > 0
    import numpy as np
    import loadgen

    pool = loadgen.playout_pool(b, 2048, 7)
    q = pool[loadgen.zipf_ranks(pool.size, 1.1, 800,
                                np.random.default_rng(8))]
    assert reference.check_answers(b, ref, q, *control.answers(b, ref, q)) == 0
    low = b.solve(remoteness_bits=3)
    assert reference.check_answers(b, ref, q, *control.answers(b, low, q)) > 0


def test_a_card_run_of_the_dense_cell_is_correct(cuda_device, tmp_path):
    """On the card: the dense cell through run.py's command, 2 s."""
    import subprocess
    import sys

    from conftest import BENCH, ROOT

    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "c4_5x5_dense.solve", "--seed", "12", "--seconds", "2", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ})
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]


test_a_card_run_of_the_dense_cell_is_correct = pytest.mark.cuda(
    test_a_card_run_of_the_dense_cell_is_correct)
