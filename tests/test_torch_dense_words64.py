"""The level kernels in Connect-4 6x5's words, held to the benchmark's plain
reference on the CPU.

6x5 is the largest board one card solves dense, and the only one whose
level kernels take 64-bit bitboards over 32-bit ranks and flat indices
(``Words(64, 32, 32)``, ops/dense_level.word_widths). Here the CUDA source
of those kernels (kernels/csrc/dense_level.cu), built by g++ under
tests/test_torch_dense_walk.py's host emulation, runs every level of 4x4
in 6x5's words, launched as the solver launches it on one device: the
backward chain top down, each level fed the kernel's own deeper level,
and the reach chain bottom up, each fed the kernel's own shallower reach.
The cells are judged by ``h100bench/reference.py``'s ``check_solve``, as
the benchmark judges a 6x5 solve on the card: no reachable position
wrong, the same root, the same reachable count. A 4x4 ``DenseSolver``
solve on the CPU (the plain level steps) is held to the same check.

The reference is loaded by path: it imports torch and the standard
library alone, nothing of JAX.
"""

import ctypes
import dataclasses
import importlib.util
import pathlib
import sys

import pytest
import torch
from test_torch_dense_walk import _emulated_library

from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.ops import dense_level
from gamesmanmpi_tpu_torch.solve import dense

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

SPEC = "connect4:w=4,h=4"
WORDS_6X5 = dense_level.Words(64, 32, 32)
REFERENCE = (pathlib.Path(__file__).resolve().parents[1] / "h100bench"
             / "reference.py")


@pytest.fixture(scope="module")
def judged():
    """(the reference module, its 4x4 board, the board's solution)."""
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  REFERENCE)
    ref = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = ref  # its dataclass looks itself up there
    spec.loader.exec_module(ref)
    board = ref.Board(4, 4, 4)
    return ref, board, board.solve()


def _launch(so, s, L, src, for_reach):
    """One emulated launch of level L's kernel in 6x5's words over the
    solver's one-device launch map -> (the [P, C] level array, the
    counter: the reach count, or the backward's window misses)."""
    t = s.tables
    geom = dataclasses.replace(dense_level.level_geom(t, L), words=WORDS_6X5)
    assert geom.words.code == 1  # 64-bit bitboards alone
    ((_, lmap),) = s._launch_maps(L, for_reach)
    out = torch.full((lmap.P, lmap.out_cols), 0xEE, dtype=torch.uint8)
    counter = torch.zeros((), dtype=torch.int64)
    pack = torch.from_numpy(dense_level.kernel_pack(t, L, for_reach,
                                                    WORDS_6X5))
    args = dense_level.launch_args(geom, lmap, src, pack, out, counter,
                                   for_reach)
    fn = so.reach_step_launch if for_reach else so.dense_step_launch
    assert fn((ctypes.c_longlong * len(args))(*args), len(args), None) == 0
    return out, int(counter), lmap.nblk


def test_kernel_chain_in_6x5_words_passes_the_reference(judged, tmp_path):
    ref, board, sol = judged
    assert dense_level.word_widths(6, 5) == WORDS_6X5 != (
        dense_level.word_widths(4, 4))
    so = _emulated_library(tmp_path)
    s = dense.DenseSolver(get_game(SPEC), device="cpu", block_elems=1 << 10)
    nc = s.tables.ncells
    cells, child, blocks = {}, torch.zeros(1, dtype=torch.uint8), 0
    for L in range(nc, -1, -1):
        out, _, nblk = _launch(so, s, L, child, False)
        blocks = max(blocks, nblk)
        cells[L], child = out.numpy(), out.reshape(-1)
    assert blocks > 1  # the wide levels take several rank blocks
    count, parent = 1, torch.ones(1, dtype=torch.uint8)
    for L in range(1, nc + 1):
        out, n, _ = _launch(so, s, L, parent, True)
        count += n
        assert torch.equal(out.bool(), sol.reach[L]), L
        parent = out.reshape(-1)
    assert ref.check_solve(board, sol, cells, None, "cpu") == 0
    root = int(cells[0][0, 0])
    assert (root & 3, root >> 2) == (sol.value, sol.remoteness) == (3, 16)
    assert count == sol.positions == 161029


def test_dense_solver_passes_the_reference(judged):
    ref, board, sol = judged
    r = dense.DenseSolver(get_game(SPEC), device="cpu").solve()
    assert ref.check_solve(board, sol, r.cells, None, "cpu") == 0
    assert (r.value, r.remoteness) == (sol.value, sol.remoteness)
    assert r.num_positions == sol.positions
