"""Tests of the torch port that need an NVIDIA card.

The CUDA kernels have no CPU mode, so these are marked `cuda` and skip when
torch.cuda.is_available() is false. They import nothing of JAX, so they
run on a machine with the card and without JAX; there, skip the repo's
conftest (it selects the JAX platform):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance zero: integer gathers and integer solves.
"""

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.ops import window_gather as port
from gamesmanmpi_tpu_torch.ops.elementwise import double_u32, double_u32_ref
from gamesmanmpi_tpu_torch.solve.dense import DenseSolver
from gamesmanmpi_tpu_torch.solve.engine import Solver

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _signed(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _table(rng, m, tdtype, offset=0):
    """A seeded table of m entries on the card; offset > 0 gives a view that
    many entries into a longer one (off 16-byte alignment)."""
    hi = 256 if tdtype == torch.uint8 else 1 << 32
    t = torch.from_numpy(rng.integers(0, hi, size=m + offset).astype(
        np.uint8 if tdtype == torch.uint8 else np.uint32).view(
        np.uint8 if tdtype == torch.uint8 else np.int32)).cuda()
    return t.view(tdtype)[offset:]


def _gather_matches(t, i, block=2048, window=8192):
    before = kernels.LAUNCHES["monotone_window_gather"]
    out, nmiss = port.monotone_window_gather(t, i, block, window)
    ref, nref = port.monotone_window_gather_ref(t, i, block, window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["monotone_window_gather"] == before + 1
    assert out.dtype == t.dtype and out.shape == i.shape
    np.testing.assert_array_equal(_signed(out).cpu().numpy(),
                                  _signed(ref).cpu().numpy())
    assert int(nmiss) == int(nref)
    return int(nmiss)


@pytest.mark.parametrize("tdtype", [torch.uint8, torch.uint32])
@pytest.mark.parametrize("idtype", [torch.int32, torch.int64])
def test_kernel_matches_plain_version(tdtype, idtype):
    _need_card()
    rng = np.random.default_rng(0)
    m = 1 << 18
    for span in (3, None):
        t = _table(rng, m, tdtype)
        if span is None:
            idx = np.sort(rng.integers(0, m, size=5000))
        else:
            idx = np.minimum(np.cumsum(rng.integers(0, span, size=5000)),
                             m - 1)
        i = torch.from_numpy(idx).to(idtype).cuda()
        for block, window in ((256, 1024), (2048, 8192)):
            _gather_matches(t, i, block, window)


EDGE_N = [1, 15, 16, 17, 2047, 2049, 5000, (1 << 20) + 3]


@pytest.mark.parametrize("case", ["aligned", "idx_off", "table_off",
                                  "wide_span", "clamp"])
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("tdtype", [torch.uint8, torch.uint32])
@pytest.mark.parametrize("idtype", [torch.int32, torch.int64])
def test_gather_edge_cases(idtype, tdtype, n, case):
    """Ragged lengths around the 16-index lane and the 2,048 block, views
    one entry off 16-byte alignment (idx: the scalar path; table: no
    staging), a span far wider than the staging budget, and indices
    clamped at both ends: bit-identical, nmiss equal."""
    _need_card()
    rng = np.random.default_rng(n)
    m = (1 << 22) if case == "wide_span" else (1 << 18)
    t = _table(rng, m, tdtype, offset=1 if case == "table_off" else 0)
    if case == "wide_span":
        idx = np.sort(rng.integers(0, m, size=n))
    else:
        idx = np.minimum(np.cumsum(rng.integers(0, 3, size=n)), m - 1)
    if case == "clamp":
        # Leading negatives and trailing indices >= M, still sorted.
        k = max(n // 10, 1)
        idx[:k] = np.sort(rng.integers(-100, 0, size=k))
        idx[n - k:] = np.maximum(idx[n - k:], np.sort(
            rng.integers(m, m + 100, size=k)))
        idx = np.maximum.accumulate(idx)
    i = torch.from_numpy(idx).to(idtype).cuda()
    if case == "idx_off":
        i = torch.cat([i[:1], i]).contiguous()[1:]
        assert i.data_ptr() % 16
    _gather_matches(t, i)


@pytest.mark.parametrize("runs", [1, 5])
def test_gather_whole_and_ragged_runs(runs):
    """Whole runs of port.RUN indices, and a ragged last run."""
    _need_card()
    rng = np.random.default_rng(7)
    m = 1 << 20
    t = _table(rng, m, torch.uint8)
    for n in (runs * port.RUN, runs * port.RUN + 7):
        idx = np.minimum(np.cumsum(rng.integers(0, 3, size=n)), m - 1)
        for idtype in (torch.int32, torch.int64):
            i = torch.from_numpy(idx).to(idtype).cuda()
            _gather_matches(t, i)


def test_dense_solve_on_card_matches_cpu():
    _need_card()
    g = get_game("connect4:w=3,h=4,connect=3")
    card = DenseSolver(g).solve()
    cpu = DenseSolver(g, device="cpu").solve()
    assert (card.value, card.remoteness, card.num_positions) == (
        cpu.value, cpu.remoteness, cpu.num_positions)
    for L, cells in cpu.cells.items():
        np.testing.assert_array_equal(card.cells[L], cells)


@pytest.mark.parametrize("n", [1, 3, 1023, 1 << 20, (1 << 20) + 1]
                         + [k for k in EDGE_N if k not in (1, 1 << 20)])
def test_double_u32_kernel_matches_plain_version(n):
    _need_card()
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 32, size=n + 1, dtype=np.uint64).astype(np.uint32)
    x[:2] = [(1 << 32) - 1, 1 << 31]
    t = torch.from_numpy(x.view(np.int32)).cuda().view(torch.uint32)
    for view in (t[:n], t[1:]):  # aligned, and one element in (scalar path)
        before = kernels.LAUNCHES["double_u32"]
        out = double_u32(view)
        ref = double_u32_ref(view)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["double_u32"] == before + 1
        assert out.shape == view.shape
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("spec", ["tictactoe:sym=1", "nim:heaps=3-4-5",
                                  "connect4:w=4,h=4,sym=1"])
@pytest.mark.parametrize("provenance", [True, False])
def test_classic_solve_on_card_matches_cpu(spec, provenance):
    _need_card()
    card = Solver(get_game(spec), use_provenance=provenance).solve()
    cpu = Solver(get_game(spec), device="cpu",
                 use_provenance=provenance).solve()
    assert (card.value, card.remoteness, card.num_positions) == (
        cpu.value, cpu.remoteness, cpu.num_positions)
    assert card.stats["misses"] == 0 and card.stats["peak_mem_bytes"] > 0
    assert sorted(card.levels) == sorted(cpu.levels)
    for k, t in cpu.levels.items():
        for field in ("states", "values", "remoteness"):
            np.testing.assert_array_equal(getattr(card.levels[k], field),
                                          getattr(t, field))
