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
from gamesmanmpi_tpu_torch.utils.checkpoint import LevelCheckpointer

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


def _npz_members(directory):
    """{file: {member: array}} of every sealed npz in a checkpoint dir."""
    out = {}
    for p in sorted(directory.glob("*.npz")):
        with np.load(p) as z:
            out[p.name] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("engine", ["classic", "dense"])
def test_checkpointed_solve_on_card_seals_what_the_cpu_seals(engine,
                                                             tmp_path):
    """The same game checkpointed on the card and on the CPU: the same
    files, members, dtypes and arrays; a rerun on the card's directory
    resumes (the dense one through the backward kernel on no level)."""
    _need_card()
    g = get_game("connect4:w=3,h=4,connect=3")
    solver = Solver if engine == "classic" else DenseSolver
    for where in ("cuda", "cpu"):
        solver(g, device=where,
               checkpointer=LevelCheckpointer(tmp_path / where)).solve()
    card, cpu = _npz_members(tmp_path / "cuda"), _npz_members(tmp_path / "cpu")
    assert sorted(card) == sorted(cpu) and card
    for name, members in cpu.items():
        assert sorted(card[name]) == sorted(members), name
        for k, a in members.items():
            assert card[name][k].dtype == a.dtype, (name, k)
            np.testing.assert_array_equal(card[name][k], a, err_msg=name)
    before = kernels.LAUNCHES["dense_step"]
    again = solver(g, checkpointer=LevelCheckpointer(tmp_path / "cuda")).solve()
    assert (again.value, again.remoteness) == (3, 12)
    if engine == "dense":
        assert again.stats["levels_resumed"] == g.width * g.height + 1
        assert kernels.LAUNCHES["dense_step"] == before


@pytest.mark.parametrize("spec", ["tictactoe:sym=1", "nim:heaps=3-4-5",
                                  "connect4:w=4,h=4"])
def test_db_export_and_reader_on_card_match_cpu(spec, tmp_path):
    """export-db on the card writes the CPU's files, and DbReader on the
    card (canonicalize and expand there) answers as one on the CPU."""
    import hashlib
    import io
    from contextlib import redirect_stdout

    from gamesmanmpi_tpu_torch.cli import main
    from gamesmanmpi_tpu_torch.db import DbReader

    _need_card()
    for dev in ("cuda", "cpu"):
        with redirect_stdout(io.StringIO()):
            assert main(["export-db", spec, "--out", str(tmp_path / dev),
                         "--compress", "--book-plies", "3", "--device",
                         dev]) == 0
    files = sorted(p.name for p in (tmp_path / "cpu").iterdir())
    for name in files:
        a, b = ((tmp_path / d / name).read_bytes() for d in ("cuda", "cpu"))
        assert hashlib.sha256(a).digest() == hashlib.sha256(b).digest(), name
    game = get_game(spec)
    q = np.random.default_rng(0).integers(
        0, 1 << game.state_bits, size=4096).astype(game.state_dtype)
    with DbReader(tmp_path / "cuda", device="cuda") as card, \
            DbReader(tmp_path / "cuda", device="cpu") as cpu:
        init = np.array([game.initial_state()], dtype=game.state_dtype)
        q = np.concatenate([init, card.book.positions, q])
        for x, y in zip(card.lookup_best(q), cpu.lookup_best(q)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["edges", "lookup"])
@pytest.mark.parametrize("spec", ["tictactoe", "nim:heaps=3-4-5",
                                  "connect4:w=4,h=4"])
def test_sharded_solve_on_card_matches_cpu(spec, mode, monkeypatch):
    """Four shards sharing the card (GAMESMAN_FAKE_DEVICES=4) give the
    CPU's tables, through both backwards."""
    from gamesmanmpi_tpu_torch.parallel import ShardedSolver

    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    monkeypatch.setenv("GAMESMAN_BACKWARD", mode)
    card = ShardedSolver(get_game(spec), num_shards=4, paranoid=True).solve()
    cpu = ShardedSolver(get_game(spec), num_shards=4, device="cpu").solve()
    assert card.stats["device"].startswith("cuda")
    assert card.stats["peak_mem_bytes"] > 0 and card.stats["misses"] == 0
    assert (card.value, card.remoteness, card.num_positions) == (
        cpu.value, cpu.remoteness, cpu.num_positions)
    assert sorted(card.levels) == sorted(cpu.levels)
    for k, t in cpu.levels.items():
        for field in ("states", "values", "remoteness"):
            np.testing.assert_array_equal(getattr(card.levels[k], field),
                                          getattr(t, field))


def test_gloo_world_on_card_matches_cpu_world(tmp_path):
    """Two processes sharing the card (gloo moves the CUDA tensors) write
    the tables a CPU world writes."""
    from gamesmanmpi_tpu_torch.parallel.launch import launch

    _need_card()
    tables = {}
    for dev in ("cuda", "cpu"):
        ranks = launch(["solve", "connect4:w=3,h=4,connect=3", "--devices",
                        "4", "--device", dev, "--table-out",
                        str(tmp_path / f"{dev}.npz")], processes=2,
                       log_dir=str(tmp_path / dev), timeout=300)
        for r in ranks:
            assert r.returncode == 0, r.stderr[-2000:]
            assert "backend gloo" in r.stderr
        for rank in (0, 1):
            with np.load(tmp_path / f"{dev}.rank{rank}.npz") as z:
                tables[dev, rank] = {f: z[f].tobytes() for f in z.files}
    assert (tables["cuda", 0] == tables["cuda", 1] == tables["cpu", 0]
            == tables["cpu", 1])


def test_sharded_checkpoint_on_card_resumes_and_reshards(tmp_path,
                                                         monkeypatch):
    """A sharded solve on the card killed mid-backward seals what the same
    solve seals on the CPU; the card resumes it at 4 shards (edges read
    back from the files) and at 2 (resharded), to the CPU's tables."""
    from gamesmanmpi_tpu_torch.parallel import ShardedSolver
    from gamesmanmpi_tpu_torch.resilience import faults

    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    g = get_game("connect4:w=4,h=4")
    for where in ("cuda", "cpu"):
        faults.configure("sharded.backward:fatal:4")
        with pytest.raises(faults.FatalFault):
            ShardedSolver(g, num_shards=4, device=where,
                          checkpointer=LevelCheckpointer(tmp_path / where)
                          ).solve()
        faults.clear()
    card, cpu = _npz_members(tmp_path / "cuda"), _npz_members(tmp_path / "cpu")
    assert sorted(card) == sorted(cpu) and card
    for name, members in cpu.items():
        for k, a in members.items():
            np.testing.assert_array_equal(card[name][k], a, err_msg=name)
    want = Solver(g, device="cpu").solve()
    import shutil

    shutil.copytree(tmp_path / "cuda", tmp_path / "two")
    for d, S in ((tmp_path / "cuda", 4), (tmp_path / "two", 2)):
        got = ShardedSolver(g, num_shards=S,
                            checkpointer=LevelCheckpointer(d)).solve()
        assert got.stats["resharded_from"] == (None if S == 4 else 4)
        assert (got.stats["backward_edges_levels"] > 0) == (S == 4)
        for k, t in want.levels.items():
            for field in ("states", "values", "remoteness"):
                np.testing.assert_array_equal(getattr(got.levels[k], field),
                                              getattr(t, field))


@pytest.mark.parametrize("devices", [1, 4])
def test_meshed_dense_and_hybrid_on_card_launch_the_gather(devices,
                                                           monkeypatch):
    """The meshed dense engine and the hybrid's dense region launch the
    level kernels on the card (the gather runs inside the backward
    step's), with the CPU's cells and nmiss."""
    from gamesmanmpi_tpu_torch.solve.hybrid import HybridSolver

    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    g = get_game("connect4:w=4,h=4")
    cpu = DenseSolver(g, device="cpu", block_elems=1 << 14).solve()
    before = kernels.LAUNCHES["dense_step"]
    card = DenseSolver(g, block_elems=1 << 14, devices=devices).solve()
    assert kernels.LAUNCHES["dense_step"] > before
    assert card.stats["gather_nmiss_per_level"] == cpu.stats[
        "gather_nmiss_per_level"]
    for L, cells in cpu.cells.items():
        np.testing.assert_array_equal(card.cells[L], cells)
    hy_cpu = HybridSolver(g, cutover=10, device="cpu").solve()
    before = dict(kernels.LAUNCHES)
    hy = HybridSolver(g, cutover=10, devices=devices).solve()
    assert kernels.LAUNCHES["dense_step"] > before["dense_step"]
    assert kernels.LAUNCHES["reach_step"] > before["reach_step"]
    assert hy.stats["kernel_launches"]["reach_step"] > 0
    assert (hy.value, hy.remoteness, hy.num_positions) == (
        hy_cpu.value, hy_cpu.remoteness, hy_cpu.num_positions)
    for L, cells in hy_cpu.cells.items():
        np.testing.assert_array_equal(hy.cells[L], cells)
