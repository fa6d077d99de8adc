"""The dense engine's level kernels (ops/dense_level.py) and the sorted
gather mode, against the JAX reference.

On the CPU the wrappers take their plain versions; what is held here:
``GAMESMAN_DENSE_GATHER=sorted`` solves equal to the reference's sorted
solves (through DenseSolver and the CLI), the kernels' word widths equal
to the reference's dtypes, the kernel layout of the constants equal to
``level_consts``, the wrappers' device routing, and the launch
arithmetic against the CUDA source. Integers throughout: tolerance zero.

The tests marked ``cuda`` hold each kernel against its plain version on
the card and skip without one. They import nothing of JAX (the reference
is imported inside the tests that use it), so on a machine with the card
and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_dense_level.py
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.kernels import build
from gamesmanmpi_tpu_torch.ops import dense_level
from gamesmanmpi_tpu_torch.solve import dense

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

SMALL = ["connect4:w=3,h=3,connect=3", "connect4:w=3,h=4,connect=3"]
CU = (pathlib.Path(dense_level.__file__).resolve().parents[1] / "kernels"
      / "csrc" / "dense_level.cu")


def _reference():
    from gamesmanmpi_tpu.games import get_game as jax_get_game
    from gamesmanmpi_tpu.solve import dense as jax_dense

    return jax_get_game, jax_dense


def _reference_sorted(spec, monkeypatch):
    jax_get_game, jax_dense = _reference()
    monkeypatch.setenv("GAMESMAN_DENSE_GATHER", "sorted")
    ref = jax_dense.DenseSolver(jax_get_game(spec))
    assert ref.gather_mode == "sorted"
    return ref.solve()


def _same_cells(got, ref):
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.cells) == sorted(ref.cells)
    for L, cells in ref.cells.items():
        np.testing.assert_array_equal(got.cells[L], cells, err_msg=L)


# ------------------------------------------------------------ sorted mode


@pytest.mark.parametrize("spec", SMALL)
def test_sorted_solve_matches_reference_sorted(spec, monkeypatch):
    ref = _reference_sorted(spec, monkeypatch)
    got = dense.DenseSolver(get_game(spec), device="cpu",
                            gather_mode="sorted").solve()
    _same_cells(got, ref)
    assert got.stats["gather_mode"] == "sorted"
    assert got.stats["gather_nmiss_per_level"] == {}
    # The mode changes no cell: the window solve gives the same bytes.
    win = dense.DenseSolver(get_game(spec), device="cpu",
                            gather_mode="window", block_elems=64).solve()
    _same_cells(win, ref)


@pytest.mark.parametrize("spec", SMALL)
def test_sorted_cli_matches_reference_sorted(spec, monkeypatch, capsys):
    from gamesmanmpi_tpu_torch.cli import solve_main

    ref = _reference_sorted(spec, monkeypatch)  # sets the env for both
    rc, got = solve_main(["solve", spec, "--engine", "dense", "--device",
                          "cpu"])
    assert rc == 0
    _same_cells(got, ref)
    assert got.stats["gather_mode"] == "sorted"
    assert f"value: {('', 'WIN', 'LOSE', 'TIE')[ref.value]}" in (
        capsys.readouterr().out)


# ------------------------------------------------------------ word widths


@pytest.mark.parametrize("board", [(3, 3), (4, 4), (5, 5), (6, 5), (6, 6),
                                   (7, 6)])
def test_word_widths_match_reference_dtypes(board, monkeypatch):
    jax_get_game, jax_dense = _reference()
    # The reference keeps every board's tables; drop this test's after it.
    monkeypatch.setattr(jax_dense, "_TABLES", {})
    w, h = board
    ref = jax_dense.DenseSolver(jax_get_game(
        f"connect4:w={w},h={h},connect=3"))
    got = dense_level.word_widths(w, h)
    assert got.bits == np.dtype(ref.tables.bits_dtype).itemsize * 8
    assert got.rank == np.dtype(ref._rank_dtype).itemsize * 8
    assert got.flat == np.dtype(ref._flat_dtype).itemsize * 8
    assert got.code in (0, 1, 5, 7)  # the instantiated combinations
    want = {(3, 3): (32, 32, 32), (4, 4): (32, 32, 32), (5, 5): (32, 32, 32),
            (6, 5): (64, 32, 32), (6, 6): (64, 64, 64), (7, 6): (64, 64, 64)}
    assert (got.bits, got.rank, got.flat) == want[board]


# ------------------------------------------------------ the kernel layout


@pytest.mark.parametrize("for_reach", [False, True])
def test_kernel_layout_equals_level_consts(for_reach):
    t = dense.tables_for(4, 4, 4)
    words = dense_level.word_widths(4, 4)
    fields = (("topstone", "parent_row", "parent_cellidx") if for_reach
              else ("newbit", "valid", "move_row", "move_fill",
                    "child_cellidx"))
    for L in range(t.ncells + 1):
        kc = dense_level.kernel_consts(t, L, for_reach, "cpu")
        c = t.level_consts(L)
        unsigned = {4: np.uint32, 8: np.uint64}
        for name in ("cellidx", "filled") + fields:
            got = kc[name].numpy()
            if got.dtype.kind == "i" and c[name].dtype.kind == "u":
                got = got.view(unsigned[got.dtype.itemsize])
            assert got.shape == c[name].shape, (L, name)
            assert got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, c[name], err_msg=f"{L} {name}")
        assert kc["cellidx"].dtype == torch.int8
        assert kc["filled"].element_size() * 8 == words.bits
        np.testing.assert_array_equal(
            kc["binom"].numpy().view(np.uint32).astype(np.uint64), t.binom)


def test_geometry_and_launch_arithmetic():
    t = dense.tables_for(4, 4, 4)
    for L in (0, 7, 16):
        g = dense_level.level_geom(t, L)
        assert (g.size, g.n1, g.is_top, g.K) == (
            t.class_size[L], dense.n1_of_level(L), L == 16, t.n1_width)
        assert g.child_size == (t.class_size[L + 1] if L < 16 else 1)
        assert g.parent_size == (t.class_size[L - 1] if L else 1)
        assert g.bitpos == tuple(int(b) for b in t.bitpos)
    g = dense_level.level_geom(t, 9)
    plan = dense_level.step_plan(g, 10, 2049, 1000)
    assert (plan.n, plan.grid, plan.nwin) == (20490, 11, 2)
    # The binomial table (17 x 10 u32 = 680 B), 8-aligned, then the masks.
    assert plan.smem == 680 + 16 * 4
    big = dataclasses.replace(g, width=7, height=6, words=dense_level.Words(
        64, 64, 64))
    assert dense_level.step_plan(big, 1, 1, 1).smem == (
        43 * 23 * 8 + 42 * 8) < 48 * 1024


def test_launch_args_follow_the_source():
    src = CU.read_text()
    enum = re.search(r"enum Arg \{([^}]*)\}", src).group(1)
    names = [a.strip() for a in enum.split(",") if a.strip()]
    assert names[-1] == "A_COUNT"
    assert tuple(n[2:].lower() for n in names[:-1]) == tuple(
        a.lower() for a in dense_level.ARGS)
    for const, value in (("kThreads", dense_level.THREADS),
                         ("kRun", dense_level.RUN),
                         ("kWindow", dense_level.WINDOW),
                         ("kMaxCols", dense_level.MAX_COLS),
                         ("kMaxCells", dense_level.MAX_CELLS)):
        assert re.search(rf"constexpr [a-z ]+{const} = {value};", src), const
    for case in (0, 1, 5, 7):
        assert f"case {case}: e = launch<" in src
    assert dense.WINDOW_BLOCK == dense_level.RUN
    assert dense.WINDOW_ELEMS == dense_level.WINDOW
    lib, fns = build.SOURCES["dense_level"]
    assert lib == "dense_level.cu"
    assert set(fns) == {"dense_step_launch", "reach_step_launch"}
    assert {"dense_step", "reach_step"} <= set(kernels.LAUNCHES)
    # The argument vector, on CPU tensors (pointers are only carried).
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu")
    g = dense_level.level_geom(s.tables, 8)
    kc = dense_level.kernel_consts(s.tables, 8, False, "cpu")
    src_cells = torch.zeros(100, dtype=torch.uint8)
    out = torch.empty((kc["cellidx"].shape[0], 70), dtype=torch.uint8)
    counter = torch.zeros((), dtype=torch.int64)
    a = dict(zip(dense_level.ARGS, dense_level.launch_args(
        g, 0, 70, src_cells, kc, out, counter, False)))
    assert (a["P"], a["width"], a["size"], a["adj"], a["m"], a["level"]) == (
        kc["cellidx"].shape[0], 70, 70, s.tables.class_size[9], 100, 8)
    assert a["valid"] == kc["valid"].data_ptr() and a["words"] == 0
    assert a["grid"] == -(-a["n"] // dense_level.RUN)


# ----------------------------------------------------------- the wrappers


def _level_inputs(solver, L, for_reach, solved):
    t = solver.tables
    consts = solver._level_tensors(L, for_reach)
    if for_reach:
        m = len(t.profiles[L - 1]) * t.class_size[L - 1]
        src = torch.from_numpy(
            np.random.default_rng(L).integers(0, 2, m).astype(np.uint8))
    else:
        src = (torch.from_numpy(solved.cells[L + 1].reshape(-1))
               if L < t.ncells else torch.zeros(1, dtype=torch.uint8))
    return consts, src


def test_wrappers_take_the_plain_version_on_the_cpu():
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu",
                          block_elems=1 << 12)
    solved = s.solve()
    before = dict(kernels.LAUNCHES)
    for L in (1, 8, 13, 16):
        g = dense_level.level_geom(s.tables, L)
        cblock, _ = s._cblock(L)
        for for_reach in (False, True):
            consts, src = _level_inputs(s, L, for_reach, solved)
            args = (g, cblock, cblock, src, consts, s._binom)
            if for_reach:
                got, n = dense_level.reach_step(*args)
                want, n_ref = dense_level.reach_step_ref(*args)
            else:
                got, n = dense_level.dense_step(*args)
                want, n_ref = dense_level.dense_step_ref(*args, "window")
            assert torch.equal(got, want)
            assert (n is None) == (n_ref is None) == (
                L == 16 and not for_reach)
            if n is not None:
                assert int(n) == int(n_ref)
    assert kernels.LAUNCHES == before  # no kernel ran


def test_wrappers_raise_off_the_cpu_and_the_card():
    s = dense.DenseSolver(get_game(SMALL[0]), device="cpu")
    g = dense_level.level_geom(s.tables, 4)
    meta = torch.zeros(10, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no dense_step kernel for meta"):
        dense_level.dense_step(g, 0, 8, meta, s._level_tensors(4, False),
                               s._binom)
    with pytest.raises(RuntimeError, match="no reach_step kernel for meta"):
        dense_level.reach_step(g, 0, 8, meta, s._level_tensors(4, True),
                               s._binom)


def test_step_work_counts_the_data():
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu")
    t = s.tables
    L = 9
    g = dense_level.level_geom(t, L)
    consts = s._level_tensors(L, False)
    P = consts["filled"].shape[0]
    lanes, followed = dense_level.dense_followed(g, 0, 200, consts)
    assert lanes == P * t.class_size[L]  # 126 in range of 200
    assert followed == t.class_size[L] * int(consts["valid"].sum())
    nbytes, ops = dense_level.step_work(g, P, 200, 10 ** 6, lanes, followed,
                                        False)
    fold = 4 * (2 * 3 + 1)
    assert ops == lanes * (3 * 16 + 2 * fold) + followed * (2 * 16 + 8)
    assert nbytes >= P * 200 + followed
    rc = s._level_tensors(L, True)
    parent = torch.ones(len(t.profiles[L - 1]) * t.class_size[L - 1],
                        dtype=torch.uint8)
    lanes, followed = dense_level.reach_followed(g, 0, t.class_size[L], rc,
                                                 s._binom, parent)
    # Every parent reachable: a lane stops at its first live column.
    _, count = dense_level.reach_step_ref(g, 0, t.class_size[L], parent, rc,
                                          s._binom)
    assert lanes == P * t.class_size[L] and int(count) <= followed


# --------------------------------------------------------- on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _check_launch(name, g, rank0, width, got, want, extra, extra_ref):
    ok = (rank0 + torch.arange(width)) < g.size
    np.testing.assert_array_equal(got.cpu()[:, ok].numpy(),
                                  want.cpu()[:, ok].numpy(),
                                  err_msg=f"{name} level {g.level}")
    assert (extra is None) == (extra_ref is None)
    if extra is not None:
        assert int(extra) == int(extra_ref), (name, g.level)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [None, (64, 32, 32), (64, 32, 64),
                                   (64, 64, 64)])
@pytest.mark.parametrize("spec,block", [("connect4:w=4,h=4", 1 << 12),
                                        ("connect4:w=5,h=4", 1 << 16)])
def test_kernels_match_plain_versions_on_every_level(spec, block, words):
    """Each rank block of each level through both kernels and their plain
    versions on the card: in-range lanes bit-identical, nmiss and the
    reach count equal; also in the 64-bit words of larger boards."""
    _need_card()
    cpu = dense.DenseSolver(get_game(spec), device="cpu",
                            block_elems=block).solve()
    s = dense.DenseSolver(get_game(spec), block_elems=block)
    t = s.tables
    w = dense_level.Words(*words) if words else None
    before = dict(kernels.LAUNCHES)
    launched = 0
    for L in range(t.ncells + 1):
        g = dense_level.level_geom(t, L)
        if w is not None:
            g = dataclasses.replace(g, words=w)
        cblock, nblk = s._cblock(L)
        for for_reach in ((False, True) if L else (False,)):
            consts, src = _level_inputs(s, L, for_reach, cpu)
            consts = dict(consts, kernel=dense_level.kernel_consts(
                t, L, for_reach, "cuda", w))
            src = src.cuda()
            for b in range(nblk):
                args = (g, b * cblock, cblock, src, consts, s._binom)
                if for_reach:
                    got, n = dense_level.reach_step(*args)
                    want, n_ref = dense_level.reach_step_ref(*args)
                else:
                    got, n = dense_level.dense_step(*args)
                    want, n_ref = dense_level.dense_step_ref(*args, "window")
                torch.cuda.synchronize()
                _check_launch("reach" if for_reach else "dense", g,
                              b * cblock, cblock, got, want, n, n_ref)
                launched += 1
    assert sum(kernels.LAUNCHES[k] - before[k]
               for k in ("dense_step", "reach_step")) == launched


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [1, 2, 3])
def test_card_solves_on_the_kernels_match_the_cpu(devices, monkeypatch):
    """Blocked and meshed dense solves on the card launch both kernels,
    count Tromp's positions and give the CPU's cells and nmiss."""
    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    for spec, want in (("connect4:w=4,h=4", 161029),
                       ("connect4:w=5,h=4", 3945711)):
        dense._REACH_COUNTS.clear()
        cpu = dense.DenseSolver(get_game(spec), device="cpu",
                                block_elems=1 << 14).solve()
        dense._REACH_COUNTS.clear()
        card = dense.DenseSolver(get_game(spec), block_elems=1 << 14,
                                 devices=devices).solve()
        assert card.num_positions == cpu.num_positions == want
        launches = card.stats["kernel_launches"]
        assert launches["dense_step"] > 0 and launches["reach_step"] > 0
        assert card.stats["gather_launches"] == launches["dense_step"]
        assert card.stats["gather_nmiss_per_level"] == cpu.stats[
            "gather_nmiss_per_level"]
        for L, cells in cpu.cells.items():
            np.testing.assert_array_equal(card.cells[L], cells, err_msg=L)
    dense._REACH_COUNTS.clear()
