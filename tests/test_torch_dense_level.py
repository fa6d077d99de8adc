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


def _unpack(geom, pack: np.ndarray, for_reach: bool) -> dict:
    """A pack's fields under level_consts' names (and ``binom``, the
    [ncells+1, K] table, and ``heights``), decoded the way the kernel
    reads them: valid, newbit and topstone from the heights, and the class
    indexing its walk follows (``cellidx``: col_base[c] + r for a filled
    cell (c, r), else -1; ``snapk``: each valid move's insertion slot
    col_base[c] + h_c at the move's new cell, else -1)."""
    lay = dense_level.pack_layout(geom, for_reach)
    w, h = geom.width, geom.height
    stride, r0 = dense_level.BINOM_STRIDE, dense_level.REC_HEIGHTS
    rank_word = np.uint32 if geom.words.rank == 32 else np.uint64
    bits_word = np.uint32 if geom.words.bits == 32 else np.uint64
    nb = (geom.ncells + 2) * stride
    binom = pack[:nb * np.dtype(rank_word).itemsize // 4].view(
        rank_word).reshape(geom.ncells + 2, stride)[:, :geom.K]
    rec = pack[lay.rows:].reshape(-1, lay.stride)
    filled = (rec[:, 0].view(np.uint32).astype(np.uint64)
              | rec[:, 1].view(np.uint32).astype(np.uint64) << np.uint64(32))
    hts = rec[:, r0:r0 + w].astype(np.int64)
    col = np.arange(w, dtype=np.int64) * (h + 1)
    base = np.cumsum(hts, axis=1) - hts
    r = np.arange(h, dtype=np.int64)
    idx = base[:, :, None] + r  # [P, w, h]: cell (c, r) is j = c*h + r
    cellidx = np.where(r < hts[:, :, None], idx, -1).reshape(-1, w * h)
    snapk = np.where(r == hts[:, :, None], idx, -1).reshape(-1, w * h)
    out = dict(binom=binom[1:], filled=filled.astype(bits_word),
               heights=hts, cellidx=cellidx, snapk=snapk)
    if for_reach:
        top = np.uint64(1) << np.maximum(col + hts - 1, 0).astype(np.uint64)
        out.update(topstone=np.where(hts > 0, top, 0).astype(bits_word),
                   parent_row=rec[:, r0 + w:])
    else:
        valid = hts < h
        new = np.uint64(1) << (col + hts).astype(np.uint64)
        out.update(valid=valid,
                   newbit=np.where(valid, new, 0).astype(bits_word),
                   move_row=rec[:, r0 + w:r0 + 2 * w],
                   move_fill=rec[:, r0 + 2 * w:])
    return out


@pytest.mark.parametrize("for_reach", [False, True])
def test_kernel_layout_equals_level_consts(for_reach):
    """Each level's kernel pack, decoded as the kernel reads it, equals
    level_consts field by field (and the binomials the tables'), in the
    board's words, 6x5's (64-bit bitboards, 32-bit ranks) and the 64-bit
    ones."""
    t = dense.tables_for(4, 4, 4)
    fields = (("topstone", "parent_row") if for_reach
              else ("newbit", "valid", "move_row", "move_fill"))
    for words in (dense_level.word_widths(4, 4),
                  dense_level.Words(64, 32, 32),
                  dense_level.Words(64, 64, 64)):
        for L in range(t.ncells + 1):
            g = dataclasses.replace(dense_level.level_geom(t, L),
                                    words=words)
            pack = dense_level.kernel_pack(t, L, for_reach, words)
            assert pack.dtype == np.int32 and pack.flags["C_CONTIGUOUS"]
            lay = dense_level.pack_layout(g, for_reach)
            P = len(t.profiles[L])
            assert pack.size == lay.rows + P * lay.stride
            got = _unpack(g, pack, for_reach)
            c = t.level_consts(L)
            for name in ("filled", "cellidx") + fields:
                want = c[name]
                assert got[name].shape == want.shape, (L, name)
                np.testing.assert_array_equal(got[name], want,
                                              err_msg=f"{L} {name}")
            # The walk's insertion slots: the reference's snapk on valid
            # moves (and -1 where the column is full).
            np.testing.assert_array_equal(got["snapk"], c["snapk"])
            np.testing.assert_array_equal(got["heights"], t.profiles[L])
            assert got["binom"].itemsize * 8 == words.rank
            np.testing.assert_array_equal(
                got["binom"].astype(np.uint64), t.binom)
            assert got["filled"].itemsize * 8 == words.bits


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
    lmap = dense_level.LaunchMap(10, 5000, 2049, 3)
    assert (lmap.width, lmap.nlanes, lmap.runs, lmap.grid) == (
        2049, 20490, 11, 33)
    plan = dense_level.step_plan(g, lmap, 1000, False)
    assert (plan.grid, plan.nwin) == (33, 2)
    # The binomial table (18 rows of 34 u32 = 2,448 B), then the row
    # record (2 + 3*4 int32 = 56 B; the reach step's 2 + 2*4 = 40 B).
    assert plan.smem == 2448 + 56
    assert dense_level.step_plan(g, lmap, 1000, True).smem == 2448 + 40
    big = dataclasses.replace(g, width=7, height=6, words=dense_level.Words(
        64, 64, 64))
    assert dense_level.step_plan(big, lmap, 1, False).smem == (
        44 * 34 * 8 + 96) < 48 * 1024
    slice_ = dense_level.LaunchMap(10, 5000, 4096, 2, 2048, 4096)
    assert (slice_.width, slice_.runs, slice_.grid) == (2048, 10, 20)
    with pytest.raises(ValueError):
        dense_level.LaunchMap(10, 5000, 2048, 2)  # blocks short of C


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
                         ("kWindowShift", dense_level.WINDOW.bit_length()
                          - 1),
                         ("kMaxCols", dense_level.MAX_COLS),
                         ("kMaxCells", dense_level.MAX_CELLS),
                         ("kMaxSmem", "227 \\* 1024"),
                         ("kRecHeights", dense_level.REC_HEIGHTS),
                         ("kStride", dense_level.BINOM_STRIDE)):
        assert re.search(rf"constexpr [a-z ]+{const} = {value};", src), const
    for case in (0, 1, 5, 7):
        assert f"case {case}: return launch<" in src
    assert dense.WINDOW_BLOCK == dense_level.RUN
    assert dense.WINDOW_ELEMS == dense_level.WINDOW
    lib, fns = build.SOURCES["dense_level"]
    assert lib == "dense_level.cu"
    assert set(fns) == {"dense_step_launch", "reach_step_launch"}
    assert {"dense_step", "reach_step"} <= set(kernels.LAUNCHES)
    # The argument vector, on CPU tensors (pointers are only carried).
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu")
    t = s.tables
    g = dense_level.level_geom(t, 8)
    P, C = len(t.profiles[8]), t.class_size[8]
    pack = torch.from_numpy(dense_level.kernel_pack(t, 8, False))
    lmap = dense_level.LaunchMap(P, C, 32, -(-C // 32), 0, 32)
    src_cells = torch.zeros(100, dtype=torch.uint8)
    out = torch.empty((P, C), dtype=torch.uint8)
    counter = torch.zeros((), dtype=torch.int64)
    a = dict(zip(dense_level.ARGS, dense_level.launch_args(
        g, lmap, src_cells, pack, out, counter, False)))
    assert (a["P"], a["size"], a["cblock"], a["width"], a["adj"], a["m"],
            a["level"]) == (P, C, 32, 32, t.class_size[9], 100, 8)
    assert a["binom"] == pack.data_ptr() and a["words"] == 0
    assert a["rows"] == pack.data_ptr() + 4 * dense_level.pack_layout(
        g, False).rows
    assert a["runs"] == -(-P * 32 // dense_level.RUN)
    assert a["grid"] == a["nblk"] * a["runs"]
    # The output: the level's [P, C] in place, or a shard's compact array.
    assert (a["ld"], a["ostep"], a["obase"]) == (C, 32, 0)
    shard = dense_level.LaunchMap(P, C, 32, -(-C // 32), 8, 24, compact=True)
    a = dict(zip(dense_level.ARGS, dense_level.launch_args(
        g, shard, src_cells, pack, torch.empty((P, shard.out_cols),
                                               dtype=torch.uint8),
        counter, False)))
    assert (a["ld"], a["ostep"], a["obase"], a["lo"], a["width"]) == (
        shard.nblk * 16, 16, 0, 8, 16)


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
    """On CPU tensors the level wrappers write, block by block, what the
    block steps' plain versions give (in-range lanes of every block of a
    slice, nothing else), and launch nothing."""
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu",
                          block_elems=1 << 12)
    solved = s.solve()
    before = dict(kernels.LAUNCHES)
    t = s.tables
    for L in (1, 8, 13, 16):
        g = dense_level.level_geom(t, L)
        P, C = len(t.profiles[L]), t.class_size[L]
        cblock, nblk = s._cblock(L)
        for for_reach in (False, True):
            consts, src = _level_inputs(s, L, for_reach, solved)
            for lo, hi in ((0, cblock), (cblock // 2, cblock)):
                lmap = dense_level.LaunchMap(P, C, cblock, nblk, lo, hi)
                out = torch.full((P, C), 0xEE, dtype=torch.uint8)
                args = (g, lmap, src, consts, s._binom, out)
                if for_reach:
                    n = dense_level.reach_step(*args)
                else:
                    n = dense_level.dense_step(*args)
                want = torch.full((P, C), 0xEE, dtype=torch.uint8)
                n_ref = None
                for b in range(nblk):
                    rank0, end = lmap.block_ranks(b)
                    blk = (g, rank0, lmap.width, src, consts, s._binom)
                    if for_reach:
                        cells, extra = dense_level.reach_step_ref(*blk)
                    else:
                        cells, extra = dense_level.dense_step_ref(
                            *blk, "window")
                    end = min(end, C)
                    want[:, rank0:end] = cells[:, :max(end - rank0, 0)]
                    if extra is not None:
                        n_ref = extra if n_ref is None else n_ref + extra
                assert torch.equal(out, want), (L, for_reach, lo)
                assert (n is None) == (n_ref is None) == (
                    L == 16 and not for_reach)
                if n is not None:
                    assert int(n) == int(n_ref)
                if lo == 0:
                    assert (out != 0xEE).all()
                    if not for_reach:  # the solve's own cells
                        np.testing.assert_array_equal(out.numpy(),
                                                      solved.cells[L])
    assert kernels.LAUNCHES == before  # no kernel ran


def test_wrappers_raise_off_the_cpu_and_the_card():
    s = dense.DenseSolver(get_game(SMALL[0]), device="cpu")
    t = s.tables
    g = dense_level.level_geom(t, 4)
    lmap = dense_level.LaunchMap(len(t.profiles[4]), t.class_size[4],
                                 t.class_size[4], 1)
    meta = torch.zeros(10, dtype=torch.uint8, device="meta")
    out = torch.empty((lmap.P, lmap.size), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no dense_step kernel for meta"):
        dense_level.dense_step(g, lmap, meta, s._level_tensors(4, False),
                               s._binom, out)
    with pytest.raises(RuntimeError, match="no reach_step kernel for meta"):
        dense_level.reach_step(g, lmap, meta, s._level_tensors(4, True),
                               s._binom, out)


def _old_ops(g, lanes, pairs, for_reach):
    """The count before the fused walk (3 per board cell per lane, 2 per
    cell per pair for its rank walk): the revised one never exceeds it."""
    nc, fold = g.ncells, 4 * (2 * (g.connect - 1) + 1)
    if for_reach:
        return lanes * 3 * nc + pairs * (2 * nc + 8 + fold)
    return lanes * (3 * nc + 2 * fold) + pairs * (2 * nc + 8)


@pytest.mark.parametrize("connect", [2, 3, 4, 5])
def test_fold_ops_counts_a_doubling_fold(connect):
    """fold_ops is the work of a fold that finds `connect` in a row by
    doubling the run (x &= x >> (step*d), step up to the run so far),
    counted here operation by operation; that fold agrees with the plain
    one on seeded bitboards."""
    t = dense.tables_for(4, 4, 4)
    g = dataclasses.replace(dense_level.level_geom(t, 8), connect=connect)
    h = g.height
    boards = torch.from_numpy(np.random.default_rng(connect).integers(
        0, 1 << (t.width * (h + 1)), 4000))
    hit, ops = torch.zeros(boards.shape, dtype=torch.bool), 0
    for d in (1, h, h + 1, h + 2):
        x, run = boards, 1
        while run < connect:
            step = min(run, connect - run)
            x, run, ops = x & (x >> (step * d)), run + step, ops + 2
        hit, ops = hit | (x != 0), ops + 1
    assert ops == dense_level.fold_ops(g)
    want = dense_level._connected_fold(boards, h, connect)
    assert torch.equal(hit, want) and 0 < int(want.sum()) < len(boards)


def test_step_work_counts_the_data():
    """The bound's operations, counted here from the data independently:
    per in-range lane the level's class indices (1 each) and its stones
    (3 each), 10 per followed pair, a fold per player (backward) or per
    lane that follows any column (reach); never above the old count. A
    fold of four in a row is four directions of x = s & s >> d, x & x >>
    2d and a test: 5 operations each."""
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu")
    t = s.tables
    fold = 4 * 5
    for L in (9, 16):
        g = dense_level.level_geom(t, L)
        P, C = len(t.profiles[L]), t.class_size[L]
        consts = s._level_tensors(L, False)
        lmap = dense_level.LaunchMap(P, C, 200, -(-C // 200))
        work = dense_level.dense_followed(g, lmap, consts)
        valid = t.level_consts(L)["valid"]
        assert work.lanes == P * C
        assert work.pairs == (0 if L == 16 else C * int(valid.sum()))
        assert work.folds == 2 * P * C
        pack_bytes = dense_level.kernel_pack(t, L, False).nbytes
        nbytes, ops = dense_level.step_work(g, 10 ** 6, work, pack_bytes)
        n1 = (L + 1) // 2
        assert ops == P * C * (L + 3 * n1 + 2 * fold) + work.pairs * 10
        assert ops <= _old_ops(g, work.lanes, work.pairs, False)
        assert nbytes == P * C + work.pairs + pack_bytes
    # The reach step: every parent reachable, so a lane whose parents are
    # live stops at its first column whose top stone is the last mover's
    # (ply L = 9: player 1).
    L = 9
    g = dense_level.level_geom(t, L)
    P, C = len(t.profiles[L]), t.class_size[L]
    rc = s._level_tensors(L, True)
    parent = torch.ones(len(t.profiles[L - 1]) * t.class_size[L - 1],
                        dtype=torch.uint8)
    lmap = dense_level.LaunchMap(P, C, C, 1)
    work = dense_level.reach_followed(g, lmap, rc, s._binom, parent)
    prof = t.profiles[L]
    pairs = folds = 0
    for row in range(P):
        top = [c for c in range(t.width) if prof[row, c] > 0]
        filled = sum(((1 << int(prof[row, c])) - 1) << (c * t.h1)
                     for c in range(t.width))
        for r in range(C):
            p1 = t.unrank_np(L, row, r)
            mine = [c for c in top if (p1 >> int(t.bitpos[
                c * t.height + prof[row, c] - 1])) & 1]
            # Player 2's line: no parent is live, every column is tried.
            dead = t._connected_np(filled ^ p1)
            pairs += len(mine) if dead else min(len(mine), 1)
            folds += bool(mine)
    assert (work.lanes, work.pairs, work.folds) == (P * C, pairs, folds)
    _, ops = dense_level.step_work(g, parent.numel(), work, 0)
    assert ops == (P * C * (L + 3 * 5) + pairs * 10 + folds * fold)
    assert ops <= _old_ops(g, work.lanes, work.pairs, True)


# --------------------------------------------------------- on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("words", [None, (64, 32, 32), (64, 32, 64),
                                   (64, 64, 64)])
@pytest.mark.parametrize("spec,block", [("connect4:w=4,h=4", 1 << 12),
                                        ("connect4:w=5,h=4", 1 << 16)])
def test_kernels_match_plain_versions_on_every_level(spec, block, words,
                                                    monkeypatch):
    """Each level through both kernels, one launch each, and their plain
    versions over the same lanes on the card: every cell bit-identical,
    nmiss and the reach count equal; also in the 64-bit words of larger
    boards and on the slices of a 3-shard mesh."""
    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    cpu = dense.DenseSolver(get_game(spec), device="cpu",
                            block_elems=block).solve()
    s = dense.DenseSolver(get_game(spec), block_elems=block, devices=3)
    t = s.tables
    w = dense_level.Words(*words) if words else None
    before = dict(kernels.LAUNCHES)
    launched = 0
    for L in range(t.ncells + 1):
        g = dense_level.level_geom(t, L)
        if w is not None:
            g = dataclasses.replace(g, words=w)
        P, C = len(t.profiles[L]), t.class_size[L]
        cblock, nblk = s._cblock(L)
        for for_reach in ((False, True) if L else (False,)):
            consts, src = _level_inputs(s, L, for_reach, cpu)
            pack = {"pack": torch.from_numpy(dense_level.kernel_pack(
                t, L, for_reach, w)).cuda()}
            src = src.cuda()
            # One device's launch, then the mesh's compact shard slices.
            slices = [(lo, hi, True) for lo, hi in s._lane_slices(
                cblock, not for_reach)]
            for lo, hi, compact in [(0, cblock, False)] + slices:
                if hi == lo:
                    continue
                lmap = dense_level.LaunchMap(P, C, cblock, nblk, lo, hi,
                                             compact)
                got = torch.full((P, lmap.out_cols), 0xEE,
                                 dtype=torch.uint8, device="cuda")
                want = got.clone()
                if for_reach:
                    n = dense_level.reach_step(g, lmap, src, pack, None, got)
                    n_ref = dense_level.reach_level_ref(g, lmap, src, consts,
                                                        s._binom, want)
                else:
                    n = dense_level.dense_step(g, lmap, src, pack, None, got)
                    n_ref = dense_level.dense_level_ref(g, lmap, src, consts,
                                                        s._binom, want)
                torch.cuda.synchronize()
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"{'reach' if for_reach else 'dense'} level {L}")
                assert (n is None) == (n_ref is None)
                if n is not None:
                    assert int(n) == int(n_ref), (for_reach, L, lo)
                launched += 1
    assert sum(kernels.LAUNCHES[k] - before[k]
               for k in ("dense_step", "reach_step")) == launched


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [1, 2, 3])
def test_card_solves_on_the_kernels_match_the_cpu(devices, monkeypatch):
    """Blocked and meshed dense solves on the card launch each kernel once
    per level and shard slice, count Tromp's positions and give the CPU's
    cells and nmiss. The counts file is off, so each solve sweeps."""
    _need_card()
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    for spec, want in (("connect4:w=4,h=4", 161029),
                       ("connect4:w=5,h=4", 3945711)):
        dense._REACH_COUNTS.clear()
        cpu = dense.DenseSolver(get_game(spec), device="cpu",
                                block_elems=1 << 14).solve()
        dense._REACH_COUNTS.clear()
        s = dense.DenseSolver(get_game(spec), block_elems=1 << 14,
                              devices=devices)
        card = s.solve()
        assert card.num_positions == cpu.num_positions == want
        launches = card.stats["kernel_launches"]
        t = s.tables
        # One launch per level and shard slice (the launch arithmetic).
        assert launches["dense_step"] == sum(
            len(s._launch_maps(L, False)) for L in range(t.ncells + 1))
        assert launches["reach_step"] == sum(
            len(s._launch_maps(L, True)) for L in range(1, t.ncells + 1))
        assert card.stats["gather_launches"] == launches["dense_step"]
        assert card.stats["gather_nmiss_per_level"] == cpu.stats[
            "gather_nmiss_per_level"]
        for L, cells in cpu.cells.items():
            np.testing.assert_array_equal(card.cells[L], cells, err_msg=L)
    dense._REACH_COUNTS.clear()
