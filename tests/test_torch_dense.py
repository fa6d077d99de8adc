"""Torch port's dense Connect-4 engine against the JAX reference.

Same boards, same seeded numpy inputs, through the JAX function and its
port, compared as numpy arrays with tolerance zero (everything here is
integer): the value algebra and bit primitives, the Connect-4 game
kernels, the combine, DenseTables and its per-level constants, the
rank/unrank walks, and whole solves — every level's cells byte-identical
to gamesmanmpi_tpu.solve.dense.DenseSolver(...).solve().cells, the same
reachable counts and the same root. The port runs on the CPU here, so its
window gather is the plain version (tests/test_torch_window_gather.py
holds that against the Pallas kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.core import bitops as jax_bitops
from gamesmanmpi_tpu.core import values as jax_values
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.ops.combine import combine_children as jax_combine
from gamesmanmpi_tpu.solve import dense as jax_dense
from gamesmanmpi_tpu_torch.core import bitops, values
from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.ops.combine import combine_children
from gamesmanmpi_tpu_torch.solve import dense
from gamesmanmpi_tpu_torch.utils.device import DeviceUnavailable

# One intra-op thread: the suite runs in parallel worker processes, and a
# torch pool as wide as the machine in each of them oversubscribes the
# cores (a 2 s meshed dense solve took 80-105 s under six workers).
torch.set_num_threads(1)

SMALL = ["connect4:w=3,h=3,connect=3", "connect4:w=3,h=4,connect=3"]

_JAX_SOLVES = {}


def jax_solve(spec):
    """The reference dense solve of `spec`, once per test process."""
    if spec not in _JAX_SOLVES:
        _JAX_SOLVES[spec] = jax_dense.DenseSolver(jax_get_game(spec)).solve()
    return _JAX_SOLVES[spec]


def _assert_same_solve(got, ref, levels=None):
    assert (got.value, got.remoteness) == (ref.value, ref.remoteness)
    assert got.num_positions == ref.num_positions
    assert got.stats["reachable_per_level"] == ref.stats[
        "reachable_per_level"]
    assert got.stats["encodable_positions"] == ref.stats[
        "encodable_positions"]
    for L in levels if levels is not None else ref.cells:
        assert got.cells[L].dtype == np.uint8
        np.testing.assert_array_equal(got.cells[L], ref.cells[L], err_msg=L)


# -------------------------------------------------------------- primitives


def test_values_match_reference():
    assert (values.WIN, values.LOSE, values.TIE, values.UNDECIDED) == (
        jax_values.WIN, jax_values.LOSE, jax_values.TIE,
        jax_values.UNDECIDED)
    assert values.MAX_REMOTENESS == jax_values.MAX_REMOTENESS
    v = np.array([0, 1, 2, 3, 3, 1], np.uint8)
    np.testing.assert_array_equal(values.negate(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax_values.negate(v)))
    np.testing.assert_array_equal(values.negate_np(v), jax_values.negate_np(v))
    assert [values.value_name(i) for i in range(4)] == [
        jax_values.value_name(i) for i in range(4)]


def test_bitops_match_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(1, 1 << 63, size=4000, dtype=np.uint64)
    x[:64] = np.uint64(1) << np.arange(63, dtype=np.uint64).repeat(2)[:64]
    t = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(bitops.popcount(t).numpy(),
                                  np.asarray(jax_bitops.popcount(x)))
    np.testing.assert_array_equal(bitops.msb_index(t).numpy(),
                                  np.asarray(jax_bitops.msb_index(x)))


def _random_states(game, n, seed):
    """Seeded random play from the root (numpy/python, no engine)."""
    rng = np.random.default_rng(seed)
    w, h1 = game.width, game.height + 1
    out = []
    for _ in range(n):
        heights = [0] * w
        cur, opp = 0, 0  # stones of the player to move / the other one
        for _ in range(int(rng.integers(0, w * game.height + 1))):
            open_cols = [c for c in range(w) if heights[c] < game.height]
            if not open_cols:
                break
            c = int(rng.choice(open_cols))
            cur |= 1 << (c * h1 + heights[c])
            heights[c] += 1
            cur, opp = opp, cur
        guards = sum(1 << (c * h1 + heights[c]) for c in range(w))
        out.append(cur | guards)
    return out


@pytest.mark.parametrize("spec", ["connect4:w=4,h=4", "connect4:w=5,h=5",
                                  "connect4:w=4,h=7"])
def test_connect4_kernels_match_reference(spec):
    g, jg = get_game(spec), jax_get_game(spec)
    assert (g.name, g.max_moves, g.num_levels, g.state_bits) == (
        jg.name, jg.max_moves, jg.num_levels, jg.state_bits)
    assert g.initial_state() == int(jg.initial_state())
    states = np.array(_random_states(g, 300, 1), dtype=jg.state_dtype)
    t = torch.from_numpy(states.astype(np.int64))
    ch, mk = g.expand(t)
    jch, jmk = jg.expand(jnp.asarray(states))
    np.testing.assert_array_equal(ch.numpy(), np.asarray(jch).astype(np.int64))
    np.testing.assert_array_equal(mk.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(g.primitive(t).numpy(),
                                  np.asarray(jg.primitive(jnp.asarray(states))))
    np.testing.assert_array_equal(g.level_of(t).numpy(),
                                  np.asarray(jg.level_of(jnp.asarray(states))))
    s = int(states[7])
    assert g.describe(s) == jg.describe(s)


def test_combine_children_matches_reference():
    rng = np.random.default_rng(3)
    for B, M in ((257, 1), (1000, 5), (64, 7)):
        cv = rng.integers(0, 4, size=(B, M)).astype(np.uint8)
        cr = rng.integers(0, 40, size=(B, M)).astype(np.int32)
        mk = rng.random((B, M)) < 0.6
        jv, jr = jax_combine(cv, cr, mk)
        v, r = combine_children(torch.from_numpy(cv), torch.from_numpy(cr),
                                torch.from_numpy(mk))
        assert v.dtype == torch.uint8 and r.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


# ------------------------------------------------------------ DenseTables


@pytest.mark.parametrize("wh", [(3, 3, 3), (3, 4, 3), (4, 4, 4), (4, 7, 4)])
def test_dense_tables_match_reference(wh):
    t, j = dense.DenseTables(*wh), jax_dense.DenseTables(*wh)
    for f in ("width", "height", "connect", "ncells", "h1", "bits_dtype",
              "n1_width", "class_size", "row_of"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.bitpos, j.bitpos)
    np.testing.assert_array_equal(t.binom, j.binom)
    for L in range(t.ncells + 1):
        np.testing.assert_array_equal(t.profiles[L], j.profiles[L])
        a, b = t.level_consts(L), j.level_consts(L)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, (L, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{L} {k}")


@pytest.mark.parametrize("wh,L", [((4, 4, 4), 8), ((4, 7, 4), 9)])
def test_unrank_rank_match_reference(wh, L):
    t = dense.DenseTables(*wh)
    P, C = len(t.profiles[L]), t.class_size[L]
    rng = np.random.default_rng(4)
    cb = 40
    ranks = rng.integers(0, C, size=(P, cb), dtype=np.uint32)
    cellidx = np.ascontiguousarray(t.cellidx_rows(L).astype(np.int32).T)
    bitpos = [int(b) for b in t.bitpos]
    jdt = jnp.uint64 if t.bits_dtype == np.uint64 else jnp.uint32
    jbits = jax.jit(lambda r: jax_dense._unrank_bits(
        r, dense.n1_of_level(L), jnp.asarray(t.binom.astype(np.uint32)),
        jnp.asarray(cellidx), bitpos, jdt, jnp.uint32, False,
    ))(jnp.asarray(ranks))
    jback = jax.jit(lambda b: jax_dense._rank_bits(
        b, jnp.asarray(t.binom.astype(np.uint32)), jnp.asarray(cellidx),
        bitpos, jdt, jnp.uint32, False,
    ))(jbits)

    binom = torch.from_numpy(t.binom.astype(np.int64))
    tcell = torch.from_numpy(cellidx.astype(np.int64))
    bits = dense._unrank_bits(torch.from_numpy(ranks.astype(np.int64)),
                              dense.n1_of_level(L), binom, tcell, bitpos)
    back = dense._rank_bits(bits, binom, tcell, bitpos)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int64))
    np.testing.assert_array_equal(back.numpy(), ranks.astype(np.int64))
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jback).astype(np.int64))

    won = dense._connected_fold(bits, wh[1], wh[2])
    jwon = jax_dense._connected_fold(jbits, wh[1], wh[2], jdt)
    np.testing.assert_array_equal(won.numpy(), np.asarray(jwon))


# ----------------------------------------------------------- whole solves


@pytest.mark.parametrize("gather_mode", ["window", "plain"])
@pytest.mark.parametrize("spec", SMALL)
def test_dense_solve_matches_reference(spec, gather_mode):
    got = dense.DenseSolver(get_game(spec), device="cpu",
                            gather_mode=gather_mode).solve()
    _assert_same_solve(got, jax_solve(spec))
    assert got.stats["gather_mode"] == gather_mode
    assert got.stats["levels_resumed"] == 0


@pytest.mark.parametrize("spec", SMALL)
def test_blocked_levels_match_reference(spec):
    got = dense.DenseSolver(get_game(spec), device="cpu",
                            block_elems=64).solve()
    _assert_same_solve(got, jax_solve(spec))


@pytest.mark.parametrize("spec", SMALL)
def test_resume_from_reference_levels(spec):
    ref = jax_solve(spec)
    g = get_game(spec)
    nc = g.width * g.height
    K = nc // 2
    seed = dense.cells_from_reference(
        {L: ref.cells[L] for L in range(K, nc + 1)}, "cpu")
    assert all(v.dtype == torch.uint8 for v in seed.values())
    got = dense.DenseSolver(g, device="cpu").solve(resume_cells=seed)
    _assert_same_solve(got, ref)
    assert got.stats["levels_resumed"] == nc - K + 1
    assert got.stats["positions_per_sec"] == 0.0
    # A gap below the top: only the contiguous top run K'..nc is taken.
    gap = dict(seed)
    del gap[K + 1]
    part = dense.DenseSolver(g, device="cpu").solve(resume_cells=gap)
    assert part.stats["levels_resumed"] == nc - (K + 2) + 1
    _assert_same_solve(part, ref)
    with pytest.raises(ValueError):
        dense.DenseSolver(g, device="cpu").solve(
            resume_cells={K: seed[K]})
    with pytest.raises(ValueError):
        dense.DenseSolver(g, device="cpu").solve(
            resume_cells={nc: seed[nc][:, :0]})


def test_lookup_matches_reference_on_reachable_states():
    spec = SMALL[0]
    ref = jax_solve(spec)
    g = get_game(spec)
    got = dense.DenseSolver(g, device="cpu").solve()
    # Every reachable state, by BFS through the port's own expand.
    frontier = torch.tensor([g.initial_state()], dtype=torch.int64)
    seen = 0
    while frontier.numel():
        for s in frontier.tolist():
            try:
                want = ref.lookup(s)
            except KeyError:
                with pytest.raises(KeyError):
                    got.lookup(s)
                continue
            assert got.lookup(s) == want
        seen += frontier.numel()
        live = g.primitive(frontier) == values.UNDECIDED
        ch, mk = g.expand(frontier[live])
        frontier = torch.unique(ch[mk])
    assert seen == ref.num_positions


def test_cblock_rounds_to_kernel_block():
    g = get_game("connect4:w=4,h=4")
    s = dense.DenseSolver(g, device="cpu", block_elems=1 << 14)
    plain = dense.DenseSolver(g, device="cpu", block_elems=1 << 14,
                              gather_mode="plain")
    t = s.tables
    split = False
    for L in range(t.ncells + 1):
        C = t.class_size[L]
        cb, nblk = s._cblock(L)
        assert cb * nblk >= C > cb * (nblk - 1)  # no empty block
        if cb >= dense.WINDOW_BLOCK:
            assert cb % dense.WINDOW_BLOCK == 0, L
            # Rounding costs under one kernel block per block of ranks.
            assert cb * nblk - C < nblk * dense.WINDOW_BLOCK
            split |= nblk > 1
        # Balanced blocks: the plain split pads under one lane per block.
        pb, pn = plain._cblock(L)
        assert pb * pn - C < pn
    assert split
    assert any(plain._cblock(L) != s._cblock(L)
               for L in range(t.ncells + 1))


def test_no_tables_mode():
    r = dense.DenseSolver(get_game(SMALL[0]), device="cpu",
                          store_tables=False).solve()
    assert r.cells is None
    with pytest.raises(KeyError):
        r.lookup(get_game(SMALL[0]).initial_state())


def test_rejects_sym_bad_mode_and_missing_card(monkeypatch):
    with pytest.raises(ValueError):
        dense.DenseSolver(get_game("connect4:w=4,h=4,sym=1"), device="cpu")
    with pytest.raises(TypeError):
        dense.DenseSolver(object(), device="cpu")
    with pytest.raises(ValueError):
        dense.DenseSolver(get_game(SMALL[0]), device="cpu",
                          gather_mode="pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        dense.DenseSolver(get_game(SMALL[0]))  # default device: the card


# ------------------------------------------------------------- the mesh


@pytest.mark.parametrize("devices", [2, 3, 4])
def test_meshed_dense_matches_one_device_and_reference(devices):
    """devices=N splits each level step's lanes over N shards by whole
    kernel blocks: the cells are the one-device run's and the
    reference's, byte for byte, and the window gather's misses summed
    over the shards equal the one-device count, level by level."""
    spec = SMALL[1]
    got = dense.DenseSolver(get_game(spec), device="cpu",
                            devices=devices).solve()
    _assert_same_solve(got, jax_solve(spec))
    assert got.stats["devices"] == devices
    wide = "connect4:w=5,h=3"  # blocks of 4,096 lanes: 140,251 misses
    one = dense.DenseSolver(get_game(wide), device="cpu",
                            block_elems=1 << 12).solve()
    mesh = dense.DenseSolver(get_game(wide), device="cpu",
                             block_elems=1 << 12, devices=devices).solve()
    assert one.stats["gather_nmiss"] > 0
    assert (mesh.stats["gather_nmiss_per_level"]
            == one.stats["gather_nmiss_per_level"])
    for L, cells in one.cells.items():
        np.testing.assert_array_equal(mesh.cells[L], cells, err_msg=L)


def test_lane_slices_are_whole_kernel_blocks():
    s = dense.DenseSolver(get_game(SMALL[0]), device="cpu", devices=3)
    W = dense.WINDOW_BLOCK
    for cblock, window in ((5 * W, True), (W // 2, True), (1000, False)):
        slices = s._lane_slices(cblock, window)
        assert slices[0][0] == 0 and slices[-1][1] == cblock
        for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
            assert hi == lo2 and lo <= hi
        if window:
            unit = W if cblock >= W else cblock
            assert all(lo % unit == 0 and hi % unit == 0
                       for lo, hi in slices)
    with pytest.raises(ValueError, match="devices"):
        dense.DenseSolver(get_game(SMALL[0]), device="cpu", devices=0)


@pytest.mark.parametrize("raw,want", [
    (None, "window"), ("pallas", "window"), ("plain", "plain"),
    ("sorted", "sorted"), ("bogus", "expected")])
def test_dense_gather_env_parses_strictly(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv("GAMESMAN_DENSE_GATHER", raising=False)
    else:
        monkeypatch.setenv("GAMESMAN_DENSE_GATHER", raw)
    if want in ("window", "plain", "sorted"):
        s = dense.DenseSolver(get_game(SMALL[0]), device="cpu")
        assert s.gather_mode == want
        # An explicit mode wins over the environment.
        assert dense.DenseSolver(get_game(SMALL[0]), device="cpu",
                                 gather_mode="plain").gather_mode == "plain"
        if raw == "sorted":  # a working mode: the CLI solves under it
            from gamesmanmpi_tpu_torch import cli

            assert cli.main(["solve", SMALL[0], "--engine", "dense",
                             "--device", "cpu"]) == 0
        return
    with pytest.raises(ValueError, match=want):
        dense.DenseSolver(get_game(SMALL[0]), device="cpu")
    from gamesmanmpi_tpu_torch import cli

    assert cli.main(["solve", SMALL[0], "--engine", "dense", "--device",
                     "cpu"]) == 2
