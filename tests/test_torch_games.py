"""Torch port's games against the JAX reference games.

For every built-in game, with and without sym: reachable states are
found by a seeded breadth-first walk through the reference game's own
`expand`, handed to both packages as numpy arrays, and `expand`
(children and mask), `primitive`, `level_of` and `canonicalize` must
agree exactly (integers: tolerance zero). States cross the boundary
through core/bitops from_reference/to_reference (the port's int64
carrier, INT64_MAX sentinel).
"""

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.core import bitops as jax_bitops
from gamesmanmpi_tpu.core import codec as jax_codec
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu_torch.core import bitops, codec
from gamesmanmpi_tpu_torch.games import get_game

SPECS = [
    "tictactoe", "tictactoe:sym=1", "tictactoe:m=3,n=4,k=3,sym=1",
    "connect4:w=3,h=3,connect=3", "connect4:w=3,h=3,connect=3,sym=1",
    "connect4:w=4,h=4", "connect4:w=4,h=4,sym=1",
    "nim:heaps=3-4-5", "nim:heaps=1-2-10,misere=1",
    "subtract:total=10,moves=1-2", "subtract:total=21,moves=1-2-3,misere=1",
    "chomp:w=4,h=3", "chomp:w=3,h=3,sym=1", "chomp:w=1,h=1",
]

_STATES = {}


def reachable_sample(spec, per_level=200, depth=8):
    """Seeded sample of reachable states (reference dtype), found with
    the reference game's expand; cached per spec."""
    if spec not in _STATES:
        g = jax_get_game(spec)
        rng = np.random.default_rng(0)
        frontier = np.array([g.initial_state()], dtype=g.state_dtype)
        seen = [frontier]
        for _ in range(depth):
            ch, m = g.expand(frontier)
            nxt = np.unique(np.asarray(ch)[np.asarray(m)])
            if nxt.size == 0:
                break
            if nxt.size > per_level:
                nxt = np.sort(rng.choice(nxt, per_level, replace=False))
            frontier = nxt
            seen.append(frontier)
        _STATES[spec] = np.concatenate(seen)
    return _STATES[spec]


def _pair(spec):
    return jax_get_game(spec), get_game(spec)


@pytest.mark.parametrize("spec", SPECS)
def test_static_attributes_match(spec):
    ref, g = _pair(spec)
    assert g.name == ref.name
    for attr in ("max_moves", "num_levels", "max_level_jump", "state_bits",
                 "uniform_level_jump", "state_dtype"):
        assert getattr(g, attr) == getattr(ref, attr), attr
    assert g.sentinel == ref.sentinel and type(g.sentinel) is type(ref.sentinel)
    assert g.initial_state() == int(ref.initial_state())


@pytest.mark.parametrize("spec", SPECS)
def test_expand_matches(spec):
    ref, g = _pair(spec)
    st = reachable_sample(spec)
    rc, rm = ref.expand(st)
    rc, rm = np.asarray(rc), np.asarray(rm)
    tc, tm = g.expand(bitops.from_reference(st))
    assert tc.dtype == torch.int64 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tm.numpy(), rm)
    np.testing.assert_array_equal(bitops.to_reference(tc, g)[rm], rc[rm])


@pytest.mark.parametrize("spec", SPECS)
def test_primitive_and_level_match(spec):
    ref, g = _pair(spec)
    st = reachable_sample(spec)
    t = bitops.from_reference(st)
    prim = g.primitive(t)
    assert prim.dtype == torch.uint8
    np.testing.assert_array_equal(prim.numpy(), np.asarray(ref.primitive(st)))
    lvl = g.level_of(t)
    assert lvl.dtype == torch.int32
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(ref.level_of(st)))


@pytest.mark.parametrize("spec", SPECS)
def test_canonicalize_matches(spec):
    ref, g = _pair(spec)
    st = reachable_sample(spec)
    np.testing.assert_array_equal(
        bitops.to_reference(g.canonicalize(bitops.from_reference(st)), g),
        np.asarray(ref.canonicalize(st)))
    # And on [B, M] children blocks, the shape the engine hands it.
    rc, rm = ref.expand(st)
    rc, rm = np.asarray(rc), np.asarray(rm)
    got = bitops.to_reference(g.canonicalize(bitops.from_reference(rc)), g)
    np.testing.assert_array_equal(got[rm],
                                  np.asarray(ref.canonicalize(rc))[rm])


def test_sentinel_and_dtype_helpers():
    for dt in (np.uint32, np.uint64):
        assert bitops.sentinel_for(dt) == jax_bitops.sentinel_for(dt)
        assert bitops.sentinel_for(dt).dtype == dt
    for bits in (1, 31, 32, 63):
        assert bitops.state_dtype_for(bits) == jax_bitops.state_dtype_for(bits)
    with pytest.raises(ValueError):
        bitops.state_dtype_for(64)
    with pytest.raises(TypeError):
        bitops.sentinel_for(np.int64)
    # The carrier sentinel sorts last; the reference's all-ones would read
    # as -1 on a signed carrier and sort first.
    assert bitops.SENTINEL == torch.iinfo(torch.int64).max  # INT64_MAX
    for spec in ("tictactoe", "connect4:w=7,h=6"):
        g = get_game(spec)
        ref = np.array([5, 3, g.sentinel], dtype=g.state_dtype)
        t = bitops.from_reference(ref)
        assert t.tolist() == [5, 3, bitops.SENTINEL]
        assert torch.sort(t).values[-1] == bitops.SENTINEL
        back = bitops.to_reference(t, g)
        assert back.dtype == g.state_dtype
        np.testing.assert_array_equal(back, ref)


def test_codec_matches_reference_bytes():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, size=5000).astype(np.uint8)
    r = rng.integers(-3, 1 << 31, size=5000).astype(np.int64)
    r[:4] = [0, 1, (1 << 30) - 1, 1 << 30]
    want = np.asarray(jax_codec.pack_cells_np(v, r))
    got = codec.pack_cells(torch.from_numpy(v), torch.from_numpy(r))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32),
                                  want)
    np.testing.assert_array_equal(codec.pack_cells_np(v, r), want)
    gv, gr = codec.unpack_cells(got)
    wv, wr = jax_codec.unpack_cells_np(want)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gr.numpy(), wr)
    nv, nr = codec.unpack_cells_np(want)
    np.testing.assert_array_equal(nv, wv)
    np.testing.assert_array_equal(nr, wr)
    # The u32 narrowing wraps mod 2^32 in both directions.
    w = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
                      -1], dtype=torch.int64)
    assert codec.u32_to_i64(codec.i64_to_u32(w)).tolist() == [
        0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 0, (1 << 32) - 1]


def test_get_game_grammar_covers_every_game():
    assert get_game("ttt").name == "tictactoe_3x3x3"
    assert get_game("mnk:m=4,n=4,k=4,sym=1").name == "tictactoe_4x4x4_sym"
    assert get_game("1210").name == get_game("subtract").name
    assert get_game("tentozero:n=21,moves=1-2-3,misere=yes").name == \
        "subtract_21_1-2-3m"
    assert get_game("nim:heaps=1-2-10,misere=1").name == "nim_1-2-10m"
    assert get_game("chomp:width=3,height=3,sym=1").name == "chomp_3x3_sym"
    with pytest.raises(ValueError):
        get_game("chomp:w=4,h=3,sym=1")  # transpose symmetry needs a square
    with pytest.raises(ValueError):
        get_game("tictactoe:m=6,n=6")  # 72 bits do not pack
    with pytest.raises(KeyError):
        get_game("go")
