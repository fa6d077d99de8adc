"""Torch port's dedup, provenance and lookup ops against the JAX reference.

Same seeded numpy inputs through both packages (states cross through
core/bitops from_reference/to_reference); integers, so tolerance zero.
The reference returns [N] outputs with a sentinel tail and a device
count; the port returns the same [N] layout on its INT64_MAX sentinel
and the count as a host int.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.ops import dedup as jax_dedup
from gamesmanmpi_tpu.ops import lookup as jax_lookup
from gamesmanmpi_tpu.ops import provenance as jax_prov
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL, from_reference
from gamesmanmpi_tpu_torch.ops import dedup, lookup, provenance


def _states(dtype, n, hi, sentinels, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, hi, size=n).astype(dtype)
    s[rng.random(n) < sentinels] = np.iinfo(dtype).max
    return s


CASES = [(np.uint32, 1000, 300, 0.2), (np.uint64, 4000, 1 << 40, 0.1),
         (np.uint64, 1, 5, 0.0), (np.uint32, 50, 7, 1.0)]


@pytest.mark.parametrize("dtype,n,hi,sent", CASES)
def test_sort_unique_matches(dtype, n, hi, sent):
    s = _states(dtype, n, hi, sent, 0)
    ref, rcount = jax_dedup.sort_unique(jnp.asarray(s))
    got, count = dedup.sort_unique(from_reference(s))
    assert count == int(rcount)
    np.testing.assert_array_equal(
        got.numpy(), from_reference(np.asarray(ref)).numpy())
    assert (got[count:] == SENTINEL).all()


@pytest.mark.parametrize("dtype,n,hi,sent", CASES)
def test_compact_sorted_matches(dtype, n, hi, sent):
    s = np.sort(_states(dtype, n, hi, sent, 1))
    rng = np.random.default_rng(2)
    keep = (rng.random(n) < 0.5) & (s != np.iinfo(dtype).max)
    ref = np.asarray(jax_dedup.compact_sorted(jnp.asarray(s),
                                              jnp.asarray(keep)))
    got = dedup.compact_sorted(from_reference(s), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), from_reference(ref).numpy())


@pytest.mark.parametrize("dtype,n,hi,sent", CASES)
def test_dedup_provenance_matches(dtype, n, hi, sent):
    s = _states(dtype, n, hi, sent, 3)
    ruq, rcount, ruidx = jax_prov.dedup_provenance(jnp.asarray(s))
    uq, count, uidx = provenance.dedup_provenance(from_reference(s))
    assert count == int(rcount)
    assert uidx.dtype == torch.int32
    np.testing.assert_array_equal(uq.numpy(),
                                  from_reference(np.asarray(ruq)).numpy())
    np.testing.assert_array_equal(uidx.numpy(), np.asarray(ruidx))


def test_gather_cells_matches():
    rng = np.random.default_rng(4)
    w = 300
    wv = rng.integers(0, 4, size=w).astype(np.uint8)
    wr = rng.integers(0, 60, size=w).astype(np.int32)
    uidx = rng.integers(-1, w, size=(50, 7)).astype(np.int32)
    ref = np.asarray(jax_prov.gather_cells(jnp.asarray(uidx), jnp.asarray(wv),
                                           jnp.asarray(wr)))
    got = provenance.gather_cells(torch.from_numpy(uidx), torch.from_numpy(wv),
                                  torch.from_numpy(wr))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32),
                                  ref)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_lookup_window_matches(dtype):
    rng = np.random.default_rng(5)
    window = []
    pool = np.unique(rng.integers(0, 5000, size=1200).astype(dtype))
    for part in np.array_split(rng.permutation(pool), 3):
        st = np.sort(part)
        window.append((st, rng.integers(0, 4, size=st.size).astype(np.uint8),
                       rng.integers(0, 90, size=st.size).astype(np.int32)))
    keys = rng.integers(0, 6000, size=(64, 9)).astype(dtype)
    keys[0, :3] = np.iinfo(dtype).max
    rv, rr, rh = jax_lookup.lookup_window(
        jnp.asarray(keys),
        [tuple(jnp.asarray(a) for a in t) for t in window], method="scan")
    gv, gr, gh = lookup.lookup_window(
        from_reference(keys),
        [(from_reference(s), torch.from_numpy(v), torch.from_numpy(r))
         for s, v, r in window])
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))
    assert gh.any() and not gh.all()


def test_lookup_sorted_empty_table_misses():
    keys = torch.tensor([[1, 2], [3, SENTINEL]])
    empty = torch.zeros(0, dtype=torch.int64)
    v, r, h = lookup.lookup_sorted(keys, empty, empty.to(torch.uint8),
                                   empty.to(torch.int32))
    assert v.shape == r.shape == h.shape == keys.shape
    assert not h.any() and (v == 0).all() and (r == 0).all()
