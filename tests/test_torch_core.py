"""Torch port's owner hashing and host probe against the JAX package.

splitmix64/owner_shard run on the port's int64 carrier, where `>>` is an
arithmetic shift; they must give the reference's uint64 results bit for
bit, top bit set included. Seeded numpy inputs; tolerance zero.
"""

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu.core import hashing as ref_hashing
from gamesmanmpi_tpu.core.probe import probe_sorted_np as ref_probe
from gamesmanmpi_tpu_torch.core import hashing
from gamesmanmpi_tpu_torch.core.probe import probe_sorted_np

#: Words with the top bit set, clear, and at both ends of each half.
EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1,
                  2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def _words(seed, n=20000):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    return np.concatenate([EDGES, u])


def _carrier(u: np.ndarray) -> torch.Tensor:
    """uint64 words as the int64 tensor with the same bits."""
    return torch.from_numpy(u.view(np.int64).copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix64_bit_exact(seed):
    u = _words(seed)
    want = np.asarray(ref_hashing.splitmix64(u))
    assert want.dtype == np.uint64
    got = hashing.splitmix64(_carrier(u)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hashing.splitmix64_np(u), want)
    np.testing.assert_array_equal(hashing.splitmix64_np(u),
                                  ref_hashing.splitmix64_np(u))


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 7, 8, 1000, 2**31 - 1])
def test_owner_shard_bit_exact(num_shards):
    u = _words(num_shards)
    want = np.asarray(ref_hashing.owner_shard(u, num_shards))
    got = hashing.owner_shard(_carrier(u), num_shards)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hashing.owner_shard_np(u, num_shards),
                                  want)
    assert hashing.owner_shard_np(u, num_shards).dtype == np.int32
    assert int(got.min()) >= 0 and int(got.max()) < num_shards


def test_splitmix64_of_top_bit_words_is_not_the_arithmetic_shift():
    """The trap the masking avoids: an unmasked int64 `>>` smears the sign
    bit and changes the hash of every word with the top bit set."""
    u = EDGES[EDGES >= 2**63]
    x = _carrier(u)
    c1 = hashing._signed(hashing._C1)
    z = x + c1
    smeared = (z ^ (z >> 30)).numpy().view(np.uint64)
    logical = (z ^ hashing._shr(z, 30)).numpy().view(np.uint64)
    with np.errstate(over="ignore"):
        zu = u + np.uint64(hashing._C1)
    np.testing.assert_array_equal(logical, zu ^ (zu >> np.uint64(30)))
    assert (smeared != logical).any()


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_probe_sorted_matches_reference(dtype):
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 1 << 30, size=5000)).astype(dtype)
    queries = np.concatenate([keys[::7], rng.integers(0, 1 << 30, 500)
                              .astype(dtype), np.array([0, (1 << 30) + 5],
                                                       dtype)])
    idx, hit = probe_sorted_np(keys, queries)
    ridx, rhit = ref_probe(keys, queries)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(hit, rhit)
    assert idx.dtype == np.int64 and hit.dtype == bool
    assert hit[:len(keys[::7])].all()
    np.testing.assert_array_equal(keys[idx[hit]], queries[hit])
    empty_idx, empty_hit = probe_sorted_np(keys[:0], queries[:3])
    assert empty_idx.tolist() == [0, 0, 0] and not empty_hit.any()
