"""Owner hashing (port of gamesmanmpi_tpu/core/hashing.py).

A position's owner shard is ``splitmix64(state) mod num_shards``: a
cheap, well-mixed 64-bit permutation before the modulo, so structured
bitboard keys spread evenly. The reference computes it on uint64; the
port carries states in int64 (core/bitops.py), where the same bits need
two changes:

* ``>>`` on int64 shifts arithmetically, so every ``x >> k`` is masked to
  its low ``64 - k`` bits, which is the logical shift;
* the modulo is of the unsigned value: a negative carrier value z stands
  for z + 2^64, whose remainder is (z mod n + 2^64 mod n) mod n.

Adds and multiplies wrap modulo 2^64 on both carriers alike. The numpy
twins run on uint64, as the reference's do.
"""

import numpy as np
import torch

_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bits (a bijection of 64-bit words)."""
    z = x.to(torch.int64) + _signed(_C1)
    z = (z ^ _shr(z, 30)) * _signed(_C2)
    z = (z ^ _shr(z, 27)) * _signed(_C3)
    return z ^ _shr(z, 31)


def owner_shard(states: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard in [0, num_shards) of each state, as int32."""
    z = splitmix64(states)
    n = int(num_shards)
    wrap = (1 << 64) % n  # what the sign bit adds to the unsigned value
    r = torch.remainder(z, n) + (z < 0).to(torch.int64) * wrap
    return torch.remainder(r, n).to(torch.int32)


def splitmix64_np(x):
    """NumPy twin of splitmix64, on uint64."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, np.uint64) + np.uint64(_C1)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_C2)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_C3)
        return z ^ (z >> np.uint64(31))


def owner_shard_np(states, num_shards: int):
    """NumPy twin of owner_shard."""
    return (splitmix64_np(states) % np.uint64(num_shards)).astype(np.int32)
