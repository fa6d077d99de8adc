"""Bit primitives on int64 bitboards (port of gamesmanmpi_tpu/core/bitops.py).

The reference carries states in uint32/uint64; torch implements neither
``>>`` nor ``searchsorted`` for its unsigned 32/64-bit types, so the port
carries them in signed int64. That is exact because every state fits 63
bits (games/base.py), so the sign bit is never set and arithmetic right
shifts behave as logical ones.

The padding sentinel moves with the carrier. The reference's all-ones
unsigned sentinel reads as -1 on a signed carrier and would sort FIRST,
breaking every "uniques, then a sentinel tail" contract; the port's
sentinel is :data:`SENTINEL` = INT64_MAX, which sorts last. A game
guarantees the all-ones 63-bit pattern is never a reachable state, as
the reference's games guarantee their all-ones word is not.
:func:`to_reference` and :func:`from_reference` convert states (sentinel
included) at every boundary with the reference's dtypes: parity tests,
``--table-out`` files, queries.
"""

import numpy as np
import torch

from gamesmanmpi_tpu_torch.core.host import (  # noqa: F401
    SENTINEL32,
    SENTINEL64,
    sentinel_for,
    state_dtype_for,
)

_M1 = 0x5555_5555_5555_5555
_M2 = 0x3333_3333_3333_3333
_M4 = 0x0F0F_0F0F_0F0F_0F0F

#: The port's padding sentinel: INT64_MAX sorts after every real state.
SENTINEL = (1 << 63) - 1


def to_reference(states, game) -> np.ndarray:
    """int64 carrier states (tensor or array) -> numpy in the game's
    reference dtype, SENTINEL mapped to the reference's all-ones."""
    if isinstance(states, torch.Tensor):
        states = states.cpu().numpy()
    a = np.asarray(states, dtype=np.int64)
    dt = game.state_dtype
    out = a.astype(dt)
    out[a == SENTINEL] = sentinel_for(dt)
    return out


def from_reference(states, device="cpu") -> torch.Tensor:
    """Reference states (uint32/uint64 numpy) -> int64 carrier tensor on
    `device`, the all-ones sentinel mapped to SENTINEL."""
    a = np.asarray(states)
    out = a.astype(np.int64)
    out[a == sentinel_for(a.dtype)] = SENTINEL
    return torch.from_numpy(out).to(device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of non-negative int64 values, as int32.

    SWAR bit counting; the byte sums are folded with shifts instead of the
    usual multiply so nothing overflows the signed carrier.
    """
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def msb_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the most-significant set bit of positive int64 values.

    A six-step binary search over shift widths (torch has no clz).
    """
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        hi = (x >> s) != 0
        x = torch.where(hi, x >> s, x)
        out = out + hi.to(torch.int32) * s
    return out
